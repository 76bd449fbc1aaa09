"""Algebra unit tests: Hamilton-product oracles (SURVEY.md §4 test 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr.ops import (
    hamilton_expand,
    hamilton_product,
    pack_components,
    qconv,
    qconv_expanded_oracle,
    qdense,
    qdense_naive,
    split_components,
)


def _rand(key, shape):
    return jax.random.normal(key, shape, dtype=jnp.float32)


class TestHamiltonProduct:
    def test_identity(self):
        # (1,0,0,0) is the multiplicative identity
        q = _rand(jax.random.PRNGKey(0), (5, 8))
        c = 2
        one = pack_components(
            jnp.ones((5, c)), jnp.zeros((5, c)), jnp.zeros((5, c)), jnp.zeros((5, c))
        )
        np.testing.assert_allclose(hamilton_product(one, q), q, rtol=1e-6)
        np.testing.assert_allclose(hamilton_product(q, one), q, rtol=1e-6)

    def test_ij_equals_k(self):
        z = jnp.zeros((1, 1))
        o = jnp.ones((1, 1))
        i = pack_components(z, o, z, z)
        j = pack_components(z, z, o, z)
        k = pack_components(z, z, z, o)
        np.testing.assert_allclose(hamilton_product(i, j), k, atol=1e-7)
        np.testing.assert_allclose(hamilton_product(j, i), -k, atol=1e-7)
        np.testing.assert_allclose(hamilton_product(i, i), -pack_components(o, z, z, z), atol=1e-7)

    def test_norm_multiplicative(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(1))
        a, b = _rand(k1, (7, 4)), _rand(k2, (7, 4))
        ab = hamilton_product(a, b)
        def qnorm(q):
            return jnp.sqrt(sum(c**2 for c in split_components(q)))
        np.testing.assert_allclose(qnorm(ab), qnorm(a) * qnorm(b), rtol=1e-5)


class TestQDense:
    @pytest.mark.parametrize("cin,cout,batch", [(3, 5, 2), (16, 8, 4), (1, 1, 1)])
    def test_matches_naive(self, cin, cout, batch):
        kx, kw = jax.random.split(jax.random.PRNGKey(2))
        x = _rand(kx, (batch, 4 * cin))
        w = _rand(kw, (4, cin, cout))
        got = qdense(x, w)
        want = qdense_naive(x, w)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_matches_scalar_hamilton(self):
        # Cin=Cout=1 dense == elementwise Hamilton product with w on the left? No:
        # our convention per quaternion.py is y_b = sum_a sign*x_a*W — verify against
        # hamilton_product(w, x) with scalar channels.
        kx, kw = jax.random.split(jax.random.PRNGKey(3))
        x = _rand(kx, (6, 4))
        w = _rand(kw, (4, 1, 1))
        wq = jnp.tile(w[:, 0, 0][None, :], (6, 1))  # packed [6, 4]
        want = hamilton_product(wq, x)
        got = qdense(x, w)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_grad_finite_difference(self):
        kx, kw = jax.random.split(jax.random.PRNGKey(4))
        x = _rand(kx, (2, 8))
        w = _rand(kw, (4, 2, 3))
        f = lambda w_: jnp.sum(jnp.sin(qdense(x, w_)))
        g = jax.grad(f)(w)
        eps = 1e-3
        idx = (1, 1, 2)
        wp = w.at[idx].add(eps)
        wm = w.at[idx].add(-eps)
        fd = (f(wp) - f(wm)) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=1e-2)


class TestQConv:
    @pytest.mark.parametrize(
        "spatial,kernel,cin,cout",
        [((11, 9), (3, 3), 2, 4), ((17,), (3,), 3, 5), ((8, 8), (1, 1), 4, 4)],
    )
    def test_matches_expanded_oracle(self, spatial, kernel, cin, cout):
        kx, kw = jax.random.split(jax.random.PRNGKey(5))
        x = _rand(kx, (2, *spatial, 4 * cin))
        w = _rand(kw, (4, *kernel, cin, cout))
        got = qconv(x, w, padding="SAME")
        want = qconv_expanded_oracle(x, w, padding="SAME")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_1x1_conv_equals_dense(self):
        kx, kw = jax.random.split(jax.random.PRNGKey(6))
        x = _rand(kx, (2, 5, 7, 12))
        w = _rand(kw, (4, 1, 1, 3, 6))
        got = qconv(x, w, padding="VALID")
        want = qdense(x, w[:, 0, 0])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_valid_padding_shapes_and_strides(self):
        kx, kw = jax.random.split(jax.random.PRNGKey(7))
        x = _rand(kx, (1, 12, 10, 8))
        w = _rand(kw, (4, 3, 3, 2, 2))
        out = qconv(x, w, strides=(2, 2), padding="VALID")
        assert out.shape == (1, 5, 4, 8)
        want = qconv_expanded_oracle(x, w, strides=(2, 2), padding="VALID")
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)

    def test_bf16_compute_close_to_f32(self):
        kx, kw = jax.random.split(jax.random.PRNGKey(8))
        x = _rand(kx, (1, 8, 8, 8))
        w = _rand(kw, (4, 3, 3, 2, 2))
        out_bf = qconv(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16))
        out_f32 = qconv(x, w)
        assert out_bf.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            out_bf.astype(jnp.float32), out_f32, rtol=5e-2, atol=5e-2
        )


class TestHamiltonExpand:
    def test_block_structure(self):
        w = _rand(jax.random.PRNGKey(9), (4, 2, 3))
        big = hamilton_expand(w)
        assert big.shape == (8, 12)
        # in-r, out-r block is Wr; in-i, out-r block is -Wi
        np.testing.assert_allclose(big[0:2, 0:3], w[0], atol=0)
        np.testing.assert_allclose(big[2:4, 0:3], -w[1], atol=0)
        # in-r out-k is Wk; in-j out-k is Wi
        np.testing.assert_allclose(big[0:2, 9:12], w[3], atol=0)
        np.testing.assert_allclose(big[4:6, 9:12], w[1], atol=0)

    def test_conjugate_is_component_transpose(self):
        # The Hamilton multiplication matrix of conj(q) is the component-wise
        # transpose of that of q (exactly the transpose for scalar channels).
        w = _rand(jax.random.PRNGKey(10), (4, 1, 1))
        big = hamilton_expand(w)
        bigc = hamilton_expand(w, conjugate=True)
        np.testing.assert_allclose(bigc, big.T, rtol=1e-6)


class TestFastVariants:
    """10-multiplication Hamilton scheme == block path (quaternion.py)."""

    def test_qdense_fast_matches(self):
        from qasr.ops.qlinalg import qdense_fast

        kx, kw = jax.random.split(jax.random.PRNGKey(20))
        x = _rand(kx, (9, 4 * 13))
        w = _rand(kw, (4, 13, 7))
        np.testing.assert_allclose(
            qdense_fast(x, w), qdense(x, w), rtol=1e-4, atol=1e-4
        )

    @pytest.mark.parametrize("spatial,kernel", [((7, 6), (3, 3)), ((11,), (3,))])
    def test_qconv_fast_matches(self, spatial, kernel):
        from qasr.ops.qlinalg import qconv_fast

        kx, kw = jax.random.split(jax.random.PRNGKey(21))
        x = _rand(kx, (2, *spatial, 4 * 5))
        w = _rand(kw, (4, *kernel, 5, 6))
        np.testing.assert_allclose(
            qconv_fast(x, w), qconv(x, w), rtol=1e-4, atol=1e-4
        )

    def test_fast_grad_matches(self):
        from qasr.ops.qlinalg import qdense_fast

        kx, kw = jax.random.split(jax.random.PRNGKey(22))
        x = _rand(kx, (5, 4 * 6))
        w = _rand(kw, (4, 6, 3))
        g1 = jax.grad(lambda w: jnp.sum(jnp.tanh(qdense_fast(x, w))))(w)
        g2 = jax.grad(lambda w: jnp.sum(jnp.tanh(qdense(x, w))))(w)
        np.testing.assert_allclose(g1, g2, rtol=1e-3, atol=1e-4)

    @pytest.mark.parametrize(
        "spatial,kernel,strides",
        [
            ((7, 6), (3, 3), (1, 1)),
            ((7, 6), (3, 3), (2, 1)),
            ((11,), (3,), (1,)),
        ],
    )
    def test_qconv_fast10_matches(self, spatial, kernel, strides):
        from qasr.ops.qlinalg import qconv_fast10

        kx, kw = jax.random.split(jax.random.PRNGKey(23))
        x = _rand(kx, (2, *spatial, 4 * 5))
        w = _rand(kw, (4, *kernel, 5, 6))
        for padding in ("SAME", "VALID"):
            np.testing.assert_allclose(
                qconv_fast10(x, w, strides=strides, padding=padding),
                qconv(x, w, strides=strides, padding=padding),
                rtol=1e-4,
                atol=1e-4,
            )

    @pytest.mark.parametrize(
        "spatial,kernel,strides",
        [
            ((7, 6), (3, 3), (1, 1)),
            ((7, 6), (3, 3), (2, 1)),
            ((11,), (3,), (1,)),
        ],
    )
    def test_qconv_fast8_matches(self, spatial, kernel, strides):
        # round 5: packed-path rank-8 conv (8 plain convs; the option for
        # fat layers outside a stacked chain)
        from qasr.ops.qlinalg import qconv_fast8

        kx, kw = jax.random.split(jax.random.PRNGKey(29))
        x = _rand(kx, (2, *spatial, 4 * 5))
        w = _rand(kw, (4, *kernel, 5, 6))
        for padding in ("SAME", "VALID"):
            np.testing.assert_allclose(
                qconv_fast8(x, w, strides=strides, padding=padding),
                qconv(x, w, strides=strides, padding=padding),
                rtol=2e-4,
                atol=2e-4,
            )

    def test_qconv_fast8_grads_match(self):
        from qasr.ops.qlinalg import qconv_fast8

        kx, kw = jax.random.split(jax.random.PRNGKey(30))
        x = _rand(kx, (2, 8, 5, 4 * 3))
        w = _rand(kw, (4, 3, 3, 3, 4))

        def loss(fn):
            return lambda x, w: jnp.sum(jnp.tanh(fn(x, w)))

        gx1, gw1 = jax.grad(loss(qconv_fast8), argnums=(0, 1))(x, w)
        gx2, gw2 = jax.grad(loss(qconv), argnums=(0, 1))(x, w)
        np.testing.assert_allclose(gx1, gx2, rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(gw1, gw2, rtol=1e-3, atol=2e-4)

    def test_qconv_fast10_grads_match(self):
        from qasr.ops.qlinalg import qconv_fast10

        kx, kw = jax.random.split(jax.random.PRNGKey(24))
        x = _rand(kx, (2, 8, 5, 4 * 3))
        w = _rand(kw, (4, 3, 3, 3, 4))

        def loss(fn):
            return lambda x, w: jnp.sum(jnp.tanh(fn(x, w)))

        gx1, gw1 = jax.grad(loss(qconv_fast10), argnums=(0, 1))(x, w)
        gx2, gw2 = jax.grad(loss(qconv), argnums=(0, 1))(x, w)
        np.testing.assert_allclose(gx1, gx2, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(gw1, gw2, rtol=1e-3, atol=1e-4)


class TestRank8Scheme:
    """Exactness of the rank-8 bilinear decomposition (quaternion.py U8/V8/O8,
    found by tools/find_rank8.py; the bilinear rank of quaternion
    multiplication is exactly 8)."""

    def test_decomposition_reconstructs_hamilton_tensor(self):
        from qasr.ops.quaternion import O8, U8, V8, hamilton_tensor

        t = np.einsum("pi,pj,kp->ijk", U8, V8, O8)
        np.testing.assert_allclose(t, hamilton_tensor(), atol=1e-12)

    def test_v8_rows_are_two_sparse(self):
        from qasr.ops.quaternion import U8, V8

        assert all(int((np.abs(V8[p]) > 0).sum()) == 2 for p in range(8))
        # conditioning bound: bf16 weight-combo rounding amplification stays
        # comparable to the 10-product scheme's +-1 combos
        assert np.abs(U8).max() < 2.5

    def test_fast8_stacked_conv_matches_oracle(self):
        from qasr.ops.qlinalg import (
            pack_to_stacked,
            qconv_fast8_stacked,
            stacked_to_pack,
        )

        k1, k2 = jax.random.split(jax.random.PRNGKey(5))
        x = jax.random.normal(k1, (2, 18, 9, 4 * 6))
        w = jax.random.normal(k2, (4, 3, 3, 6, 7)) * 0.2
        x_st = pack_to_stacked(jnp.swapaxes(x, 1, 2))
        y = jnp.swapaxes(stacked_to_pack(qconv_fast8_stacked(x_st, w)), 1, 2)
        ref = qconv(x, w, padding="SAME")
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(ref), atol=2e-4, rtol=2e-4
        )

    def test_fast8_stacked_grads_match(self):
        from qasr.ops.qlinalg import pack_to_stacked, qconv_fast8_stacked

        k1, k2 = jax.random.split(jax.random.PRNGKey(7))
        x = jax.random.normal(k1, (2, 10, 7, 4 * 3))
        w = jax.random.normal(k2, (4, 3, 3, 3, 3)) * 0.2
        x_st = pack_to_stacked(jnp.swapaxes(x, 1, 2))

        g8 = jax.grad(
            lambda a, b: jnp.sum(qconv_fast8_stacked(a, b) ** 2), argnums=(0, 1)
        )(x_st, w)
        from qasr.ops.qlinalg import stacked_to_pack

        gref = jax.grad(
            lambda a, b: jnp.sum(
                qconv(
                    jnp.swapaxes(stacked_to_pack(a), 1, 2), b, padding="SAME"
                )
                ** 2
            ),
            argnums=(0, 1),
        )(x_st, w)
        np.testing.assert_allclose(
            np.asarray(g8[1]), np.asarray(gref[1]), atol=3e-3, rtol=3e-3
        )
        np.testing.assert_allclose(
            np.asarray(g8[0]), np.asarray(gref[0]), atol=3e-3, rtol=3e-3
        )


class TestQDenseFast8:
    def test_matches_block_dense(self):
        from qasr.ops.qlinalg import qdense_fast8

        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        x = jax.random.normal(k1, (32, 4 * 24))
        w = jax.random.normal(k2, (4, 24, 10)) * 0.2
        np.testing.assert_allclose(
            np.asarray(qdense_fast8(x, w)),
            np.asarray(qdense(x, w)),
            atol=2e-4,
            rtol=2e-4,
        )
        g8 = jax.grad(lambda a, b: jnp.sum(qdense_fast8(a, b) ** 2), argnums=(0, 1))(x, w)
        gb = jax.grad(lambda a, b: jnp.sum(qdense(a, b) ** 2), argnums=(0, 1))(x, w)
        np.testing.assert_allclose(np.asarray(g8[0]), np.asarray(gb[0]), atol=3e-4, rtol=3e-4)
        np.testing.assert_allclose(np.asarray(g8[1]), np.asarray(gb[1]), atol=3e-3, rtol=3e-3)


class TestGroupedConv:
    """stacked8g (one feature-grouped dispatch) must match the separate-conv
    rank-8 path for values AND the hand-written rotated-role backward."""

    def test_value_and_grads_match_stacked(self):
        from qasr.ops.qlinalg import (
            qconv_fast8_grouped,
            qconv_fast8_stacked,
        )

        kx, kw = jax.random.split(jax.random.PRNGKey(0))
        x = jax.random.normal(kx, (2, 4, 5, 12, 16))
        w = jax.random.normal(kw, (4, 3, 3, 16, 8)) * 0.2
        np.testing.assert_allclose(
            np.asarray(qconv_fast8_grouped(x, w)),
            np.asarray(qconv_fast8_stacked(x, w)),
            rtol=2e-4, atol=2e-4,
        )
        g1 = jax.grad(
            lambda x_, w_: jnp.sum(qconv_fast8_grouped(x_, w_) ** 2), (0, 1)
        )(x, w)
        g2 = jax.grad(
            lambda x_, w_: jnp.sum(qconv_fast8_stacked(x_, w_) ** 2), (0, 1)
        )(x, w)
        np.testing.assert_allclose(g1[0], g2[0], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(g1[1], g2[1], rtol=1e-3, atol=1e-3)

    def test_even_kernel_falls_back_to_autodiff(self):
        from qasr.ops.qlinalg import qconv_fast8_grouped
        from qasr.ops.qlinalg import qconv

        kx, kw = jax.random.split(jax.random.PRNGKey(1))
        x = jax.random.normal(kx, (1, 4, 4, 8, 4))
        w = jax.random.normal(kw, (4, 2, 2, 4, 4)) * 0.3
        # value parity vs the block oracle through the packed layout
        from qasr.ops.qlinalg import stacked_to_pack

        got = jnp.swapaxes(stacked_to_pack(qconv_fast8_grouped(x, w)), 1, 2)
        xp = jnp.swapaxes(stacked_to_pack(x), 1, 2)
        want = qconv(xp, w, padding="SAME")
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-4
        )
