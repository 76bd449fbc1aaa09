"""Reduced-product quaternion paths (qasr/ops/qlinalg.py) against the block
path and the 16-product oracle (SURVEY.md §4 tests 1-2): the 10-product and
rank-8 GEMMs, the packed convs, the stacked F-major convs and a stacked conv
tower. Shapes cover unaligned K and N, odd M, small N, strides, VALID
padding, odd T and 5x5 kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr.ops.qlinalg import (
    pack_to_stacked,
    qconv,
    qconv_expanded_oracle,
    qconv_fast8,
    qconv_fast8_stacked,
    qconv_fast10,
    qconv_fast10_stacked,
    qdense,
    qdense_fast,
    qdense_fast8,
    stacked_to_pack,
)

DENSE = {"fast": qdense_fast, "fast8": qdense_fast8}
CONV = {"fast10": qconv_fast10, "fast8": qconv_fast8}
STACKED = {"fast10": qconv_fast10_stacked, "fast8": qconv_fast8_stacked}


def _rand(key, shape, scale=1.0):
    return jax.random.normal(key, shape, jnp.float32) * scale


def _to_stacked(x_btfc):
    return pack_to_stacked(jnp.swapaxes(x_btfc, 1, 2))


def _from_stacked(x_st):
    return jnp.swapaxes(stacked_to_pack(x_st), 1, 2)


class TestQGemm:
    @pytest.mark.parametrize("impl", ["fast", "fast8"])
    @pytest.mark.parametrize(
        "m,k,n",
        [
            (256, 128, 128),   # aligned
            (300, 130, 96),    # everything unaligned
            (8, 832, 256),     # tiny M, big K
            (512, 64, 32),     # small K/N
            (12, 128, 128),
            (300, 1664, 256),  # large K
            (7, 256, 62),      # odd N (output head width)
            (64, 640, 384),
        ],
    )
    def test_matches_block_path(self, impl, m, k, n):
        kx, kw = jax.random.split(jax.random.PRNGKey(m + k + n))
        x = _rand(kx, (m, 4 * k), 0.3)
        w = _rand(kw, (4, k, n), 0.05)
        np.testing.assert_allclose(
            DENSE[impl](x, w), qdense(x, w), rtol=2e-4, atol=2e-4
        )

    @pytest.mark.parametrize("impl", ["fast", "fast8"])
    @pytest.mark.parametrize("k,n", [(130, 40), (128, 128), (1664, 640)])
    def test_grads_match_block_path(self, impl, k, n):
        kx, kw = jax.random.split(jax.random.PRNGKey(k))
        x = _rand(kx, (5, 4 * k), 0.3)
        w = _rand(kw, (4, k, n), 0.05)

        def loss(fn):
            return lambda x_, w_: jnp.sum(jnp.sin(fn(x_, w_)))

        gx, gw = jax.grad(loss(DENSE[impl]), argnums=(0, 1))(x, w)
        rx, rw = jax.grad(loss(qdense), argnums=(0, 1))(x, w)
        np.testing.assert_allclose(gx, rx, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(gw, rw, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("impl", ["fast", "fast8"])
    def test_batch_dims_wrapper(self, impl):
        kx, kw = jax.random.split(jax.random.PRNGKey(1))
        x = _rand(kx, (2, 7, 4 * 130))
        w = _rand(kw, (4, 130, 40))
        got = DENSE[impl](x, w)
        assert got.shape == (2, 7, 160)
        np.testing.assert_allclose(got, qdense(x, w), rtol=2e-4, atol=2e-4)


class TestQConvPacked:
    @pytest.mark.parametrize("impl", ["fast10", "fast8"])
    @pytest.mark.parametrize(
        "spatial,cin,cout,padding",
        [((12, 9), 16, 8, "SAME"), ((8, 8), 4, 4, "VALID"), ((10, 13), 32, 16, "SAME")],
    )
    def test_matches_block_path(self, impl, spatial, cin, cout, padding):
        kx, kw = jax.random.split(jax.random.PRNGKey(cin + cout))
        x = _rand(kx, (2, *spatial, 4 * cin))
        w = _rand(kw, (4, 3, 3, cin, cout))
        got = CONV[impl](x, w, padding=padding)
        want = qconv(x, w, padding=padding)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("impl", ["fast10", "fast8"])
    def test_matches_expanded_oracle(self, impl):
        kx, kw = jax.random.split(jax.random.PRNGKey(9))
        x = _rand(kx, (1, 9, 9, 4 * 8))
        w = _rand(kw, (4, 3, 3, 8, 8))
        np.testing.assert_allclose(
            CONV[impl](x, w), qconv_expanded_oracle(x, w), rtol=2e-4, atol=2e-4
        )

    @pytest.mark.parametrize("impl", ["fast10", "fast8"])
    def test_strides(self, impl):
        kx, kw = jax.random.split(jax.random.PRNGKey(10))
        x = _rand(kx, (1, 12, 10, 4 * 8))
        w = _rand(kw, (4, 3, 3, 8, 8))
        got = CONV[impl](x, w, strides=(2, 2), padding="VALID")
        want = qconv(x, w, strides=(2, 2), padding="VALID")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("impl", ["fast10", "fast8"])
    def test_grad_through_conv(self, impl):
        kx, kw = jax.random.split(jax.random.PRNGKey(11))
        x = _rand(kx, (1, 8, 8, 4 * 8))
        w = _rand(kw, (4, 3, 3, 8, 8))
        g1 = jax.grad(lambda w: jnp.sum(CONV[impl](x, w) ** 2))(w)
        g2 = jax.grad(lambda w: jnp.sum(qconv(x, w) ** 2))(w)
        np.testing.assert_allclose(g1, g2, rtol=1e-3, atol=1e-3)


class TestFtConv:
    """Stacked F-major convs (``[B, 4, F, T, C]``) against the oracle —
    both schemes, SAME stride 1, through the transposed-conv custom VJP."""

    @pytest.mark.parametrize(
        "shape",
        [
            (1, 20, 13, 8, 8),
            (2, 16, 9, 4, 4),
            (1, 7, 5, 2, 3),       # tiny dims
            (1, 33, 15, 8, 12),    # odd T
        ],
    )
    @pytest.mark.parametrize("scheme", ["fast10", "fast8"])
    def test_matches_block_path(self, shape, scheme):
        b, t, f, cin, cout = shape
        kx, kw = jax.random.split(jax.random.PRNGKey(sum(shape)))
        x = _rand(kx, (b, t, f, 4 * cin))
        w = _rand(kw, (4, 3, 3, cin, cout))
        got = _from_stacked(STACKED[scheme](_to_stacked(x), w))
        want = qconv_expanded_oracle(x, w)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("scheme", ["fast10", "fast8"])
    def test_5x5_kernel(self, scheme):
        kx, kw = jax.random.split(jax.random.PRNGKey(0))
        x = _rand(kx, (1, 18, 11, 4 * 4))
        w = _rand(kw, (4, 5, 5, 4, 4))
        got = _from_stacked(STACKED[scheme](_to_stacked(x), w))
        np.testing.assert_allclose(
            got, qconv_expanded_oracle(x, w), rtol=2e-4, atol=2e-4
        )

    @pytest.mark.parametrize("scheme", ["fast10", "fast8"])
    def test_grads_match(self, scheme):
        kx, kw = jax.random.split(jax.random.PRNGKey(1))
        x = _rand(kx, (1, 18, 7, 4 * 4))
        w = _rand(kw, (4, 3, 3, 4, 4))
        x_st = _to_stacked(x)
        g1x, g1w = jax.grad(
            lambda x_, w_: jnp.sum(STACKED[scheme](x_, w_) ** 2), argnums=(0, 1)
        )(x_st, w)
        g2x, g2w = jax.grad(
            lambda x_, w_: jnp.sum(qconv(_from_stacked(x_), w_) ** 2),
            argnums=(0, 1),
        )(x_st, w)
        np.testing.assert_allclose(g1w, g2w, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(g1x, g2x, rtol=1e-3, atol=1e-3)


class TestEvenKernelVjpGate:
    def test_even_kernel_grads_fall_back_to_autodiff(self):
        """The conjugate-transpose custom-VJP dx is only valid for odd
        kernels (symmetric SAME padding); even kernels must route to autodiff
        of the plain formulation — dx would otherwise be computed with
        mirrored padding offsets."""
        kx, kw = jax.random.split(jax.random.PRNGKey(4))
        x = _rand(kx, (1, 12, 6, 4 * 3))
        w = _rand(kw, (4, 2, 2, 3, 3)) * 0.3
        x_st = _to_stacked(x)
        gx, gw = jax.grad(
            lambda a, b: jnp.sum(qconv_fast8_stacked(a, b) ** 2), argnums=(0, 1)
        )(x_st, w)
        gxr, gwr = jax.grad(
            lambda a, b: jnp.sum(qconv(_from_stacked(a), b) ** 2),
            argnums=(0, 1),
        )(x_st, w)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(gxr), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(gw), np.asarray(gwr), rtol=1e-3, atol=1e-3)


C = 128  # the width at which the tower enters the stacked layout


def _prelu_st(x, alpha):
    a = alpha.reshape(4, 1, 1, -1).astype(x.dtype)
    return jnp.where(x >= 0, x, a * x)


def _prelu_packed(x, alpha):
    return jnp.where(x >= 0, x, alpha.astype(x.dtype) * x)


def _stacked_layer(x_st, w, bias, alpha, scheme):
    """PReLU(alpha) then conv + bias, on the stacked layout."""
    xin = _prelu_st(x_st, alpha) if alpha is not None else x_st
    return STACKED[scheme](xin, w) + bias.reshape(4, 1, 1, -1)


def _packed_layer(x, w, bias, alpha):
    """The same layer on the packed layout through the block conv."""
    xin = _prelu_packed(x, alpha) if alpha is not None else x
    return qconv(xin, w) + bias


class TestStackedTower:
    """Fat conv layers chained on the stacked layout (the tower's steady
    state) against the same composition on the packed block path."""

    @pytest.mark.parametrize("scheme", ["fast8", "fast10"])
    @pytest.mark.parametrize("t", [32, 40])
    def test_single_layer_matches_packed(self, scheme, t):
        kx, kw_, kb = jax.random.split(jax.random.PRNGKey(t), 3)
        x = _rand(kx, (1, t, 5, 4 * C), 0.5)
        w = _rand(kw_, (4, 3, 3, C, C), 0.05)
        bias = _rand(kb, (4 * C,), 0.1)
        got = _from_stacked(_stacked_layer(_to_stacked(x), w, bias, None, scheme))
        want = _packed_layer(x, w, bias, None)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def test_two_layer_chain_with_prelu(self):
        keys = jax.random.split(jax.random.PRNGKey(7), 6)
        t = 40
        x = _rand(keys[0], (2, t, 5, 4 * C), 0.5)
        w1, w2 = (_rand(k, (4, 3, 3, C, C), 0.05) for k in keys[1:3])
        b1, b2 = (_rand(k, (4 * C,), 0.1) for k in keys[3:5])
        a1 = jnp.abs(_rand(keys[5], (4 * C,), 0.25))
        z = _stacked_layer(_to_stacked(x), w1, b1, None, "fast8")
        got = _from_stacked(_stacked_layer(z, w2, b2, a1, "fast8"))
        want = _packed_layer(_packed_layer(x, w1, b1, None), w2, b2, a1)
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)

    @pytest.mark.parametrize("negative_alpha", [False, True])
    def test_grads_match_packed_composition(self, negative_alpha):
        keys = jax.random.split(jax.random.PRNGKey(11), 6)
        t = 40
        x = _rand(keys[0], (1, t, 5, 4 * C), 0.5)
        w1, w2 = (_rand(k, (4, 3, 3, C, C), 0.05) for k in keys[1:3])
        b1, b2 = (_rand(k, (4 * C,), 0.1) for k in keys[3:5])
        a1 = _rand(keys[5], (4 * C,), 0.25)
        if not negative_alpha:
            a1 = jnp.abs(a1)

        def loss_st(x, w1, b1, a1, w2, b2):
            z = _stacked_layer(_to_stacked(x), w1, b1, None, "fast8")
            z = _stacked_layer(z, w2, b2, a1, "fast8")
            return jnp.sum(z * jnp.sin(0.3 * z))

        def loss_packed(x, w1, b1, a1, w2, b2):
            z = _packed_layer(_packed_layer(x, w1, b1, None), w2, b2, a1)
            return jnp.sum(z * jnp.sin(0.3 * z))

        args = (x, w1, b1, a1, w2, b2)
        g1 = jax.grad(loss_st, argnums=tuple(range(6)))(*args)
        g2 = jax.grad(loss_packed, argnums=tuple(range(6)))(*args)
        for got, want, name in zip(g1, g2, ["x", "w1", "b1", "a1", "w2", "b2"]):
            np.testing.assert_allclose(
                got, want, rtol=2e-3, atol=2e-3, err_msg=f"grad {name}"
            )

    def test_wide_channel_grads(self):
        keys = jax.random.split(jax.random.PRNGKey(21), 4)
        t, c = 32, 256
        x = _rand(keys[0], (1, t, 3, 4 * c), 0.5)
        w = _rand(keys[1], (4, 3, 3, c, c), 0.05)
        b1 = _rand(keys[2], (4 * c,), 0.1)
        a1 = _rand(keys[3], (4 * c,), 0.25)

        def loss_st(x, w, b1, a1):
            return jnp.sum(_stacked_layer(_to_stacked(x), w, b1, a1, "fast8") ** 2)

        def loss_packed(x, w, b1, a1):
            return jnp.sum(_packed_layer(x, w, b1, a1) ** 2)

        g1 = jax.grad(loss_st, argnums=(0, 1, 2, 3))(x, w, b1, a1)
        g2 = jax.grad(loss_packed, argnums=(0, 1, 2, 3))(x, w, b1, a1)
        for got, want, name in zip(g1, g2, ["x", "w", "b", "a"]):
            np.testing.assert_allclose(
                got, want, rtol=2e-3, atol=2e-3, err_msg=f"grad {name}"
            )


class TestModelIntegration:
    """The encoder's stacked tower ("stacked8", what "auto" routes fat
    layers to) against the all-packed block tower with shared params."""

    def _build(self, variant, conv_features=(8, 128, 128, 128)):
        from qasr.models.qcnn import QCNNEncoder

        return QCNNEncoder(
            variant=variant,
            conv_features=conv_features,
            dense_features=(16,),
            vocab=12,
            pool_after=1,
            dropout_rate=0.0,
        )

    def test_stacked_tower_matches_block(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 32, 40, 4))
        m_blk = self._build("block")
        p = m_blk.init(jax.random.PRNGKey(1), x, train=False)["params"]
        y_blk = np.asarray(m_blk.apply({"params": p}, x, train=False))
        m_st = self._build("stacked8")
        p_st = m_st.init(jax.random.PRNGKey(1), x, train=False)["params"]
        assert jax.tree_util.tree_map(lambda a: a.shape, p_st) == \
            jax.tree_util.tree_map(lambda a: a.shape, p)
        y_st = np.asarray(m_st.apply({"params": p}, x, train=False))
        np.testing.assert_allclose(y_st, y_blk, rtol=2e-4, atol=2e-4)

    def test_grads_match_block(self):
        x = jax.random.normal(jax.random.PRNGKey(2), (1, 32, 40, 4))
        m_blk, m_st = self._build("block"), self._build("stacked8")
        p = m_blk.init(jax.random.PRNGKey(1), x, train=False)["params"]

        def loss(m):
            return lambda p_: jnp.sum(m.apply({"params": p_}, x, train=False) ** 2)

        g_blk = jax.grad(loss(m_blk))(p)
        g_st = jax.grad(loss(m_st))(p)
        for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(g_blk), jax.tree_util.tree_leaves(g_st)
        ):
            a, b = np.asarray(a), np.asarray(b)
            rms = float(np.sqrt(np.mean((a - b) ** 2))) / max(
                float(np.sqrt(np.mean(a**2))), 1e-6
            )
            assert rms < 1e-4, f"{jax.tree_util.keystr(path)}: rel RMS {rms}"

    def test_thin_layer_after_fat_exits_chain(self):
        """conv_features=(8,128,128,8): the trailing thin layer must leave
        the stacked layout and still match the per-layer routing."""
        x = jax.random.normal(jax.random.PRNGKey(3), (1, 32, 40, 4))
        m_leg = self._build("legacy_auto", (8, 128, 128, 8))
        p = m_leg.init(jax.random.PRNGKey(1), x, train=False)["params"]
        y_leg = np.asarray(m_leg.apply({"params": p}, x, train=False))
        y = np.asarray(
            self._build("stacked8", (8, 128, 128, 8)).apply({"params": p}, x, train=False)
        )
        np.testing.assert_allclose(y, y_leg, rtol=2e-4, atol=2e-4)
