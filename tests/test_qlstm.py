"""QLSTM hybrid tests (BASELINE.json config 4 capability)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr.configs import get_config
from qasr.models.qlstm import (
    QBiLSTM,
    QLSTMEncoder,
    QLSTMLayer,
    qchannel_concat,
    qchannel_split,
)
from qasr.train.state import build_model


class TestQChannelOps:
    def test_split_concat_roundtrip(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 3, 4 * 12))
        parts = qchannel_split(x, 4)
        assert len(parts) == 4 and parts[0].shape == (2, 3, 12)
        back = qchannel_concat(parts)
        np.testing.assert_array_equal(back, x)

    def test_split_layout(self):
        # packed [r0 r1 | i0 i1 | j0 j1 | k0 k1], groups=2 -> part0 = ch0 of
        # each component
        x = jnp.arange(8, dtype=jnp.float32)[None, :]
        p0, p1 = qchannel_split(x, 2)
        np.testing.assert_array_equal(p0[0], [0, 2, 4, 6])
        np.testing.assert_array_equal(p1[0], [1, 3, 5, 7])


class TestQLSTMLayer:
    def test_forward_shape_and_state(self):
        m = QLSTMLayer(hidden=8)
        x = jax.random.normal(jax.random.PRNGKey(1), (2, 10, 4 * 5))
        params = m.init(jax.random.PRNGKey(0), x)
        y = m.apply(params, x)
        assert y.shape == (2, 10, 32)
        assert np.isfinite(np.asarray(y)).all()

    def test_reverse_is_time_mirrored(self):
        xf = jax.random.normal(jax.random.PRNGKey(2), (1, 7, 4 * 3))
        fwd = QLSTMLayer(hidden=4, reverse=False)
        bwd = QLSTMLayer(hidden=4, reverse=True)
        params = fwd.init(jax.random.PRNGKey(0), xf)
        y_f = fwd.apply(params, xf[:, ::-1])
        y_b = bwd.apply(params, xf)
        np.testing.assert_allclose(
            np.asarray(y_f[:, ::-1]), np.asarray(y_b), rtol=1e-5, atol=1e-6
        )

    def test_causality(self):
        # output at t must not depend on inputs after t (forward direction)
        m = QLSTMLayer(hidden=4)
        x = jax.random.normal(jax.random.PRNGKey(3), (1, 8, 4 * 3))
        params = m.init(jax.random.PRNGKey(0), x)
        y1 = m.apply(params, x)
        x2 = x.at[:, 5:].set(99.0)
        y2 = m.apply(params, x2)
        np.testing.assert_allclose(
            np.asarray(y1[:, :5]), np.asarray(y2[:, :5]), rtol=1e-5, atol=1e-6
        )
        assert not np.allclose(np.asarray(y1[:, 5:]), np.asarray(y2[:, 5:]))


class TestQLSTMEncoder:
    def test_full_model_forward(self):
        m = QLSTMEncoder(
            conv_features=(4, 4), dense_features=(8,), lstm_features=8,
            lstm_layers=2, vocab=10,
        )
        x = jax.random.normal(jax.random.PRNGKey(4), (2, 12, 9, 4))
        params = m.init(jax.random.PRNGKey(0), x, train=False)
        y = m.apply(params, x, train=False)
        assert y.shape == (2, 12, 10)

    def test_build_from_preset(self):
        cfg = get_config("librispeech_qlstm").override(
            **{
                "model.conv_features": (4, 4),
                "model.lstm_features": 8,
                "model.lstm_layers": 1,
                "model.dense_features": (8,),
            }
        )
        m = build_model(cfg)
        x = jnp.ones((1, 10, 9, 4))
        params = m.init(jax.random.PRNGKey(0), x, train=False)
        y = m.apply(params, x, train=False)
        assert y.shape == (1, 10, cfg.model.vocab)

    def test_trains_on_synthetic(self):
        # one gradient step decreases loss on a small batch
        import optax
        from qasr.ops.ctc import ctc_loss

        m = QLSTMEncoder(
            conv_features=(4,), dense_features=(8,), lstm_features=8,
            lstm_layers=1, vocab=8, dropout_rate=0.0,
        )
        x = jax.random.normal(jax.random.PRNGKey(5), (4, 16, 9, 4))
        labels = jax.random.randint(jax.random.PRNGKey(6), (4, 4), 1, 8)
        params = m.init(jax.random.PRNGKey(0), x, train=False)["params"]
        tx = optax.adam(1e-2)
        opt = tx.init(params)

        def loss_fn(p):
            lg = m.apply({"params": p}, x, train=False)
            return ctc_loss(lg, labels, jnp.full((4,), 16), jnp.full((4,), 4)).mean()

        @jax.jit
        def step(params, opt):
            l, g = jax.value_and_grad(loss_fn)(params)
            upd, opt = tx.update(g, opt)
            return optax.apply_updates(params, upd), opt, l

        l0 = None
        for _ in range(10):
            params, opt, l = step(params, opt)
            l0 = l if l0 is None else l0
        l_end = loss_fn(params)
        assert float(l_end) < float(l0), (float(l0), float(l_end))


class TestLengthMasking:
    def test_bilstm_padded_matches_truncated(self):
        """With lengths passed, a padded utterance's valid frames must equal
        running the same utterance unpadded — i.e. the backward direction
        never sees pad frames (and the forward state is never polluted)."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from qasr.models.qlstm import QBiLSTM

        b, t_full, t_valid, h = 2, 12, 7, 3
        x_full = jax.random.normal(jax.random.PRNGKey(0), (b, t_full, 4 * 5))
        x_full = x_full.at[:, t_valid:].set(0.0)
        lengths = jnp.full((b,), t_valid, jnp.int32)

        layer = QBiLSTM(hidden=h)
        params = layer.init(jax.random.PRNGKey(1), x_full, lengths)
        y_pad = layer.apply(params, x_full, lengths)
        y_cut = layer.apply(params, x_full[:, :t_valid], jnp.full((b,), t_valid))
        np.testing.assert_allclose(
            np.asarray(y_pad[:, :t_valid]), np.asarray(y_cut), rtol=2e-5, atol=2e-5
        )

    def test_unidirectional_masking_freezes_state(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from qasr.models.qlstm import QLSTMLayer

        b, t_full, t_valid, h = 2, 10, 6, 3
        x = jax.random.normal(jax.random.PRNGKey(0), (b, t_full, 4 * 4))
        lengths = jnp.full((b,), t_valid, jnp.int32)
        layer = QLSTMLayer(hidden=h)
        params = layer.init(jax.random.PRNGKey(1), x, lengths)
        y = layer.apply(params, x, lengths)
        # frozen state: every frame past length-1 repeats the last valid h
        for tt in range(t_valid, t_full):
            np.testing.assert_allclose(
                np.asarray(y[:, tt]), np.asarray(y[:, t_valid - 1]), rtol=1e-6
            )


class TestRecurrentFast8:
    """The rank-8 in-scan recurrent path (the measured default) must match
    the block-expanded recurrence bit-for-tolerance with shared params."""

    def test_bilstm_recurrent_variants_match(self):
        from qasr.models.qlstm import QBiLSTM

        x = jax.random.normal(jax.random.PRNGKey(0), (2, 12, 4 * 5))
        m_blk = QBiLSTM(hidden=6, recurrent="block")
        p = m_blk.init(jax.random.PRNGKey(1), x)["params"]
        y_blk = m_blk.apply({"params": p}, x)
        m_f8 = QBiLSTM(hidden=6, recurrent="fast8")
        y_f8 = m_f8.apply({"params": p}, x)
        np.testing.assert_allclose(
            np.asarray(y_f8), np.asarray(y_blk), rtol=2e-4, atol=2e-4
        )

    def test_grads_match(self):
        from qasr.models.qlstm import QBiLSTM

        x = jax.random.normal(jax.random.PRNGKey(2), (1, 8, 4 * 3))
        m_blk = QBiLSTM(hidden=4, recurrent="block")
        p = m_blk.init(jax.random.PRNGKey(1), x)["params"]
        m_f8 = QBiLSTM(hidden=4, recurrent="fast8")

        def loss(m):
            return lambda p_: jnp.sum(m.apply({"params": p_}, x) ** 2)

        g1 = jax.tree_util.tree_leaves(jax.grad(loss(m_blk))(p))
        g2 = jax.tree_util.tree_leaves(jax.grad(loss(m_f8))(p))
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-3
            )

    def test_real_lstm_encoder_builds_and_runs(self):
        from qasr.configs import get_config
        from qasr.train.state import build_model

        cfg = get_config("librispeech_qlstm").override(
            **{
                "model.arch": "real_lstm",
                "model.conv_features": "8,8",
                "model.dense_features": "8",
                "model.lstm_features": 4,
                "model.lstm_layers": 1,
                "model.compute_dtype": "float32",
            }
        )
        m = build_model(cfg)
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 16, 40, 4))
        p = m.init(jax.random.PRNGKey(1), x, train=False)["params"]
        y = m.apply({"params": p}, x, train=False)
        assert y.shape == (2, 16, cfg.model.vocab)
        assert np.isfinite(np.asarray(y)).all()

    def test_unidirectional_recurrent_variants_match(self):
        """QLSTMLayer honors the recurrent knob too (the encoder passes it
        for bidirectional=False configs)."""
        from qasr.models.qlstm import QLSTMLayer

        x = jax.random.normal(jax.random.PRNGKey(3), (2, 10, 4 * 3))
        m_blk = QLSTMLayer(hidden=5, recurrent="block")
        p = m_blk.init(jax.random.PRNGKey(1), x)["params"]
        y_blk = m_blk.apply({"params": p}, x)
        m_f8 = QLSTMLayer(hidden=5, recurrent="fast8")
        y_f8 = m_f8.apply({"params": p}, x)
        np.testing.assert_allclose(
            np.asarray(y_f8), np.asarray(y_blk), rtol=2e-4, atol=2e-4
        )

    def test_pallas8_op_variant_builds(self):
        # the scan-resident kernel this variant selected is gone: the name
        # is now rejected like any other unknown variant
        from qasr.configs import get_config
        from qasr.train.state import build_model

        cfg = get_config("librispeech_qlstm").override(
            **{"model.op_variant": "pallas8"}
        )
        with pytest.raises(ValueError, match="not valid for arch='qlstm'"):
            build_model(cfg)

    def test_auto_routes_rank8_recurrence(self):
        m = build_model(get_config("librispeech_qlstm"))
        assert (m.recurrent, m.input_proj) == ("fast8", "auto")

    def test_invalid_qlstm_op_variant_rejected(self):
        from qasr.configs import get_config
        from qasr.train.state import build_model

        cfg = get_config("librispeech_qlstm").override(
            **{"model.op_variant": "fast10"}
        )
        import pytest as _pytest

        with _pytest.raises(ValueError, match="not valid for arch='qlstm'"):
            build_model(cfg)


class TestPallasScan:
    """The fused-direction scan (rank-8 and block recurrences) against
    `qbilstm_reference`, the step-by-step float32 twin: forward and every
    param grad, with odd T, tiny shapes and per-utterance lengths."""

    def _pair(self, hidden=8, recurrent="fast8"):
        from qasr.models.qlstm import qbilstm_reference

        m = QBiLSTM(hidden=hidden, recurrent=recurrent)
        return m, qbilstm_reference

    @pytest.mark.parametrize(
        "b,t",
        [
            (2, 16),
            (3, 17),   # odd T, ragged lengths
            (1, 5),    # tiny
        ],
    )
    def test_forward_parity(self, b, t):
        m, ref = self._pair()
        x = jax.random.normal(jax.random.PRNGKey(0), (b, t, 4 * 8)) * 0.5
        lengths = jnp.asarray((np.arange(b) % t + max(1, t - b)) % t + 1)
        p = m.init(jax.random.PRNGKey(1), x, lengths)
        np.testing.assert_allclose(
            np.asarray(m.apply(p, x, lengths)),
            np.asarray(ref(p["params"], x, lengths)),
            rtol=2e-5, atol=2e-5,
        )

    def test_forward_parity_no_lengths(self):
        m, ref = self._pair()
        x = jax.random.normal(jax.random.PRNGKey(2), (2, 12, 4 * 8)) * 0.5
        p = m.init(jax.random.PRNGKey(1), x)
        np.testing.assert_allclose(
            np.asarray(m.apply(p, x)), np.asarray(ref(p["params"], x)),
            rtol=2e-5, atol=2e-5,
        )

    def test_grads_parity(self):
        m, ref = self._pair()
        b, t = 3, 14
        x = jax.random.normal(jax.random.PRNGKey(3), (b, t, 4 * 8)) * 0.5
        lengths = jnp.asarray([14, 9, 4], jnp.int32)
        p = m.init(jax.random.PRNGKey(1), x, lengths)
        g = jax.grad(lambda p_: jnp.sum(m.apply(p_, x, lengths) ** 2))(p)
        g_ref = jax.grad(
            lambda p_: jnp.sum(ref(p_["params"], x, lengths) ** 2)
        )(p)
        for (kp, a), (_, b_) in zip(
            jax.tree_util.tree_leaves_with_path(g_ref),
            jax.tree_util.tree_leaves_with_path(g),
        ):
            np.testing.assert_allclose(
                np.asarray(b_), np.asarray(a), rtol=2e-4, atol=2e-4,
                err_msg=f"grad mismatch at {jax.tree_util.keystr(kp)}",
            )

    def test_any_hidden_size(self):
        # the XLA scan has no alignment contract: H=6 with the block
        # recurrence, against the same reference
        m, ref = self._pair(hidden=6, recurrent="block")
        x = jax.random.normal(jax.random.PRNGKey(4), (2, 9, 4 * 5)) * 0.5
        p = m.init(jax.random.PRNGKey(1), x)
        np.testing.assert_allclose(
            np.asarray(m.apply(p, x)), np.asarray(ref(p["params"], x)),
            rtol=2e-5, atol=2e-5,
        )

    @pytest.mark.parametrize("input_proj", ["block", "fast8", "auto"])
    def test_input_projection_paths(self, input_proj):
        m = QBiLSTM(hidden=8, recurrent="fast8", input_proj=input_proj)
        _, ref = self._pair()
        x = jax.random.normal(jax.random.PRNGKey(5), (2, 12, 4 * 8)) * 0.5
        lengths = jnp.asarray([12, 7], jnp.int32)
        p = m.init(jax.random.PRNGKey(1), x, lengths)
        np.testing.assert_allclose(
            np.asarray(m.apply(p, x, lengths)),
            np.asarray(ref(p["params"], x, lengths)),
            rtol=2e-5, atol=2e-5,
        )


class TestUnidirectionalReference:
    """QLSTMLayer runs the same one-scan recurrence as QBiLSTM with a
    direction axis of 1: each direction against its half of the float32
    step-by-step reference, with ragged lengths."""

    @pytest.mark.parametrize("recurrent", ["fast8", "block"])
    @pytest.mark.parametrize("reverse", [False, True])
    def test_matches_reference_direction(self, reverse, recurrent):
        from qasr.models.qlstm import qbilstm_reference

        b, t, h = 3, 11, 6
        x = jax.random.normal(jax.random.PRNGKey(7), (b, t, 4 * 5)) * 0.5
        lengths = jnp.asarray([11, 6, 2], jnp.int32)
        m = QLSTMLayer(hidden=h, reverse=reverse, recurrent=recurrent)
        p = m.init(jax.random.PRNGKey(1), x, lengths)["params"]
        ref = qbilstm_reference({"fwd_cell": p["cell"], "bwd_cell": p["cell"]}, x, lengths)
        want = qchannel_split(ref, 2)[1 if reverse else 0]
        np.testing.assert_allclose(
            np.asarray(m.apply({"params": p}, x, lengths)), np.asarray(want),
            rtol=2e-5, atol=2e-5,
        )


class TestSharedConvTower:
    """Round 5: QLSTMEncoder routes its conv front-end through the shared
    quaternion_conv_tower, so fat layers (>=128 q-channels) take the
    stacked rank-8 path. Params must stay byte-identical across routings
    (checkpoint compatibility) and outputs must match."""

    def _enc(self, conv_variant):
        from qasr.models.qlstm import QLSTMEncoder

        return QLSTMEncoder(
            conv_features=(8, 128, 128),
            dense_features=(8,),
            lstm_features=8,
            lstm_layers=1,
            vocab=10,
            dropout_rate=0.0,
            conv_variant=conv_variant,
        )

    def test_routing_parity_and_checkpoint_compat(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (1, 10, 9, 4)) * 0.5
        enc_packed = self._enc("block")     # whole tower per-layer packed
        enc_auto = self._enc("auto")        # fat 128->128 layer -> stacked8
        p = enc_packed.init(jax.random.PRNGKey(1), x, train=False)
        p2 = enc_auto.init(jax.random.PRNGKey(1), x, train=False)
        # identical param trees (names AND shapes) across routings
        s1 = jax.tree.map(lambda a: a.shape, p)
        s2 = jax.tree.map(lambda a: a.shape, p2)
        assert s1 == s2
        y1 = enc_packed.apply(p, x, train=False)
        y2 = enc_auto.apply(p, x, train=False)
        np.testing.assert_allclose(
            np.asarray(y2), np.asarray(y1), rtol=2e-3, atol=2e-3
        )


class TestPallasScanSharded:
    """The fused scan under a DP-sharded jit on the 8-device CPU mesh
    (GSPMD partitions the lax.scan on batch; weights and time replicated)
    must match the unsharded float32 reference — fwd and every grad."""

    def test_dp_sharded_parity(self):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from qasr.models.qlstm import qbilstm_reference

        mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("data",))
        b, t, h = 8, 12, 16
        x = jax.random.normal(jax.random.PRNGKey(0), (b, t, 4 * 2 * h)) * 0.3
        lengths = jnp.asarray([12, 9, 7, 12, 3, 12, 5, 11], jnp.int32)
        m = QBiLSTM(h, recurrent="fast8")
        p = m.init(jax.random.PRNGKey(1), x, lengths)
        rep, dat = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
        xs, ls, ps = (
            jax.device_put(x, dat), jax.device_put(lengths, dat),
            jax.device_put(p, rep),
        )
        y = jax.jit(
            lambda pp, xx, ll: m.apply(pp, xx, ll),
            in_shardings=(rep, dat, dat),
        )(ps, xs, ls)
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(qbilstm_reference(p["params"], x, lengths)),
            rtol=2e-5, atol=2e-5,
        )
        g = jax.jit(
            jax.grad(lambda pp: jnp.sum(m.apply(pp, xs, ls) ** 2)),
            in_shardings=(rep,),
        )(ps)
        g_ref = jax.grad(
            lambda pp: jnp.sum(qbilstm_reference(pp["params"], x, lengths) ** 2)
        )(p)
        for (kp, a), (_, b_) in zip(
            jax.tree_util.tree_leaves_with_path(g_ref),
            jax.tree_util.tree_leaves_with_path(g),
        ):
            np.testing.assert_allclose(
                np.asarray(b_), np.asarray(a), rtol=2e-4, atol=2e-4,
                err_msg=f"sharded grad mismatch at {jax.tree_util.keystr(kp)}",
            )
