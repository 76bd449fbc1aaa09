"""Model construction / forward tests (SURVEY.md §4; reference C7 parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr.configs import get_config
from qasr.models import QCNNEncoder, RealCNNEncoder, QConv, QDense, PReLU, flatten_quaternion
from qasr.train.state import build_model, param_count


class TestLayers:
    def test_qconv_param_shape_and_forward(self):
        m = QConv(features=8, kernel_size=(3, 3))
        x = jnp.ones((2, 10, 6, 4 * 3))
        params = m.init(jax.random.PRNGKey(0), x)
        assert params["params"]["kernel"].shape == (4, 3, 3, 3, 8)
        y = m.apply(params, x)
        assert y.shape == (2, 10, 6, 32)

    def test_qdense(self):
        m = QDense(features=5)
        x = jnp.ones((7, 4 * 3))
        params = m.init(jax.random.PRNGKey(0), x)
        y = m.apply(params, x)
        assert y.shape == (7, 20)

    def test_prelu(self):
        m = PReLU()
        x = jnp.array([[-2.0, 3.0]])
        params = m.init(jax.random.PRNGKey(0), x)
        y = m.apply(params, x)
        np.testing.assert_allclose(y, [[-0.5, 3.0]])

    def test_flatten_quaternion_layout(self):
        # [B, T, F=2, 4C with C=3] -> components must stay contiguous blocks
        b, t, f, c = 1, 1, 2, 3
        x = jnp.arange(b * t * f * 4 * c, dtype=jnp.float32).reshape(b, t, f, 4 * c)
        out = flatten_quaternion(x)
        assert out.shape == (b, t, 4 * f * c)
        # r-block of output = concat of r-blocks over F
        want_r = jnp.concatenate([x[0, 0, 0, :c], x[0, 0, 1, :c]])
        np.testing.assert_array_equal(out[0, 0, : f * c], want_r)
        want_j = jnp.concatenate([x[0, 0, 0, 2 * c : 3 * c], x[0, 0, 1, 2 * c : 3 * c]])
        np.testing.assert_array_equal(out[0, 0, 2 * f * c : 3 * f * c], want_j)


class TestQCNN:
    def test_forward_shapes(self):
        m = QCNNEncoder(conv_features=(8, 8), dense_features=(16,), vocab=12)
        x = jnp.ones((2, 20, 9, 4))
        params = m.init(jax.random.PRNGKey(0), x, train=False)
        y = m.apply(params, x, train=False)
        assert y.shape == (2, 20, 12)  # time preserved for CTC
        assert y.dtype == jnp.float32

    def test_param_reduction_vs_real(self):
        # Hamilton weight sharing: quaternion conv kernel has 1/4 the params of
        # the equal-feature-map real conv (paper abstract: 3-4x fewer overall).
        q = QCNNEncoder(conv_features=(16, 16), dense_features=(32,), vocab=12)
        r = RealCNNEncoder(conv_features=(16, 16), dense_features=(32,), vocab=12)
        x = jnp.ones((1, 12, 9, 4))
        qp = q.init(jax.random.PRNGKey(0), x, train=False)["params"]
        rp = r.init(jax.random.PRNGKey(0), x, train=False)["params"]
        qk = qp["qconv_1"]["kernel"].size
        rk = rp["conv_1"]["kernel"].size
        assert rk == 4 * qk
        assert param_count(rp) > 2.5 * param_count(qp)

    def test_dropout_only_in_train(self):
        m = QCNNEncoder(conv_features=(4,), dense_features=(8,), vocab=5,
                        dropout_rate=0.5)
        x = jnp.ones((1, 8, 6, 4))
        params = m.init(jax.random.PRNGKey(0), x, train=False)
        y1 = m.apply(params, x, train=False)
        y2 = m.apply(params, x, train=False)
        np.testing.assert_array_equal(y1, y2)
        y3 = m.apply(params, x, train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        assert not np.allclose(y1, y3)

    def test_bf16_compute(self):
        m = QCNNEncoder(conv_features=(4,), dense_features=(8,), vocab=5,
                        dtype=jnp.bfloat16)
        x = jnp.ones((1, 8, 6, 4))
        params = m.init(jax.random.PRNGKey(0), x, train=False)
        # params stay f32, logits come back f32
        assert params["params"]["qconv_0"]["kernel"].dtype == jnp.float32
        y = m.apply(params, x, train=False)
        assert y.dtype == jnp.float32


class TestConfigs:
    @pytest.mark.parametrize("name", ["tiny_synthetic", "timit_qcnn", "timit_real_cnn"])
    def test_build_model_from_preset(self, name):
        cfg = get_config(name)
        m = build_model(cfg)
        assert m is not None

    def test_json_roundtrip(self):
        from qasr.configs import Config

        cfg = get_config("timit_qcnn")
        cfg2 = Config.from_json(cfg.to_json())
        assert cfg2 == cfg

    def test_override(self):
        cfg = get_config("tiny_synthetic").override(**{"train.num_steps": 5})
        assert cfg.train.num_steps == 5
        cfg = cfg.override(**{"model.compute_dtype": "bfloat16"})
        assert cfg.model.compute_dtype == "bfloat16"

    def test_beam_prune_scoped_to_timit_presets(self):
        # round-4 verdict: pruning is a TIMIT protocol setting, not a global
        # default — a fresh non-TIMIT config must decode unpruned
        from qasr.configs import Config

        assert Config().decode.beam_prune_logp is None
        assert get_config("tiny_synthetic").decode.beam_prune_logp is None
        assert get_config("librispeech_qlstm").decode.beam_prune_logp is None
        assert get_config("timit_qcnn").decode.beam_prune_logp == -20.0
        assert get_config("timit_qcnn_fm64").decode.beam_prune_logp == -20.0

    def test_optional_float_cli_coercion(self):
        cfg = get_config("timit_qcnn").override(
            **{"decode.beam_prune_logp": "none"}
        )
        assert cfg.decode.beam_prune_logp is None
        cfg = cfg.override(**{"decode.beam_prune_logp": "-12.5"})
        assert cfg.decode.beam_prune_logp == -12.5
        # JSON round-trip preserves None
        from qasr.configs import Config

        cfg2 = Config.from_json(
            cfg.override(**{"decode.beam_prune_logp": "null"}).to_json()
        )
        assert cfg2.decode.beam_prune_logp is None

    def test_override_tuple_coercion(self):
        # CLI strings for tuple-typed fields, including the single-element
        # case that the old comma test left as a bare string
        cfg = get_config("tiny_synthetic").override(**{
            "model.conv_features": "128,128",
            "model.dense_features": "64",
            "data.bucket_sizes": "32",
        })
        assert cfg.model.conv_features == (128, 128)
        assert cfg.model.dense_features == (64,)
        assert cfg.data.bucket_sizes == (32,)


class TestQBatchNorm:
    def test_whitens_to_identity_covariance(self):
        from qasr.models.layers import QBatchNorm
        import jax.numpy as jnp

        rng = np.random.RandomState(0)
        # correlated but FULL-RANK components: random 4x4 mixing per channel
        src = rng.randn(4096, 4, 3).astype(np.float32)
        mix = rng.randn(3, 4, 4).astype(np.float32) + 2 * np.eye(4)[None]
        x = (np.einsum("nac,cba->nbc", src, mix) + rng.randn(3, 4)[None].transpose(0, 2, 1)).reshape(4096, 12)
        m = QBatchNorm()
        vars_ = m.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
        y, _ = m.apply(
            vars_, jnp.asarray(x), use_running_average=False,
            mutable=["batch_stats"],
        )
        ys = np.asarray(y).reshape(-1, 4, 3)
        for c in range(3):
            comp = ys[:, :, c]
            cov = np.cov(comp.T)
            # gamma=0.5*I on whitened unit components -> cov = 0.25 I
            np.testing.assert_allclose(cov, 0.25 * np.eye(4), atol=0.02)
            np.testing.assert_allclose(comp.mean(axis=0), 0.0, atol=0.02)

    def test_running_stats_update_and_inference(self):
        from qasr.models.layers import QBatchNorm
        import jax.numpy as jnp

        x = jnp.asarray(np.random.RandomState(1).randn(512, 8).astype(np.float32) * 3 + 1)
        m = QBatchNorm(momentum=0.0)  # adopt batch stats immediately
        vars_ = m.init(jax.random.PRNGKey(0), x, use_running_average=False)
        y, updated = m.apply(vars_, x, use_running_average=False, mutable=["batch_stats"])
        vars2 = {"params": vars_["params"], **updated}
        y_inf = m.apply(vars2, x, use_running_average=True)
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_inf), atol=1e-3)

    def test_grads_flow(self):
        from qasr.models.layers import QBatchNorm
        import jax.numpy as jnp

        x = jnp.asarray(np.random.RandomState(2).randn(64, 8).astype(np.float32))
        m = QBatchNorm()
        vars_ = m.init(jax.random.PRNGKey(0), x, use_running_average=False)

        def loss(p):
            y, _ = m.apply(
                {"params": p, "batch_stats": vars_["batch_stats"]}, x,
                use_running_average=False, mutable=["batch_stats"],
            )
            return jnp.sum(y**2)

        g = jax.grad(loss)(vars_["params"])
        assert np.isfinite(np.asarray(g["gamma"])).all()
        assert np.isfinite(np.asarray(g["beta"])).all()


class TestStackedVariants:
    """The stacked F-major conv-chain variants must be
    drop-in: same param tree as the legacy routing (checkpoint-compatible)
    and the same outputs for shared params."""

    def _build(self, variant):
        from qasr.models.qcnn import QCNNEncoder

        return QCNNEncoder(
            variant=variant,
            conv_features=(8, 128, 128),
            dense_features=(16,),
            vocab=12,
            pool_after=1,
        )

    def test_variants_match_legacy_with_shared_params(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 32, 40, 4))
        m_leg = self._build("legacy_auto")
        p = m_leg.init(jax.random.PRNGKey(1), x, train=False)["params"]
        y_leg = m_leg.apply({"params": p}, x, train=False)
        for variant in (
            "auto", "stacked", "stacked8", "stacked8g", "block", "fast10"
        ):
            m = self._build(variant)
            y = m.apply({"params": p}, x, train=False)
            np.testing.assert_allclose(
                np.asarray(y), np.asarray(y_leg), atol=2e-4, rtol=2e-4,
                err_msg=variant,
            )

    def test_param_trees_identical(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (1, 16, 40, 4))
        trees = {}
        for variant in ("legacy_auto", "stacked", "stacked8g"):
            p = self._build(variant).init(jax.random.PRNGKey(1), x, train=False)[
                "params"
            ]
            trees[variant] = jax.tree_util.tree_map(lambda a: a.shape, p)
        assert trees["legacy_auto"] == trees["stacked"] == trees["stacked8g"]

    def test_stacked_grads_flow(self):
        x = jax.random.normal(jax.random.PRNGKey(2), (2, 16, 40, 4))
        m = self._build("stacked8")
        p = m.init(jax.random.PRNGKey(1), x, train=False)["params"]

        def loss(p):
            return jnp.sum(m.apply({"params": p}, x, train=False) ** 2)

        g = jax.grad(loss)(p)
        norms = [float(jnp.linalg.norm(v)) for v in jax.tree_util.tree_leaves(g)]
        assert all(np.isfinite(n) for n in norms)
        # every conv layer receives gradient
        assert float(jnp.linalg.norm(g["qconv_1"]["kernel"])) > 0
        assert float(jnp.linalg.norm(g["qconv_2"]["kernel"])) > 0


class TestStackedEntryDense:
    """dense_variant="fast8_stacked": the first dense consumes the stacked
    conv output directly. Same params, same numbers as the packed path."""

    def test_op_matches_packed_dense(self):
        from qasr.ops.qlinalg import qdense, qdense_fast8_from_stacked

        kx, kw = jax.random.split(jax.random.PRNGKey(0))
        b, f, t, c, n = 2, 3, 5, 7, 6
        x_st = jax.random.normal(kx, (b, 4, f, t, c))
        w = jax.random.normal(kw, (4, f * c, n))
        got = qdense_fast8_from_stacked(x_st, w)
        # packed reference: the model's fused exit transpose + block dense
        x_packed = x_st.transpose(0, 3, 1, 2, 4).reshape(b, t, 4 * f * c)
        want = qdense(x_packed, w)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-4
        )

    def test_model_matches_default_with_shared_params(self):
        from qasr.models.qcnn import QCNNEncoder

        def build(dense_variant):
            return QCNNEncoder(
                variant="stacked8",
                conv_features=(8, 128, 128),
                dense_features=(16, 16),
                vocab=12,
                pool_after=1,
                dense_variant=dense_variant,
            )

        x = jax.random.normal(jax.random.PRNGKey(0), (2, 32, 40, 4))
        m0 = build("auto")
        p = m0.init(jax.random.PRNGKey(1), x, train=False)["params"]
        y0 = np.asarray(m0.apply({"params": p}, x, train=False))
        m1 = build("fast8_stacked")
        p1 = m1.init(jax.random.PRNGKey(1), x, train=False)["params"]
        assert jax.tree_util.tree_map(lambda a: a.shape, p1) == \
            jax.tree_util.tree_map(lambda a: a.shape, p)
        y1 = np.asarray(m1.apply({"params": p}, x, train=False))
        np.testing.assert_allclose(y1, y0, rtol=2e-4, atol=2e-4)

    def test_grads_flow_through_stacked_entry(self):
        from qasr.models.qcnn import QCNNEncoder

        m = QCNNEncoder(
            variant="stacked8",
            conv_features=(8, 128),
            dense_features=(16,),
            vocab=12,
            pool_after=1,
            dense_variant="fast8_stacked",
        )
        x = jax.random.normal(jax.random.PRNGKey(2), (1, 16, 40, 4))
        p = m.init(jax.random.PRNGKey(1), x, train=False)["params"]
        g = jax.grad(
            lambda p_: float(0) + jnp.sum(
                m.apply({"params": p_}, x, train=False) ** 2
            )
        )(p)
        for leaf in jax.tree_util.tree_leaves(g):
            assert np.isfinite(np.asarray(leaf)).all()
        assert float(jnp.linalg.norm(g["qdense_0"]["kernel"])) > 0
