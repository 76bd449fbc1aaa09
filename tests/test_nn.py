"""qasr.nn, the repo's own module system: parameter paths, auto-naming,
random streams, mutable collections, and the stock layers against lax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from qasr import nn


class Pair(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(self.features)(x)
        return nn.Dense(self.features, name="head")(nn.Dense(self.features)(x))


class Dropper(nn.Module):
    rate: float = 0.5

    @nn.compact
    def __call__(self, x, train: bool):
        return nn.Dropout(self.rate, deterministic=not train)(x)


class Counter(nn.Module):
    @nn.compact
    def __call__(self, x):
        n = self.variable("stats", "n", lambda: jnp.zeros((), jnp.int32))
        if not self.is_initializing():
            n.value = n.value + 1
        return x * self.param("scale", nn.initializers.ones, (x.shape[-1],))


class Twins(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(2, name="same")(x) + nn.Dense(2, name="same")(x)


def test_param_paths_and_autonames():
    x = jnp.ones((3, 5))
    params = Pair(4).init(jax.random.PRNGKey(0), x)["params"]
    assert sorted(params) == ["Dense_0", "Dense_1", "head"]
    assert params["Dense_0"]["kernel"].shape == (5, 4)
    assert params["head"]["bias"].shape == (4,)
    # distinct keys per parameter path
    assert not np.allclose(params["Dense_0"]["kernel"][:4], params["Dense_1"]["kernel"])


def test_model_param_tree_names():
    from qasr.configs import get_config
    from qasr.train.state import build_model

    cfg = get_config("tiny_synthetic")
    x = jnp.ones((2, 16, cfg.data.n_mels, 4))
    params = build_model(cfg).init(jax.random.PRNGKey(0), x, train=False)["params"]
    assert set(params) == {
        "qconv_0", "qconv_1", "conv_prelu_0", "conv_prelu_1", "qdense_0",
        "dense_prelu_0", "output",
    }
    assert params["qconv_0"]["kernel"].shape == (4, 3, 3, 1, 8)
    assert params["conv_prelu_1"]["alpha"].shape == (32,)
    assert params["output"]["kernel"].dtype == jnp.float32


def test_init_is_deterministic_and_apply_matches():
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 5))
    m = Pair(4)
    v1, v2 = m.init(jax.random.PRNGKey(0), x), m.init(jax.random.PRNGKey(0), x)
    jax.tree.map(np.testing.assert_array_equal, v1, v2)
    p = v1["params"]
    want = x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
    want = want @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]
    want = want @ p["head"]["kernel"] + p["head"]["bias"]
    np.testing.assert_allclose(m.apply(v1, x), want, rtol=1e-6, atol=1e-6)


def test_apply_under_jit_and_grad():
    x = jnp.ones((3, 5))
    m = Pair(4)
    v = m.init(jax.random.PRNGKey(0), x)
    g = jax.jit(jax.grad(lambda v_: jnp.sum(m.apply(v_, x) ** 2)))(v)
    assert jax.tree.structure(g) == jax.tree.structure(v)


def test_dropout_rng_stream():
    x = jnp.ones((4, 64))
    m = Dropper()
    v = m.init(jax.random.PRNGKey(0), x, train=False)
    assert v == {}
    np.testing.assert_array_equal(m.apply(v, x, train=False), x)
    a = m.apply(v, x, train=True, rngs={"dropout": jax.random.PRNGKey(1)})
    b = m.apply(v, x, train=True, rngs={"dropout": jax.random.PRNGKey(1)})
    c = m.apply(v, x, train=True, rngs={"dropout": jax.random.PRNGKey(2)})
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert set(np.unique(np.asarray(a))) <= {0.0, 2.0}  # inverted scaling
    with pytest.raises(ValueError, match="dropout"):
        m.apply(v, x, train=True)


def test_two_dropouts_draw_different_masks():
    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dropout(0.5)(x), nn.Dropout(0.5)(x)

    x = jnp.ones((8, 64))
    a, b = Two().apply({}, x, rngs={"dropout": jax.random.PRNGKey(0)})
    assert not np.array_equal(a, b)


def test_mutable_collection():
    x = jnp.ones((2, 3))
    m = Counter()
    v = m.init(jax.random.PRNGKey(0), x)
    assert int(v["stats"]["n"]) == 0
    y, upd = m.apply(v, x, mutable=["stats"])
    assert int(upd["stats"]["n"]) == 1 and int(v["stats"]["n"]) == 0
    np.testing.assert_array_equal(y, x)
    with pytest.raises(ValueError, match="immutable"):
        m.apply(v, x)


def test_batch_stats_through_qbatchnorm():
    from qasr.models.layers import QBatchNorm

    x = jax.random.normal(jax.random.PRNGKey(0), (64, 8)) * 3 + 1
    m = QBatchNorm()
    v = m.init(jax.random.PRNGKey(0), x, use_running_average=False)
    assert set(v) == {"params", "batch_stats"}
    _, upd = m.apply(v, x, use_running_average=False, mutable=["batch_stats"])
    assert not np.allclose(upd["batch_stats"]["mean"], v["batch_stats"]["mean"])
    with pytest.raises(ValueError, match="exactly once"):
        m.apply(v, x)


def test_missing_param_and_duplicate_names_raise():
    x = jnp.ones((3, 5))
    with pytest.raises(KeyError, match="Dense_0/kernel"):
        Pair(4).apply({"params": {}}, x)
    with pytest.raises(ValueError, match="duplicate submodule name"):
        Twins().init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="not bound"):
        nn.Dense(3)(x)


def test_conv_and_max_pool_match_lax():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 9, 7, 3))
    m = nn.Conv(5, kernel_size=(3, 3))
    p = m.init(jax.random.PRNGKey(1), x)["params"]
    want = lax.conv_general_dilated(
        x, p["kernel"], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    ) + p["bias"]
    np.testing.assert_allclose(m.apply({"params": p}, x), want, rtol=1e-5, atol=1e-5)
    pooled = nn.max_pool(x, window_shape=(1, 3), strides=(1, 3))
    assert pooled.shape == (2, 9, 2, 3)
    np.testing.assert_array_equal(pooled[:, :, 0], jnp.max(x[:, :, :3], axis=2))


def test_merge_param():
    assert nn.merge_param("a", None, 3) == 3 and nn.merge_param("a", 2, None) == 2
    with pytest.raises(ValueError):
        nn.merge_param("a", 1, 2)
