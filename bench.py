#!/usr/bin/env python
"""qasr headline benchmark — one JSON line for the driver.

Metric: training throughput in audio-seconds/s/chip on the flagship TIMIT
QCNN (BASELINE.json north-star metric). vs_baseline compares against the
*reference's computation strategy* — the equal-feature-map real CNN whose
conv FLOPs equal the 4x-expanded block conv the reference executes every step
(SURVEY.md §3.2, BASELINE.json config 3) — identical harness, same hardware.

The flagship preset is the paper's best TIMIT model — uniform 256 feature
maps over 10 conv layers (QCNN-256; SURVEY.md §2a C7 sweep). At this width
the "auto" routing runs the reduced-product Hamilton schemes (10 and 8 real
convs per quaternion conv instead of the 16 block products of the
reference's 4x-expanded conv).

Timing: each measured unit is ONE jit-compiled loop of n chained train steps
ending in a scalar loss fetched to the host. Step time is the difference
quotient
    dt = (T(n_big) - T(n_small)) / (n_big - n_small)
which cancels the fixed per-call costs (dispatch, the final fetch); arms are
interleaved (ABAB) across repeats and medians taken.

The device kind is printed on a line before the JSON. The roofline share is
taken against `qasr.utils.profiling.DEVICE_PEAKS`; for a device the table
does not know it is null.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _make_batch(b, t, f, vocab, max_l, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "features": rng.randn(b, t, f, 4).astype(np.float32),
        "feature_lengths": np.full((b,), t, np.int32),
        "labels": rng.randint(1, vocab, size=(b, max_l)).astype(np.int32),
        "label_lengths": np.full((b,), max_l, np.int32),
    }


class _Arm:
    """One model config under test: n chained train steps inside one jit.

    The loop bound is a *traced* fori_loop argument so each arm compiles
    exactly once.
    """

    def __init__(self, cfg, batch, lengths=(4, 24)):
        import jax
        import jax.numpy as jnp

        from qasr.train.state import build_model, build_optimizer, create_train_state
        from qasr.train.step import make_loss_fn

        self._jax = jax
        self.lengths = lengths
        model = build_model(cfg)
        tx = build_optimizer(cfg)
        loss_fn = make_loss_fn(cfg, model)
        self.state = create_train_state(cfg, jax.random.PRNGKey(0), batch["features"])
        self.batch = {k: jnp.asarray(v) for k, v in batch.items()}

        def one_step(state, batch):
            rng = jax.random.fold_in(state.dropout_rng, state.step)
            (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params, batch, rng, True
            )
            return state.apply_gradients(grads, tx), loss

        @jax.jit
        def chain(state, batch, n):
            def body(_, carry):
                s, _loss = carry
                return one_step(s, batch)

            _, loss = jax.lax.fori_loop(0, n, body, (state, jnp.float32(0)))
            return loss

        self._chain = chain
        float(chain(self.state, self.batch, 1))  # single compile + warm

    def timed(self, n) -> float:
        t0 = time.perf_counter()
        loss = float(self._chain(self.state, self.batch, n))  # host fetch = sync
        dt = time.perf_counter() - t0
        assert np.isfinite(loss), f"non-finite loss {loss}"
        return dt


def bench_arms(arms: dict, *, repeats=5) -> dict:
    from qasr.utils.profiling import steady_state_times

    return steady_state_times(
        {name: (arm.timed, arm.lengths) for name, arm in arms.items()},
        repeats=repeats,
    )


def main():
    import jax

    from qasr.configs import get_config
    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    b, t, f = 16, 256, 40
    frame_s = 0.010
    base = get_config("timit_qcnn").override(
        **{"train.num_steps": 100, "data.batch_size": b}
    )
    batch = _make_batch(b, t, f, base.model.vocab, 48)

    arms = {
        "qcnn": _Arm(base, batch),
        "real_cnn": _Arm(base.override(**{"model.arch": "real_cnn"}), batch),
    }
    times = bench_arms(arms)

    n_chips = jax.device_count()
    audio_s = b * t * frame_s
    ours = audio_s / times["qcnn"] / n_chips
    baseline = audio_s / times["real_cnn"] / n_chips

    # %-of-roofline (the BASELINE.json kernel metric): conv FLOPs the QCNN
    # step needs, counted at the reference's computation strategy (16 block
    # products == the 4x-expanded real conv, SURVEY.md §3.2), divided by
    # step time and the device's peak. Values toward or above 100% reflect
    # the reduced-product schemes executing 8/16 or 10/16 of those FLOPs.
    from qasr.utils.profiling import device_spec, qconv_flops

    cfg_m = base.model
    f_pooled = f
    conv_flops_expanded = 0
    layer0_flops = 0
    cin = 1
    for i, feats in enumerate(cfg_m.conv_features):
        lf = qconv_flops(b, t, f_pooled, cin, feats)
        conv_flops_expanded += lf
        if i == 0:
            layer0_flops = lf
        if i + 1 == cfg_m.pool_after:
            f_pooled = f_pooled // cfg_m.pool_size
        cin = feats
    # fwd + dx + dW each cost one conv pass, except dx is absent for the
    # input layer (no gradient flows to the features)
    step_flops_expanded = 3 * conv_flops_expanded - layer0_flops
    kind = jax.devices()[0].device_kind
    spec = device_spec(kind)
    pct = None
    if spec is not None:
        peak = spec.peak_bf16_tflops * 1e12
        pct = round(100.0 * step_flops_expanded / times["qcnn"] / peak / n_chips, 1)
    print(f"device: {jax.devices()[0].platform} {kind} x{n_chips}"
          + (f" (peak {spec.peak_bf16_tflops} TFLOP/s bf16: {spec.source})"
             if spec else " (no peak on record: roofline share omitted)"))
    print(
        json.dumps(
            {
                "metric": "train_throughput_timit_qcnn",
                "value": round(ours, 2),
                "unit": "audio-s/s/chip",
                "vs_baseline": round(ours / baseline, 3),
                "pct_of_expanded_conv_roofline": pct,
            }
        )
    )


if __name__ == "__main__":
    main()
