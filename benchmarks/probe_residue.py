#!/usr/bin/env python
"""Itemize the flagship (QCNN-256, B16 T256) train step's non-conv residue:
the time between the conv tower and the full step.

Measures independent component arms with the difference-quotient harness:
the full step, a dropout-free step, an Adam-update-only chain at flagship
parameter shapes, a CTC-only chain at flagship logit shapes, and the dense
stack op-level. Prints the breakdown table.

  python benchmarks/probe_residue.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import _Arm, _make_batch
    from qasr.configs import get_config
    from qasr.utils.profiling import steady_state_times

    b, t, f = 16, 256, 40
    base = get_config("timit_qcnn").override(**{"data.batch_size": b})
    batch = _make_batch(b, t, f, base.model.vocab, 48)

    arms = {
        "full": (lambda: _Arm(base, batch)),
        "no_dropout": (
            lambda: _Arm(base.override(**{"model.dropout_rate": 0.0}), batch)
        ),
    }
    built = {}
    for name, mk in arms.items():
        print(f"building {name} ...", file=sys.stderr)
        arm = mk()
        built[name] = (arm.timed, arm.lengths)

    # Adam-only: chained apply_gradients on flagship-shaped state with
    # fixed grads (isolates optimizer elementwise + param traffic)
    from qasr.train.state import build_optimizer, create_train_state

    state = create_train_state(
        base, jax.random.PRNGKey(0), jnp.asarray(batch["features"])
    )
    tx = build_optimizer(base)
    fake_grads = jax.tree.map(lambda a: jnp.ones_like(a) * 1e-6, state.params)

    @jax.jit
    def adam_chain(s, n):
        def body(_, s_):
            return s_.apply_gradients(fake_grads, tx)

        s = jax.lax.fori_loop(0, n, body, s)
        return s.step

    int(adam_chain(state, 1))

    def adam_run(n):
        t0 = time.perf_counter()
        int(adam_chain(state, n))
        return time.perf_counter() - t0

    built["adam_only"] = (adam_run, (4, 24))

    # CTC-only: loss fwd+bwd at flagship logit shapes
    from qasr.ops.ctc import ctc_loss

    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(b, t, base.model.vocab).astype(np.float32))
    labels = jnp.asarray(batch["labels"])
    tl = jnp.asarray(batch["feature_lengths"])
    ll = jnp.asarray(batch["label_lengths"])

    gfn = jax.value_and_grad(
        lambda lg: ctc_loss(lg, labels, tl, ll).mean()
    )

    @jax.jit
    def ctc_chain(lg, n):
        def body(_, carry):
            lg_, acc = carry
            v, g = gfn(lg_)
            return lg_ - 1e-9 * g, acc + v

        _, acc = jax.lax.fori_loop(0, n, body, (lg, jnp.float32(0)))
        return acc

    float(ctc_chain(logits, 1))

    def ctc_run(n):
        t0 = time.perf_counter()
        float(ctc_chain(logits, n))
        return time.perf_counter() - t0

    built["ctc_only"] = (ctc_run, (4, 24))

    times = steady_state_times(built, repeats=3)
    full = times["full"]
    print(f"\nflagship residue breakdown (B{b} T{t}, ms/step):")
    print(f"  full step:           {full*1e3:7.2f}")
    print(f"  dropout (A/B):       {(full-times['no_dropout'])*1e3:7.2f}")
    print(f"  adam update:         {times['adam_only']*1e3:7.2f}")
    print(f"  ctc loss fwd+bwd:    {times['ctc_only']*1e3:7.2f}")


if __name__ == "__main__":
    main()
