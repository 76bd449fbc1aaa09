#!/usr/bin/env python
"""One-command TIMIT acceptance protocol (round-5 verdict task: the
BASELINE north-star PER number should be one command away the moment a
real corpus appears).

Runs the full reference protocol end-to-end:

  1. train the flagship QCNN (or restore an existing checkpoint run),
  2. select the best dev-PER checkpoint (`best.json` pointer),
  3. decode dev AND core-test with the reference decode protocol
     (prefix beam search, W=100, -20 nat emission pruning, on device),
  4. apply the Lee-Hon 61->39 scoring fold and report PER,
  5. print ONE machine-readable JSON line.

Against a real TIMIT directory:

  python tools/run_timit_protocol.py --data-dir /path/to/TIMIT \
      --ckpt checkpoints/timit_protocol

Against the mini-TIMIT fixture (--make-mini generates it; see
docs/end_to_end.md):

  python tools/run_timit_protocol.py --make-mini \
      --set train.num_steps=2000 --preset timit_qcnn_fm32
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="timit_qcnn",
                    help="timit_qcnn = the paper's best model (QCNN-256)")
    ap.add_argument("--data-dir", default=None, help="TIMIT root")
    ap.add_argument("--ckpt", default="checkpoints/timit_protocol")
    ap.add_argument("--make-mini", action="store_true",
                    help="no corpus: generate the mini-TIMIT fixture")
    ap.add_argument("--set", action="append", nargs="+", default=[],
                    metavar="key.path=value")
    ap.add_argument("--skip-train", action="store_true",
                    help="decode-only from the existing checkpoint")
    args = ap.parse_args()

    data_dir = args.data_dir
    if args.make_mini:
        data_dir = data_dir or "data/mini_timit_protocol"
        if not os.path.isdir(os.path.join(data_dir, "train")):
            subprocess.run(
                [
                    sys.executable,
                    os.path.join(os.path.dirname(__file__), "make_mini_timit.py"),
                    "--out", data_dir,
                    "--train-speakers", "16", "--utts-per-speaker", "10",
                ],
                check=True,
            )
    if not data_dir:
        raise SystemExit("need --data-dir (or --make-mini for the fixture)")

    import jax

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from qasr.configs import get_config

    overrides = {
        "data.data_dir": data_dir,
        "train.checkpoint_dir": args.ckpt,
    }
    for kv in (x for group in args.set for x in group):
        k, v = kv.split("=", 1)
        overrides[k] = v
    cfg = get_config(args.preset).override(**overrides)

    # 1. train or restore -------------------------------------------------
    from qasr.train import build_dataset, evaluate, train
    from qasr.train.checkpoint import CheckpointManager
    from qasr.train.state import create_train_state

    probe = CheckpointManager(cfg, write_config=False)
    latest = probe.latest_step()
    trained_here = False
    if args.skip_train:
        if latest is None:
            raise SystemExit(f"--skip-train but no checkpoint in {args.ckpt}")
    elif latest is not None and latest >= cfg.train.num_steps:
        print(f"[protocol] checkpoint at step {latest} covers "
              f"num_steps={cfg.train.num_steps}; skipping training",
              file=sys.stderr)
    else:
        print(f"[protocol] training {args.preset} -> {args.ckpt}",
              file=sys.stderr)
        train(cfg, resume=latest is not None)
        trained_here = True

    # 2. best-dev-PER model selection ------------------------------------
    ckpt = CheckpointManager(cfg, write_config=False)
    best = ckpt.best_step()
    step = best if best is not None and best in ckpt.all_steps() else ckpt.latest_step()

    from qasr.data.batching import epoch_iterator

    dev_ds = build_dataset(cfg, split="dev")
    batch = next(iter(epoch_iterator(dev_ds, cfg.data, train=False)))
    state = create_train_state(cfg, jax.random.PRNGKey(0), batch["features"])
    state = ckpt.restore(step, state)

    # 3-4. reference decode protocol on dev + core test ------------------
    results = {}
    for split, ds in (("dev", dev_ds), ("core_test", build_dataset(cfg, split="core_test"))):
        print(f"[protocol] beam-decoding {split} "
              f"(W={cfg.decode.beam_width}, prune={cfg.decode.beam_prune_logp})",
              file=sys.stderr)
        out = evaluate(cfg, state.params, ds, None, beam=True)
        results[split] = out["per"]

    # 5. the acceptance line ---------------------------------------------
    print(json.dumps({
        "protocol": "timit_per",
        "preset": args.preset,
        "step": int(step),
        "selected_by": "best_dev_per" if best is not None else "latest",
        "beam_width": cfg.decode.beam_width,
        "beam_prune_logp": cfg.decode.beam_prune_logp,
        "fold": "lee_hon_61_to_39",
        "dev_per": round(float(results["dev"]), 4),
        "test_per": round(float(results["core_test"]), 4),
        "trained_here": trained_here,
        "data_dir": data_dir,
    }))


if __name__ == "__main__":
    main()
