"""qasr experiment CLI — L5 entry point (SURVEY.md §1, §2a C11).

Installed as the ``qasr-train`` console script (pyproject.toml); the repo
root's ``train.py`` delegates here, so both spellings behave identically:

  qasr-train --preset tiny_synthetic [--set train.num_steps=500] [--resume]
  qasr-train --preset timit_qcnn --set data.data_dir=/path/to/TIMIT
  qasr-train --preset timit_qcnn --eval-only --beam [--split core_test]

Presets are the BASELINE.json configs plus the paper's feature-map sweep
(qasr/configs/config.py).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="tiny_synthetic")
    ap.add_argument(
        "--set",
        action="append",
        nargs="+",
        default=[],
        metavar="key.path=value",
        help="config override(s); repeatable, and one --set accepts several "
        "space-separated key.path=value pairs",
    )
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--beam", action="store_true", help="prefix beam search for eval")
    ap.add_argument("--split", default=None,
                    help="eval split (timit: dev/core_test/full_test; librispeech: dev-clean/test-clean)")
    ap.add_argument("--list-presets", action="store_true")
    args = ap.parse_args(argv)

    from qasr.configs import PRESETS, get_config

    if args.list_presets:
        for name, cfg in PRESETS.items():
            print(f"{name}: arch={cfg.model.arch} dataset={cfg.data.dataset}")
        return

    cfg = get_config(args.preset)
    overrides = {}
    for kv in (x for group in args.set for x in group):
        if "=" not in kv:
            raise SystemExit(f"--set expects key.path=value, got {kv!r}")
        k, v = kv.split("=", 1)
        overrides[k] = v
    if overrides:
        cfg = cfg.override(**overrides)

    from qasr.train import build_dataset, evaluate, make_eval_step, train
    from qasr.train.checkpoint import CheckpointManager
    from qasr.train.state import create_train_state
    from qasr.utils.compile_cache import enable_compile_cache
    import jax

    enable_compile_cache()

    if args.eval_only:
        from qasr.data.batching import epoch_iterator

        dataset = build_dataset(cfg, split=args.split) if args.split else build_dataset(cfg)
        batch = next(iter(epoch_iterator(dataset, cfg.data, train=False)))
        state = create_train_state(cfg, jax.random.PRNGKey(0), batch["features"])
        # read-only consumer: never clobber the training run's config.json
        ckpt = CheckpointManager(cfg, write_config=False)
        # best.json may point at a garbage-collected step; fall back to the latest
        # surviving one (and compare against None: step 0 is legitimate)
        best = ckpt.best_step()
        step = best if best is not None and best in ckpt.all_steps() else ckpt.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint in {cfg.train.checkpoint_dir}")
        state = ckpt.restore(step, state)
        dev = evaluate(cfg, state.params, dataset, make_eval_step(cfg), beam=args.beam)
        print(f"[qasr] eval @ step {step}: {dev}")
        return

    train(cfg, resume=args.resume)


def transcribe_main(argv=None):
    """``qasr-transcribe``: checkpoint -> transcriptions for audio files.

    qasr-transcribe --ckpt checkpoints [--beam] [--fold] [--step N] f1.wav ...
    """
    ap = argparse.ArgumentParser(description=transcribe_main.__doc__)
    ap.add_argument("--ckpt", required=True, help="training checkpoint dir")
    ap.add_argument("--step", type=int, default=None, help="pin a step (default: best/latest)")
    ap.add_argument("--beam", action="store_true", help="prefix beam search")
    ap.add_argument("--fold", action="store_true", help="TIMIT 61->39 scoring fold")
    ap.add_argument("files", nargs="+", help="audio files (SPHERE/RIFF wav, FLAC)")
    args = ap.parse_args(argv)

    from qasr.infer import Transcriber

    t = Transcriber(args.ckpt, step=args.step, beam=args.beam)
    for path in args.files:
        out = t.transcribe_file(path, fold=args.fold)
        text = out if isinstance(out, str) else " ".join(out)
        print(f"{path}\t{text}")


if __name__ == "__main__":
    main()
