"""Generate a synthetic TIMIT-format corpus for end-to-end pipeline demos.

The container has no TIMIT audio and no network (SURVEY.md §7), so the only
way to demonstrate the FULL data path — SPHERE/RIFF read -> on-device
log-mel + Δ/ΔΔ/ΔΔΔ front-end -> 61-phone CTC targets -> train -> decode ->
61->39 fold -> PER — is a corpus that *looks* like TIMIT on disk and is
acoustically learnable. This tool writes one: every TIMIT phone gets a
distinct deterministic formant signature (closure/silence phones are
near-silent), utterances are random phone strings rendered at 16 kHz with
per-utterance speaker coloration, and the directory layout / speaker naming
reproduces the standard splits (train, 50-speaker dev, 24-speaker core test)
that `qasr.data.timit.TimitDataset` indexes.

This is a pipeline/convergence fixture, not a phonetics simulation: PER on it
measures that the framework learns, not how well it would do on real speech.

Usage:
    python tools/make_mini_timit.py --out data/mini_timit \
        --train-speakers 12 --utts-per-speaker 8 --seed 0
"""

from __future__ import annotations

import argparse
import os

import numpy as np

import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from qasr.data.timit import (  # noqa: E402
    CORE_TEST_SPEAKERS,
    DEV_SPEAKERS,
    TIMIT_61,
    write_riff,
)

RATE = 16000
# Closure/silence-like phones render as near-silence, like real TIMIT.
SILENT = {"h#", "pau", "epi", "pcl", "tcl", "kcl", "bcl", "dcl", "gcl", "q"}


def phone_bank(seed: int) -> dict[str, dict]:
    """Deterministic per-phone acoustic signature: 3 formants + noise mix."""
    rng = np.random.RandomState(seed)
    bank = {}
    for p in TIMIT_61:
        f1 = rng.uniform(250, 900)
        f2 = rng.uniform(900, 2600)
        f3 = rng.uniform(2600, 6800)
        bank[p] = {
            "formants": np.array([f1, f2, f3]),
            "amps": rng.uniform(0.3, 1.0, size=3),
            "noise": rng.uniform(0.02, 0.5),  # fricative-ness
            "dur_ms": rng.uniform(45, 110),   # mean duration
        }
    return bank


def render_utterance(
    phones: list[str],
    bank: dict,
    rng: np.random.RandomState,
    speaker_shift: float,
    silent: frozenset | set = frozenset(SILENT),
) -> tuple[np.ndarray, list[tuple[int, int, str]]]:
    """Render a symbol string to 16 kHz samples + (start, end, symbol) rows."""
    segs, marks, pos = [], [], 0
    for p in phones:
        spec = bank[p]
        dur = int(RATE * spec["dur_ms"] * rng.uniform(0.7, 1.4) / 1000.0)
        dur = max(dur, int(0.025 * RATE))  # at least one analysis window
        t = np.arange(dur) / RATE
        if p in silent:
            sig = 0.01 * rng.randn(dur)
        else:
            sig = np.zeros(dur)
            for f, a in zip(spec["formants"], spec["amps"]):
                # mild per-speaker vocal-tract scaling + random phase
                sig += a * np.sin(
                    2 * np.pi * f * speaker_shift * t + rng.uniform(0, 2 * np.pi)
                )
            sig = (1 - spec["noise"]) * sig + spec["noise"] * rng.randn(dur)
            # attack/decay envelope so boundaries aren't clicks
            env = np.minimum(1.0, np.minimum(np.arange(dur), np.arange(dur)[::-1]) / 80.0)
            sig *= env * 0.25
        segs.append(sig)
        marks.append((pos, pos + dur, p))
        pos += dur
    wav = np.concatenate(segs)
    return np.clip(wav * 32767 * 0.8, -32767, 32767).astype(np.int16), marks


def write_utt(d: str, name: str, phones, bank, rng, shift) -> None:
    os.makedirs(d, exist_ok=True)
    wav, marks = render_utterance(phones, bank, rng, shift)
    write_riff(os.path.join(d, f"{name}.wav"), wav)
    with open(os.path.join(d, f"{name}.phn"), "w") as f:
        for s, e, p in marks:
            f.write(f"{s} {e} {p}\n")


def random_sentence(rng: np.random.RandomState, pool: list[str]) -> list[str]:
    n = rng.randint(6, 15)
    body = [pool[rng.randint(len(pool))] for _ in range(n)]
    return ["h#"] + body + ["h#"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--train-speakers", type=int, default=12)
    ap.add_argument("--utts-per-speaker", type=int, default=8)
    ap.add_argument("--dev-speakers", type=int, default=8)
    ap.add_argument("--test-speakers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    bank = phone_bank(args.seed)
    rng = np.random.RandomState(args.seed + 1)
    pool = [p for p in TIMIT_61 if p not in SILENT]

    def speaker_utts(split_dir: str, speaker: str, n: int) -> None:
        shift = rng.uniform(0.9, 1.1)
        d = os.path.join(args.out, split_dir, f"dr{1 + rng.randint(8)}", speaker)
        for u in range(n):
            write_utt(d, f"si{u * 4 + 1}", random_sentence(rng, pool), bank, rng, shift)

    for s in range(args.train_speakers):
        sex = "mf"[s % 2]
        speaker_utts("train", f"{sex}trn{s}", args.utts_per_speaker)
    for speaker in sorted(DEV_SPEAKERS)[: args.dev_speakers]:
        speaker_utts("test", speaker, args.utts_per_speaker)
    for speaker in sorted(CORE_TEST_SPEAKERS)[: args.test_speakers]:
        speaker_utts("test", speaker, args.utts_per_speaker)

    n_train = args.train_speakers * args.utts_per_speaker
    print(
        f"wrote {args.out}: {n_train} train utts, "
        f"{args.dev_speakers * args.utts_per_speaker} dev, "
        f"{args.test_speakers * args.utts_per_speaker} core-test"
    )


if __name__ == "__main__":
    main()
