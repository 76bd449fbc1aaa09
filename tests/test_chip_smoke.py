"""chip_smoke.py: it refuses to run without a GPU, and its phases run here
on the CPU at tiny widths (the same code the card runs at full widths), so
a wrong path, argument or control flow shows before a chip call."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY_PARITY = dict(b=2, t=16, f_in=8, f=3, c=8, dense_m=32, lstm_b=3,
                   lstm_t=9, lstm_h=4, lstm_cin=6, dtype="float32")
TINY_MODEL = ("model.compute_dtype=float32", "data.batch_size=8")


def test_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_parity_phase_tiny(capsys):
    chip_smoke.parity_phase(TINY_PARITY)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("parity")]
    # 5 conv checks, 1 dense, 2 dtypes x (fwd + dx + 6 param grads), 2 TF32
    assert len(lines) == 6 + 2 * 8 + 2


def test_timit_phases_tiny(tmp_path, capsys):
    chip_smoke.timit_phases(
        tmp_path,
        extra=(*TINY_MODEL, "model.conv_features=(8,8)", "model.dense_features=(16,)",
               "decode.beam_width=8"),
        corpus=dict(train_speakers=4, utts_per_speaker=8, dev_speakers=1,
                    test_speakers=1),
        steps=2,
    )
    out = capsys.readouterr().out
    assert "checkpoint round trip bit-equal" in out
    assert "resumed from step 2" in out
    hits = re.findall(r"in float64: device == C\+\+ host on (\d+)/(\d+) hypotheses", out)
    assert len(hits) == 2 and all(a == b != "0" for a, b in hits), hits


def test_beam_parity_fails_on_a_float64_difference(monkeypatch, capsys):
    import numpy as np

    import qasr.native

    kw = dict(beam_width=8, blank_id=0, max_len=20, prune_logp=None)
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (3, 20, 6))) * 2.0
    lengths = np.asarray([20, 15, 9], np.int32)
    chip_smoke.beam_parity("sharp logits", logits, lengths, np.ones(3, bool), kw,
                           f32_exact=True)
    assert "in float32: device == C++ host on 3/3" in capsys.readouterr().out

    native = qasr.native.ctc_beam_decode_native

    def off_by_one(*a, **k):
        seq, lens, score = native(*a, **k)
        seq[1, 0] = (seq[1, 0] % 5) + 1 if lens[1] else 1
        lens[1] = max(lens[1], 1)
        return seq, lens, score

    monkeypatch.setattr(qasr.native, "ctc_beam_decode_native", off_by_one)
    with pytest.raises(AssertionError, match="in float64"):
        chip_smoke.beam_parity("sharp logits", logits, lengths, np.ones(3, bool), kw,
                               f32_exact=False)
    assert "row 1 differs" in capsys.readouterr().out


def test_libri_phases_tiny(tmp_path, capsys):
    chip_smoke.libri_phases(
        tmp_path,
        extra=(*TINY_MODEL, "model.conv_features=(8,8)", "model.dense_features=(8,)",
               "model.lstm_features=4", "model.lstm_layers=1"),
        corpus=dict(speakers=2, utts_per_speaker=8, dev_speakers=1),
        steps=2,
    )
    assert "losses finite: 2 steps" in capsys.readouterr().out


def test_four_card_phase_tiny(capsys):
    chip_smoke.four_card_phase(
        jax.devices()[:4],
        dict(t=32, b=8, seq_b=2, seq_t=32, seq_f=3, seq_c=4),
        extra=("model.conv_features=(8,8,8)", "model.dense_features=(16,)",
               "data.max_label_len=8"),
    )
    out = capsys.readouterr().out
    assert "sharded == unsharded on 8/8 hypotheses" in out
    assert out.count("updated params: rel_rms") == 2


@pytest.mark.gpu
def test_full_smoke_on_card(gpu_device, capsys):
    assert chip_smoke.main([]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
