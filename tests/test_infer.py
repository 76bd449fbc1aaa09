"""Transcriber API tests: checkpoint -> file/waveform transcription
(the user-facing inference entry; SURVEY.md §3.4 eval path as a library API)."""

import os

import numpy as np
import pytest

import jax

from qasr.configs import get_config
from qasr.data.timit import FOLD_61_TO_39, TIMIT_61, write_riff
from qasr.infer import Transcriber, _next_time_pad
from qasr.train.checkpoint import CheckpointManager
from qasr.train.state import create_train_state


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """A saved (untrained) checkpoint + its config.json, plus a fixture wav."""
    root = tmp_path_factory.mktemp("infer")
    ckpt_dir = str(root / "ckpt")
    cfg = get_config("tiny_synthetic").override(**{
        "data.dataset": "timit",
        "data.n_mels": "8",
        "data.bucket_sizes": "(32,64)",
        "train.checkpoint_dir": ckpt_dir,
    })
    feats = np.zeros((1, 32, 8, 4), np.float32)
    state = create_train_state(cfg, jax.random.PRNGKey(0), feats)
    ckpt = CheckpointManager(cfg)
    ckpt.save(1, state, dev_per=0.5)
    ckpt.save(2, state)
    ckpt.wait()
    wav_path = str(root / "utt.wav")
    rng = np.random.RandomState(0)
    write_riff(wav_path, (rng.randn(9000) * 5000).astype(np.int16))
    return ckpt_dir, wav_path


class TestNextTimePad:
    def test_buckets_then_powers_of_two(self):
        assert _next_time_pad(10, (64, 128)) == 64
        assert _next_time_pad(100, (64, 128)) == 128
        assert _next_time_pad(129, (64, 128)) == 256
        assert _next_time_pad(600, (64, 128)) == 1024


class TestTranscriber:
    def test_loads_best_step_from_config_json(self, trained_ckpt):
        ckpt_dir, _ = trained_ckpt
        t = Transcriber(ckpt_dir)
        assert t.step == 1  # best.json points at step 1, not latest (2)
        assert Transcriber(ckpt_dir, step=2).step == 2

    def test_transcribe_file_returns_phones(self, trained_ckpt):
        ckpt_dir, wav_path = trained_ckpt
        t = Transcriber(ckpt_dir)
        phones = t.transcribe_file(wav_path)
        assert isinstance(phones, list)
        assert all(p in TIMIT_61 for p in phones)
        folded = t.transcribe_file(wav_path, fold=True)
        allowed = {m for m in FOLD_61_TO_39.values() if m is not None}
        assert all(p in allowed for p in folded)

    def test_batch_and_single_agree(self, trained_ckpt):
        ckpt_dir, _ = trained_ckpt
        t = Transcriber(ckpt_dir)
        rng = np.random.RandomState(1)
        w1 = rng.randn(6000).astype(np.float32) * 0.1
        w2 = rng.randn(9500).astype(np.float32) * 0.1
        both = t.transcribe_batch([w1, w2])
        assert both[0] == t.transcribe(w1)
        assert both[1] == t.transcribe(w2)

    def test_beam_decode_path(self, trained_ckpt):
        ckpt_dir, wav_path = trained_ckpt
        t = Transcriber(ckpt_dir, beam=True)
        phones = t.transcribe_file(wav_path)
        assert all(p in TIMIT_61 for p in phones)

    def test_does_not_clobber_config_json(self, trained_ckpt):
        ckpt_dir, _ = trained_ckpt
        cfg_path = os.path.join(ckpt_dir, "config.json")
        before = open(cfg_path).read()
        Transcriber(ckpt_dir)
        assert open(cfg_path).read() == before

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            Transcriber(str(tmp_path / "nope"))

    def test_best_pointer_to_gcd_step_falls_back_to_latest(self, trained_ckpt):
        """keep_checkpoints GC can delete the step best.json points at; the
        default restore must then use the latest surviving step, not crash."""
        import json
        import shutil

        ckpt_dir, _ = trained_ckpt
        stale = str(trained_ckpt[0]) + "_stale"
        shutil.copytree(ckpt_dir, stale)
        with open(os.path.join(stale, "best.json"), "w") as f:
            json.dump({"step": 999, "dev_per": 0.01}, f)
        assert Transcriber(stale).step == 2
        with pytest.raises(FileNotFoundError, match="not in"):
            Transcriber(stale, step=999)

    def test_fold_rejected_for_character_checkpoints(self, trained_ckpt):
        ckpt_dir, wav_path = trained_ckpt
        t = Transcriber(ckpt_dir)
        t.cfg = t.cfg.override(**{"data.dataset": "librispeech"})
        assert isinstance(t.transcribe_file(wav_path), str)
        with pytest.raises(ValueError, match="TIMIT"):
            t.transcribe_file(wav_path, fold=True)

    def test_transcribe_flac(self, trained_ckpt, tmp_path):
        """FLAC files decode to [n, channels]; the mono selection must happen
        before featurization (a 2-D waveform would fail to broadcast)."""
        from test_flac import FlacEncoder

        ckpt_dir, wav_path = trained_ckpt
        rng = np.random.RandomState(3)
        pcm = (rng.randn(8000) * 4000).astype(np.int16)
        flac_path = str(tmp_path / "utt.flac")
        with open(flac_path, "wb") as f:
            f.write(FlacEncoder().encode(pcm.reshape(-1, 1)))
        t = Transcriber(ckpt_dir)
        phones = t.transcribe_file(flac_path)
        assert all(p in TIMIT_61 for p in phones)

    def test_transcribe_cli(self, trained_ckpt, capsys):
        from qasr.cli import transcribe_main

        ckpt_dir, wav_path = trained_ckpt
        transcribe_main(["--ckpt", ckpt_dir, "--fold", wav_path])
        out = capsys.readouterr().out
        assert out.startswith(wav_path + "\t")
