"""User-facing inference: checkpoint -> transcriptions.

The reference's eval path is `model.predict` + `K.ctc_decode` inside the
experiment script (SURVEY.md §3.4) — there is no standalone "transcribe this
file" entry. This module adds one as a first-class API: load a trained
checkpoint (plus the config serialized next to it), featurize raw audio with
the on-device front-end, run the jitted forward + CTC decode, and map ids
back to symbols (TIMIT phones or LibriSpeech characters).

    from qasr.infer import Transcriber
    t = Transcriber("/path/to/checkpoint_dir", beam=True)
    phones = t.transcribe_file("sx42.wav")            # ['h#', 'sh', ...]
    folded = t.transcribe_file("sx42.wav", fold=True) # 39-phone protocol

Shapes are bucketed exactly like training (`cfg.data.bucket_sizes`, then
power-of-two growth) so repeated calls reuse a small set of compilations.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from qasr.configs import Config


def _next_time_pad(t: int, bucket_sizes: tuple[int, ...]) -> int:
    for b in bucket_sizes:
        if t <= b:
            return b
    p = max(bucket_sizes) if bucket_sizes else 1
    while p < t:
        p *= 2
    return p


class Transcriber:
    """Load a trained qasr checkpoint and transcribe waveforms/audio files.

    Args:
      checkpoint_dir: directory written by training (contains `config.json`
        and numbered step dirs). The best-dev-PER step is used when a `best.json`
        pointer exists, else the latest step; pass ``step`` to pin one.
      beam: decode with the jitted prefix beam search (`cfg.decode.beam_width`)
        instead of greedy best-path.
      cfg: override the checkpoint's serialized config (rarely needed).
    """

    def __init__(
        self,
        checkpoint_dir: str,
        *,
        step: int | None = None,
        beam: bool = False,
        cfg: Config | None = None,
    ):
        from qasr.features import FrontendConfig
        from qasr.train.state import build_model

        if cfg is None:
            cfg_path = os.path.join(checkpoint_dir, "config.json")
            if not os.path.exists(cfg_path):
                raise FileNotFoundError(
                    f"no config.json in {checkpoint_dir!r}; pass cfg= explicitly"
                )
            with open(cfg_path) as f:
                cfg = Config.from_json(f.read())
        if os.path.abspath(cfg.train.checkpoint_dir) != os.path.abspath(
            checkpoint_dir
        ):
            cfg = cfg.override(**{"train.checkpoint_dir": checkpoint_dir})
        self.cfg = cfg
        self.beam = beam
        self.fcfg = FrontendConfig(
            sample_rate=cfg.data.sample_rate, n_mels=cfg.data.n_mels
        )
        self._model = build_model(cfg)
        self.step = self._restore(step)
        self._run = jax.jit(self._decode_fn)

    # -- setup ---------------------------------------------------------------

    def _restore(self, step: int | None) -> int:
        from qasr.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(self.cfg, write_config=False)
        avail = set(ckpt.all_steps())
        if not avail:
            raise FileNotFoundError(
                f"no checkpoint steps in {self.cfg.train.checkpoint_dir!r}"
            )
        if step is None:
            # best-dev-PER step when it still exists; keep_checkpoints GC
            # may have deleted it (best.json is only a pointer), in which
            # case fall back to the latest surviving step.
            best = ckpt.best_step()
            step = best if best in avail else ckpt.latest_step()
        elif step not in avail:
            raise FileNotFoundError(
                f"step {step} not in {sorted(avail)} under "
                f"{self.cfg.train.checkpoint_dir!r}"
            )
        t0 = _next_time_pad(1, self.cfg.data.bucket_sizes)
        skeleton = np.zeros((1, t0, self.cfg.data.n_mels, 4), np.float32)
        self.params = ckpt.restore_params(step, self.cfg, skeleton)
        return int(step)

    def _decode_fn(self, params, features, lengths):
        from qasr.decode.beam import ctc_beam_search_decode
        from qasr.ops.ctc import ctc_greedy_decode

        logits = self._model.apply(
            {"params": params}, features, train=False, lengths=lengths
        )
        if self.beam:
            # max_len = the frame count (static under jit): CTC can't emit
            # more non-blank symbols than frames, so nothing truncates —
            # cfg.data.max_label_len is a training-data bound, not an
            # inference bound.
            seq, lens, _ = ctc_beam_search_decode(
                logits,
                lengths,
                beam_width=self.cfg.decode.beam_width,
                blank_id=self.cfg.decode.blank_id,
                max_len=int(features.shape[1]),
                prune_logp=self.cfg.decode.beam_prune_logp,
            )
        else:
            seq, lens = ctc_greedy_decode(
                logits, lengths, blank_id=self.cfg.decode.blank_id
            )
        return seq, lens

    # -- symbol mapping ------------------------------------------------------

    def ids_to_symbols(self, ids: np.ndarray, *, fold: bool = False):
        """Decoded ids -> symbols: TIMIT phone strings (optionally folded to
        the 39-phone scoring set) or LibriSpeech characters (joined string)."""
        ids = [int(i) for i in ids]
        if self.cfg.data.dataset == "librispeech":
            if fold:
                raise ValueError(
                    "fold=True is the TIMIT 61->39 phone fold; this is a "
                    "character (LibriSpeech) checkpoint"
                )
            from qasr.data.librispeech import ids_to_text

            return ids_to_text(ids)
        from qasr.data.timit import ID_TO_PHONE, fold_to_39

        phones = [ID_TO_PHONE[i] for i in ids if i in ID_TO_PHONE]
        return fold_to_39(phones) if fold else phones

    # -- public entry points ---------------------------------------------------

    def transcribe_batch(self, wavs: list[np.ndarray], *, fold: bool = False):
        """Transcribe a list of ``[N]`` float32 waveforms (one jitted dispatch
        per call; utterances pad to the longest bucket in the batch)."""
        from qasr.features import featurize_waveform

        feats = [featurize_waveform(np.asarray(w, np.float32), self.fcfg) for w in wavs]
        lengths = np.array([f.shape[0] for f in feats], np.int32)
        t_pad = _next_time_pad(int(lengths.max()), self.cfg.data.bucket_sizes)
        batch = np.zeros((len(feats), t_pad, self.cfg.data.n_mels, 4), np.float32)
        for i, f in enumerate(feats):
            batch[i, : f.shape[0]] = f
        seq, lens = self._run(self.params, jnp.asarray(batch), jnp.asarray(lengths))
        seq, lens = np.asarray(seq), np.asarray(lens)
        return [
            self.ids_to_symbols(seq[i][: int(lens[i])], fold=fold)
            for i in range(len(feats))
        ]

    def transcribe(self, wav: np.ndarray, *, fold: bool = False):
        """Transcribe one ``[N]`` float32 waveform at cfg.data.sample_rate."""
        return self.transcribe_batch([wav], fold=fold)[0]

    def transcribe_file(self, path: str, *, fold: bool = False):
        """Transcribe one audio file (NIST SPHERE / RIFF wav / FLAC)."""
        if path.lower().endswith(".flac"):
            from qasr.native import flac_decode_native, flac_probe

            samples, rate = flac_decode_native(path)
            samples = samples[:, 0]  # [n, channels] -> mono
            # the native decoder returns samples at the stream's bit depth;
            # normalize by the actual full-scale value (8/24-bit streams would
            # otherwise come out 256x too quiet / loud)
            scale = float(2 ** (flac_probe(path)["bps"] - 1))
        else:
            from qasr.data.timit import read_sphere

            samples, rate = read_sphere(path)
            scale = 32768.0  # SPHERE/RIFF path is 16-bit PCM
        if rate != self.cfg.data.sample_rate:
            raise ValueError(
                f"{path!r} is {rate} Hz but the model expects "
                f"{self.cfg.data.sample_rate} Hz (no resampler in qasr)"
            )
        wav = samples.astype(np.float32) / scale
        return self.transcribe(wav, fold=fold)
