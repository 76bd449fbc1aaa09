"""Corpus -> on-device quaternion features -> cached or streamed examples.

The reference preprocesses TIMIT offline into pickled numpy features
(SURVEY.md §1 L1, §3.5). Here waveforms are featurized by the
jitted JAX front-end (qasr.features) in large padded batches on the
accelerator, normalized per utterance, then either

* **cached** as one .npz per split so subsequent epochs stream from host RAM
  (right for TIMIT / LibriSpeech-100h scale), or
* **streamed** (``cache_features=False``): featurized on demand — the right
  mode for LibriSpeech-960h, whose feature matrix (~220 GB f32) fits
  neither RAM nor a sane cache file. The batching layer announces the epoch
  order ahead of consumption, so streaming featurizes a BLOCK of upcoming
  utterances per device dispatch (``prefetch``; measured 2-3x the
  per-utterance dispatch throughput on the config-5 run) with a
  single-utterance fallback. Waveforms pad to power-of-2 sample counts so
  the jitted front-end compiles O(log) variants, not one per length.

No audio libraries needed — the native SPHERE/RIFF reader in qasr.data.timit
and the native FLAC decoder in qasr/native handle the formats.

`FeaturePipeline` is corpus-agnostic (anything with ``load(i) -> (wav, ids)``
and ``__len__``); `TimitFeaturePipeline` / `LibriFeaturePipeline` bind it to
the two corpora. Exercised end-to-end in CI on synthetic fixture corpora
(tests/test_timit_pipeline.py); on a machine with real audio, point
``data.data_dir`` at the corpus root.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from qasr.configs import Config


class _FeatureExample:
    __slots__ = ("features", "labels", "num_frames", "num_labels")

    def __init__(self, features, labels):
        self.features = features
        self.labels = labels
        self.num_frames = features.shape[0]
        self.num_labels = len(labels)


class FeaturePipeline:
    """Dataset of (quaternion features [T, F, 4], label ids [L]) pairs."""

    def __init__(
        self,
        corpus,
        cfg: Config,
        *,
        cache_key: str,
        cache_dir: str,
        featurize_batch: int = 32,
        cache_features: bool | None = None,
    ):
        self.cfg = cfg
        self.corpus = corpus
        if cache_features is None:
            cache_features = cfg.data.cache_features
        # version bump invalidates caches when featurization semantics change
        # (v2: length-aware delta clamping)
        key = hashlib.sha1(
            f"{cache_key}:{cfg.data.n_mels}:{cfg.data.sample_rate}:v2".encode()
        ).hexdigest()[:12]
        self.cache_path = os.path.join(cache_dir, f"feats_{key}.npz")
        self._featurize_batch = featurize_batch
        self._stream_cache: dict[int, _FeatureExample] = {}
        if cache_features:
            self._examples = self._load_or_build(featurize_batch)
        else:
            self._examples = None  # streaming: featurize in __getitem__

    def _load_or_build(self, featurize_batch: int):
        if os.path.exists(self.cache_path):
            data = np.load(self.cache_path, allow_pickle=True)
            return [
                _FeatureExample(np.asarray(f, np.float32), np.asarray(l, np.int32))
                for f, l in zip(data["features"], data["labels"])
            ]

        import jax.numpy as jnp

        from qasr.features import (
            FrontendConfig,
            normalize_features,
            num_frames,
            quaternion_features,
        )

        fcfg = FrontendConfig(
            sample_rate=self.cfg.data.sample_rate, n_mels=self.cfg.data.n_mels
        )
        examples = []
        n = len(self.corpus)
        for start in range(0, n, featurize_batch):
            idxs = range(start, min(start + featurize_batch, n))
            wavs, labels = zip(*(self.corpus.load(i) for i in idxs))
            max_samp = max(len(w) for w in wavs)
            batch = np.zeros((len(wavs), max_samp), np.float32)
            lens = np.zeros((len(wavs),), np.int32)
            for j, w in enumerate(wavs):
                batch[j, : len(w)] = w
                lens[j] = num_frames(len(w), fcfg)
            feats = quaternion_features(jnp.asarray(batch), fcfg, jnp.asarray(lens))
            feats = normalize_features(feats, jnp.asarray(lens))
            feats = np.asarray(feats)
            for j, lab in enumerate(labels):
                t = int(lens[j])
                f = feats[j, :t].reshape(t, 4, self.cfg.data.n_mels)
                # packed [T, 4*n_mels] -> [T, F, 4] NHWC layout for the QCNN
                f = np.moveaxis(f, 1, 2)
                examples.append(_FeatureExample(f.copy(), np.asarray(lab)))

        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)

        def _obj_array(items):
            # explicit fill: np.array(..., dtype=object) on same-shaped arrays
            # would broadcast into a multi-dim object array
            arr = np.empty(len(items), dtype=object)
            for i, x in enumerate(items):
                arr[i] = x
            return arr

        np.savez_compressed(
            self.cache_path,
            features=_obj_array([e.features for e in examples]),
            labels=_obj_array([e.labels for e in examples]),
        )
        return examples

    def _featurize_one(self, i: int) -> _FeatureExample:
        """Streaming path: featurize utterance i on demand (shape-bounded
        jit compiles — see `qasr.features.featurize_waveform`)."""
        from qasr.features import FrontendConfig, featurize_waveform

        fcfg = FrontendConfig(
            sample_rate=self.cfg.data.sample_rate, n_mels=self.cfg.data.n_mels
        )
        wav, labels = self.corpus.load(i)
        return _FeatureExample(featurize_waveform(wav, fcfg), np.asarray(labels))

    def prefetch(self, indices) -> None:
        """Streaming mode: featurize a block of upcoming utterances in ONE
        padded device dispatch instead of one dispatch per utterance.

        The batching layer announces the epoch order ahead of consumption
        (qasr.data.batching.bucketed_batches), so per-utterance dispatch
        latency — dominant when the accelerator is remote or the host is
        small — amortizes over the block. Shapes stay jit-bounded: the
        sample dim pads to a power of two and the batch dim is fixed at
        ``featurize_batch`` (short blocks pad with dummy rows), so the
        front-end compiles O(log max-len) variants total. Results are
        popped from the block cache on first access (bounded memory: at
        most one block resident). Cached (non-streaming) pipelines no-op.
        """
        if self._examples is not None:
            return
        todo = [int(i) for i in indices if int(i) not in self._stream_cache]
        if not todo:
            return

        import jax.numpy as jnp

        from qasr.features import (
            FrontendConfig,
            normalize_features,
            num_frames,
            quaternion_features,
        )

        fcfg = FrontendConfig(
            sample_rate=self.cfg.data.sample_rate, n_mels=self.cfg.data.n_mels
        )
        bsz = self._featurize_batch
        for start in range(0, len(todo), bsz):
            chunk = todo[start : start + bsz]
            loaded = [self.corpus.load(i) for i in chunk]
            max_samp = max(len(w) for w, _ in loaded)
            pow2 = 1
            while pow2 < max_samp:
                pow2 *= 2
            batch = np.zeros((bsz, pow2), np.float32)
            lens = np.zeros((bsz,), np.int32)
            for j, (w, _) in enumerate(loaded):
                batch[j, : len(w)] = w
                lens[j] = num_frames(len(w), fcfg)
            feats = quaternion_features(
                jnp.asarray(batch), fcfg, jnp.asarray(lens)
            )
            feats = np.asarray(normalize_features(feats, jnp.asarray(lens)))
            for j, (i, (_, lab)) in enumerate(zip(chunk, loaded)):
                t = int(lens[j])
                f = feats[j, :t].reshape(t, 4, self.cfg.data.n_mels)
                f = np.moveaxis(f, 1, 2)  # packed [T, 4F] -> [T, F, 4] NHWC
                self._stream_cache[i] = _FeatureExample(
                    f.copy(), np.asarray(lab)
                )

    def __len__(self):
        return len(self.corpus) if self._examples is None else len(self._examples)

    def __getitem__(self, i) -> _FeatureExample:
        if self._examples is None:
            ex = self._stream_cache.pop(int(i), None)
            return ex if ex is not None else self._featurize_one(i)
        return self._examples[i]


class TimitFeaturePipeline(FeaturePipeline):
    def __init__(self, cfg: Config, split: str = "train", **kw):
        from qasr.data.timit import TimitDataset

        root = cfg.data.data_dir
        super().__init__(
            TimitDataset(root, split),
            cfg,
            cache_key=f"timit_{split}",
            cache_dir=kw.pop("cache_dir", None) or os.path.join(root, ".qasr_cache"),
            **kw,
        )


class LibriFeaturePipeline(FeaturePipeline):
    def __init__(self, cfg: Config, split: str = "train-clean-100", **kw):
        from qasr.data.librispeech import LibriSpeechDataset

        root = cfg.data.data_dir
        super().__init__(
            LibriSpeechDataset(root, split),
            cfg,
            cache_key=f"libri_{split}",
            cache_dir=kw.pop("cache_dir", None) or os.path.join(root, ".qasr_cache"),
            **kw,
        )
