"""On-device acoustic front-end: log-mel FBANK + Δ, ΔΔ, ΔΔΔ quaternion features.

Capability parity: the reference precomputes 40 log-mel filterbank
coefficients per frame offline and stacks the value with its first/second/
third time-derivatives as the four quaternion components (SURVEY.md §2a C10,
§3.5; paper arXiv:1806.07789 §4.1; mount empty — no file:line).

Everything is jitted XLA so features run on-device in the input pipeline
(BASELINE.json north star: "mel-filterbank/STFT feature extraction runs as
a JAX/XLA front-end"):

* framing via a gather of strided indices,
* DFT as one GEMM against a precomputed real/imag DFT matrix (GEMM-native
  NDFT; cf. the MelT pattern, PAPERS.md),
* mel projection as a second GEMM (both at HIGHEST precision: f32 features,
  not TF32, on every backend),
* regression deltas as a depthwise 1-D convolution along time.

Output layout matches the framework's packed quaternion convention
``[B, T, 4*n_mels]`` component-major: [fbank, Δ, ΔΔ, ΔΔΔ].
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    win_length: int = 400        # 25 ms
    hop_length: int = 160        # 10 ms
    n_fft: int = 512
    n_mels: int = 40
    fmin: float = 0.0
    fmax: float | None = None    # default sr/2
    delta_window: int = 2        # regression delta half-window
    log_floor: float = 1e-10


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """HTK-style triangular mel filterbank matrix ``[n_fft//2+1, n_mels]``."""
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2
    n_bins = cfg.n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(cfg.fmin), hz_to_mel(fmax), cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * cfg.sample_rate / cfg.n_fft
    fb = np.zeros((n_bins, cfg.n_mels), dtype=np.float32)
    for m in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dft_matrices(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices ``[win_length, n_fft//2+1]`` with the Hamming
    window folded in — the STFT becomes a single GEMM."""
    n_bins = cfg.n_fft // 2 + 1
    window = np.hamming(cfg.win_length).astype(np.float32)
    n = np.arange(cfg.win_length)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * math.pi * n * k / cfg.n_fft
    return (
        (window[:, None] * np.cos(ang)).astype(np.float32),
        (window[:, None] * np.sin(ang)).astype(np.float32),
    )


def num_frames(n_samples: int, cfg: FrontendConfig) -> int:
    return max(0, 1 + (n_samples - cfg.win_length) // cfg.hop_length)


def frame_signal(x: jnp.ndarray, cfg: FrontendConfig) -> jnp.ndarray:
    """``[B, N] -> [B, T, win_length]`` strided framing (no centering)."""
    t = num_frames(x.shape[-1], cfg)
    idx = (
        jnp.arange(t)[:, None] * cfg.hop_length + jnp.arange(cfg.win_length)[None, :]
    )
    return x[..., idx]


def _delta_kernel(n: int) -> np.ndarray:
    """Regression delta filter: d_t = sum_k k*(c_{t+k}-c_{t-k}) / (2*sum k^2)."""
    denom = 2.0 * sum(k * k for k in range(1, n + 1))
    taps = np.arange(-n, n + 1, dtype=np.float32) / denom
    return taps  # correlation taps: sum_k taps[k+n]*c_{t+k}


def delta(
    feat: jnp.ndarray, n: int = 2, lengths: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Regression deltas along time: ``[B, T, F] -> [B, T, F]``, edge-clamped.

    With ``lengths`` (``[B]`` valid frame counts), each utterance's windows
    clamp at ITS last valid frame — matching the reference's per-utterance
    offline deltas, and making features within the valid region independent
    of how much batch padding follows (cached and streaming featurization
    then agree exactly; see qasr/data/pipeline.py).
    """
    taps = jnp.asarray(_delta_kernel(n))
    t = feat.shape[1]
    idx = jnp.clip(
        jnp.arange(t)[:, None] + jnp.arange(-n, n + 1)[None, :], 0, t - 1
    )  # [T, W]
    if lengths is not None:
        idx = jnp.minimum(idx[None], jnp.maximum(lengths - 1, 0)[:, None, None])
    else:
        idx = idx[None]  # [1, T, W]
    b = feat.shape[0]
    w = 2 * n + 1
    idx = jnp.broadcast_to(idx, (b, t, w)).reshape(b, t * w)
    windows = jnp.take_along_axis(feat, idx[..., None], axis=1)
    windows = windows.reshape(b, t, w, feat.shape[-1])
    return jnp.einsum("btwf,w->btf", windows, taps)


@functools.partial(jax.jit, static_argnames=("cfg",))
def log_mel_spectrogram(x: jnp.ndarray, cfg: FrontendConfig = FrontendConfig()):
    """``[B, N]`` waveform -> ``[B, T, n_mels]`` log-mel FBANK."""
    frames = frame_signal(x.astype(jnp.float32), cfg)  # [B, T, W]
    dft_re, dft_im = (jnp.asarray(m) for m in dft_matrices(cfg))
    hi = jax.lax.Precision.HIGHEST
    re = jnp.matmul(frames, dft_re, precision=hi)  # [B, T, bins]
    im = jnp.matmul(frames, dft_im, precision=hi)
    power = re * re + im * im
    mel = jnp.matmul(power, jnp.asarray(mel_filterbank(cfg)), precision=hi)
    return jnp.log(jnp.maximum(mel, cfg.log_floor))


@functools.partial(jax.jit, static_argnames=("cfg",))
def quaternion_features(
    x: jnp.ndarray,
    cfg: FrontendConfig = FrontendConfig(),
    lengths: jnp.ndarray | None = None,
):
    """``[B, N]`` waveform -> packed ``[B, T, 4*n_mels]`` quaternion features
    (component-major: [fbank, Δ, ΔΔ, ΔΔΔ]).

    ``lengths`` (``[B]`` valid frame counts) makes the delta chain clamp at
    each utterance's boundary (see `delta`) so valid-region features don't
    depend on batch padding."""
    fbank = log_mel_spectrogram(x, cfg)
    d1 = delta(fbank, cfg.delta_window, lengths)
    d2 = delta(d1, cfg.delta_window, lengths)
    d3 = delta(d2, cfg.delta_window, lengths)
    return jnp.concatenate([fbank, d1, d2, d3], axis=-1)


def featurize_waveform(
    wav: np.ndarray, cfg: FrontendConfig = FrontendConfig()
) -> np.ndarray:
    """One ``[N]`` float32 waveform -> normalized ``[T, n_mels, 4]`` features.

    The single-utterance host-side entry (feature pipeline streaming mode and
    `qasr.infer.Transcriber`). The waveform pads to the next power of two so
    the jitted front-end sees a bounded set of shapes (one compile per octave
    of utterance length); padded tail frames are sliced off. Per-utterance
    CMVN over valid frames; deltas clamp at the true boundary so the result
    is independent of the padding.
    """
    t = num_frames(len(wav), cfg)
    n_pad = 1 << max(int(np.ceil(np.log2(max(len(wav), cfg.win_length)))), 0)
    batch = np.zeros((1, n_pad), np.float32)
    batch[0, : len(wav)] = wav
    t_arr = jnp.asarray([t], jnp.int32)
    feats = quaternion_features(jnp.asarray(batch), cfg, t_arr)
    feats = normalize_features(feats, t_arr)
    f = np.asarray(feats)[0, :t].reshape(t, 4, cfg.n_mels)
    return np.moveaxis(f, 1, 2).copy()


def normalize_features(feat: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Per-utterance mean/variance normalization over valid frames.

    feat: ``[B, T, F]``; lengths: ``[B]`` valid frame counts.
    """
    mask = (jnp.arange(feat.shape[1])[None, :] < lengths[:, None])[..., None]
    cnt = jnp.maximum(lengths[:, None, None].astype(feat.dtype), 1.0)
    mean = jnp.sum(feat * mask, axis=1, keepdims=True) / cnt
    var = jnp.sum(((feat - mean) ** 2) * mask, axis=1, keepdims=True) / cnt
    out = (feat - mean) * lax.rsqrt(var + 1e-8)
    return jnp.where(mask, out, 0.0)
