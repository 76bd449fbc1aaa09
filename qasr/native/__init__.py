"""Native (C++) components, built on demand with g++ and loaded via ctypes.

Components: the batch edit-distance / PER scorer (edit_distance.cpp), the
host-side CTC prefix beam-search decoder (beam_decode.cpp) that overlaps
batch decode with device compute, and the FLAC audio decoder
(flac_decode.cpp) the LibriSpeech loader uses (this container ships no other
FLAC decoder). Import errors degrade gracefully — qasr.decode falls back to
numpy / the on-device JAX beam.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "edit_distance.cpp"),
    os.path.join(_DIR, "beam_decode.cpp"),
    os.path.join(_DIR, "flac_decode.cpp"),
]
_SO = os.path.join(_DIR, "_qasr_native.so")
_lock = threading.Lock()
_lib = None


def _build() -> None:
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
        + _SRCS
        + ["-o", _SO],
        check=True,
        capture_output=True,
    )


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or any(
            os.path.getmtime(_SO) < os.path.getmtime(src) for src in _SRCS
        ):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.qasr_edit_distance.restype = ctypes.c_int
        lib.qasr_edit_distance.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.qasr_batch_per.restype = None
        lib.qasr_batch_per.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.qasr_flac_error.restype = ctypes.c_char_p
        lib.qasr_flac_error.argtypes = []
        lib.qasr_flac_probe.restype = ctypes.c_int
        lib.qasr_flac_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.qasr_flac_decode.restype = ctypes.c_int64
        lib.qasr_flac_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        for name, real in (("qasr_ctc_beam_decode", ctypes.c_float),
                           ("qasr_ctc_beam_decode_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(real),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                real,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(real),
            ]
        _lib = lib
        return lib


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def edit_distance_native(ref, hyp) -> int:
    lib = _load()
    r = _as_i32(ref)
    h = _as_i32(hyp)
    return int(
        lib.qasr_edit_distance(
            r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(r),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(h),
        )
    )


def ctc_beam_decode_native(
    logits,
    lengths,
    *,
    beam_width: int = 16,
    blank_id: int = 0,
    max_len: int = 128,
    prune_logp: float | None = None,
):
    """Host-side CTC prefix beam search (qasr/native/beam_decode.cpp).

    Same algorithm and merge structure as the on-device
    ``qasr.decode.ctc_beam_search_decode`` (see that module's docstring), run
    on CPU threads so batch decode overlaps with device compute.

    Args:
      logits: ``[B, T, V]`` raw scores (log-softmax applied internally).
        The search runs in double for float64 logits, else in float.
      lengths: ``[B]`` valid frame counts.

    Returns:
      (sequences ``[B, max_len]`` int32 padded with -1, lengths ``[B]`` int32,
       best-prefix log-score ``[B]`` in the search's dtype).
    """
    lib = _load()
    f64 = np.asarray(logits).dtype == np.float64
    dtype, real = (np.float64, ctypes.c_double) if f64 else (np.float32, ctypes.c_float)
    decode = lib.qasr_ctc_beam_decode_f64 if f64 else lib.qasr_ctc_beam_decode
    logits = np.ascontiguousarray(logits, dtype=dtype)
    lengths = _as_i32(lengths)
    b, t, v = logits.shape
    assert v < (1 << 20), "vocab must fit the 20-bit candidate key"
    out_seqs = np.empty((b, max_len), np.int32)
    out_lens = np.empty((b,), np.int32)
    out_scores = np.empty((b,), dtype)
    decode(
        logits.ctypes.data_as(ctypes.POINTER(real)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b,
        t,
        v,
        beam_width,
        blank_id,
        max_len,
        real(-3e38 if prune_logp is None else prune_logp),
        out_seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_scores.ctypes.data_as(ctypes.POINTER(real)),
    )
    return out_seqs, out_lens, out_scores


def flac_probe(path: str) -> dict:
    """STREAMINFO of a FLAC file: n_samples / channels / sample_rate / bps."""
    lib = _load()
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    bps = ctypes.c_int32()
    rc = lib.qasr_flac_probe(
        path.encode(), ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr),
        ctypes.byref(bps),
    )
    if rc != 0:
        raise ValueError(f"{path}: {lib.qasr_flac_error().decode()}")
    return {
        "n_samples": n.value,
        "channels": ch.value,
        "sample_rate": sr.value,
        "bps": bps.value,
    }


def flac_decode_native(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file with the native decoder (qasr/native/flac_decode.cpp).

    Returns (samples ``[n, channels]`` int32 at the stream's bit depth,
    sample_rate). LibriSpeech is 16 kHz mono 16-bit; the decoder also handles
    8/24-bit and stereo with left/right/mid-side decorrelation.
    """
    lib = _load()
    info = flac_probe(path)
    if info["n_samples"] > 0:
        cap = info["n_samples"] * info["channels"]
    else:
        # STREAMINFO total unknown: bound by bitstream size (compressed FLAC
        # never drops below ~1 bit per sample, so the file's total bit count
        # bounds the sample count regardless of bps — constant-subframe runs
        # can far exceed size*8/bps)
        cap = max(os.path.getsize(path) * 8, 4096)
    out = np.empty((cap,), np.int32)
    got = lib.qasr_flac_decode(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap
    )
    if got < 0:
        raise ValueError(f"{path}: {lib.qasr_flac_error().decode()}")
    return out[: got * info["channels"]].reshape(-1, info["channels"]), info[
        "sample_rate"
    ]


def batch_per_native(refs, ref_lens, hyps, hyp_lens) -> tuple[int, int]:
    """Padded id matrices -> (total errors, total reference tokens)."""
    lib = _load()
    refs = _as_i32(refs)
    hyps = _as_i32(hyps)
    ref_lens = _as_i32(ref_lens)
    hyp_lens = _as_i32(hyp_lens)
    errs = ctypes.c_int64()
    total = ctypes.c_int64()
    lib.qasr_batch_per(
        refs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ref_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hyps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hyp_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        refs.shape[0],
        refs.shape[1] if refs.ndim == 2 else 0,
        hyps.shape[1] if hyps.ndim == 2 else 0,
        ctypes.byref(errs),
        ctypes.byref(total),
    )
    return int(errs.value), int(total.value)
