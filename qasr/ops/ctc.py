"""Native CTC loss — a JAX redesign of the reference's loss path.

Capability parity: the reference wraps its backend's native CTC
(`ctc_batch_cost`, a Theano/TF C++ forward-backward) in a Lambda layer
(SURVEY.md §2a C8, §3.3; mount empty — no file:line). Here the dynamic
program is implemented natively in JAX: a log-space alpha recursion over the
blank-interleaved label lattice, `lax.scan` over time with the whole batch
vectorized in-lattice (alpha carried as ``[B, S]``), gradients by autodiff
through the scan. Numerics: f32 lattice regardless of logit dtype; stable
3-way logsumexp with -inf handling.

`optax.ctc_loss` is used as a parity oracle in tests only (SURVEY.md §4
test 4); this implementation is the framework's own.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

LOG_EPS = -1e30  # effective -inf that stays finite under arithmetic


def _logsumexp3(a, b, c):
    """Stable logsumexp over three arrays with -inf (LOG_EPS) support.

    Double-where guards keep log(0) out of both the primal and the autodiff
    graph when every input is LOG_EPS (dead lattice states).
    """
    m = jnp.maximum(jnp.maximum(a, b), c)
    degenerate = m <= LOG_EPS / 2
    m_safe = jnp.where(degenerate, 0.0, m)
    s = jnp.exp(a - m_safe) + jnp.exp(b - m_safe) + jnp.exp(c - m_safe)
    s = jnp.where(degenerate, 1.0, s)
    return jnp.where(degenerate, LOG_EPS, m_safe + jnp.log(s))


def build_lattice(labels, label_lengths, *, blank_id: int):
    """Blank-interleaved CTC lattice metadata shared by all loss variants.

    Returns (z ``[B, S]`` lattice symbols, can_skip ``[B, S]``, in_lattice
    ``[B, S]``, s_valid ``[B, 1]``) for S = 2L+1.
    """
    b, l = labels.shape
    s = 2 * l + 1
    # Blank-interleaved lattice symbols z: [blank, l1, blank, l2, ..., blank]
    z = jnp.full((b, s), blank_id, dtype=labels.dtype)
    z = z.at[:, 1::2].set(labels)

    pos = jnp.arange(s)[None, :]  # [1, S]
    s_valid = 2 * label_lengths[:, None] + 1  # [B, 1]
    in_lattice = pos < s_valid

    # Skip transition (s-2) allowed when z_s is a label and z_s != z_{s-2}.
    z_m2 = jnp.pad(z, ((0, 0), (2, 0)), constant_values=blank_id)[:, :s]
    can_skip = (z != blank_id) & (z != z_m2) & (pos >= 2)
    return z, can_skip, in_lattice, s_valid


def lattice_emissions(logp, z):
    """em[b,t,s] = logp[b,t,z[b,s]] as ONE one-hot einsum before the scan.

    A per-step take_along_axis inside the scan lowers to T serialized small
    gathers (and T scatter-adds in the backward), which dominated the whole
    train step on the previous accelerator; this einsum form is one matmul
    forward and one backward.
    """
    v = logp.shape[-1]
    zhot = jax.nn.one_hot(z, v, dtype=logp.dtype)  # [B, S, V]
    return jnp.einsum(
        "btv,bsv->bts", logp, zhot, precision=lax.Precision.HIGHEST
    )  # [B, T, S]; HIGHEST keeps f32 fidelity (no TF32; negligible FLOPs)


def make_alpha_step(can_skip, in_lattice, logit_lengths):
    """One frame of the log-space alpha recursion, scan-compatible.

    The carry convention admits a uniform "pre-frame" state: alpha before any
    frame is one-hot(0) in log space (0 at lattice state 0, LOG_EPS
    elsewhere); applying the step with frame 0's emissions reproduces the
    textbook alpha_0. That uniformity is what lets the sequence-parallel
    chunked scan (qasr.parallel.seq_parallel) carry alpha across shards
    without special-casing the first chunk.
    """
    s = can_skip.shape[1]

    def step(alpha, inputs):
        emit, t_idx = inputs  # emit: [B, S]
        a_m1 = jnp.pad(alpha, ((0, 0), (1, 0)), constant_values=LOG_EPS)[:, :s]
        a_m2 = jnp.pad(alpha, ((0, 0), (2, 0)), constant_values=LOG_EPS)[:, :s]
        a_m2 = jnp.where(can_skip, a_m2, LOG_EPS)
        new = _logsumexp3(alpha, a_m1, a_m2) + emit
        new = jnp.where(in_lattice, new, LOG_EPS)
        # Past the utterance's last frame, freeze alpha so the final read
        # is uniform across the batch.
        active = (t_idx < logit_lengths)[:, None]  # [B, 1]
        return jnp.where(active, new, alpha), None

    return step


def alpha_pre(b: int, s: int) -> jnp.ndarray:
    """Pre-frame alpha carry: log one-hot at lattice state 0."""
    return jnp.full((b, s), LOG_EPS, jnp.float32).at[:, 0].set(0.0)


def loglik_from_alpha(alpha_final, s_valid, label_lengths):
    """-log p from the final alpha column: last blank or last label state."""
    last = jnp.take_along_axis(alpha_final, s_valid - 1, axis=1)[:, 0]
    second = jnp.take_along_axis(
        alpha_final, jnp.maximum(s_valid - 2, 0), axis=1
    )[:, 0]
    # label_length == 0 edge case: only the all-blank path exists
    second = jnp.where(label_lengths > 0, second, LOG_EPS)
    return _logsumexp3(last, second, jnp.full_like(last, LOG_EPS))


def ctc_loss(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    logit_lengths: jnp.ndarray,
    label_lengths: jnp.ndarray,
    *,
    blank_id: int = 0,
) -> jnp.ndarray:
    """CTC negative log-likelihood per utterance.

    Args:
      logits: ``[B, T, V]`` unnormalized scores (any float dtype; lattice in f32).
      labels: ``[B, L]`` int labels (values != blank_id at positions < length).
      logit_lengths: ``[B]`` valid frame counts.
      label_lengths: ``[B]`` valid label counts.
      blank_id: index of the CTC blank symbol.

    Returns:
      ``[B]`` f32 loss = -log p(labels | logits).
    """
    logits = logits.astype(jnp.float32)
    b, t, v = logits.shape
    s = 2 * labels.shape[1] + 1

    logp = jax.nn.log_softmax(logits, axis=-1)  # [B, T, V]
    z, can_skip, in_lattice, s_valid = build_lattice(
        labels, label_lengths, blank_id=blank_id
    )
    em = lattice_emissions(logp, z)  # [B, T, S]
    step = make_alpha_step(can_skip, in_lattice, logit_lengths)

    xs = (jnp.moveaxis(em, 1, 0), jnp.arange(t))
    # unroll: the per-iteration work is small ([B, S] elementwise), so loop
    # overhead dominates; unrolling 8 iterations per trip amortizes it
    alpha_final, _ = lax.scan(step, alpha_pre(b, s), xs, unroll=8)
    return -loglik_from_alpha(alpha_final, s_valid, label_lengths)


def ctc_greedy_decode(
    logits: jnp.ndarray,
    logit_lengths: jnp.ndarray,
    *,
    blank_id: int = 0,
    pad_id: int = -1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best-path CTC decode: framewise argmax, collapse repeats, drop blanks.

    Reference capability: `K.ctc_decode(greedy=True)` (SURVEY.md §2a C9, §3.4).
    Fully jittable, fixed shapes: returns (``[B, T]`` sequences left-packed and
    padded with ``pad_id``, ``[B]`` decoded lengths).
    """
    b, t, _ = logits.shape
    path = jnp.argmax(logits, axis=-1)  # [B, T]
    t_idx = jnp.arange(t)[None, :]
    valid = t_idx < logit_lengths[:, None]
    prev = jnp.pad(path, ((0, 0), (1, 0)), constant_values=blank_id)[:, :t]
    keep = valid & (path != blank_id) & ((path != prev) | (t_idx == 0))

    out_pos = jnp.cumsum(keep, axis=1) - 1  # [B, T]
    out_pos = jnp.where(keep, out_pos, t)  # out-of-range -> dropped
    out = jnp.full((b, t + 1), pad_id, dtype=path.dtype)
    batch_idx = jnp.arange(b)[:, None]
    out = out.at[batch_idx, out_pos].set(jnp.where(keep, path, pad_id), mode="drop")
    lengths = jnp.sum(keep, axis=1)
    return out[:, :t], lengths
