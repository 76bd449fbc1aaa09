"""Native CTC prefix beam search — jittable, fixed-shape (SURVEY.md §2b R4).

Capability parity: the reference decodes with the backend's beam search
(`K.ctc_decode(greedy=False, beam_width=W)`, a TF CPU op; SURVEY.md §2a C9,
§3.4). Here the search is a `lax.scan` over time with static
shapes throughout, so it jits, vmaps over the batch, and runs on device.

Per frame, W stay-candidates (prefix unchanged: blank emission + collapsed
repeat) and W*V extend-candidates compete for the next beam. The classic
prefix-merge problem (SURVEY.md §7 hard part (c)) has a structural shortcut:
duplicates can ONLY pair an extend-candidate with a stay-candidate (two
distinct surviving prefixes can't extend to the same prefix, and stays keep
distinct prefixes), so merging is a dense [W,V,W] rolling-hash equality
contraction + masked logsumexp — no per-frame sort, which keeps compile
time sane (an argsort/segment-reduce formulation took ~5 min to compile).
`lax.top_k` then keeps the W best by total probability.

Hashes are 32-bit rolling; a collision would merge two distinct prefixes
(probability ~W^2·V·T / 2^32 per utterance — negligible for ASR sizes).

Multi-host DP decode shards utterances over hosts; PER numerators/
denominators combine via qasr.parallel.collectives.aggregate_per
(SURVEY.md §3.4).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

NEG_INF = -1e30
# numpy scalar, not jnp: a module-level jnp constant would initialize the XLA
# backend at import time, breaking jax.distributed.initialize() bring-up
# (tests/test_multihost.py imports qasr before joining the process group)
_HASH_MULT = np.uint32(1000003)


def _logaddexp(a, b):
    m = jnp.maximum(a, b)
    m_safe = jnp.where(m <= NEG_INF / 2, 0.0, m)
    s = jnp.exp(a - m_safe) + jnp.exp(b - m_safe)
    s = jnp.where(m <= NEG_INF / 2, 1.0, s)
    return jnp.where(m <= NEG_INF / 2, NEG_INF, m_safe + jnp.log(s))


def _masked_logsumexp(vals, mask, axis):
    """logsumexp over `axis` counting only `mask` entries (-inf elsewhere)."""
    vals = jnp.where(mask, vals, NEG_INF)
    m = jnp.max(vals, axis=axis)
    m_safe = jnp.where(m <= NEG_INF / 2, 0.0, m)
    s = jnp.sum(jnp.exp(vals - jnp.expand_dims(m_safe, axis)), axis=axis)
    s = jnp.where(m <= NEG_INF / 2, 1.0, jnp.maximum(s, 1e-38))
    return jnp.where(m <= NEG_INF / 2, NEG_INF, m_safe + jnp.log(s))


def _beam_search_single(
    logp: jnp.ndarray,          # [T, V] log-softmax
    length: jnp.ndarray,        # scalar frame count
    *,
    beam_width: int,
    blank_id: int,
    max_len: int,
    prune_logp: float | None,
):
    t_total, v = logp.shape
    w = beam_width

    # initial beam: slot 0 = empty prefix; others dead with distinct hashes
    prefixes0 = jnp.full((w, max_len), -1, jnp.int32)
    lens0 = jnp.zeros((w,), jnp.int32)
    hashes0 = jnp.uint32(1) + jnp.arange(w, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9)
    p_b0 = jnp.full((w,), NEG_INF, logp.dtype).at[0].set(0.0)
    p_nb0 = jnp.full((w,), NEG_INF, logp.dtype)

    tokens = jnp.arange(v, dtype=jnp.int32)
    widx = jnp.arange(w)

    def step(carry, inp):
        prefixes, lens, hashes, p_b, p_nb = carry
        logp_t, t_idx = inp

        last = jnp.where(lens > 0, prefixes[widx, jnp.maximum(lens - 1, 0)], -1)
        p_tot = _logaddexp(p_b, p_nb)

        # --- stay candidates (prefix unchanged) ---
        stay_pb = p_tot + logp_t[blank_id]
        stay_pnb = jnp.where(lens > 0, p_nb + logp_t[jnp.maximum(last, 0)], NEG_INF)

        # --- extend candidates: prefix + v, v != blank ---
        base = jnp.where(tokens[None, :] == last[:, None], p_b[:, None], p_tot[:, None])
        ext_pnb = base + logp_t[None, :]
        ext_pnb = jnp.where(tokens[None, :] == blank_id, NEG_INF, ext_pnb)
        ext_pnb = jnp.where(lens[:, None] >= max_len, NEG_INF, ext_pnb)
        if prune_logp is not None:
            # classic prefix-beam emission pruning (reference backends expose
            # this as the decoder's cutoff knob): tokens whose frame log-prob
            # is below the threshold never extend a prefix. Blank/repeat stay
            # paths are unaffected. Same rule in the native C++ twin.
            ext_pnb = jnp.where(
                logp_t[None, :] < prune_logp, NEG_INF, ext_pnb
            )
        ext_hash = hashes[:, None] * _HASH_MULT + (tokens[None, :].astype(jnp.uint32) + 2)

        # --- merge extend-candidates that equal an existing beam prefix ---
        # (the only possible duplicate pairing; see module docstring)
        eq = ext_hash[:, :, None] == hashes[None, None, :]          # [W, V, W]
        contrib = _masked_logsumexp(
            jnp.broadcast_to(ext_pnb[:, :, None], eq.shape), eq, axis=(0, 1)
        )                                                            # [W]
        stay_pnb = _logaddexp(stay_pnb, contrib)
        ext_alive = ~jnp.any(eq, axis=2)
        ext_pnb = jnp.where(ext_alive, ext_pnb, NEG_INF)

        # --- candidate pool: W stays + W*V extends, all unique prefixes ---
        cand_pb = jnp.concatenate([stay_pb, jnp.full((w * v,), NEG_INF)])
        cand_pnb = jnp.concatenate([stay_pnb, ext_pnb.reshape(-1)])
        cand_hash = jnp.concatenate([hashes, ext_hash.reshape(-1)])
        cand_parent = jnp.concatenate([widx, jnp.repeat(widx, v)]).astype(jnp.int32)
        cand_tok = jnp.concatenate(
            [jnp.full((w,), -1, jnp.int32), jnp.tile(tokens, w)]
        )
        total = _logaddexp(cand_pb, cand_pnb)

        _, sel = lax.top_k(total, w)
        parent = cand_parent[sel]
        tok = cand_tok[sel]
        new_hash = cand_hash[sel]
        new_pb = cand_pb[sel]
        new_pnb = cand_pnb[sel]

        new_prefixes = prefixes[parent]
        new_lens = lens[parent]
        extend = tok >= 0
        pos = jnp.minimum(new_lens, max_len - 1)
        cur = new_prefixes[widx, pos]
        new_prefixes = new_prefixes.at[widx, pos].set(jnp.where(extend, tok, cur))
        new_lens = new_lens + extend.astype(jnp.int32)

        # freeze past the utterance's last frame
        active = t_idx < length
        out = (
            jnp.where(active, new_prefixes, prefixes),
            jnp.where(active, new_lens, lens),
            jnp.where(active, new_hash, hashes),
            jnp.where(active, new_pb, p_b),
            jnp.where(active, new_pnb, p_nb),
        )
        return out, None

    carry0 = (prefixes0, lens0, hashes0, p_b0, p_nb0)
    (prefixes, lens, _, p_b, p_nb), _ = lax.scan(
        step, carry0, (logp, jnp.arange(t_total))
    )
    scores = _logaddexp(p_b, p_nb)
    best = jnp.argmax(scores)
    return prefixes[best], lens[best], scores[best], prefixes, lens, scores


@functools.partial(
    jax.jit,
    static_argnames=("beam_width", "blank_id", "max_len", "prune_logp"),
)
def ctc_beam_search_decode(
    logits: jnp.ndarray,
    logit_lengths: jnp.ndarray,
    *,
    beam_width: int = 16,
    blank_id: int = 0,
    max_len: int = 128,
    prune_logp: float | None = None,
):
    """Batched CTC prefix beam search.

    Args:
      logits: ``[B, T, V]`` unnormalized scores. The search runs in float32,
        or in float64 for float64 logits (with x64 enabled).
      logit_lengths: ``[B]`` valid frame counts.
      prune_logp: if set, tokens with frame log-prob below this never extend
        a prefix (``cfg.decode.beam_prune_logp``).

    Returns:
      (sequences ``[B, max_len]`` padded with -1, lengths ``[B]``,
       log-score ``[B]`` of the best prefix).
    """
    dtype = jnp.promote_types(logits.dtype, jnp.float32)
    logp = jax.nn.log_softmax(logits.astype(dtype), axis=-1)
    fn = functools.partial(
        _beam_search_single,
        beam_width=beam_width,
        blank_id=blank_id,
        max_len=max_len,
        prune_logp=prune_logp,
    )
    seq, lens, score, _, _, _ = jax.vmap(fn)(logp, logit_lengths)
    return seq, lens, score
