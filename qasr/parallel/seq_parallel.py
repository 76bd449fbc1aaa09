"""Sequence parallelism: halo-exchange conv + chunked-scan CTC over the mesh.

SURVEY.md §2c P3: for very long utterances the time axis is sharded across
devices. Two ops need cross-shard structure:

* **Convolution** (`qconv2d_seq_parallel`): a 2-D conv with a (kh, kw) kernel
  needs only the (kh-1)/2 boundary frames from each neighbor — `shard_map` +
  `lax.ppermute` halo exchange, with global sequence boundaries
  masked to the zero-padding SAME convolution expects. Time stride must be 1
  (the CTC topology's invariant in this framework).
* **CTC loss** (`ctc_loss_seq_parallel`): the alpha recursion is sequential
  in time, so the chunked form is a *pipeline*: each shard holds only its
  local emissions (the memory win — [B, T/n, S] instead of [B, T, S] per
  device), and the [B, S] alpha column is carried shard-to-shard with
  `ppermute` (SURVEY.md §5 "blockwise chunked scan (carried alpha)").

The reference has no sequence parallelism of any kind (single device).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from qasr.ops.qlinalg import qconv


def qconv2d_seq_parallel(
    x: jnp.ndarray,
    w: jnp.ndarray,
    mesh: Mesh,
    *,
    axis: str = "data",
    variant: str = "auto",
) -> jnp.ndarray:
    """Quaternion conv2d with the time axis sharded over `axis`.

    x: ``[B, T, F, 4*Cin]`` (T divisible by the axis size); w: ``[4, kh, kw,
    Cin, Cout]``; SAME padding, stride 1. Returns ``[B, T, F, 4*Cout]`` with
    the same sharding.

    ``variant``: "auto" routes each shard's local conv like the single-device
    path — the rank-8 stacked scheme (8/16 the block path's FLOPs) at
    >= 128 quaternion channels, the block conv below — so long-utterance time-sharding
    composes with the production compute scheme instead of paying the
    16-product expansion. "block"/"fast8" force a path. (The fast8 local
    conv uses asymmetric-padding autodiff, not the rotated-role custom VJP,
    which requires plain SAME; grads are parity-tested either way.)
    """
    kh = w.shape[1]
    if kh % 2 == 0:
        raise ValueError("sequence-parallel conv requires an odd time kernel")
    hh = (kh - 1) // 2
    n = mesh.shape[axis]
    cin, cout = w.shape[-2], w.shape[-1]
    if variant == "auto":
        variant = "fast8" if min(cin, cout) >= 128 else "block"

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis, None, None), P()),
        out_specs=P(None, axis, None, None),
    )
    def _fn(x_local, w_full):
        # x_local: [B, T/n, F, 4Cin]
        idx = lax.axis_index(axis)
        if hh > 0 and n > 1:
            fwd = [(i, (i + 1) % n) for i in range(n)]
            bwd = [(i, (i - 1) % n) for i in range(n)]
            # halo from the LEFT neighbor (its trailing frames travel +1)
            left = lax.ppermute(x_local[:, -hh:], axis, perm=fwd)
            # halo from the RIGHT neighbor (its leading frames travel -1)
            right = lax.ppermute(x_local[:, :hh], axis, perm=bwd)
            # global boundaries see zeros (SAME zero padding semantics)
            left = jnp.where(idx == 0, jnp.zeros_like(left), left)
            right = jnp.where(idx == n - 1, jnp.zeros_like(right), right)
            x_ext = jnp.concatenate([left, x_local, right], axis=1)
        else:
            x_ext = jnp.pad(x_local, ((0, 0), (hh, hh), (0, 0), (0, 0)))
        # VALID in time over the halo-extended chunk == SAME on the global T;
        # SAME in frequency.
        pw = (w_full.shape[2] - 1) // 2
        pw2 = w_full.shape[2] - 1 - pw
        if variant == "fast8":
            from qasr.ops.qlinalg import (
                SCHEME8,
                _qconv_stacked_xla,
                pack_to_stacked,
                stacked_to_pack,
            )

            # stacked F-major local conv: spatial dims are (F, T), so SAME
            # on F and VALID on the halo-extended T
            x_st = pack_to_stacked(jnp.swapaxes(x_ext, 1, 2))
            y_st = _qconv_stacked_xla(
                x_st, w_full, SCHEME8, padding=((pw, pw2), (0, 0))
            )
            return jnp.swapaxes(stacked_to_pack(y_st), 1, 2)
        return qconv(
            x_ext,
            w_full,
            padding=((0, 0), (pw, pw2)),
        )

    return _fn(x, w)


def ctc_loss_seq_parallel(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    logit_lengths: jnp.ndarray,
    label_lengths: jnp.ndarray,
    mesh: Mesh,
    *,
    axis: str = "data",
    blank_id: int = 0,
) -> jnp.ndarray:
    """CTC loss with the TIME axis of ``logits`` sharded over ``axis``.

    Blockwise chunked alpha scan (SURVEY.md §5): each shard computes the
    lattice emissions for its own [B, T/n, S] chunk only — no device ever
    materializes the full [B, T, S] emission tensor or the full logits, which
    is the point of time-sharding very long utterances. The [B, S] alpha
    column is carried between shards with `ppermute`.

    Because the recursion is inherently sequential in time, the pipeline does
    n rounds in which exactly one shard's chunk carry is "live" — but under
    SPMD every shard executes its chunk scan in *all* n rounds (masked when
    not live), so aggregate compute is ~n x the unsharded scan while
    wall-clock matches it. That redundancy is the accepted cost of SPMD
    uniformity; the win is the n-fold activation-memory reduction (no device
    holds the full [B, T, S] lattice). The uniform pre-frame carry convention
    (`qasr.ops.ctc.alpha_pre` — applying the step to a log one-hot at state 0
    reproduces alpha_0) means chunk 0 needs no special casing.

    Args/returns as `qasr.ops.ctc.ctc_loss`; T must divide the axis size.
    Differentiable (grads flow through ppermute) and parity-tested against
    the unsharded loss in tests/test_sharding.py.
    """
    from qasr.ops.ctc import (
        alpha_pre,
        build_lattice,
        lattice_emissions,
        loglik_from_alpha,
        make_alpha_step,
    )

    n = mesh.shape[axis]
    b, t, _ = logits.shape
    s = 2 * labels.shape[1] + 1
    chunk = t // n
    if chunk * n != t:
        raise ValueError(f"T={t} must be divisible by the {axis!r} axis size {n}")

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis, None), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def _fn(logits_local, labels_f, logit_lengths_f, label_lengths_f):
        idx = lax.axis_index(axis)
        logp = jax.nn.log_softmax(logits_local.astype(jnp.float32), axis=-1)
        z, can_skip, in_lattice, s_valid = build_lattice(
            labels_f, label_lengths_f, blank_id=blank_id
        )
        em = lattice_emissions(logp, z)  # [B, T/n, S] — local chunk only
        step = make_alpha_step(can_skip, in_lattice, logit_lengths_f)
        t0 = idx * chunk  # global frame index of this shard's first frame
        xs = (jnp.moveaxis(em, 1, 0), t0 + jnp.arange(chunk))

        fwd = [(i, (i + 1) % n) for i in range(n)]

        def stage(k, alpha):
            # All shards run the scan SPMD-uniformly; only shard k's result
            # is the real carried alpha, everyone else's is discarded.
            out, _ = lax.scan(step, alpha, xs, unroll=8)
            alpha = jnp.where(idx == k, out, alpha)
            # Hand shard k's final alpha to shard k+1 (ring; the last
            # iteration wraps it around to shard 0 for the readout).
            return lax.ppermute(alpha, axis, perm=fwd)

        alpha = lax.fori_loop(0, n, stage, alpha_pre(b, s))
        # After n stages the final alpha (from shard n-1) sits on shard 0.
        loglik = loglik_from_alpha(alpha, s_valid, label_lengths_f)
        loss = jnp.where(idx == 0, -loglik, 0.0)
        return lax.psum(loss, axis)

    return _fn(logits, labels, logit_lengths, label_lengths)
