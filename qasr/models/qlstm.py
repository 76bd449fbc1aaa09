"""Quaternion LSTM hybrid encoder — BASELINE.json config 4.

Capability: the QCNN-LSTM hybrid (quaternion conv front-end + recurrent
encoder) from the reference family's QLSTM work (Parcollet et al.,
arXiv:1811.02566, PAPERS.md; SURVEY.md §7 stage 8). Gate projections are
Hamilton-product quaternion dense ops; gate nonlinearities and the cell/hidden
elementwise products are *split* (component-wise), per the paper.

Structure: the input projections for all timesteps run as one big
quaternion GEMM outside the recurrence; the recurrent weights expand to the
block (or rank-8 combo) form once outside the scan; `lax.scan` carries only
the hidden matmul + pointwise cell update. One recurrence,
`lstm_recurrence`, serves both layers through a direction axis:
bidirectional runs BOTH directions in one fused scan (direction axis of 2,
backward stream time-flipped) — half the sequential scan steps and double
the GEMM row count per step. Optional
``lengths`` freeze the state past each utterance's last frame so padding
never contaminates either direction. `qbilstm_reference` is the plain
float32 twin that tests and chip_smoke.py check the fused scan against.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from qasr import nn
from qasr.models.layers import PReLU, QDense, flatten_quaternion
from qasr.ops.initializers import quaternion_initializer
from qasr.ops.qlinalg import qdense, qdense_fast8
from qasr.ops.quaternion import O8, U8, V8, hamilton_expand


def qchannel_split(x: jnp.ndarray, groups: int) -> tuple[jnp.ndarray, ...]:
    """Split packed ``[..., 4*G*H]`` into G packed ``[..., 4*H]`` tensors,
    preserving component-major layout."""
    *lead, c4 = x.shape
    gh = c4 // 4
    h = gh // groups
    x = x.reshape(*lead, 4, groups, h)
    return tuple(
        x[..., g, :].reshape(*lead, 4 * h) for g in range(groups)
    )


def qchannel_concat(parts: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Concatenate packed quaternion tensors along the quaternion-channel dim."""
    *lead, _ = parts[0].shape
    stacked = [p.reshape(*lead, 4, -1) for p in parts]
    return jnp.concatenate(stacked, axis=-1).reshape(*lead, -1)


def _input_proj_fn(name: str, rows: int = 0):
    """Pre-scan gate-projection op: auto | block | fast8.

    "auto" picks by the GEMM's row count M = B*T: the rank-8 scheme pays
    combo traffic proportional to M*K while the block path pays a fixed 2x
    weight read and 2x FLOPs, so block wins at large M. The M >= 8192
    crossover was tuned on the previous accelerator and is a hypothesis on
    the GPU until the benchmark measures it."""
    if name == "auto":
        name = "block" if rows >= 8192 else "fast8"
    return qdense_fast8 if name == "fast8" else qdense


class QLSTMCellParams(nn.Module):
    """Parameter container: one quaternion projection for all 4 gates."""

    in_features: int   # quaternion input channels
    hidden: int        # quaternion hidden channels

    @nn.compact
    def __call__(self):
        wx = self.param(
            "wx", quaternion_initializer("glorot"), (4, self.in_features, 4 * self.hidden)
        )
        wh = self.param(
            "wh", quaternion_initializer("glorot"), (4, self.hidden, 4 * self.hidden)
        )
        bias = self.param("bias", nn.initializers.zeros, (4 * 4 * self.hidden,))
        return wx, wh, bias


def _gate_update(z, c, split_groups=4):
    zi, zf, zo, zg = qchannel_split(z, split_groups)
    i = jax.nn.sigmoid(zi)
    f = jax.nn.sigmoid(zf)
    o = jax.nn.sigmoid(zo)
    g = jnp.tanh(zg)
    c_new = f * c + i * g              # split products (paper)
    return o * jnp.tanh(c_new), c_new


class QLSTMLayer(nn.Module):
    """Unidirectional quaternion LSTM over ``[B, T, 4*Cin]`` -> ``[B, T, 4*H]``.

    ``lengths`` (optional ``[B]``) freezes (h, c) past each utterance's last
    frame so padded frames never contaminate the state.
    """

    hidden: int
    reverse: bool = False
    dtype: jnp.dtype | None = None
    input_proj: str = "fast8"  # see QBiLSTM
    recurrent: str = "block"   # see QBiLSTM ("fast8" = rank-8 in-scan GEMM)

    @nn.compact
    def __call__(self, x: jnp.ndarray, lengths: jnp.ndarray | None = None) -> jnp.ndarray:
        b, t, cin4 = x.shape
        cin = cin4 // 4
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        wx, wh, bias = QLSTMCellParams(cin, self.hidden, name="cell")()
        wx, bias = wx.astype(dtype), bias.astype(dtype)

        # all-timestep input projection: one GEMM (outside the scan)
        in_proj = _input_proj_fn(self.input_proj, b * t)
        z = in_proj(x.reshape(b * t, cin4), wx).reshape(b, t, -1) + bias
        return lstm_recurrence(
            z[None], wh[None], lengths, reverse=(self.reverse,),
            recurrent=self.recurrent, dtype=dtype,
        )[0]


def lstm_recurrence(z, wh, lengths=None, *, reverse, recurrent="fast8",
                    dtype=jnp.float32, weight_dtype=jnp.float32):
    """D directions' recurrence as ONE `lax.scan` (a direction axis of D).

    z: ``[D, B, T, 16H]`` input projections (bias added); wh:
    ``[D, 4, H, 4H]`` recurrent weights; ``reverse``: one flag per
    direction, True for a direction that walks time backward (its stream is
    time-flipped inside the scan). Returns the hidden states
    ``[D, B, T, 4H]`` in time order. Runs under the name scope
    ``qlstm_recurrence`` so a profile can attribute its device time.

    The recurrent weights enter the scan in ``weight_dtype`` and are cast to
    the compute ``dtype`` inside each step, so the backward scan sums their
    gradient over the T steps in ``weight_dtype``: float32 by default, since
    a bfloat16 sum's rounding grows with T (~5% relative error at T=512).
    """
    d, b, t, _ = z.shape
    hidden = wh.shape[2]
    with jax.named_scope("qlstm_recurrence"):
        # the recurrent weights expand ONCE here, never inside the scan (XLA
        # does not reliably hoist the expansion out of the loop body)
        wh = wh.astype(weight_dtype)
        if recurrent == "fast8":
            # rank-8 recurrent path: per-direction U-combined weights
            wc8 = jnp.einsum("dakn,pa->dpkn", wh, jnp.asarray(U8, wh.dtype))
            v8 = jnp.asarray(V8, dtype)
            o8 = jnp.asarray(O8, jnp.float32)
        else:
            wh_big = jnp.stack([hamilton_expand(w) for w in wh])  # [D, 4H, 16H]

        # xs: [T, D, B, 16H]; each reversed direction's stream time-flipped
        xs = jnp.stack([z[i, :, ::-1] if r else z[i] for i, r in enumerate(reverse)])
        xs = jnp.moveaxis(xs, 2, 0)
        flipped = jnp.asarray(reverse)[:, None]  # [D, 1]
        h0 = jnp.zeros((d, b, 4 * hidden), dtype)
        c0 = jnp.zeros((d, b, 4 * hidden), dtype)

        def step(carry, inp):
            h, c = carry
            xz_t, t_idx = inp
            if recurrent == "fast8":
                hs_ = h.reshape(d, b, 4, hidden)
                hc = jnp.einsum("dbak,pa->dbpk", hs_, v8)
                prods = jnp.einsum(
                    "dbpk,dpkn->dbpn", hc, wc8.astype(dtype),
                    preferred_element_type=jnp.float32,
                )
                proj = jnp.einsum("dbpn,qp->dbqn", prods, o8).reshape(
                    d, b, 16 * hidden
                ).astype(dtype)
            else:
                proj = jax.lax.dot_general(
                    h,
                    wh_big.astype(dtype),
                    dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                ).astype(dtype)  # [D, B, 16H]
            h_new, c_new = _gate_update(xz_t + proj, c)
            if lengths is not None:
                # a flipped stream's step t_idx is original frame T-1-t_idx
                frame = jnp.where(flipped, t - 1 - t_idx, t_idx)  # [D, 1]
                active = (frame < lengths)[:, :, None]  # [D, B, 1]
                h_new = jnp.where(active, h_new, h)
                c_new = jnp.where(active, c_new, c)
            return (h_new, c_new), h_new

        (_, _), hs = jax.lax.scan(step, (h0, c0), (xs, jnp.arange(t)), unroll=4)
        hs = jnp.moveaxis(hs, 0, 2)  # [D, B, T, 4H] in scan order
        return jnp.stack([hs[i, :, ::-1] if r else hs[i] for i, r in enumerate(reverse)])


class QBiLSTM(nn.Module):
    """Bidirectional quaternion LSTM as ONE fused scan.

    Both directions run in a single `lax.scan` with a direction axis of 2
    (the backward stream's inputs are time-flipped, its outputs un-flipped):
    half the sequential scan steps of two scans, and the per-step recurrent
    matmul doubles its row count. The recurrent projection is a batched dot
    against the pre-expanded ``[2, 4H, 16H]`` weights, or the rank-8 combo
    weights ``[2, 8, H, 4H]``.
    """

    hidden: int
    dtype: jnp.dtype | None = None
    # input (pre-scan) projection: "fast8" = rank-8 scheme (8/16 the FLOPs
    # of the expanded GEMM) | "block" = expanded GEMM | "auto" (by M = B*T)
    input_proj: str = "fast8"
    # recurrent projection: "block" (expanded in-scan GEMM) | "fast8"
    # (rank-8 in-scan einsums: half the weight bytes read per step)
    recurrent: str = "block"

    @nn.compact
    def __call__(self, x, lengths: jnp.ndarray | None = None):
        b, t, cin4 = x.shape
        cin = cin4 // 4
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        wxf, whf, bf = QLSTMCellParams(cin, self.hidden, name="fwd_cell")()
        wxb, whb, bb = QLSTMCellParams(cin, self.hidden, name="bwd_cell")()

        # both directions' input projections as ONE quaternion GEMM
        wx_cat = jnp.concatenate([wxf, wxb], axis=-1).astype(dtype)  # [4,cin,8H]
        in_proj = _input_proj_fn(self.input_proj, b * t)
        z = in_proj(x.reshape(b * t, cin4), wx_cat)
        zf, zb = qchannel_split(z, 2)  # each [B*T, 16H]
        zf = (zf + bf.astype(dtype)).reshape(b, t, -1)
        zb = (zb + bb.astype(dtype)).reshape(b, t, -1)

        hs = lstm_recurrence(
            jnp.stack([zf, zb]), jnp.stack([whf, whb]), lengths,
            reverse=(False, True), recurrent=self.recurrent, dtype=dtype,
        )  # [2, B, T, 4H]
        return qchannel_concat([hs[0], hs[1]])


def qbilstm_reference(params, x, lengths=None):
    """Plain float32 twin of `QBiLSTM`: each direction its own step-by-step
    scan with the block-expanded (16-product) recurrent weights, at HIGHEST
    matmul precision. ``params`` is a QBiLSTM's ``variables["params"]``.

    The reference for the fused, rank-8, bf16-capable recurrence in tests
    and in chip_smoke.py.
    """
    b, t, _ = x.shape
    x = x.astype(jnp.float32)
    if lengths is None:
        lengths = jnp.full((b,), t, jnp.int32)
    outs = []
    with jax.default_matmul_precision("highest"):
        for cell, reverse in (("fwd_cell", False), ("bwd_cell", True)):
            p = jax.tree.map(lambda a: a.astype(jnp.float32), params[cell])
            wh_big = hamilton_expand(p["wh"])  # [4H, 16H]
            xz = qdense(x, p["wx"]) + p["bias"]

            def step(carry, inp, wh_big=wh_big):
                h, c = carry
                xz_t, t_idx = inp
                h_new, c_new = _gate_update(xz_t + h @ wh_big, c)
                active = (t_idx < lengths)[:, None]
                h_new = jnp.where(active, h_new, h)
                c_new = jnp.where(active, c_new, c)
                return (h_new, c_new), h_new

            zeros = jnp.zeros((b, wh_big.shape[0]), jnp.float32)
            _, hs = jax.lax.scan(
                step, (zeros, zeros), (jnp.moveaxis(xz, 1, 0), jnp.arange(t)),
                reverse=reverse,
            )
            outs.append(jnp.moveaxis(hs, 0, 1))
    return qchannel_concat(outs)


class QLSTMEncoder(nn.Module):
    """Quaternion conv front-end + (bi)QLSTM encoder -> CTC logits."""

    conv_features: Sequence[int] = (64, 64, 128, 128)
    dense_features: Sequence[int] = (256,)
    lstm_features: int = 256
    lstm_layers: int = 3
    bidirectional: bool = True
    vocab: int = 32
    kernel_size: tuple[int, int] = (3, 3)
    pool_after: int = 1
    pool_size: int = 3
    dropout_rate: float = 0.3
    dtype: jnp.dtype | None = None
    input_proj: str = "fast8"   # pre-scan gate projection: auto | fast8 | block
    recurrent: str = "block"    # in-scan hidden projection: block | fast8
    # conv front-end routing (the tower shared with QCNNEncoder, so fat
    # layers — e.g. config 4's 128->128 — take the stacked rank-8 path)
    conv_variant: str = "auto"

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        *,
        train: bool = False,
        lengths: jnp.ndarray | None = None,
    ) -> jnp.ndarray:
        from qasr.models.qcnn import quaternion_conv_tower

        if x.ndim != 4:
            raise ValueError(f"expected [B, T, F, 4*C] input, got {x.shape}")
        x, in_stacked = quaternion_conv_tower(
            x,
            conv_features=self.conv_features,
            kernel_size=self.kernel_size,
            pool_after=self.pool_after,
            pool_size=self.pool_size,
            dropout_rate=self.dropout_rate,
            conv_dropout=False,
            dtype=self.dtype,
            variant=self.conv_variant,
            train=train,
        )
        if in_stacked:
            # fused exit: stacked [B,4,F,T,C] -> flattened packed
            # [B,T,4*(F*C)] in ONE transpose
            b_, _, f_, t_, c_ = x.shape
            x = x.transpose(0, 3, 1, 2, 4).reshape(b_, t_, 4 * f_ * c_)
        else:
            x = flatten_quaternion(x)  # [B, T, 4*(F*C)]

        for i in range(self.lstm_layers):
            if self.bidirectional:
                x = QBiLSTM(
                    self.lstm_features,
                    dtype=self.dtype,
                    input_proj=self.input_proj,
                    recurrent=self.recurrent,
                    name=f"qbilstm_{i}",
                )(x, lengths)
            else:
                x = QLSTMLayer(
                    self.lstm_features,
                    dtype=self.dtype,
                    input_proj=self.input_proj,
                    recurrent=self.recurrent,
                    name=f"qlstm_{i}",
                )(x, lengths)
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)

        for i, feats in enumerate(self.dense_features):
            x = QDense(features=feats, dtype=self.dtype, name=f"qdense_{i}")(x)
            x = PReLU(name=f"dense_prelu_{i}")(x)
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)

        logits = nn.Dense(self.vocab, dtype=self.dtype, name="output")(x)
        return logits.astype(jnp.float32)


class RealBiLSTM(nn.Module):
    """Real-valued bidirectional LSTM with the SAME fused-scan structure as
    QBiLSTM (one scan, direction axis 2, pre-scan input projection) so the
    quaternion-vs-real comparison isolates the Hamilton-product arithmetic,
    not the scan engineering. ``hidden`` counts REAL units."""

    hidden: int
    dtype: jnp.dtype | None = None

    @nn.compact
    def __call__(self, x, lengths: jnp.ndarray | None = None):
        b, t, cin = x.shape
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        h4 = 4 * self.hidden
        init = nn.initializers.glorot_uniform()
        wx = self.param("wx", init, (2, cin, h4))
        wh = self.param("wh", init, (2, self.hidden, h4))
        bias = self.param("bias", nn.initializers.zeros, (2, h4))

        # both directions' input projections as one GEMM
        z = jax.lax.dot_general(
            x.reshape(b * t, cin),
            jnp.moveaxis(wx.astype(dtype), 0, 1).reshape(cin, 2 * h4),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(dtype).reshape(b, t, 2, h4)
        z = z + bias.astype(dtype)
        zf = z[:, :, 0]
        zb = z[:, :, 1]

        xs = jnp.stack(
            [jnp.moveaxis(zf, 1, 0), jnp.moveaxis(zb, 1, 0)[::-1]], axis=1
        )  # [T, 2, B, 4H]
        h0 = jnp.zeros((2, b, self.hidden), dtype)
        c0 = jnp.zeros((2, b, self.hidden), dtype)
        t_iota = jnp.arange(t)
        wh_f32 = wh.astype(jnp.float32)  # cast per step: f32 grad sums

        def step(carry, inp):
            h, c = carry
            xz_t, t_idx = inp
            proj = jax.lax.dot_general(
                h, wh_f32.astype(dtype), dimension_numbers=(((2,), (1,)), ((0,), (0,)))
            ).astype(dtype)  # [2, B, 4H]
            zt = xz_t + proj
            i, f, o, g = jnp.split(zt, 4, axis=-1)
            c_new = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
            h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
            if lengths is not None:
                active = jnp.stack(
                    [t_idx < lengths, (t - 1 - t_idx) < lengths]
                )[:, :, None]
                h_new = jnp.where(active, h_new, h)
                c_new = jnp.where(active, c_new, c)
            return (h_new, c_new), h_new

        (_, _), hs = jax.lax.scan(step, (h0, c0), (xs, t_iota), unroll=4)
        fwd = jnp.moveaxis(hs[:, 0], 0, 1)
        bwd = jnp.moveaxis(hs[::-1, 1], 0, 1)
        return jnp.concatenate([fwd, bwd], axis=-1)


class RealLSTMEncoder(nn.Module):
    """Real-valued CNN-LSTM at equal real width (4x the quaternion feature
    counts) — the ablation arm for BASELINE config 4, mirroring
    RealCNNEncoder's role for the conv models: identical topology and scan
    structure, ordinary real arithmetic, 4x the parameters."""

    conv_features: Sequence[int] = (64, 64, 128, 128)
    dense_features: Sequence[int] = (256,)
    lstm_features: int = 256       # quaternion channels; real width = 4x
    lstm_layers: int = 3
    bidirectional: bool = True
    vocab: int = 32
    kernel_size: tuple[int, int] = (3, 3)
    pool_after: int = 1
    pool_size: int = 3
    dropout_rate: float = 0.3
    dtype: jnp.dtype | None = None

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        *,
        train: bool = False,
        lengths: jnp.ndarray | None = None,
    ) -> jnp.ndarray:
        if x.ndim != 4:
            raise ValueError(f"expected [B, T, F, C] input, got {x.shape}")
        for i, feats in enumerate(self.conv_features):
            x = nn.Conv(
                features=4 * feats,
                kernel_size=self.kernel_size,
                dtype=self.dtype,
                name=f"conv_{i}",
            )(x)
            x = PReLU(name=f"conv_prelu_{i}")(x)
            if i + 1 == self.pool_after:
                x = nn.max_pool(
                    x, window_shape=(1, self.pool_size), strides=(1, self.pool_size)
                )
        b, t = x.shape[0], x.shape[1]
        x = x.reshape(b, t, -1)

        for i in range(self.lstm_layers):
            if self.bidirectional:
                x = RealBiLSTM(
                    4 * self.lstm_features, dtype=self.dtype, name=f"bilstm_{i}"
                )(x, lengths)
            else:
                raise NotImplementedError("real ablation is bidirectional-only")
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)

        for i, feats in enumerate(self.dense_features):
            x = nn.Dense(4 * feats, dtype=self.dtype, name=f"dense_{i}")(x)
            x = PReLU(name=f"dense_prelu_{i}")(x)
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        logits = nn.Dense(self.vocab, dtype=self.dtype, name="output")(x)
        return logits.astype(jnp.float32)
