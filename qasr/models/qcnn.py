"""QCNN / real-CNN acoustic model topologies.

Capability parity: the reference builds ~10-layer 3x3 quaternion conv stacks
with early frequency max-pooling, PReLU, dropout, then 3 (quaternion) dense
layers and a softmax over 62 CTC symbols, following Zhang et al. 2016
(SURVEY.md §2a C7, provenance [PAPER §4]; mount empty — no file:line). The
real-CNN baseline at equal feature-map count is the paper's ablation and the
kernel roofline comparison target (BASELINE.json config 3).

Input: packed quaternion features ``[B, T, F_mel, 4]`` (one quaternion channel
whose components are fbank/Δ/ΔΔ/ΔΔΔ). Time stride is always 1 so CTC frame
lengths pass through unchanged.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from qasr import nn
from qasr.models.layers import (
    PReLU,
    QConv,
    QDense,
    flatten_quaternion,
    stacked_to_tf_packed,
    tf_packed_to_stacked,
)


def quaternion_conv_tower(
    x: jnp.ndarray,
    *,
    conv_features: Sequence[int],
    kernel_size: tuple[int, int],
    pool_after: int,
    pool_size: int,
    dropout_rate: float,
    conv_dropout: bool,
    dtype,
    variant: str,
    train: bool,
) -> tuple[jnp.ndarray, bool]:
    """The shared quaternion conv tower with its layer routing.

    Encoder-agnostic: used by both QCNNEncoder and QLSTMEncoder so the
    stacked-chain routing applies wherever fat conv layers appear. MUST be
    called from inside the encoder's ``@nn.compact`` ``__call__`` — the
    QConv/PReLU submodules bind to the caller's scope under the names
    ``qconv_i`` / ``conv_prelu_i``, keeping checkpoints compatible across
    encoders and layout variants.

    Routing: fat layers (>= 128 quaternion channels in AND out) run in the
    component-stacked F-major layout, entered even for a single qualifying
    layer, with the rank-8 scheme; thin layers keep the per-layer packed
    routing. Both rules were tuned on the previous accelerator and are
    hypotheses on the GPU until the benchmark measures them. Returns
    ``(x, in_stacked)``; if ``in_stacked`` the result is still ``[B, 4, F,
    T, C]`` and the caller owns the exit transpose (or a stacked-entry
    consumer).
    """
    chain_variant = {
        "auto": "stacked8",
        "stacked": "stacked",
        "stacked8": "stacked8",
        "stacked8g": "stacked8g",    # grouped single-dispatch rank-8
    }.get(variant)
    in_stacked = False
    for i, feats in enumerate(conv_features):
        cin = (x.shape[-1] if in_stacked else x.shape[-1] // 4)
        if in_stacked and min(cin, feats) < 128:
            # chain exit: a thin layer after fat ones leaves the stacked
            # layout
            x = stacked_to_tf_packed(x)
            in_stacked = False
        if (
            chain_variant
            and not in_stacked
            and i >= pool_after
            and len(kernel_size) == 2
            and min(cin, feats) >= 128
        ):
            x = tf_packed_to_stacked(x)
            in_stacked = True
        if in_stacked:
            layer_variant = chain_variant
        else:
            # thin layers: per-layer routing (block below 128)
            layer_variant = "auto" if chain_variant else variant
        x = QConv(
            features=feats,
            kernel_size=kernel_size,
            dtype=dtype,
            variant=layer_variant,
            layout="stacked_ft" if in_stacked else "btfc",
            name=f"qconv_{i}",
        )(x)
        x = PReLU(name=f"conv_prelu_{i}")(x)
        if i + 1 == pool_after:
            # pool along frequency only — time resolution feeds CTC
            # (always before stacked entry: gate requires i >= pool_after)
            x = nn.max_pool(
                x,
                window_shape=(1, pool_size),
                strides=(1, pool_size),
            )
        if conv_dropout:
            x = nn.Dropout(dropout_rate, deterministic=not train)(x)
    return x, in_stacked


class QCNNEncoder(nn.Module):
    """Quaternion CNN encoder -> framewise CTC logits ``[B, T, vocab]``."""

    conv_features: Sequence[int] = (32, 32, 64, 64, 64, 64, 64, 64, 64, 64)
    dense_features: Sequence[int] = (256, 256, 256)
    vocab: int = 62
    kernel_size: tuple[int, int] = (3, 3)
    pool_after: int = 1          # freq max-pool after this many conv layers
    pool_size: int = 3
    dropout_rate: float = 0.3
    conv_dropout: bool = False
    dtype: jnp.dtype | None = None
    variant: str = "block"
    dense_variant: str = "auto"

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        *,
        train: bool = False,
        lengths: jnp.ndarray | None = None,  # frame-local model: unused
    ) -> jnp.ndarray:
        if x.ndim != 4:
            raise ValueError(f"expected [B, T, F, 4*C] input, got {x.shape}")
        # "stacked*" (and "auto") run the fat post-pool conv layers in the
        # component-stacked F-major layout: one transpose in, one out, zero
        # per-layer repacking. Thin layers keep the per-layer routing (block
        # below 128 q-channels). Shared with QLSTMEncoder.
        x, in_stacked = quaternion_conv_tower(
            x,
            conv_features=self.conv_features,
            kernel_size=self.kernel_size,
            pool_after=self.pool_after,
            pool_size=self.pool_size,
            dropout_rate=self.dropout_rate,
            conv_dropout=self.conv_dropout,
            dtype=self.dtype,
            variant=self.variant,
            train=train,
        )

        dense_start = 0
        if in_stacked and self.dense_variant == "fast8_stacked" and self.dense_features:
            # stacked-entry dense: the first dense layer consumes the
            # stacked conv output directly (rank-8, K = F*C) — no conv-exit
            # transpose at all; its output is already packed
            x = QDense(
                features=self.dense_features[0],
                dtype=self.dtype,
                layout="stacked_entry",
                name="qdense_0",
            )(x)
            x = PReLU(name="dense_prelu_0")(x)
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
            dense_start = 1
        elif in_stacked:
            # fused exit: stacked [B,4,F,T,C] -> flattened packed
            # [B,T,4*(F*C)] in ONE transpose (equivalent to
            # flatten_quaternion(stacked_to_tf_packed(x)) which would pay two)
            b_, _, f_, t_, c_ = x.shape
            x = x.transpose(0, 3, 1, 2, 4).reshape(b_, t_, 4 * f_ * c_)
        else:
            # fold (F, 4C) -> packed 4*(F*C) keeping component-major layout
            x = flatten_quaternion(x)
        for i in range(dense_start, len(self.dense_features)):
            feats = self.dense_features[i]
            x = QDense(
                features=feats,
                dtype=self.dtype,
                variant="auto" if self.dense_variant == "fast8_stacked"
                else self.dense_variant,
                name=f"qdense_{i}",
            )(x)
            x = PReLU(name=f"dense_prelu_{i}")(x)
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)

        logits = nn.Dense(
            self.vocab,
            dtype=self.dtype,
            name="output",
            kernel_init=nn.initializers.glorot_uniform(),
        )(x)
        return logits.astype(jnp.float32)


class RealCNNEncoder(nn.Module):
    """Real-valued CNN baseline at equal feature-map count (4x params).

    The paper's ablation: identical topology with ordinary real convs whose
    channel count matches the quaternion model's real width (4*features).
    """

    conv_features: Sequence[int] = (32, 32, 64, 64, 64, 64, 64, 64, 64, 64)
    dense_features: Sequence[int] = (256, 256, 256)
    vocab: int = 62
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
        lengths: jnp.ndarray | None = None,  # frame-local model: unused
    ) -> jnp.ndarray:
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
                    x,
                    window_shape=(1, self.pool_size),
                    strides=(1, self.pool_size),
                )

        b, t = x.shape[0], x.shape[1]
        x = x.reshape(b, t, -1)
        for i, feats in enumerate(self.dense_features):
            x = nn.Dense(4 * feats, dtype=self.dtype, name=f"dense_{i}")(x)
            x = PReLU(name=f"dense_prelu_{i}")(x)
            x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        logits = nn.Dense(self.vocab, dtype=self.dtype, name="output")(x)
        return logits.astype(jnp.float32)
