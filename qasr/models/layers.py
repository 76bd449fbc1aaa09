"""Modules wrapping the quaternion ops.

Capability parity with the reference's Keras layer library (SURVEY.md §2a
C1/C2/C4/C5: `QuaternionConv{1D,2D}`, `QuaternionDense`, split PReLU
activation, component-split utilities; mount empty — no file:line). Weights
live as a single stacked ``[4, ..., Cin, Cout]`` param so checkpoints never
store the 4x-expanded kernel and tensor-parallel sharding can target the
quaternion output-channel dim while keeping the component structure intact.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from qasr import nn
from qasr.ops.initializers import quaternion_initializer
from qasr.ops.qlinalg import (
    pack_to_stacked,
    qconv,
    qconv_fast,
    qconv_fast8,
    qconv_fast8_grouped,
    qconv_fast8_stacked,
    qconv_fast10,
    qconv_fast10_stacked,
    qdense,
    qdense_fast,
    qdense_fast8,
    qdense_fast8_from_stacked,
    stacked_to_pack,
)
from qasr.ops.quaternion import split_components


def flatten_quaternion(x: jnp.ndarray) -> jnp.ndarray:
    """Fold trailing spatial dims into the quaternion channel dim, preserving
    component-major packing: ``[..., F, 4*C] -> [..., 4*(F*C)]``."""
    *lead, f, c4 = x.shape
    c = c4 // 4
    x = x.reshape(*lead, f, 4, c)
    x = jnp.moveaxis(x, -2, -3)  # [..., 4, F, C]
    return x.reshape(*lead, 4 * f * c)


def tf_packed_to_stacked(x: jnp.ndarray) -> jnp.ndarray:
    """[B, T, F, 4C] packed -> [B, 4, F, T, C] component-stacked F-major.

    The stacked layout is the conv-chain steady state: component slices are
    leading-dim indexes, so the per-product convs pay no packed-layout
    reshapes. One transpose at conv-stack entry; its inverse at exit.
    Defined in terms of the op-level converters in qlinalg so the layout
    contract lives in one place.
    """
    return pack_to_stacked(jnp.swapaxes(x, 1, 2))


def stacked_to_tf_packed(x: jnp.ndarray) -> jnp.ndarray:
    """[B, 4, F, T, C] stacked -> [B, T, F, 4C] packed."""
    return jnp.swapaxes(stacked_to_pack(x), 1, 2)


class QConv(nn.Module):
    """Quaternion convolution (1 or 2 spatial dims), NHWC, packed channels.

    Reference capability: `QuaternionConv1D/2D` (SURVEY.md C1).
    """

    features: int  # quaternion output channels (real channels = 4*features)
    kernel_size: Sequence[int] = (3, 3)
    strides: Sequence[int] | None = None
    padding: str = "SAME"
    use_bias: bool = True
    criterion: str = "glorot"
    dtype: jnp.dtype | None = None  # compute dtype (e.g. bf16); params f32
    # auto | block | fast | fast10 | fast8 | legacy_auto | stacked |
    # stacked8 | stacked8g (stacked* variants require layout="stacked_ft")
    variant: str = "auto"
    # btfc (packed [B,T,F,4C]) | stacked_ft ([B,4,F,T,C])
    layout: str = "btfc"

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.layout == "stacked_ft":
            return self._call_stacked(x)
        cin4 = x.shape[-1]
        if cin4 % 4:
            raise ValueError(f"input channels {cin4} not divisible by 4")
        cin = cin4 // 4
        kernel = self.param(
            "kernel",
            quaternion_initializer(self.criterion),
            (4, *self.kernel_size, cin, self.features),
        )
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        impl = self.variant
        if impl in ("stacked", "stacked8", "stacked8g", "legacy_auto"):
            # stacked-chain variants reaching the packed path (e.g. a thin
            # layer the encoder kept packed), and the pre-stacked routing
            # kept for A/B ("legacy_auto"), use the auto routing
            impl = "auto"
        if impl == "auto":
            # The 10-product scheme runs each bilinear product as a full real
            # conv whose output width is `features` (fwd/dW) and `cin` (dx),
            # not 4x as in the block path, so it only pays at >= 128
            # quaternion channels; below that one big block conv wins. This
            # threshold was tuned on the previous accelerator and is a
            # hypothesis on the GPU until the benchmark measures it.
            impl = "fast10" if min(cin, self.features) >= 128 else "block"
        conv_fn = {
            "block": qconv,
            "fast": qconv_fast,
            "fast10": qconv_fast10,
            "fast8": qconv_fast8,
        }[impl]
        y = conv_fn(
            x,
            kernel.astype(dtype),
            strides=self.strides,
            padding=self.padding,
        )
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (4 * self.features,))
            y = y + bias.astype(dtype)
        return y

    def _call_stacked(self, x: jnp.ndarray) -> jnp.ndarray:
        """Stacked F-major path: x ``[B, 4, F, T, Cin]`` -> same layout.

        Params are identical to the packed path (same names and shapes), so
        checkpoints are layout-independent.
        """
        if x.ndim != 5 or x.shape[1] != 4:
            raise ValueError(f"stacked_ft expects [B, 4, F, T, C], got {x.shape}")
        if self.strides is not None and tuple(self.strides) != (1, 1):
            raise ValueError("stacked_ft layout supports stride 1 only")
        cin = x.shape[-1]
        kernel = self.param(
            "kernel",
            quaternion_initializer(self.criterion),
            (4, *self.kernel_size, cin, self.features),
        )
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        if self.variant == "stacked8g":
            # rank-8 as ONE feature-grouped conv dispatch
            fn = qconv_fast8_grouped
        elif self.variant.endswith("8"):
            fn = qconv_fast8_stacked
        else:
            fn = qconv_fast10_stacked
        y = fn(x, kernel.astype(dtype), padding=self.padding)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (4 * self.features,))
            y = y + bias.astype(dtype).reshape(4, 1, 1, self.features)
        return y


class QDense(nn.Module):
    """Quaternion dense layer (SURVEY.md C2).

    ``layout="stacked_entry"`` consumes the conv chain's component-stacked
    ``[B, 4, F, T, C]`` output directly (rank-8 scheme, K = F*C) and returns
    packed ``[B, T, 4*features]`` — the conv-stack exit transpose vanishes.
    Params are byte-identical to the packed path.
    """

    features: int  # quaternion output units
    use_bias: bool = True
    criterion: str = "glorot"
    dtype: jnp.dtype | None = None
    variant: str = "auto"  # auto | block | fast | fast8
    layout: str = "packed"  # packed | stacked_entry

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.layout == "stacked_entry":
            if x.ndim != 5 or x.shape[1] != 4:
                raise ValueError(
                    f"stacked_entry expects [B, 4, F, T, C], got {x.shape}"
                )
            k = x.shape[2] * x.shape[4]
            kernel = self.param(
                "kernel",
                quaternion_initializer(self.criterion),
                (4, k, self.features),
            )
            dtype = self.dtype or x.dtype
            y = qdense_fast8_from_stacked(x.astype(dtype), kernel.astype(dtype))
            if self.use_bias:
                bias = self.param(
                    "bias", nn.initializers.zeros, (4 * self.features,)
                )
                y = y + bias.astype(dtype)
            return y
        cin4 = x.shape[-1]
        if cin4 % 4:
            raise ValueError(f"input channels {cin4} not divisible by 4")
        kernel = self.param(
            "kernel",
            quaternion_initializer(self.criterion),
            (4, cin4 // 4, self.features),
        )
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        impl = self.variant
        if impl == "auto":
            # The block GEMM won the full train step against the rank-8 and
            # 10-product denses on the previous accelerator (the combo
            # traffic ate their FLOP cut); a hypothesis on the GPU until the
            # benchmark measures it. Route explicitly via variant="fast8" /
            # "fast" or dense_variant="fast8_stacked" to force a path.
            impl = "block"
        dense_fn = {"fast": qdense_fast, "fast8": qdense_fast8}.get(impl, qdense)
        y = dense_fn(x, kernel.astype(dtype))
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (4 * self.features,))
            y = y + bias.astype(dtype)
        return y


class PReLU(nn.Module):
    """Split (component-wise) PReLU: the paper's activation (SURVEY.md C4).

    One learnable slope per real channel, as Keras stock PReLU does.
    """

    negative_slope_init: float = 0.25

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if x.ndim == 5 and x.shape[1] == 4:
            # component-stacked [B, 4, F, T, C]: same per-real-channel alpha
            # as the packed path (param shape [4C] — checkpoint-compatible)
            alpha = self.param(
                "alpha",
                nn.initializers.constant(self.negative_slope_init),
                (4 * x.shape[-1],),
            )
            a = alpha.astype(x.dtype).reshape(4, 1, 1, x.shape[-1])
            return jnp.where(x >= 0, x, a * x)
        alpha = self.param(
            "alpha",
            nn.initializers.constant(self.negative_slope_init),
            (x.shape[-1],),
        )
        return jnp.where(x >= 0, x, alpha.astype(x.dtype) * x)


def get_r(x):
    """Component-split utility (reference `GetReal`, SURVEY.md C5)."""
    return split_components(x)[0]


def get_i(x):
    return split_components(x)[1]


def get_j(x):
    return split_components(x)[2]


def get_k(x):
    return split_components(x)[3]


class QBatchNorm(nn.Module):
    """Quaternion whitening batch norm (reference library component C6).

    Present in the DCN-derived reference layer library though unused by the
    paper's models (SURVEY.md §2a C6): per quaternion channel, the 4-component
    covariance is whitened with an inverse-Cholesky factor, then an affine
    transform with a learnable symmetric 4x4 gamma (init diag 1/2, so the
    whitened unit-variance components recombine to overall unit variance) and
    a 4-vector beta is applied. Running stats live in the `batch_stats`
    collection.
    """

    momentum: float = 0.99
    eps: float = 1e-4
    use_running_average: bool | None = None

    @nn.compact
    def __call__(self, x: jnp.ndarray, use_running_average: bool | None = None):
        use_ra = nn.merge_param(
            "use_running_average", self.use_running_average, use_running_average
        )
        *lead, c4 = x.shape
        c = c4 // 4
        xs = x.reshape(-1, 4, c)  # [N, 4, C]

        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros((4, c), jnp.float32)
        )
        ra_cov = self.variable(
            "batch_stats",
            "cov",
            lambda: jnp.tile(jnp.eye(4, dtype=jnp.float32)[None] / 4.0, (c, 1, 1)),
        )

        if use_ra:
            mean = ra_mean.value
            cov = ra_cov.value
        else:
            xf = xs.astype(jnp.float32)
            mean = xf.mean(axis=0)  # [4, C]
            xc = xf - mean[None]
            cov = jnp.einsum("nac,nbc->cab", xc, xc) / xs.shape[0]  # [C, 4, 4]
            if not self.is_initializing():
                ra_mean.value = (
                    self.momentum * ra_mean.value + (1 - self.momentum) * mean
                )
                ra_cov.value = (
                    self.momentum * ra_cov.value + (1 - self.momentum) * cov
                )

        # whitening: W = L^-1 with L = chol(cov + eps I); y = W (x - mean)
        ident = jnp.eye(4, dtype=jnp.float32)
        chol = jnp.linalg.cholesky(cov + self.eps * ident[None])
        white = jax.scipy.linalg.solve_triangular(
            chol, jnp.tile(ident[None], (c, 1, 1)), lower=True
        )  # [C, 4, 4]

        gamma = self.param(
            "gamma", lambda *_: jnp.tile(ident[None] * 0.5, (c, 1, 1)), (c, 4, 4)
        )
        beta = self.param("beta", nn.initializers.zeros, (4, c))

        xc = xs.astype(jnp.float32) - mean[None]
        y = jnp.einsum("cab,nbc->nac", gamma @ white, xc) + beta[None]
        return y.reshape(*lead, c4).astype(x.dtype)
