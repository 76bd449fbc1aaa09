"""Quaternion dense and convolution ops.

Re-designs the reference's hot ops (quaternion conv/dense via one real
conv2d/dot on a 4x-expanded block kernel; SURVEY.md §2a C1/C2, §3.2) in JAX:
the block path is a single `lax.dot_general` / `lax.conv_general_dilated` on
the transiently-expanded block kernel, with bf16 compute + f32 accumulation
(`preferred_element_type`); the reduced-product paths (10 and 8 real
products, quaternion.py) run one plain real conv or GEMM per product. XLA
hands every product to cuBLAS/cuDNN.

Layouts:
  activations: NHWC-style, packed trailing dim ``[..., 4*Cin]`` component-major,
               or stacked F-major ``[B, 4, F, T, C]`` (the conv tower's fat layers).
  weights:     stacked ``[4, kh, kw, Cin, Cout]`` (conv) / ``[4, Cin, Cout]`` (dense).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from qasr.ops.quaternion import (
    O8,
    OUT_COMBO,
    U8,
    V8,
    W_COMBO,
    X_COMBO,
    hamilton_expand,
)


def qdense(
    x: jnp.ndarray,
    w: jnp.ndarray,
    *,
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Quaternion dense: ``[..., 4*Cin] @ [4, Cin, Cout] -> [..., 4*Cout]``.

    One real GEMM on the block-expanded matrix; XLA fuses the expansion and the
    device runs a single ``[M, 4Cin] x [4Cin, 4Cout]`` matmul.
    """
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, Cin, Cout], got {w.shape}")
    w_big = hamilton_expand(w).astype(x.dtype)  # [4Cin, 4Cout]
    out = lax.dot_general(
        x,
        w_big,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        precision=precision,
        preferred_element_type=accum_dtype,
    )
    return out.astype(x.dtype)


def qconv(
    x: jnp.ndarray,
    w: jnp.ndarray,
    *,
    strides: Sequence[int] | None = None,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Quaternion N-D convolution (N = 1 or 2 spatial dims), NHWC layout.

    x: ``[B, *spatial, 4*Cin]``; w: ``[4, *kernel, Cin, Cout]``.
    Returns ``[B, *spatial_out, 4*Cout]``.

    The reference calls the backend real conv on the concatenated kernel once
    per step (SURVEY.md §3.2); here the expansion happens inside jit so XLA
    fuses it with the convolution's weight read — no separate HBM round-trip
    for the 4x kernel at steady state, and the device runs one large conv.
    """
    nspatial = w.ndim - 3
    if w.shape[0] != 4 or nspatial not in (1, 2):
        raise ValueError(f"conv weights must be [4, *k, Cin, Cout], got {w.shape}")
    if x.ndim != nspatial + 2:
        raise ValueError(f"x rank {x.ndim} incompatible with {nspatial}-D conv")
    if strides is None:
        strides = (1,) * nspatial

    w_big = hamilton_expand(w).astype(x.dtype)  # [*k, 4Cin, 4Cout]
    if nspatial == 1:
        dn = lax.conv_dimension_numbers(x.shape, w_big.shape, ("NWC", "WIO", "NWC"))
    else:
        dn = lax.conv_dimension_numbers(x.shape, w_big.shape, ("NHWC", "HWIO", "NHWC"))
    # No preferred_element_type here: conv's autodiff transpose cannot mix an
    # f32 cotangent with bf16 operands, and bf16 convs accumulate in f32
    # internally regardless — output dtype follows the operands.
    out = lax.conv_general_dilated(
        x,
        w_big,
        window_strides=tuple(strides),
        padding=padding,
        dimension_numbers=dn,
        precision=precision,
    )
    return out.astype(x.dtype)


def qdense_fast(
    x: jnp.ndarray,
    w: jnp.ndarray,
    *,
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Quaternion dense via the 10-multiplication scheme (quaternion.py).

    10 batched ``[M,K]x[K,N]`` matmuls instead of the 16 block products the
    4x-expanded GEMM performs — a 1.6x FLOP reduction. Elementwise combo
    formation is fused by XLA.
    """
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, Cin, Cout], got {w.shape}")
    k = w.shape[1]
    xs = x.reshape(*x.shape[:-1], 4, k)
    xc = jnp.einsum(
        "...ak,pa->...pk", xs, jnp.asarray(X_COMBO, x.dtype)
    )  # [..., 10, K]
    wc = jnp.einsum("akn,pa->pkn", w, jnp.asarray(W_COMBO, w.dtype))  # [10, K, N]
    prods = jnp.einsum(
        "...pk,pkn->...pn",
        xc,
        wc.astype(x.dtype),
        precision=precision,
        preferred_element_type=accum_dtype,
    )
    ys = jnp.einsum(
        "...pn,bp->...bn", prods, jnp.asarray(OUT_COMBO, accum_dtype)
    )  # [..., 4, N]
    return ys.reshape(*x.shape[:-1], 4 * w.shape[2]).astype(x.dtype)


def qdense_fast8(
    x: jnp.ndarray,
    w: jnp.ndarray,
    *,
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Quaternion dense via the exact rank-8 scheme (quaternion.py U8/V8/O8).

    8 batched real GEMMs — the bilinear-rank floor, 8/16 the FLOPs of
    the block-expanded GEMM. Same einsum structure as `qdense_fast`; input
    combos are 2-sparse weighted sums, output recombination is a dense
    [4, 8] contraction in the accumulate dtype.
    """
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, Cin, Cout], got {w.shape}")
    k = w.shape[1]
    xs = x.reshape(*x.shape[:-1], 4, k)
    xc = jnp.einsum("...ak,pa->...pk", xs, jnp.asarray(V8, x.dtype))
    wc = jnp.einsum("akn,pa->pkn", w, jnp.asarray(U8, w.dtype))  # [8, K, N]
    prods = jnp.einsum(
        "...pk,pkn->...pn",
        xc,
        wc.astype(x.dtype),
        precision=precision,
        preferred_element_type=accum_dtype,
    )
    ys = jnp.einsum("...pn,bp->...bn", prods, jnp.asarray(O8, accum_dtype))
    return ys.reshape(*x.shape[:-1], 4 * w.shape[2]).astype(x.dtype)


def qconv_fast(
    x: jnp.ndarray,
    w: jnp.ndarray,
    *,
    strides: Sequence[int] | None = None,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Quaternion conv via the 10-multiplication scheme as ONE grouped conv.

    The 10 products become feature groups of a single
    `lax.conv_general_dilated(feature_group_count=10)` call: input combos
    ``[B,*sp,10*Cin]``, kernel ``[*k, Cin, 10*Cout]``, output ``[B,*sp,10*Cout]``
    recombined to the 4 quaternion components. 10/16 the FLOPs of the
    reference's expanded conv (SURVEY.md §3.2) on the hot op.
    """
    nspatial = w.ndim - 3
    if w.shape[0] != 4 or nspatial not in (1, 2):
        raise ValueError(f"conv weights must be [4, *k, Cin, Cout], got {w.shape}")
    if strides is None:
        strides = (1,) * nspatial
    cin, cout = w.shape[-2], w.shape[-1]

    xs = x.reshape(*x.shape[:-1], 4, cin)
    xc = jnp.einsum("...ak,pa->...pk", xs, jnp.asarray(X_COMBO, x.dtype))
    xc = xc.reshape(*x.shape[:-1], 10 * cin)
    # kernel for grouped conv: [*k, Cin, 10*Cout]; group p reads input slice p
    wc = jnp.einsum("a...kn,pa->...kpn", w, jnp.asarray(W_COMBO, w.dtype))
    wc = wc.reshape(*w.shape[1:-2], cin, 10 * cout).astype(x.dtype)

    if nspatial == 1:
        dn = lax.conv_dimension_numbers(xc.shape, wc.shape, ("NWC", "WIO", "NWC"))
    else:
        dn = lax.conv_dimension_numbers(xc.shape, wc.shape, ("NHWC", "HWIO", "NHWC"))
    prods = lax.conv_general_dilated(
        xc,
        wc,
        window_strides=tuple(strides),
        padding=padding,
        dimension_numbers=dn,
        feature_group_count=10,
        precision=precision,
    )  # [B, *sp_out, 10*Cout]
    prods = prods.reshape(*prods.shape[:-1], 10, cout)
    ys = jnp.einsum("...pn,bp->...bn", prods, jnp.asarray(OUT_COMBO, prods.dtype))
    return ys.reshape(*prods.shape[:-2], 4 * cout).astype(x.dtype)


def qconv_fast10(
    x: jnp.ndarray,
    w: jnp.ndarray,
    *,
    strides: Sequence[int] | None = None,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Quaternion conv via the 10-multiplication scheme as TEN plain convs.

    Unlike `qconv_fast` (one grouped conv), each of the 10 bilinear products
    is an ordinary full real convolution ``[B,*sp,Cin] x [*k,Cin,Cout]``.
    Autodiff through this structure yields the matching 10-product adjoints
    for dx (10 transposed convs, per-product width Cin) and dW (10
    correlation convs, per-product width Cout), so the whole train step runs
    at 10/16 of the block path's FLOPs.

    Per-product output width is Cout, not 4*Cout as in the block path, so
    the products are narrow below 128 quaternion channels; qasr.models.layers
    routes per layer on that rule (variant="auto"). Verified against qconv /
    the naive 16-product oracle in tests/test_quaternion_ops.py.
    """
    nspatial = w.ndim - 3
    if w.shape[0] != 4 or nspatial not in (1, 2):
        raise ValueError(f"conv weights must be [4, *k, Cin, Cout], got {w.shape}")
    if strides is None:
        strides = (1,) * nspatial
    cin, cout = w.shape[-2], w.shape[-1]

    xs = x.reshape(*x.shape[:-1], 4, cin)
    wc = jnp.einsum(
        "a...kn,pa->p...kn", w, jnp.asarray(W_COMBO, w.dtype)
    ).astype(x.dtype)  # [10, *k, Cin, Cout]

    sample_shape = (*x.shape[:-1], cin)
    if nspatial == 1:
        dn = lax.conv_dimension_numbers(
            sample_shape, wc.shape[1:], ("NWC", "WIO", "NWC")
        )
    else:
        dn = lax.conv_dimension_numbers(
            sample_shape, wc.shape[1:], ("NHWC", "HWIO", "NHWC")
        )

    prods = []
    for p in range(10):
        terms = np.nonzero(X_COMBO[p])[0]
        xc = xs[..., int(terms[0]), :]
        if len(terms) == 2:
            xc = xc + xs[..., int(terms[1]), :]
        prods.append(
            lax.conv_general_dilated(
                xc,
                wc[p],
                window_strides=tuple(strides),
                padding=padding,
                dimension_numbers=dn,
                precision=precision,
            )
        )
    outs = []
    for b in range(4):
        acc = None
        for p in range(10):
            c = int(OUT_COMBO[b, p])
            if c == 0:
                continue
            term = prods[p] if c > 0 else -prods[p]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return jnp.concatenate(outs, axis=-1).astype(x.dtype)


def qconv_fast8(
    x: jnp.ndarray,
    w: jnp.ndarray,
    *,
    strides: Sequence[int] | None = None,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Quaternion conv via the exact rank-8 scheme as EIGHT plain convs,
    PACKED layout (round-5: the rank-8 option for fat layers outside a
    stacked chain — e.g. the QLSTM front-end's lone 128->128 layer).

    Same structure as `qconv_fast10` with the U8/V8/O8 tables: each of the
    8 bilinear products is an ordinary full real conv ``[B,*sp,Cin] x
    [*k,Cin,Cout]``, input combos are 2-sparse weighted sums, and the output
    recombination is a dense [4, 8] contraction on f32. 8/16 of the
    reference's expanded-conv FLOPs; same >= 128-channel gate as the other
    reduced-product paths. Verified against the 16-product oracle in
    tests/test_quaternion_ops.py.
    """
    nspatial = w.ndim - 3
    if w.shape[0] != 4 or nspatial not in (1, 2):
        raise ValueError(f"conv weights must be [4, *k, Cin, Cout], got {w.shape}")
    if strides is None:
        strides = (1,) * nspatial
    cin, cout = w.shape[-2], w.shape[-1]

    xs = x.reshape(*x.shape[:-1], 4, cin)
    wc = jnp.einsum(
        "a...kn,pa->p...kn", w, jnp.asarray(U8, w.dtype)
    ).astype(x.dtype)  # [8, *k, Cin, Cout]

    sample_shape = (*x.shape[:-1], cin)
    if nspatial == 1:
        dn = lax.conv_dimension_numbers(
            sample_shape, wc.shape[1:], ("NWC", "WIO", "NWC")
        )
    else:
        dn = lax.conv_dimension_numbers(
            sample_shape, wc.shape[1:], ("NHWC", "HWIO", "NHWC")
        )

    prods = []
    for p in range(8):
        terms = np.nonzero(V8[p])[0]
        a1, a2 = int(terms[0]), int(terms[1])
        xc = (
            xs[..., a1, :] * x.dtype.type(V8[p, a1])
            + xs[..., a2, :] * x.dtype.type(V8[p, a2])
        )
        prods.append(
            lax.conv_general_dilated(
                xc,
                wc[p],
                window_strides=tuple(strides),
                padding=padding,
                dimension_numbers=dn,
                precision=precision,
            )
        )
    stacked = jnp.stack(prods, axis=-2)  # [B, *sp, 8, Cout]
    ys = jnp.einsum(
        "...pn,bp->...bn", stacked, jnp.asarray(O8, accum_dtype)
    )
    return ys.reshape(*stacked.shape[:-2], 4 * cout).astype(x.dtype)


def qconv_expanded_oracle(x, w, *, strides=None, padding="SAME"):
    """Test oracle: explicitly materialized 4x-expanded real conv (the
    reference's exact computation, SURVEY.md §3.2). f32 only, at HIGHEST
    precision (no TF32); tests and chip_smoke.py certify every conv path
    against it (SURVEY.md §4 tests 1–2)."""
    w_big = jax.device_put(hamilton_expand(w))
    nspatial = w.ndim - 3
    if strides is None:
        strides = (1,) * nspatial
    if nspatial == 1:
        dn = lax.conv_dimension_numbers(x.shape, w_big.shape, ("NWC", "WIO", "NWC"))
    else:
        dn = lax.conv_dimension_numbers(x.shape, w_big.shape, ("NHWC", "HWIO", "NHWC"))
    return lax.conv_general_dilated(
        x, w_big, tuple(strides), padding, dimension_numbers=dn,
        precision=lax.Precision.HIGHEST,
    )


def qdense_fast8_from_stacked(
    x_st: jnp.ndarray,
    w: jnp.ndarray,
    *,
    precision=None,
    accum_dtype=jnp.float32,
) -> jnp.ndarray:
    """Rank-8 quaternion dense consuming the conv chain's STACKED output.

    ``x_st``: ``[B, 4, F, T, C]`` component-stacked F-major (the conv-chain
    steady state); ``w``: ``[4, F*C, N]`` with K ordered (F-major, C-minor)
    — byte-identical to the packed path's first-dense kernel, because
    ``flatten_quaternion`` maps (f, c) -> f*C + c. Returns packed
    ``[B, T, 4*N]`` (component-major), which is a FREE reshape from the
    ``[B, T, 4, N]`` einsum output.

    Why: the packed path pays a real HBM transpose at conv-stack exit
    ([B,4,F,T,C] -> [B,T,4FC]) before the first dense GEMM. Here the
    component combos index the leading dim (no repacking), the (F, C)
    contraction runs directly on the F-major layout, and the exit transpose
    disappears — while the largest-K dense GEMM in the model takes the
    rank-8 8/16 FLOP cut. dx lands back in the stacked layout with no
    transposes either (autodiff of the same einsums).
    """
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, K, N], got {w.shape}")
    b, four, f, t, c = x_st.shape
    if four != 4 or w.shape[1] != f * c:
        raise ValueError(
            f"stacked dense expects [B,4,F,T,C] with F*C == K; got {x_st.shape}"
            f" vs K={w.shape[1]}"
        )
    n = w.shape[2]
    # input combos on the leading component dim; output layout puts (f, c)
    # adjacent so the K merge is free
    xc = jnp.einsum(
        "baftc,pa->bptfc", x_st, jnp.asarray(V8, x_st.dtype)
    ).reshape(b, 8, t, f * c)
    wc = jnp.einsum("akn,pa->pkn", w, jnp.asarray(U8, w.dtype))  # [8, K, N]
    prods = jnp.einsum(
        "bptk,pkn->bptn",
        xc,
        wc.astype(x_st.dtype),
        precision=precision,
        preferred_element_type=accum_dtype,
    )
    ys = jnp.einsum("bptn,qp->btqn", prods, jnp.asarray(O8, accum_dtype))
    return ys.reshape(b, t, 4 * n).astype(x_st.dtype)


# ---------------------------------------------------------------------------
# Stacked F-major layout: the conv tower's fat layers.
#
# Activations ``[B, 4, F, T, C]``: the four quaternion components index a
# leading dim (component combos are free slices, no packed-layout reshapes)
# and the layout is identical on input and output, so a chain of conv layers
# pays one transpose at entry and one at exit. Each bilinear product of a
# reduced-product scheme is one plain real conv.
# ---------------------------------------------------------------------------


class _Scheme:
    """A bilinear decomposition of the Hamilton product:
    ``y_b = Σ_p O[b,p] · (Σ_a U[p,a] w_a) ⊛ (Σ_a V[p,a] x_a)``.

    Term tables are (index, coefficient) tuples of the sparse V and O.
    """

    def __init__(self, name, u, v, o):
        self.name = name
        self.u = np.asarray(u, np.float64)       # [P, 4] weight-side
        v = np.asarray(v, np.float64)            # [P, 4] input-side
        o = np.asarray(o, np.float64)            # [4, P] output-side
        p = self.u.shape[0]
        self.n_prods = p
        self.fwd_in = tuple(
            tuple((int(a), float(v[q, a])) for a in range(4) if v[q, a] != 0)
            for q in range(p)
        )
        self.fwd_out = tuple(
            tuple((int(b), float(o[b, q])) for b in range(4) if o[b, q] != 0)
            for q in range(p)
        )
        # dense forms, for formulations that contract against the full
        # matrices (the grouped conv)
        self.v_mat = v.copy()
        self.o_mat = o.copy()


SCHEME10 = _Scheme("fast10", W_COMBO, X_COMBO, OUT_COMBO)
SCHEME8 = _Scheme("fast8", U8, V8, O8)


def _scaled(val, coef):
    """coef * val with ±1 shortcuts (coef is a static Python float)."""
    if coef == 1.0:
        return val
    if coef == -1.0:
        return -val
    return val * val.dtype.type(coef)


def pack_to_stacked(x_ft: jnp.ndarray) -> jnp.ndarray:
    """[B, F, T, 4C] packed -> [B, 4, F, T, C] stacked (one transpose; in
    models this happens once at conv-stack entry, not per layer)."""
    b, f, t, c4 = x_ft.shape
    return jnp.moveaxis(x_ft.reshape(b, f, t, 4, c4 // 4), 3, 1)


def stacked_to_pack(x_st: jnp.ndarray) -> jnp.ndarray:
    """[B, 4, F, T, C] stacked -> [B, F, T, 4C] packed."""
    b, _, f, t, cq = x_st.shape
    return jnp.moveaxis(x_st, 1, 3).reshape(b, f, t, 4 * cq)


def _qconv_stacked_xla(x_st, w, scheme: _Scheme, padding="SAME"):
    """Reduced-product quaternion conv on the stacked F-major layout:
    ``[B, 4, F, T, Cin]`` x ``[4, kh, kw, Cin, Cout]`` -> ``[B, 4, F, T,
    Cout]``, one real conv per product."""
    # w's kernel dims are (time, freq); the stacked layout is (F, T)-major,
    # so swap them to match conv dimension numbers H=F, W=T
    wc = jnp.einsum(
        "a...kn,pa->p...kn",
        jnp.swapaxes(w, 1, 2),
        jnp.asarray(scheme.u, w.dtype),
    ).astype(x_st.dtype)  # [P, kw, kh, Cin, Cout]
    dn = lax.conv_dimension_numbers(
        x_st[:, 0].shape, wc.shape[1:], ("NHWC", "HWIO", "NHWC")
    )
    prods = []
    for p in range(scheme.n_prods):
        xc = None
        for a, coef in scheme.fwd_in[p]:
            term = _scaled(x_st[:, a], coef)
            xc = term if xc is None else xc + term
        prods.append(
            lax.conv_general_dilated(xc, wc[p], (1, 1), padding, dimension_numbers=dn)
        )
    outs = []
    for bo in range(4):
        acc = None
        for p in range(scheme.n_prods):
            for b_, coef in scheme.fwd_out[p]:
                if b_ == bo:
                    term = _scaled(prods[p], coef)
                    acc = term if acc is None else acc + term
        outs.append(acc)
    return jnp.stack(outs, axis=1)


def _conj_transpose_w(w):
    """[4, kh, kw, Cin, Cout] -> the adjoint kernel [4, kh, kw, Cout, Cin].

    The adjoint of quaternion left-multiplication is multiplication by the
    conjugate (<w⊗x, y> = <x, conj(w)⊗y> in the real inner product), so the
    transposed conv is a plain quaternion conv with conj(w), channel dims
    swapped and spatial taps flipped: dx uses the same scheme, with its
    2-sparse input combos.
    """
    wc = jnp.stack([w[0], -w[1], -w[2], -w[3]])[:, ::-1, ::-1]
    return jnp.swapaxes(wc, -1, -2)


def _stacked_dw(x_st, dy_st, w_shape, w_dtype, scheme: _Scheme):
    """dW as the linear transpose of the stacked conv (P correlation convs
    whose contraction dim is B*F*T)."""
    (dw,) = jax.linear_transpose(
        lambda w_: _qconv_stacked_xla(x_st, w_, scheme),
        jax.ShapeDtypeStruct(w_shape, w_dtype),
    )(dy_st)
    return dw


def _make_stacked_xla(scheme: _Scheme):
    @jax.custom_vjp
    def conv(x_st, w):
        return _qconv_stacked_xla(x_st, w, scheme)

    def fwd(x_st, w):
        return _qconv_stacked_xla(x_st, w, scheme), (x_st, w)

    def bwd(res, dy):
        x_st, w = res
        dx = _qconv_stacked_xla(dy, _conj_transpose_w(w), scheme, "SAME")
        return dx, _stacked_dw(x_st, dy, w.shape, w.dtype, scheme)

    conv.defvjp(fwd, bwd)
    return conv


_FAST10_STACKED_SAME = _make_stacked_xla(SCHEME10)
_FAST8_STACKED_SAME = _make_stacked_xla(SCHEME8)


def _use_custom_vjp(w, padding):
    # the conjugate-transpose dx only equals the true transpose when SAME
    # padding is symmetric, i.e. odd kernels; otherwise fall back to
    # autodiff of the plain formulation
    return padding == "SAME" and w.shape[1] % 2 == 1 and w.shape[2] % 2 == 1


def qconv_fast10_stacked(x_st, w, *, padding="SAME"):
    """10-product quaternion conv, stacked F-major layout."""
    if _use_custom_vjp(w, padding):
        return _FAST10_STACKED_SAME(x_st, w)
    return _qconv_stacked_xla(x_st, w, SCHEME10, padding)


def qconv_fast8_stacked(x_st, w, *, padding="SAME"):
    """Rank-8 quaternion conv, stacked F-major layout (8/16 the FLOPs of the
    reference's expanded conv; see quaternion.py U8/V8/O8)."""
    if _use_custom_vjp(w, padding):
        return _FAST8_STACKED_SAME(x_st, w)
    return _qconv_stacked_xla(x_st, w, SCHEME8, padding)


def _qconv_stacked_grouped_xla(x_st, w, scheme: _Scheme, padding="SAME"):
    """The P product convs of a scheme as ONE conv with
    ``feature_group_count=P``: x_st [B, 4, F, T, Cin] -> [B, 4, F, T, Cout]."""
    b, _, f, t, cin = x_st.shape
    _, kh, kw, _, cout = w.shape
    p = scheme.n_prods
    wc = jnp.einsum(
        "a...kn,pa->p...kn",
        jnp.swapaxes(w, 1, 2),
        jnp.asarray(scheme.u, w.dtype),
    ).astype(x_st.dtype)  # [P, kw, kh, Cin, Cout]
    wg = jnp.moveaxis(wc, 0, 3).reshape(kw, kh, cin, p * cout)
    xc = jnp.einsum(
        "baftc,pa->bftpc", x_st, jnp.asarray(scheme.v_mat, x_st.dtype)
    ).reshape(b, f, t, p * cin)
    dn = lax.conv_dimension_numbers(
        (b, f, t, p * cin), (kw, kh, cin, p * cout), ("NHWC", "HWIO", "NHWC")
    )
    out = lax.conv_general_dilated(
        xc, wg, (1, 1), padding, dimension_numbers=dn, feature_group_count=p
    ).reshape(b, f, t, p, cout)
    y = jnp.einsum("bftpc,qp->bqftc", out, jnp.asarray(scheme.o_mat, out.dtype))
    return y.astype(x_st.dtype)


def _qconv_stacked_grouped_dx_xla(dy_st, w, scheme: _Scheme):
    """Transposed grouped conv (SAME, stride 1, odd kernels): input combos
    from O's columns, outputs through V's columns, weights flipped."""
    b, _, f, t, cout = dy_st.shape
    _, kh, kw, cin, _ = w.shape
    p = scheme.n_prods
    wc = jnp.einsum(
        "ahwkn,pa->pwhnk", w, jnp.asarray(scheme.u, w.dtype)
    )  # [P, kw, kh, Cout, Cin]
    wc = wc[:, ::-1, ::-1].astype(dy_st.dtype)
    wg = jnp.moveaxis(wc, 0, 3).reshape(kw, kh, cout, p * cin)
    dyc = jnp.einsum(
        "bqftc,qp->bftpc", dy_st, jnp.asarray(scheme.o_mat, dy_st.dtype)
    ).reshape(b, f, t, p * cout)
    dn = lax.conv_dimension_numbers(
        (b, f, t, p * cout), (kw, kh, cout, p * cin), ("NHWC", "HWIO", "NHWC")
    )
    out = lax.conv_general_dilated(
        dyc, wg, (1, 1), "SAME", dimension_numbers=dn, feature_group_count=p
    ).reshape(b, f, t, p, cin)
    dx = jnp.einsum("bftpc,pa->baftc", out, jnp.asarray(scheme.v_mat, out.dtype))
    return dx.astype(dy_st.dtype)


def _make_stacked_grouped(scheme: _Scheme):
    @jax.custom_vjp
    def conv(x_st, w):
        return _qconv_stacked_grouped_xla(x_st, w, scheme)

    def fwd(x_st, w):
        return _qconv_stacked_grouped_xla(x_st, w, scheme), (x_st, w)

    def bwd(res, dy):
        x_st, w = res
        dx = _qconv_stacked_grouped_dx_xla(dy, w, scheme)
        (dw,) = jax.linear_transpose(
            lambda w_: _qconv_stacked_grouped_xla(x_st, w_, scheme),
            jax.ShapeDtypeStruct(w.shape, w.dtype),
        )(dy)
        return dx, dw

    conv.defvjp(fwd, bwd)
    return conv


_FAST8_GROUPED_SAME = _make_stacked_grouped(SCHEME8)


def qconv_fast8_grouped(x_st, w, *, padding="SAME"):
    """Rank-8 quaternion conv as ONE feature-grouped conv (stacked F-major
    layout); same math as `qconv_fast8_stacked`. Odd-kernel SAME uses the
    transposed-conv VJP; anything else autodiff of the plain formulation."""
    if _use_custom_vjp(w, padding):
        return _FAST8_GROUPED_SAME(x_st, w)
    return _qconv_stacked_grouped_xla(x_st, w, SCHEME8, padding)
