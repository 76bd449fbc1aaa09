"""Core quaternion algebra for Hamilton-product layers.

Reference capability: the reference implements quaternion convolution/dense by
concatenating the four real weight sub-tensors (r, i, j, k) into one 4x4
block-structured real kernel and calling the backend's real conv2d/dot once
(reference: quaternion conv layer `call()` assembling ``cat_kernels_4_quaternion``;
mount was empty at build time — see SURVEY.md §0/§3.2, provenance [BASELINE][FAMILY]).

This module is the JAX redesign of that algebra:

* Packed layout: a quaternion tensor with C quaternion channels is stored as a
  real tensor with trailing dim ``4*C`` in *component-major* order
  ``[r_0..r_{C-1}, i_0..i_{C-1}, j_0..j_{C-1}, k_0..k_{C-1}]`` — i.e. it
  reshapes to ``[..., 4, C]``. This matches the reference's concat layout so
  the 4x-expanded real-conv oracle is a trivial reshape away.
* Weights are kept as a single stacked array ``W[4, ..., Cin, Cout]`` (never
  pre-expanded in checkpoints); the 4x4 block-structured real matrix is only
  materialized transiently inside jit, where XLA fuses it, or not at all in
  the reduced-product paths (qasr/ops/qlinalg.py).

Hamilton product convention (y = w ⊗ x, weight acting on the left):

    y_r = Wr·xr − Wi·xi − Wj·xj − Wk·xk
    y_i = Wr·xi + Wi·xr + Wj·xk − Wk·xj
    y_j = Wr·xj + Wj·xr + Wk·xi − Wi·xk
    y_k = Wr·xk + Wk·xr + Wi·xj − Wj·xi
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

R, I, J, K = 0, 1, 2, 3

# Block-structure tables for the 4x4 real matrix acting on a *row vector* of
# packed input components: y_b = sum_a sign[a][b] * x_a @ W[comp[a][b]].
# Rows = input component a, cols = output component b.
HAMILTON_COMP = np.array(
    [
        [R, I, J, K],
        [I, R, K, J],
        [J, K, R, I],
        [K, J, I, R],
    ],
    dtype=np.int32,
)
HAMILTON_SIGN = np.array(
    [
        [1, 1, 1, 1],
        [-1, 1, 1, -1],
        [-1, -1, 1, 1],
        [-1, 1, -1, 1],
    ],
    dtype=np.int32,
)

# E[c, a, b] = sign[a, b] * 1{comp[a, b] == c}: W_big's (a,b) block is
# sum_c E[c,a,b] * w[c], which lets the whole 4x4 block expansion run as one
# tiny tensor contraction already laid out in block order (no transpose).
HAMILTON_E = np.zeros((4, 4, 4), np.float32)
for _a in range(4):
    for _b in range(4):
        HAMILTON_E[int(HAMILTON_COMP[_a, _b]), _a, _b] = float(
            HAMILTON_SIGN[_a, _b]
        )


def split_components(x: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """Split packed ``[..., 4C]`` into four ``[..., C]`` components (r,i,j,k)."""
    c4 = x.shape[-1]
    if c4 % 4:
        raise ValueError(f"packed quaternion dim must be divisible by 4, got {c4}")
    c = c4 // 4
    return tuple(x[..., n * c : (n + 1) * c] for n in range(4))


def pack_components(r, i, j, k) -> jnp.ndarray:
    """Concatenate four ``[..., C]`` components into packed ``[..., 4C]``."""
    return jnp.concatenate([r, i, j, k], axis=-1)


def hamilton_expand(w: jnp.ndarray, conjugate: bool = False) -> jnp.ndarray:
    """Expand stacked quaternion weights into the 4x4 block real matrix.

    Args:
      w: ``[4, *spatial, Cin, Cout]`` stacked component weights.
      conjugate: expand conj(w) instead (negates i,j,k blocks) — used by
        transposed/adjoint ops.

    Returns:
      ``[*spatial, 4*Cin, 4*Cout]`` block-structured real weights, the exact
      matrix the reference materializes every step (SURVEY.md §3.2). Here it is
      only built transiently inside jit for the XLA fallback path.
    """
    if conjugate:
        w = jnp.concatenate([w[:1], -w[1:]], axis=0)
    out_shape = (*w.shape[1:-2], 4 * w.shape[-2], 4 * w.shape[-1])
    if w.dtype == jnp.bfloat16:
        # Contraction form: the einsum output is already in block order
        # ([*sp, a, K, b, N]) so no transpose is needed, and its backward is a
        # clean contraction too (no scatter). The 0/±1 selection is exact
        # in bf16. Chosen over 16-concat and gather+transpose on the
        # previous accelerator; not yet measured on the GPU.
        wb = jnp.einsum(
            "cab,c...kn->...akbn", jnp.asarray(HAMILTON_E, w.dtype), w
        )
        return wb.reshape(out_shape)
    # f32/f64: exact selection via gather + signed scale + transpose.
    n_sp = w.ndim - 3
    wb = jnp.take(w, jnp.asarray(HAMILTON_COMP.reshape(-1)), axis=0)
    wb = wb.reshape(4, 4, *w.shape[1:])
    sign = jnp.asarray(HAMILTON_SIGN, w.dtype).reshape(4, 4, *([1] * (w.ndim - 1)))
    wb = wb * sign
    # [a, b, *sp, K, N] -> [*sp, a, K, b, N] -> [*sp, 4K, 4N]
    perm = tuple(range(2, 2 + n_sp)) + (0, 2 + n_sp, 1, 3 + n_sp)
    wb = jnp.transpose(wb, perm)
    return wb.reshape(out_shape)


# ---------------------------------------------------------------------------
# 10-multiplication Hamilton product (Karatsuba-style bilinear scheme).
#
# The reference computes the Hamilton product as 16 block products (one
# 4x-expanded real conv/GEMM, SURVEY.md §3.2). The product bilinear form
# admits a 10-real-multiplication scheme built from pairwise component sums:
#
#   m1..m4 = Wr·xr, Wi·xi, Wj·xj, Wk·xk
#   m5 = (Wr+Wi)(xr+xi)   m6 = (Wj−Wk)(xj+xk)
#   m7 = (Wr+Wj)(xr+xj)   m8 = (Wk−Wi)(xk+xi)
#   m9 = (Wr+Wk)(xr+xk)   m10 = (Wi−Wj)(xi+xj)
#
#   y_r = m1 − m2 − m3 − m4
#   y_i = (m5 − m1 − m2) + (m6 − m3 + m4)
#   y_j = (m7 − m1 − m3) + (m8 − m4 + m2)
#   y_k = (m9 − m1 − m4) + (m10 − m2 + m3)
#
# For conv/GEMM each "multiplication" is a real matmul, so this is
# a 16→10 FLOP reduction (1.6x) at the cost of cheap elementwise combos.
# Verified against the naive product in tests/test_quaternion_ops.py.
# ---------------------------------------------------------------------------

# rows: the 10 products; columns: (r, i, j, k) coefficients
X_COMBO = np.array(
    [
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [1, 1, 0, 0], [0, 0, 1, 1], [1, 0, 1, 0], [0, 1, 0, 1],
        [1, 0, 0, 1], [0, 1, 1, 0],
    ],
    dtype=np.float32,
)
W_COMBO = np.array(
    [
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [1, 1, 0, 0], [0, 0, 1, -1], [1, 0, 1, 0], [0, -1, 0, 1],
        [1, 0, 0, 1], [0, 1, -1, 0],
    ],
    dtype=np.float32,
)
# rows: output components (r, i, j, k); columns: the 10 products
OUT_COMBO = np.array(
    [
        [1, -1, -1, -1, 0, 0, 0, 0, 0, 0],
        [-1, -1, -1, 1, 1, 1, 0, 0, 0, 0],
        [-1, 1, -1, -1, 0, 0, 1, 1, 0, 0],
        [-1, -1, 1, -1, 0, 0, 0, 0, 1, 1],
    ],
    dtype=np.float32,
)


# ---------------------------------------------------------------------------
# Rank-8 Hamilton product (the bilinear rank of quaternion multiplication is
# exactly 8). Found by sparsity-constrained ALS on the product tensor
# (tools/find_rank8.py) and verified exact to f64 precision in
# tests/test_quaternion_ops.py:
#
#   prod_p = (Σ_a U8[p,a] w_a) · (Σ_a V8[p,a] x_a),   p = 0..7
#   y_b    = Σ_p O8[b,p] prod_p
#
# V8 has two nonzeros per row (input combos stay one FMA on the VPU); U8
# lives on the weight side, precomputed for free; O8 is dense but the
# recombination is f32-accumulator FMAs. max|U8| ≈ 2.0, so bf16 rounding of
# the weight combos is amplified no worse than the 10-product scheme's ±1
# combos. 8/16 the products of the reference's expanded conv — a 2.0x
# FLOP cut (vs 1.6x for the 10-product scheme).
# ---------------------------------------------------------------------------

U8 = np.array([
    [-0.41134848995960666, -1.89911105715955, -1.6081577100916444, -0.2830177865031355],
    [-2.0002010968731994, 1.1923724898812937, -0.14584853038532697, -0.039972063029792726],
    [-1.7575503310010283, 0.3525711467091218, 0.23758858505076308, -1.3885017354386253],
    [-1.2647601436934603, -1.9928792483501931, -0.20893727813149843, -0.026890051237025675],
    [-1.422885414406715, -0.41364218483401466, -0.41268414926265184, 1.356973490598023],
    [-0.41348667546468526, 0.3752519092863721, -1.118442139724733, -1.7062214536864513],
    [0.43514041891738603, -1.4008969396946274, 1.4349888685965422, 0.4304451237930994],
    [0.24777709857135102, 0.5543302028802017, 1.788705629898477, -1.0215471431842396],
], dtype=np.float64)
V8 = np.array([
    [0.0, 0.4513786445826455, 0.0, 0.8923325160569082],
    [0.8446318483303761, -0.5353475887534835, 0.0, 0.0],
    [0.8475335129218723, 0.0, -0.5307418812119522, 0.0],
    [0.0, 0.0, 0.5351701533441554, 0.8447442849568957],
    [-0.7028365579661247, 0.0, -0.7113513708318894, 0.0],
    [-0.6828031123792481, -0.7306024293164547, 0.0, 0.0],
    [0.0, 0.781536511377488, 0.0, -0.6238595045214324],
    [0.0, 0.0, 0.682885397420987, -0.7305255190526655],
], dtype=np.float64)
O8 = np.array([
    [0.6261460263168904, -0.01767477854650512, -0.3870646792669045, -0.16414261279326867, 0.4094475742742699, -0.056301890266540845, 0.44752562851604755, -0.9720666782625007],
    [-0.33545488689537056, 0.9643638498922589, -0.5930157361554107, 0.23021875668841382, 0.736780997967462, 0.0320916070897509, -0.3076453760319158, -0.21721813550164476],
    [0.34554159148622104, -0.06153785859793262, 0.573149817907253, 0.011662710438349832, 0.4766460235894757, 0.9673691779622062, -0.4769016103208764, -0.05431815127358439],
    [0.6131983212115742, 0.256715911429653, -0.41232578983948065, -0.959124865654911, -0.24962975213152433, 0.24494305345008152, -0.6911150327540616, -0.0703718200778613],
], dtype=np.float64)


def hamilton_tensor() -> np.ndarray:
    """The 4x4x4 product tensor T with y_k = Σ_ij T[i,j,k] w_i x_j (the
    object the 10- and 8-product schemes decompose; used by tests)."""
    # built from the sign/component tables: y_b = Σ_a sign[a,b] x_a W[comp];
    # T[w_idx, x_idx, out] with w_idx = comp[a, b], x_idx = a
    t = np.zeros((4, 4, 4))
    for a in range(4):
        for b in range(4):
            t[HAMILTON_COMP[a, b], a, b] += float(HAMILTON_SIGN[a, b])
    return t


def hamilton_product(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamilton product of packed quaternion tensors (q1 ⊗ q2)."""
    ar, ai, aj, ak = split_components(q1)
    br, bi, bj, bk = split_components(q2)
    return pack_components(
        ar * br - ai * bi - aj * bj - ak * bk,
        ar * bi + ai * br + aj * bk - ak * bj,
        ar * bj + aj * br + ak * bi - ai * bk,
        ar * bk + ak * br + ai * bj - aj * bi,
    )


def qdense_naive(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Oracle: quaternion dense as 16 explicit component GEMMs.

    x: ``[..., 4*Cin]`` packed; w: ``[4, Cin, Cout]``. Slow/reference path used
    only in tests (SURVEY.md §4 test 1).
    """
    xs = split_components(x)
    outs = []
    for b in range(4):
        acc = None
        for a in range(4):
            term = HAMILTON_SIGN[a, b] * (xs[a] @ w[HAMILTON_COMP[a, b]])
            acc = term if acc is None else acc + term
        outs.append(acc)
    return jnp.concatenate(outs, axis=-1)
