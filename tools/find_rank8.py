#!/usr/bin/env python
"""Find rank-8 bilinear decompositions of the quaternion product.

Produced the U8/V8/O8 scheme embedded in qasr/ops/quaternion.py (seed 8 of
`python tools/find_rank8.py 2 16 120` — exact to f64 with max|U| = 2.0).
The bilinear rank of quaternion multiplication is exactly 8 (De Groote);
x-side rows (V) and out-side columns (O) only need to be SPARSE (<= k nnz) —
coefficients can be arbitrary reals since a VPU FMA costs the same as an
add. U (w-side) is free: weight combos are precomputed.
Hard-thresholded ALS with restarts; verify exact residual.
"""
import sys
import numpy as np

T = np.zeros((4, 4, 4))
terms = [
    (0,0,0,1), (1,1,0,-1), (2,2,0,-1), (3,3,0,-1),
    (0,1,1,1), (1,0,1,1), (2,3,1,1), (3,2,1,-1),
    (0,2,2,1), (2,0,2,1), (3,1,2,1), (1,3,2,-1),
    (0,3,3,1), (3,0,3,1), (1,2,3,1), (2,1,3,-1),
]
for i, j, k, s in terms:
    T[i, j, k] = s
R = 8
Tm = T.reshape(4, 16)
Tj = T.transpose(1, 0, 2).reshape(4, 16)
Tk = T.transpose(2, 0, 1).reshape(4, 16)


def resid(U, V, O):
    return np.abs(np.einsum("pi,pj,kp->ijk", U, V, O) - T).max()


def hard_threshold_rows(M, k):
    out = M.copy()
    for r in range(M.shape[0]):
        idx = np.argsort(-np.abs(M[r]))
        out[r, idx[k:]] = 0.0
    return out


def solve_U(V, O):
    M = np.einsum("pj,kp->pjk", V, O).reshape(R, 16)
    U, *_ = np.linalg.lstsq(M.T, Tm.T, rcond=None)
    return U


def solve_V(U, O):
    M = np.einsum("pi,kp->pik", U, O).reshape(R, 16)
    V, *_ = np.linalg.lstsq(M.T, Tj.T, rcond=None)
    return V


def solve_O(U, V):
    M = np.einsum("pi,pj->pij", U, V).reshape(R, 16)
    O, *_ = np.linalg.lstsq(M.T, Tk.T, rcond=None)
    return O.T


def run(seed, kv, ko, iters=6000, anneal_at=2000):
    rr = np.random.default_rng(seed)
    U = rr.standard_normal((R, 4))
    V = rr.standard_normal((R, 4))
    O = rr.standard_normal((4, R))
    for it in range(iters):
        U = solve_U(V, O)
        V = solve_V(U, O)
        if it > anneal_at:
            V = hard_threshold_rows(V, kv)
        O = solve_O(U, V)
        if it > anneal_at:
            O = hard_threshold_rows(O.T, ko).T
        for p in range(R):
            s = np.linalg.norm(V[p]) + 1e-12
            V[p] /= s; U[p] *= s
            s = np.linalg.norm(O[:, p]) + 1e-12
            O[:, p] /= s; U[p] *= s
    # final: freeze sparsity patterns, re-solve to convergence
    for it in range(500):
        U = solve_U(V, O)
        Vn = solve_V(U, O)
        V = np.where(V != 0, Vn, 0.0)
        On = solve_O(U, V)
        O = np.where(O != 0, On, 0.0)
    return U, V, O, resid(U, V, O)


best = None
# defaults reproduce the embedded scheme: kv=2 (2-sparse x combos),
# ko=16 (O sparsity target; dense solutions still accepted), 120 seeds
kv = int(sys.argv[1]) if len(sys.argv) > 1 else 2
ko = int(sys.argv[2]) if len(sys.argv) > 2 else 16
for seed in range(int(sys.argv[3]) if len(sys.argv) > 3 else 120):
    U, V, O, r = run(seed, kv, ko)
    if r < 1e-9:
        nnz_v = int((np.abs(V) > 1e-12).sum()); nnz_o = int((np.abs(O) > 1e-12).sum())
        maxu = np.abs(U).max()
        score = (maxu, nnz_o)  # conditioning first (bf16 wc rounding!)
        print(f"seed {seed}: EXACT nnzV={nnz_v} nnzO={nnz_o} max|U|={maxu:.2f}", flush=True)
        if best is None or score < best[0]:
            best = (score, U.copy(), V.copy(), O.copy())
    else:
        print(f"seed {seed}: r={r:.2e}", flush=True)

if best:
    (score, U, V, O) = best
    print('BEST max|U|=%.2f nnzO=%d' % score)
    np.set_printoptions(precision=6, suppress=True, linewidth=140)
    print("U=\n", U); print("V=\n", V); print("O=\n", O)
    np.savez("rank8.npz", U=U, V=V, O=O)
    print("saved rank8.npz")
