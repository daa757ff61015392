"""NumPy oracle for SAC-COT — the framework's "reference CPU" implementation.

The mounted reference (/root/reference/README.md:1-2) ships no code, only the
identification of the SAC-COT paper; this module is an independently written,
obviously-correct implementation of that paper's estimator, used as

1. the correctness baseline every JAX/Pallas stage is tested against, and
2. the CPU throughput baseline for the ">=10x CPU pairs/sec per chip" target
   (BASELINE.md).

Algorithm (paper structure, SURVEY.md section 2.1):
  correspondences -> rigidity-compatibility graph -> 3-clique ("compatibility
  triangle", COT) enumeration -> triangle ranking -> guided sampling in ranked
  order -> 3-point SVD (Horn/Umeyama) per sample -> inlier-count scoring ->
  best transform (+ inlier re-fit polish).

Everything here favors clarity over speed; it is still vectorized enough to
serve as a fair CPU baseline (batched numpy throughout, no Python-level
per-correspondence loops).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from saccot.utils.params import SacCotParams


def compat_scores(
    P: np.ndarray,
    Q: np.ndarray,
    params: SacCotParams,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Dense rigidity-compatibility score matrix S[N, N].

    S[i, j] = (1 - |d_p - d_q| / compat_tau)  if the pair (i, j) is
    rigidity-compatible (|d_p - d_q| < compat_tau) and both intra-cloud
    distances exceed min_separation, else 0. Diagonal is 0. Scores lie in
    (0, 1]; an edge of the compatibility graph exists iff S > 0.
    """
    P = np.asarray(P, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    dp = np.linalg.norm(P[:, None, :] - P[None, :, :], axis=-1)
    dq = np.linalg.norm(Q[:, None, :] - Q[None, :, :], axis=-1)
    delta = np.abs(dp - dq)
    ok = (delta < params.compat_tau) & (dp > params.min_separation) & (dq > params.min_separation)
    S = np.where(ok, 1.0 - delta / params.compat_tau, 0.0)
    np.fill_diagonal(S, 0.0)
    if mask is not None:
        m = np.asarray(mask, dtype=bool)
        S = S * m[:, None] * m[None, :]
    return S


def enumerate_triangles(S: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All 3-cliques of the compatibility graph, with their scores.

    Returns (triples[M, 3] int with i < j < k, scores[M]) where
    score = S[i,j] + S[i,k] + S[j,k]. Exhaustive enumeration via common-
    neighbor intersection per edge — the oracle analog of the reference's
    adjacency-list intersection (SURVEY.md section 2.1, "Triangle (COT)
    enumeration").
    """
    A = S > 0.0
    n = A.shape[0]
    ii, jj = np.nonzero(np.triu(A, k=1))
    if ii.size == 0:
        return np.zeros((0, 3), dtype=np.int64), np.zeros((0,), dtype=np.float64)

    # Vectorized common-neighbor intersection over packed bitsets: for every
    # edge (i, j), the triangles through it are the set bits of
    # row(i) & row(j) & {k > j}. This is the same adjacency-intersection the
    # reference's C++ would do, in honest vectorized NumPy (it is also the
    # CPU throughput baseline, so it must not be a strawman).
    bits = np.packbits(A, axis=1)  # [n, ceil(n/8)] uint8
    # suffix_mask[j] has bits set exactly for indices > j
    tri_upper = ~np.tri(n, n, k=0, dtype=bool)  # strict upper: col > row
    suffix = np.packbits(tri_upper, axis=1)  # [n, nb]

    triples_list = []
    scores_list = []
    edge_block = max(1, int(2e8) // max(n, 1))  # cap unpacked block at ~200MB
    for s0 in range(0, ii.size, edge_block):
        sl = slice(s0, min(s0 + edge_block, ii.size))
        common = bits[ii[sl]] & bits[jj[sl]] & suffix[jj[sl]]  # [e, nb]
        ks_mask = np.unpackbits(common, axis=1, count=n).astype(bool)  # [e, n]
        e_idx, k_idx = np.nonzero(ks_mask)
        i_idx = ii[sl][e_idx]
        j_idx = jj[sl][e_idx]
        triples_list.append(np.stack([i_idx, j_idx, k_idx], axis=1))
        scores_list.append(S[i_idx, j_idx] + S[i_idx, k_idx] + S[j_idx, k_idx])

    triples = np.concatenate(triples_list, axis=0).astype(np.int64)
    scores = np.concatenate(scores_list, axis=0).astype(np.float64)
    return triples, scores


def rank_triangles(
    triples: np.ndarray, scores: np.ndarray, max_hypotheses: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort triangles by score descending, keep the top ``max_hypotheses``.

    Ties broken by (i, j, k) lexicographic order for determinism.
    """
    if triples.shape[0] == 0:
        return triples, scores
    order = np.lexsort((triples[:, 2], triples[:, 1], triples[:, 0], -scores))
    order = order[:max_hypotheses]
    return triples[order], scores[order]


def umeyama(p: np.ndarray, q: np.ndarray, w: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted rigid alignment (no scale): find R, t minimizing sum w ||R p + t - q||^2.

    Horn/Umeyama via SVD of the weighted cross-covariance, with the det<0
    reflection fix. p, q: [M, 3]; w: [M] nonneg (default uniform).
    """
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    if w is None:
        w = np.ones(p.shape[0])
    w = np.asarray(w, dtype=np.float64)
    wsum = max(w.sum(), 1e-12)
    pbar = (w[:, None] * p).sum(0) / wsum
    qbar = (w[:, None] * q).sum(0) / wsum
    pc, qc = p - pbar, q - qbar
    H = (w[:, None] * pc).T @ qc  # 3x3 cross-covariance
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = qbar - R @ pbar
    return R, t


def umeyama_batch(p: np.ndarray, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Batched unweighted Horn/Umeyama: p, q [K, M, 3] -> (R [K,3,3], t [K,3]).

    Same algorithm as `umeyama` (SVD of the cross-covariance with the det<0
    reflection fix), batched over the hypothesis axis so the oracle scores
    all K minimal samples without a Python-level per-hypothesis loop.
    """
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    pbar = p.mean(axis=1)
    qbar = q.mean(axis=1)
    pc = p - pbar[:, None, :]
    qc = q - qbar[:, None, :]
    H = np.einsum("kmi,kmj->kij", pc, qc)  # [K, 3, 3]
    U, _, Vt = np.linalg.svd(H)
    V = np.swapaxes(Vt, -1, -2)
    Ut = np.swapaxes(U, -1, -2)
    d = np.sign(np.linalg.det(V @ Ut))  # [K]
    D = np.zeros_like(H)
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 2, 2] = d
    R = V @ D @ Ut
    t = qbar - np.einsum("kij,kj->ki", R, pbar)
    return R, t


def score_hypotheses_np(
    R: np.ndarray,
    t: np.ndarray,
    P: np.ndarray,
    Q: np.ndarray,
    params: SacCotParams,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched hypothesis scoring: one [K, N] residual einsum.

    Returns (scores [K], counts [K]): counts = inlier counts; scores follow
    params.scoring ("count" -> counts as float, "weighted" -> MSAC-style
    soft weights), identical to the per-hypothesis formulas in `sac_cot`.
    """
    # [K, N, 3] residuals in one shot.
    x = np.einsum("kij,nj->kni", R, P) + t[:, None, :] - Q[None, :, :]
    d = np.linalg.norm(x, axis=-1)  # [K, N]
    inl = d < params.inlier_tau
    if mask is not None:
        inl = inl & np.asarray(mask, dtype=bool)[None, :]
    counts = inl.sum(axis=1)
    if params.scoring == "weighted":
        w = np.maximum(0.0, 1.0 - d / params.inlier_tau)
        if mask is not None:
            w = w * np.asarray(mask, dtype=np.float64)[None, :]
        scores = w.sum(axis=1)
    else:
        scores = counts.astype(np.float64)
    return scores, counts


def count_inliers(
    R: np.ndarray,
    t: np.ndarray,
    P: np.ndarray,
    Q: np.ndarray,
    tau: float,
    mask: Optional[np.ndarray] = None,
) -> Tuple[int, np.ndarray]:
    """Inliers of hypothesis (R, t): ||R p_i + t - q_i|| < tau."""
    r = P @ R.T + t - Q
    d = np.linalg.norm(r, axis=-1)
    inl = d < tau
    if mask is not None:
        inl = inl & np.asarray(mask, dtype=bool)
    return int(inl.sum()), inl


def sac_cot(
    P: np.ndarray,
    Q: np.ndarray,
    params: SacCotParams,
    mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Full SAC-COT estimation: correspondences -> best rigid transform.

    Returns a dict with R [3,3], t [3], T [4,4], inliers [N] bool,
    num_inliers, best_score, num_triangles (clique count before truncation),
    and hypotheses_tried.
    """
    P = np.asarray(P, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    N = P.shape[0]
    S = compat_scores(P, Q, params, mask)
    triples, tri_scores = enumerate_triangles(S)
    num_triangles = triples.shape[0]
    triples, tri_scores = rank_triangles(triples, tri_scores, params.max_hypotheses)

    best = dict(
        R=np.eye(3), t=np.zeros(3), score=-1.0, num_inliers=0,
        inliers=np.zeros(N, dtype=bool),
    )
    if triples.shape[0] > 0:
        # Batched solve + score over all K hypotheses at once: [K,3,3]
        # gathers -> batched Horn -> one [K,N] residual reduction. Same
        # math as the scalar loop (umeyama/count_inliers per triple),
        # argmax keeps the first maximum exactly like sequential
        # strictly-greater replacement.
        Rk, tk = umeyama_batch(P[triples], Q[triples])
        scores_k, counts_k = score_hypotheses_np(Rk, tk, P, Q, params, mask)
        b = int(np.argmax(scores_k))
        n_inl, inl = count_inliers(
            Rk[b], tk[b], P, Q, params.inlier_tau, mask
        )
        best = dict(
            R=Rk[b], t=tk[b], score=float(scores_k[b]),
            num_inliers=n_inl, inliers=inl,
        )

    # Polish: re-fit on the inlier set, fixed iteration count (matches the
    # jitted engine's branchless refinement).
    R, t = best["R"], best["t"]
    inl = best["inliers"]
    for _ in range(params.refine_iters):
        if inl.sum() >= 3:
            R, t = umeyama(P[inl], Q[inl])
        _, inl = count_inliers(R, t, P, Q, params.inlier_tau, mask)
    n_inl = int(inl.sum())

    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return dict(
        R=R, t=t, T=T, inliers=inl, num_inliers=n_inl,
        best_score=best["score"], num_triangles=num_triangles,
        hypotheses_tried=triples.shape[0],
    )
