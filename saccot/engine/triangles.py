"""Compatibility-triangle (COT) pool: ranking + guided sampling, static shapes.

The reference enumerates all 3-cliques of the compatibility graph into an
adjacency-list structure, ranks them, and samples in ranked order
(SURVEY.md section 2.1, "Triangle (COT) enumeration"/"Triangle ranking").
That enumeration is inherently data-dependent-size; XLA requires static
shapes. This module implements the behaviorally-equivalent fixed-budget
contract:

  1. anchors: the `num_anchors` nodes with the highest weighted degree
     (degree = row-sum of the virtual score matrix — well-connected
     correspondences are overwhelmingly the true inliers);
  2. per anchor, its `neighbors_per_anchor` strongest edges (top-k by score);
  3. candidate triangles = anchor + every pair of its selected neighbors,
     scored s_ij + s_ik + s_jk and validated (all three edges present,
     indices distinct);
  4. de-duplicate (sort-free cross-anchor membership test — a triangle
     appears once per vertex that is an anchor holding the other two in
     its top-B; the smallest-slot copy is kept), canonicalize via a
     min/max network, and select the global top-`max_hypotheses` by
     score (exact `lax.top_k`; `approx_topk` swaps in `lax.approx_max_k`).

With num_anchors >= N and neighbors_per_anchor >= N-1 the candidate set is a
superset of the exhaustive clique enumeration, so ranked truncation matches
the oracle exactly — that regime is what the parity tests run. Production
configs use budgets that keep the pool a few x max_hypotheses.

The hot-path entry is `triangle_pool_from_points`, which consumes only the
precomputed degrees plus raw points — the dense N x N score matrix is never
built (see engine/compat.py module docstring). `triangle_pool` (from a dense
S) remains for tests and small-N debugging.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from saccot.engine import compat as compat_mod
from saccot.utils.params import SacCotParams


# Largest node counts for which a canonical triple packs losslessly into
# one / two int32 sort keys (Nn^3 - 1 < 2^31 and Nn^2 + Nn - 1 < 2^31).
_PACK1_MAX_NODES = 1290
_PACK2_MAX_NODES = 46340


class TrianglePool(NamedTuple):
    # [K, 3] int32 node triples. Canonical i<j<k when dedup_triangles=True;
    # with dedup off the (anchor, nbr, nbr) order is kept as-is — the
    # 3-point solve and scoring are permutation-invariant, so no
    # canonicalizing sort is needed. Padded entries arbitrary.
    triples: jnp.ndarray
    scores: jnp.ndarray   # [K] float32, -1 for padded/invalid entries
    valid: jnp.ndarray    # [K] bool


def pair_scores(
    pa: jnp.ndarray,
    pb: jnp.ndarray,
    qa: jnp.ndarray,
    qb: jnp.ndarray,
    params: SacCotParams,
) -> jnp.ndarray:
    """Elementwise compatibility score of point pairs (same formula as
    `compat.score_block`, shared so the threshold logic lives once)."""
    dp = jnp.linalg.norm(pa - pb, axis=-1)
    dq = jnp.linalg.norm(qa - qb, axis=-1)
    delta = jnp.abs(dp - dq)
    ok = (
        (delta < params.compat_tau)
        & (dp > params.min_separation)
        & (dq > params.min_separation)
    )
    return jnp.where(ok, 1.0 - delta / params.compat_tau, 0.0)


def edge_scores_from_points(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    idx_a: jnp.ndarray,
    idx_b: jnp.ndarray,
    params: SacCotParams,
) -> jnp.ndarray:
    """Compatibility score of edges (idx_a, idx_b), gathering only point rows."""
    s = pair_scores(P[idx_a], P[idx_b], Q[idx_a], Q[idx_b], params)
    return jnp.where(idx_a != idx_b, s, 0.0)


def triangle_pool_from_points(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    deg: jnp.ndarray,
    params: SacCotParams,
    mask: Optional[jnp.ndarray] = None,
    anchor_axis: Optional[str] = None,
) -> TrianglePool:
    """Hot-path pool builder: degrees + points in, ranked triangles out.

    Anchor rows of the virtual score matrix are recomputed from points
    ([A, N] — A x N work, not N^2), so nothing quadratic in N is ever
    materialized here.

    `anchor_axis`: optional mesh axis to shard the ANCHOR dimension over
    (the SP/corr axis in the sharded estimator): per-anchor work is
    anchor-local, so each device scores A/d anchors against the (gathered)
    point set and one tiny all_gather of the [A/d, T] candidate stats
    reassembles the identical global pool — triangle scores and sampled
    indices are computed shard-parallel rather than replicated
    (SURVEY.md section 5, long-context row). Exact: contiguous anchor
    slices concatenate in axis order. Applies only with
    `per_anchor_candidates > 0`; the other paths (exhaustive candidates,
    dedup ranking) need the full candidate set on every device and stay
    replicated.
    """
    N = P.shape[0]
    A = min(params.num_anchors, N)
    _, anchors = lax.top_k(deg, A)
    shard = None
    if anchor_axis is not None and params.per_anchor_candidates > 0:
        d_ax = lax.axis_size(anchor_axis)
        if A % d_ax == 0 and d_ax > 1:
            a_loc = A // d_ax
            a0 = lax.axis_index(anchor_axis) * a_loc
            shard = (anchor_axis, a0, a_loc)
    my_anchors = _slice_anchors(anchors, shard)
    # mask_rows matters: when fewer than A correspondences are valid (the
    # common padded-pipeline case), top_k must still fill the anchor budget
    # with masked degree-0 nodes — without zeroing their rows, garbage
    # triangles through padded points would enter the pool as "valid".
    rows = compat_mod.score_block(
        P[my_anchors], Q[my_anchors], P, Q, params,
        row_ids=my_anchors,
        mask_rows=None if mask is None else mask[my_anchors],
        mask_cols=mask,
    )  # [A (or A/d), N]
    B = min(params.neighbors_per_anchor, N - 1)
    nbr_s, nbr_idx = lax.top_k(rows, B)
    return _pool_from_neighbors(
        my_anchors, nbr_s, nbr_idx, P, Q, params,
        all_anchors=anchors, shard=shard,
    )


def _slice_anchors(anchors, shard):
    if shard is None:
        return anchors
    _, a0, a_loc = shard
    return lax.dynamic_slice_in_dim(anchors, a0, a_loc, axis=0)


def _gather_anchor_shards(shard, *arrs):
    """all_gather each [A/d, ...] shard back to [A, ...] in axis order."""
    if shard is None:
        return arrs if len(arrs) > 1 else arrs[0]
    axis, _, _ = shard
    out = tuple(
        lax.all_gather(a, axis, tiled=True) for a in arrs
    )
    return out if len(out) > 1 else out[0]


def triangle_pool(
    S: jnp.ndarray,
    params: SacCotParams,
    P: Optional[jnp.ndarray] = None,
    Q: Optional[jnp.ndarray] = None,
) -> TrianglePool:
    """Pool builder from a dense score matrix S [N, N] (test/debug path)."""
    N = S.shape[-1]
    A = min(params.num_anchors, N)
    deg = jnp.sum(S, axis=-1)
    _, anchors = lax.top_k(deg, A)
    B = min(params.neighbors_per_anchor, N - 1)
    nbr_s, nbr_idx = lax.top_k(S[anchors], B)  # [A, B]
    return _pool_from_neighbors(anchors, nbr_s, nbr_idx, P, Q, params, S=S)


def _pool_from_neighbors(
    anchors: jnp.ndarray,   # [A] global node indices
    nbr_s: jnp.ndarray,     # [A, B] per-anchor neighbor scores, descending
    nbr_idx: jnp.ndarray,   # [A, B] per-anchor neighbor column indices
    P: Optional[jnp.ndarray],
    Q: Optional[jnp.ndarray],
    params: SacCotParams,
    S: Optional[jnp.ndarray] = None,
    all_anchors: Optional[jnp.ndarray] = None,
    shard=None,
) -> TrianglePool:
    """Candidate triangles (anchor, nbr b1, nbr b2), b1 < b2, -> the pool.

    With `per_anchor_candidates` = T > 0 each anchor's candidates are first
    cut to its own top T (`lax.top_k` per row: score descending, ties to
    the lowest pair slot in np.triu_indices order), and the global top-K
    runs over A*T survivors. Under `shard` the rows are this device's
    anchor slice and `all_anchors` the full list.
    """
    A, B = nbr_s.shape
    # Node-index range, for the packed-key dedup sort below.
    if P is not None:
        n_nodes = P.shape[0]
    elif S is not None:
        n_nodes = S.shape[-1]
    else:
        n_nodes = None

    # Static neighbor-pair template (b1 < b2).
    b1, b2 = np.triu_indices(B, k=1)
    b1 = jnp.asarray(b1, dtype=jnp.int32)
    b2 = jnp.asarray(b2, dtype=jnp.int32)

    i = jnp.broadcast_to(anchors[:, None], (A, b1.shape[0]))  # [A, Pairs]
    j = nbr_idx[:, b1]
    k = nbr_idx[:, b2]
    s_ij = nbr_s[:, b1]
    s_ik = nbr_s[:, b2]
    if P is not None and Q is not None:
        # Gather each anchor's B neighbor points ONCE ([A, B, 3]), then form
        # the B*(B-1)/2 pairs by static-index slicing. Profiling showed the
        # naive per-pair formulation (4 dynamic gathers of A*Pairs rows,
        # ~0.5M at production budgets) dominating the whole estimator; this
        # cuts dynamic-gather volume by the pair/neighbor ratio (~60x).
        nbr_p = P[nbr_idx]  # [A, B, 3]
        nbr_q = Q[nbr_idx]
        s_jk = pair_scores(
            nbr_p[:, b1, :], nbr_p[:, b2, :],  # static indices
            nbr_q[:, b1, :], nbr_q[:, b2, :],
            params,
        )
        s_jk = jnp.where(j != k, s_jk, 0.0)
    else:
        assert S is not None, "need either points or the dense S"
        s_jk = S[j, k]

    score = s_ij + s_ik + s_jk
    valid = (s_ij > 0) & (s_ik > 0) & (s_jk > 0) & (i != j) & (i != k) & (j != k)
    score = jnp.where(valid, score, -1.0)
    if params.per_anchor_candidates > 0:
        T = min(params.per_anchor_candidates, b1.shape[0])
        cand_s, sel = lax.top_k(score, T)  # [A, T]
        cand_j = jnp.take_along_axis(j, sel, axis=1)
        cand_k = jnp.take_along_axis(k, sel, axis=1)
        cand_s, cand_j, cand_k = _gather_anchor_shards(
            shard, cand_s, cand_j, cand_k
        )
        return _pool_from_preranked(
            anchors if all_anchors is None else all_anchors,
            cand_s, cand_j, cand_k, params,
        )
    dedup_done = False
    if params.dedup_triangles:
        dup = _mark_cross_anchor_duplicates(anchors, nbr_idx, nbr_s > 0, b1, b2)
        score = jnp.where(dup, -1.0, score)
        dedup_done = True
    return _rank_candidates(i, j, k, score, params, n_nodes=n_nodes,
                            dedup_done=dedup_done)


def _mark_cross_anchor_duplicates(
    anchors: jnp.ndarray,   # [A] anchor node ids (distinct)
    nbr_idx: jnp.ndarray,   # [A, B] neighbor node ids per anchor
    nbr_valid: jnp.ndarray,  # [A, B] bool: selection has positive score
    b1: jnp.ndarray,        # [Pairs] upper-triangle template
    b2: jnp.ndarray,
) -> jnp.ndarray:
    """Sort-free exact dedup mask [A, Pairs].

    A triangle {u, v, w} enters the candidate list once per VERTEX that is
    an anchor with the other two among its valid top-B neighbors — so a
    candidate at anchor slot `a` is a duplicate iff one of its neighbor
    vertices is an anchor at a SMALLER slot that also generates it
    (validity of the third edge is shared — edge scores are symmetric —
    so only the two membership tests differ). Keeping the smallest-slot
    generator keeps exactly one copy of every triangle: any consistent
    copy choice yields the identical canonical-triple SET, which is all
    the ranking consumes.

    Everything is batched compares + one tiny einsum — no sorts and no
    gathers:
      match[a, b, x] : neighbor (a, b) is anchor slot x
      W[x, a]        : anchor a's node is a valid neighbor of anchor x
      R3/V3[a, b, c] : the top-B row of slot(a,b)'s anchor, selected by
                       the one-hot `match` contraction (node ids < 2^24,
                       exact in f32)
    """
    A, B = nbr_idx.shape
    match = (
        (nbr_idx[:, :, None] == anchors[None, None, :]) & nbr_valid[:, :, None]
    )  # [A, B, X]
    matchf = match.astype(jnp.float32)
    # W[x, a]: anchors[a] in topB(x) with positive score — the same compare
    # tensor reduced over the neighbor slot.
    W = jnp.any(match, axis=1)  # [X(owning anchor), A(tested anchor)]
    xlt = (
        jax.lax.broadcasted_iota(jnp.int32, (A, A), 1)
        < jax.lax.broadcasted_iota(jnp.int32, (A, A), 0)
    )  # [A(slot a), X]: x < a
    # gate[a, b]: neighbor (a, b) is an EARLIER anchor x with anchors[a]
    # among x's valid neighbors.
    gatef = jnp.einsum(
        "abx,ax->ab", matchf,
        (xlt & W.T).astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    gate = gatef > 0.5  # [A, B]
    # R3[a, b, c] = nbr_idx[slot(a,b), c]; V3 its validity. One-hot einsum
    # instead of a gather (node ids exact in f32 below 2^24).
    R3 = jnp.einsum("abx,xc->abc", matchf, nbr_idx.astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST)
    V3 = jnp.einsum("abx,xc->abc", matchf,
                    nbr_valid.astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST)
    R3 = jnp.round(R3).astype(jnp.int32)          # [A, B, C]
    V3ok = V3 > 0.5

    # in_row[a, b, t]: nbr_idx[a, t] is a valid neighbor of slot(a,b)'s
    # anchor — [A, B, T] via one [A, B, C, T] compare block.
    in_row = jnp.any(
        (R3[:, :, :, None] == nbr_idx[:, None, None, :]) & V3ok[:, :, :, None],
        axis=2,
    )  # [A, B(which neighbor is the anchor), T(which vertex to test)]

    # Candidate (a, b1, b2): duplicate via b1 iff gate[a, b1] and vertex
    # b2 in that anchor's row; symmetrically via b2. b1/b2 are STATIC
    # templates, so this advanced indexing folds at trace time.
    dup = (gate[:, b1] & in_row[:, b1, b2]) | (gate[:, b2] & in_row[:, b2, b1])
    return dup  # [A, Pairs]


def _rank_candidates(
    i: jnp.ndarray,       # [A, Pairs] anchor node ids
    j: jnp.ndarray,       # [A, Pairs] neighbor-1 node ids
    k: jnp.ndarray,       # [A, Pairs] neighbor-2 node ids
    score: jnp.ndarray,   # [A, Pairs] candidate scores, -1 = invalid
    params: SacCotParams,
    n_nodes: Optional[int],
    dedup_done: bool = False,
) -> TrianglePool:
    """Canonicalize -> (optional dedup) -> global top-K of a candidate set.

    dedup_done=True: cross-anchor duplicates were already invalidated
    (`_mark_cross_anchor_duplicates`), so the exact path needs NO sort at
    all — canonical min/max network, packed-key arithmetic, one exact
    top-K over the flat candidates, one [K] key gather, decode.
    """
    K = params.max_hypotheses
    Nn = n_nodes
    score = score.reshape(-1)

    if not params.dedup_triangles:
        # No dedup -> no need for the canonical i<j<k triple: the 3-point
        # solve and scoring are permutation-invariant. Keep (anchor, j, k)
        # order as-is.
        ss = score
        tri_cols = (
            i.reshape(-1).astype(jnp.int32),
            j.reshape(-1).astype(jnp.int32),
            k.reshape(-1).astype(jnp.int32),
        )
        return _select_topk(tri_cols, ss, params)

    # Canonicalize with a 3-element min/max sorting network on the flat
    # index columns (6 elementwise ops instead of a size-3 sort).
    if dedup_done:
        fi = i.reshape(-1).astype(jnp.int32)
        fj = j.reshape(-1).astype(jnp.int32)
        fk = k.reshape(-1).astype(jnp.int32)
        a0 = jnp.minimum(fi, fj)
        b0 = jnp.maximum(fi, fj)
        lo2 = jnp.minimum(b0, fk)
        hi = jnp.maximum(b0, fk)
        lo = jnp.minimum(a0, lo2)
        mid = jnp.maximum(a0, lo2)
        top_s, top_i = _topk_fn(score, params)
        if Nn is not None and Nn <= _PACK1_MAX_NODES:
            key = (lo * Nn + mid) * Nn + hi
            keysel = key[top_i]
            rem = keysel % (Nn * Nn)
            tri_cols = (keysel // (Nn * Nn), rem // Nn, rem % Nn)
        elif Nn is not None and Nn <= _PACK2_MAX_NODES:
            kjk = mid * Nn + hi
            losel = lo[top_i]
            kjksel = kjk[top_i]
            tri_cols = (losel, kjksel // Nn, kjksel % Nn)
        else:
            tri_cols = (lo[top_i], mid[top_i], hi[top_i])
        return _pool_from_selected(tri_cols, top_s, params)

    # Dedup is the sort-free cross-anchor membership test
    # (_mark_cross_anchor_duplicates); every caller runs it first.
    raise ValueError(
        "dedup_triangles=True requires the caller to invalidate cross-"
        "anchor duplicates (_mark_cross_anchor_duplicates) and pass "
        "dedup_done=True"
    )


def _pool_from_preranked(
    anchors: jnp.ndarray,    # [A] anchor node ids
    cand_s: jnp.ndarray,     # [A, T] per-anchor top-T candidate scores
    cand_j: jnp.ndarray,     # [A, T] int32 global node id of neighbor b1
    cand_k: jnp.ndarray,     # [A, T] int32 global node id of neighbor b2
    params: SacCotParams,
) -> TrianglePool:
    """Global top-K over per-anchor preranked candidates.

    In the identity regime (A*T <= K) this assembly is pure reshape/repeat
    work: no top-k and no index gathers."""
    A, T = cand_s.shape
    K = params.max_hypotheses
    flat_s = cand_s.reshape(-1)
    k_sel = min(K, flat_s.shape[0])
    if k_sel == flat_s.shape[0]:
        # A*T <= K: every preranked candidate enters the pool — selection
        # is the identity and the (expensive) top-k + index gathers vanish.
        # Downstream only argmaxes over hypothesis scores, so order is
        # irrelevant.
        top_s = flat_s
        i = jnp.repeat(anchors.astype(jnp.int32), T)
        j = cand_j.reshape(-1)
        k = cand_k.reshape(-1)
    elif params.approx_topk:
        top_s, top_i = lax.approx_max_k(flat_s, k_sel)
        a = (top_i // T).astype(jnp.int32)
        i = anchors[a]
        j = cand_j.reshape(-1)[top_i]
        k = cand_k.reshape(-1)[top_i]
    else:
        top_s, top_i = lax.top_k(flat_s, k_sel)
        a = (top_i // T).astype(jnp.int32)
        i = anchors[a]
        j = cand_j.reshape(-1)[top_i]
        k = cand_k.reshape(-1)[top_i]
    triples = jnp.stack([i, j, k], axis=-1).astype(jnp.int32)
    if top_s.shape[0] < K:  # pad to the static budget
        pad = K - top_s.shape[0]
        triples = jnp.concatenate([triples, jnp.zeros((pad, 3), jnp.int32)], axis=0)
        top_s = jnp.concatenate([top_s, jnp.full((pad,), -1.0, top_s.dtype)], axis=0)
    return TrianglePool(triples=triples, scores=top_s, valid=top_s > 0)


def _topk_fn(ss, params: SacCotParams):
    k_sel = min(params.max_hypotheses, ss.shape[0])
    if params.approx_topk:
        return lax.approx_max_k(ss, k_sel)
    return lax.top_k(ss, k_sel)


def _pool_from_selected(tri_cols, top_s, params: SacCotParams) -> TrianglePool:
    K = params.max_hypotheses
    triples = jnp.stack(tri_cols, axis=-1).astype(jnp.int32)
    if top_s.shape[0] < K:  # pad to the static budget
        pad = K - top_s.shape[0]
        triples = jnp.concatenate([triples, jnp.zeros((pad, 3), jnp.int32)], axis=0)
        top_s = jnp.concatenate([top_s, jnp.full((pad,), -1.0, top_s.dtype)], axis=0)
    return TrianglePool(triples=triples, scores=top_s, valid=top_s > 0)


def _select_topk(tri_cols, ss, params: SacCotParams) -> TrianglePool:
    top_s, top_i = _topk_fn(ss, params)
    return _pool_from_selected([c[top_i] for c in tri_cols], top_s, params)
