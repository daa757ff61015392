"""Baseline sample-consensus estimators for SAC-COT ablations.

The SAC-COT paper's core claim is that *compatibility-triangle-guided*
sampling beats uniform random sampling at equal sample budgets; reference
users reproduce that comparison against plain RANSAC and one/two-point
guided variants. This module provides those baselines as jitted, batched
estimators sharing the framework's solver and scoring machinery
(engine/svd3, engine/score), so an ablation sweep is an apples-to-apples
swap of the sampler only:

- ``ransac_register_pair``: classic 3-point RANSAC — K uniform random
  correspondence triples (with replacement across samples, distinct within
  a sample), all K solved and scored in one batch. No graph, no ranking.
- ``edge_guided_register_pair``: the intermediate ablation — samples the
  top-K *compatibility edges* (2 correspondences) and completes each with
  one uniform random third correspondence; uses the graph but not the
  triangle rank.

Everything is static-shape: "iterations" of classic RANSAC become the
hypothesis batch axis, which is how a sample-consensus loop maps onto an
accelerator — the reference's early-exit confidence test trades work for
latency on a CPU, while here the K hypotheses are one tensor op.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from saccot.engine import compat as compat_mod
from saccot.engine import score as score_mod
from saccot.engine.svd3 import transform_from_rt, umeyama
from saccot.utils.params import SacCotParams


class BaselineResult(NamedTuple):
    R: jnp.ndarray            # [3, 3]
    t: jnp.ndarray            # [3]
    T: jnp.ndarray            # [4, 4]
    inliers: jnp.ndarray      # [N] bool
    num_inliers: jnp.ndarray  # int32 scalar
    best_score: jnp.ndarray   # float32 scalar


def _score_refine(R, t, P, Q, m, params, valid):
    """Shared tail: score K hypotheses, pick best, re-fit on inliers."""
    scores, _ = score_mod.score_hypotheses(
        R, t, P, Q, params.inlier_tau, mask=m, mode=params.scoring,
        block_k=params.score_block_k,
    )
    scores = jnp.where(valid, scores, -1.0)
    best = jnp.argmax(scores)
    Rb, tb = R[best], t[best]
    inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)
    for _ in range(params.refine_iters):
        w = inl.astype(jnp.float32) * m
        Rf, tf = umeyama(P, Q, w=w)
        keep = jnp.sum(w) >= 3.0
        Rb = jnp.where(keep, Rf, Rb)
        tb = jnp.where(keep, tf, tb)
        inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)
    return BaselineResult(
        R=Rb, t=tb, T=transform_from_rt(Rb, tb), inliers=inl,
        num_inliers=jnp.sum(inl).astype(jnp.int32),
        best_score=scores[best],
    )


def _random_triples(key, n, k, mask=None):
    """[k, 3] uniform random index triples, distinct within each triple.

    Sampling is by per-correspondence random priority (top-3 of an iid
    uniform field), which is uniform over ordered distinct triples and
    respects the validity mask (masked rows get -inf priority).
    """
    u = jax.random.uniform(key, (k, n))
    if mask is not None:
        u = jnp.where(mask.astype(bool)[None, :], u, -jnp.inf)
    _, idx = lax.top_k(u, 3)
    return idx.astype(jnp.int32)


def _ransac(P, Q, mask, params: SacCotParams, seed) -> BaselineResult:
    P = P.astype(jnp.float32)
    Q = Q.astype(jnp.float32)
    N = P.shape[0]
    m = jnp.ones((N,), jnp.float32) if mask is None else mask.astype(jnp.float32)
    key = jax.random.PRNGKey(seed)
    triples = _random_triples(key, N, params.max_hypotheses, mask=m)
    R, t = umeyama(P[triples], Q[triples])
    valid = jnp.ones((params.max_hypotheses,), bool)
    return _score_refine(R, t, P, Q, m, params, valid)


def _edge_guided(P, Q, mask, params: SacCotParams, seed) -> BaselineResult:
    P = P.astype(jnp.float32)
    Q = Q.astype(jnp.float32)
    N = P.shape[0]
    K = params.max_hypotheses
    m = jnp.ones((N,), jnp.float32) if mask is None else mask.astype(jnp.float32)

    # Top-K compatibility edges by score, found from the anchor rows of the
    # virtual score matrix (same budgeted machinery as the triangle pool).
    A = min(params.num_anchors, N)
    deg = compat_mod.degrees(
        P, Q, P, Q, params, mask_rows=m, mask_cols=m,
        block_rows=min(params.degree_block_rows, N),
    )
    _, anchors = lax.top_k(deg, A)
    rows = compat_mod.score_block(
        P[anchors], Q[anchors], P, Q, params,
        row_ids=anchors, mask_rows=m[anchors], mask_cols=m,
    )  # [A, N]
    flat_s, flat_i = lax.top_k(rows.reshape(-1), K)
    ei = anchors[flat_i // N]
    ej = (flat_i % N).astype(jnp.int32)

    # Complete each edge with one uniform random third point (!= i, j by
    # priority masking of the two edge members).
    u = jax.random.uniform(jax.random.PRNGKey(seed), (K, N))
    u = jnp.where(m.astype(bool)[None, :], u, -jnp.inf)
    cols = lax.broadcasted_iota(jnp.int32, (K, N), 1)
    u = jnp.where((cols == ei[:, None]) | (cols == ej[:, None]), -jnp.inf, u)
    ek = jnp.argmax(u, axis=1).astype(jnp.int32)

    triples = jnp.stack([ei, ej, ek], axis=-1)
    R, t = umeyama(P[triples], Q[triples])
    valid = flat_s > 0
    return _score_refine(R, t, P, Q, m, params, valid)


# Module-level jitted wrappers: one trace per params value, with `seed`
# traced (PRNGKey accepts traced ints) so new seeds never retrace.
_ransac_jit = functools.partial(jax.jit, static_argnames=("params",))(_ransac)
_edge_guided_jit = functools.partial(jax.jit, static_argnames=("params",))(
    _edge_guided
)


def ransac_register_pair(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    params: SacCotParams,
    mask: Optional[jnp.ndarray] = None,
    seed: int = 0,
) -> BaselineResult:
    """Classic 3-point RANSAC at a fixed sample budget of params.max_hypotheses."""
    return _ransac_jit(P, Q, mask, params=params, seed=jnp.uint32(seed))


def edge_guided_register_pair(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    params: SacCotParams,
    mask: Optional[jnp.ndarray] = None,
    seed: int = 0,
) -> BaselineResult:
    """Two-point compatibility-edge-guided sampling (the paper's mid ablation)."""
    return _edge_guided_jit(P, Q, mask, params=params, seed=jnp.uint32(seed))


def sampler_ablation(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    params: SacCotParams,
    mask: Optional[jnp.ndarray] = None,
    seed: int = 0,
):
    """Run all three samplers (random / edge-guided / COT) at one budget.

    Returns {"ransac": ..., "edge": ..., "saccot": ...}; each value exposes
    `.T` and `.num_inliers`, so callers can tabulate the paper-style
    comparison directly.
    """
    from saccot.engine.sac_cot import register_pair

    return {
        "ransac": ransac_register_pair(P, Q, params, mask=mask, seed=seed),
        "edge": edge_guided_register_pair(P, Q, params, mask=mask, seed=seed),
        "saccot": register_pair(P, Q, params, mask=mask),
    }
