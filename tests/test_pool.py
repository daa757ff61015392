"""Per-anchor top-T pre-ranking of the triangle pool (engine/triangles.py).

With `per_anchor_candidates` = T each anchor keeps only its T best
candidate triangles before the global top-K. The reference here enumerates
every candidate of every anchor from the dense score matrix in NumPy and
truncates each anchor's list itself; with K = A*T the pool must hold
exactly those triangles.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
from jax import lax

from saccot.engine import compat as jcompat
from saccot.engine.triangles import triangle_pool_from_points
from saccot.io.synthetic import correspondence_problem
from saccot.utils.params import SacCotParams

N, A, B = 160, 24, 8
BASE = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=A, neighbors_per_anchor=B, dedup_triangles=False,
)


def _reference(P, Q, mask, params, T):
    """{(anchor, j, k): score} of each anchor's top-T valid candidates."""
    deg = jcompat.degrees(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    _, anchors = lax.top_k(deg, A)
    S = np.asarray(jcompat.compat_matrix(P, Q, params, mask=mask), np.float64)
    _, nbr = lax.top_k(jnp.asarray(S[np.asarray(anchors)], jnp.float32), B)
    out = {}
    for a, row in zip(np.asarray(anchors), np.asarray(nbr)):
        cands = []
        for b1 in range(B):
            for b2 in range(b1 + 1, B):
                j, k = row[b1], row[b2]
                s = (S[a, j], S[a, k], S[j, k])
                if min(s) > 0 and len({a, j, k}) == 3:
                    cands.append((-sum(s), (a, j, k)))
        cands.sort(key=lambda c: c[0])  # stable: ties keep slot order
        for neg, tri in cands[:T]:
            out[tri] = -neg
    return deg, out


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("T", [1, 4, 8])
def test_per_anchor_topt_pool_matches_truncated_reference(T, masked):
    prob = correspondence_problem(seed=40 + T, n=N, outlier_ratio=0.5)
    P, Q = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mask = None
    if masked:
        mask = jnp.asarray((np.arange(N) % 4 != 1).astype(np.float32))
    params = dataclasses.replace(BASE, per_anchor_candidates=T,
                                 max_hypotheses=A * T)
    deg, want = _reference(P, Q, mask, params, T)
    pool = triangle_pool_from_points(P, Q, deg, params, mask=mask)
    valid = np.asarray(pool.valid)
    got = {
        tuple(int(v) for v in tri): float(s)
        for tri, s in zip(np.asarray(pool.triples)[valid],
                          np.asarray(pool.scores)[valid])
    }
    assert len(want) > A // 2  # the problem must produce triangles
    assert set(got) == set(want)
    for tri, s in want.items():
        assert abs(got[tri] - s) < 1e-4
    if masked:
        bad = np.nonzero(np.asarray(mask) == 0)[0]
        assert not np.isin(np.asarray(pool.triples)[valid], bad).any()
