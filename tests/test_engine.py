"""JAX engine vs NumPy oracle parity (SURVEY.md section 4.1-4.2).

In the exhaustive regime (num_anchors >= N, neighbors_per_anchor >= N-1) the
engine's static triangle pool is a superset of the oracle's clique
enumeration, so stage outputs must agree: compat matrices exactly (up to
f32), triangle score multisets, SVD transforms, inlier counts, and the final
registration.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from saccot.engine import compat as jcompat
from saccot.engine import score as jscore
from saccot.engine import triangles as jtri
from saccot.engine.sac_cot import register_pair, register_batch
from saccot.engine.svd3 import umeyama as jumeyama
from saccot.io.synthetic import correspondence_problem
from saccot.oracle import saccot as oracle
from saccot.utils import se3np
from saccot.utils.params import SacCotParams

# Exhaustive regime for a 96-correspondence problem.
N = 96
EXHAUSTIVE = SacCotParams(
    compat_tau=0.03,
    min_separation=0.05,
    inlier_tau=0.03,
    num_anchors=N,
    neighbors_per_anchor=N - 1,
    max_hypotheses=512,
)


@pytest.fixture(scope="module")
def prob():
    return correspondence_problem(seed=11, n=N, outlier_ratio=0.5, noise=0.004)


def test_compat_matrix_matches_oracle(prob):
    S_np = oracle.compat_scores(prob["P"], prob["Q"], EXHAUSTIVE)
    S_jx = jcompat.compat_matrix(jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), EXHAUSTIVE)
    np.testing.assert_allclose(np.asarray(S_jx), S_np, atol=2e-4)


def test_triangle_pool_matches_oracle_topk(prob):
    S_np = oracle.compat_scores(prob["P"], prob["Q"], EXHAUSTIVE)
    triples, scores = oracle.enumerate_triangles(S_np)
    triples, scores = oracle.rank_triangles(triples, scores, EXHAUSTIVE.max_hypotheses)

    S_jx = jcompat.compat_matrix(jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), EXHAUSTIVE)
    pool = jtri.triangle_pool(S_jx, EXHAUSTIVE)
    pool_valid = np.asarray(pool.valid)
    got_scores = np.sort(np.asarray(pool.scores)[pool_valid])[::-1]
    want_scores = np.sort(scores)[::-1]
    k = min(len(got_scores), len(want_scores))
    assert k > 50  # the problem must actually produce triangles
    np.testing.assert_allclose(got_scores[:k], want_scores[:k], atol=5e-4)

    # The top half (safely above any tie boundary) must be the same triangles.
    got_set = set(map(tuple, np.asarray(pool.triples)[pool_valid].tolist()))
    want_set = set(map(tuple, triples[: k // 2].tolist()))
    assert want_set.issubset(got_set)


def test_triangle_pool_dedup(prob):
    S_jx = jcompat.compat_matrix(jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), EXHAUSTIVE)
    pool = jtri.triangle_pool(S_jx, EXHAUSTIVE)
    valid = np.asarray(pool.valid)
    tri = np.asarray(pool.triples)[valid]
    assert len(set(map(tuple, tri.tolist()))) == tri.shape[0]
    # canonical ordering
    assert (tri[:, 0] < tri[:, 1]).all() and (tri[:, 1] < tri[:, 2]).all()


def test_umeyama_batched_matches_oracle(rng):
    p = rng.normal(size=(32, 5, 3)).astype(np.float32)
    T = np.stack([se3np.random_transform(rng) for _ in range(32)])
    q = (se3np.apply_T(T, p.astype(np.float64)) + rng.normal(scale=1e-3, size=p.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(32, 5)).astype(np.float32)

    Rj, tj = jumeyama(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    for b in range(32):
        Rn, tn = oracle.umeyama(p[b], q[b], w[b])
        np.testing.assert_allclose(np.asarray(Rj[b]), Rn, atol=2e-3)
        np.testing.assert_allclose(np.asarray(tj[b]), tn, atol=2e-3)


def test_score_hypotheses_matches_oracle(prob, rng):
    K = 37  # deliberately not a multiple of the block size
    Rs, ts = [], []
    for _ in range(K):
        T = se3np.random_transform(rng, max_angle_rad=0.5, max_trans=0.3)
        Rs.append(T[:3, :3])
        ts.append(T[:3, 3])
    Rs, ts = np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)
    scores, counts = jscore.score_hypotheses(
        jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]),
        EXHAUSTIVE.inlier_tau, block_k=16,
    )
    for k in range(K):
        n, _ = oracle.count_inliers(
            Rs[k].astype(np.float64), ts[k].astype(np.float64),
            prob["P"], prob["Q"], EXHAUSTIVE.inlier_tau,
        )
        assert int(counts[k]) == n


def test_register_pair_matches_oracle(prob):
    res_np = oracle.sac_cot(prob["P"], prob["Q"], EXHAUSTIVE)
    res_jx = register_pair(jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), EXHAUSTIVE)
    assert bool(res_jx.success)
    # Same registration: transforms agree tightly.
    E = np.asarray(res_jx.T, dtype=np.float64) @ np.linalg.inv(res_np["T"])
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.1
    assert np.linalg.norm(E[:3, 3]) < 1e-3
    assert abs(int(res_jx.num_inliers) - res_np["num_inliers"]) <= 1
    # And it solves the planted problem.
    E2 = np.asarray(res_jx.T, dtype=np.float64) @ np.linalg.inv(prob["T_gt"])
    assert se3np.rotation_angle_deg(E2[:3, :3]) < 2.0


def test_register_pair_budgeted_still_solves(prob):
    budget = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=32, neighbors_per_anchor=8, max_hypotheses=128,
    )
    res = register_pair(jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), budget)
    E = np.asarray(res.T, dtype=np.float64) @ np.linalg.inv(prob["T_gt"])
    assert se3np.rotation_angle_deg(E[:3, :3]) < 2.0
    assert np.linalg.norm(E[:3, 3]) < 0.05


def test_register_pair_mask(prob):
    mask = np.ones(N, dtype=np.float32)
    mask[N // 2:] = 0.0
    res = register_pair(
        jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), EXHAUSTIVE, mask=jnp.asarray(mask)
    )
    assert not np.asarray(res.inliers)[N // 2:].any()


def test_register_pair_failure_flag():
    rng = np.random.default_rng(8)
    P = rng.uniform(-1, 1, size=(32, 3)).astype(np.float32)
    Q = (rng.uniform(10, 20, size=(32, 3)) * np.array([1, 3, 7.0])).astype(np.float32)
    params = SacCotParams(compat_tau=1e-6, min_separation=0.01, inlier_tau=0.01,
                          num_anchors=32, neighbors_per_anchor=8, max_hypotheses=64)
    res = register_pair(jnp.asarray(P), jnp.asarray(Q), params)
    assert not bool(res.success)
    assert int(res.num_inliers) == 0
    np.testing.assert_allclose(np.asarray(res.R), np.eye(3), atol=1e-6)


def test_register_batch_vmap(prob):
    probs = [correspondence_problem(seed=s, n=N, outlier_ratio=0.5) for s in (21, 22, 23)]
    P = jnp.stack([jnp.asarray(p["P"]) for p in probs])
    Q = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
    budget = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=48, neighbors_per_anchor=10, max_hypotheses=256,
    )
    res = jax.jit(lambda a, b: register_batch(a, b, budget))(P, Q)
    for b, p in enumerate(probs):
        E = np.asarray(res.T[b], dtype=np.float64) @ np.linalg.inv(p["T_gt"])
        assert se3np.rotation_angle_deg(E[:3, :3]) < 2.0


def test_masked_anchors_produce_no_valid_triangles():
    """Regression: when valid correspondences < num_anchors, top_k must fill
    the anchor budget with masked nodes, and none of their triangles may be
    marked valid (code-review finding: missing mask_rows)."""
    from saccot.engine.compat import degrees
    from saccot.engine.triangles import triangle_pool_from_points

    prob = correspondence_problem(seed=77, n=64, outlier_ratio=0.2)
    P, Q = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mask = jnp.asarray((np.arange(64) < 8).astype(np.float32))  # 8 valid
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=32, neighbors_per_anchor=8, max_hypotheses=64,
    )
    deg = degrees(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    pool = triangle_pool_from_points(P, Q, deg, params, mask=mask)
    tri = np.asarray(pool.triples)[np.asarray(pool.valid)]
    assert (tri < 8).all(), tri


def test_num_candidate_triangles_matches_pool_template():
    from saccot.utils.params import num_candidate_triangles

    p = SacCotParams(num_anchors=7, neighbors_per_anchor=5)
    b1, b2 = np.triu_indices(5, k=1)
    assert num_candidate_triangles(p) == 7 * len(b1)


def test_triangle_pool_dedup_key_packings_agree(prob, monkeypatch):
    """The 1-key / 2-key / 3-key dedup sorts are exact rewrites of each other."""
    P, Q = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    params = SacCotParams(
        compat_tau=0.05, min_separation=0.02,
        num_anchors=48, neighbors_per_anchor=8, max_hypotheses=128,
    )
    deg = jcompat.degrees(P, Q, P, Q, params)

    def pool():
        return jtri.triangle_pool_from_points(P, Q, deg, params)

    ref = pool()  # 1-key packing (small N)
    monkeypatch.setattr(jtri, "_PACK1_MAX_NODES", 0)
    two = pool()  # forced 2-key packing
    monkeypatch.setattr(jtri, "_PACK2_MAX_NODES", 0)
    three = pool()  # forced plain 3-key sort
    for other in (two, three):
        np.testing.assert_array_equal(np.asarray(ref.triples), np.asarray(other.triples))
        np.testing.assert_allclose(np.asarray(ref.scores), np.asarray(other.scores), atol=1e-6)


@pytest.mark.parametrize("outlier", [0.9, 0.95])
def test_fast_config_recall_neutral(outlier):
    """bench.py's fast config (dedup off + approx top-k) must match the
    exact config's recall at the hard ablation operating points, not just
    the 80%-outlier headline point."""
    N2, B = 512, 6
    base = SacCotParams(
        compat_tau=0.03,
        min_separation=0.05,
        inlier_tau=0.03,
        num_anchors=128,
        neighbors_per_anchor=16,
        max_hypotheses=512,
        degree_block_rows=128,
        score_block_k=128,
    )
    fast = dataclasses.replace(
        base, dedup_triangles=False, approx_topk=True, per_anchor_candidates=4
    )
    probs = [
        correspondence_problem(seed=300 + s, n=N2, outlier_ratio=outlier, noise=0.004)
        for s in range(B)
    ]
    P_all = jnp.stack([jnp.asarray(p["P"]) for p in probs])
    Q_all = jnp.stack([jnp.asarray(p["Q"]) for p in probs])

    def recall(params):
        res = register_batch(P_all, Q_all, params)
        T_all = np.asarray(res.T, np.float64)
        ok = 0
        for b, p in enumerate(probs):
            E = T_all[b] @ np.linalg.inv(p["T_gt"])
            if (
                se3np.rotation_angle_deg(E[:3, :3]) < 5.0
                and np.linalg.norm(E[:3, 3]) < 0.05
            ):
                ok += 1
        return ok / B

    r_exact = recall(base)
    r_fast = recall(fast)
    assert r_exact >= 5 / 6, f"exact config recall {r_exact} at outlier={outlier}"
    assert r_fast >= r_exact, (
        f"fast config lost recall at outlier={outlier}: {r_fast} < {r_exact}"
    )
