"""Oracle self-consistency: the NumPy reference must solve planted problems.

This pins down the behavioral contract everything else is tested against
(SURVEY.md section 4.1): known-transform synthetic pairs with planted
outlier fractions must be recovered, and the oracle's internal stages must
satisfy basic invariants.
"""

import numpy as np
import pytest

from saccot.io.synthetic import correspondence_problem
from saccot.oracle import saccot as oracle
from saccot.utils import se3np
from saccot.utils.params import SacCotParams

PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, max_hypotheses=256
)


def pose_error(T_est, T_gt):
    E = T_est @ np.linalg.inv(T_gt)
    return se3np.rotation_angle_deg(E[:3, :3]), np.linalg.norm(E[:3, 3])


def test_compat_scores_symmetry_and_range():
    prob = correspondence_problem(seed=1, n=120, outlier_ratio=0.4)
    S = oracle.compat_scores(prob["P"], prob["Q"], PARAMS)
    assert np.allclose(S, S.T, atol=1e-12)
    assert (S >= 0).all() and (S <= 1).all()
    assert np.diag(S).max() == 0.0


def test_triangle_enumeration_matches_bruteforce():
    prob = correspondence_problem(seed=2, n=40, outlier_ratio=0.5)
    S = oracle.compat_scores(prob["P"], prob["Q"], PARAMS)
    triples, scores = oracle.enumerate_triangles(S)
    # Brute-force check over all C(40,3) triples.
    n = S.shape[0]
    expected = set()
    for i in range(n):
        for j in range(i + 1, n):
            if S[i, j] <= 0:
                continue
            for k in range(j + 1, n):
                if S[i, k] > 0 and S[j, k] > 0:
                    expected.add((i, j, k))
    got = set(map(tuple, triples.tolist()))
    assert got == expected
    for (i, j, k), s in zip(triples, scores):
        assert np.isclose(s, S[i, j] + S[i, k] + S[j, k])


def test_umeyama_exact_recovery():
    rng = np.random.default_rng(3)
    T = se3np.random_transform(rng)
    p = rng.normal(size=(10, 3))
    q = se3np.apply_T(T, p)
    R, t = oracle.umeyama(p, q)
    assert np.allclose(R, T[:3, :3], atol=1e-9)
    assert np.allclose(t, T[:3, 3], atol=1e-9)


def test_umeyama_reflection_fix():
    # Near-planar points are the classic det<0 trap.
    rng = np.random.default_rng(4)
    p = rng.normal(size=(6, 3))
    p[:, 2] *= 1e-6
    T = se3np.random_transform(rng)
    q = se3np.apply_T(T, p)
    R, _ = oracle.umeyama(p, q)
    assert np.isclose(np.linalg.det(R), 1.0, atol=1e-6)


@pytest.mark.parametrize("outlier_ratio", [0.3, 0.6, 0.8])
def test_oracle_recovers_planted_transform(outlier_ratio):
    prob = correspondence_problem(seed=5, n=200, outlier_ratio=outlier_ratio, noise=0.004)
    res = oracle.sac_cot(prob["P"], prob["Q"], PARAMS)
    rot_err, trans_err = pose_error(res["T"], prob["T_gt"])
    assert rot_err < 2.0, rot_err
    assert trans_err < 0.05, trans_err
    # Refined inlier set must cover most planted inliers.
    gt = prob["gt_inliers"]
    assert (res["inliers"] & gt).sum() >= 0.9 * gt.sum()


def test_oracle_respects_mask():
    prob = correspondence_problem(seed=6, n=150, outlier_ratio=0.4)
    mask = np.ones(150, dtype=bool)
    mask[100:] = False
    res = oracle.sac_cot(prob["P"], prob["Q"], PARAMS, mask=mask)
    assert not res["inliers"][100:].any()


def test_oracle_degenerate_no_triangles():
    # All-outlier garbage: far-apart random correspondences, tiny tau.
    rng = np.random.default_rng(7)
    P = rng.uniform(-1, 1, size=(30, 3))
    Q = rng.uniform(50, 100, size=(30, 3)) * np.array([1, 5, 9.0])
    params = SacCotParams(compat_tau=1e-6, min_separation=0.01, inlier_tau=0.01)
    res = oracle.sac_cot(P, Q, params)
    assert res["num_triangles"] == 0
    assert res["num_inliers"] == 0
