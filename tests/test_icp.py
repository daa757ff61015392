"""ICP refinement tests: NN parity, convergence, trimming, point-to-plane.

The reference pipeline has no ICP of its own (it delegates everything past
the estimator to PCL conventions), so correctness is established against
scipy's exact NN search and planted-transform synthetic clouds: from a
perturbed initialization the refined transform must land within tight
rotation/translation bounds of the ground truth.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial import cKDTree

from saccot.engine.icp import IcpParams, icp, icp_batch, nearest_neighbors
from saccot.features.normals import estimate_normals
from saccot.io.synthetic import blob_cloud
from saccot.utils import se3np


def _cloud_pair(seed, n=800, noise=0.002, angle=0.15, trans=0.05):
    """Two noisy views of one blob surface with a planted transform."""
    rng = np.random.default_rng(seed)
    base = blob_cloud(rng, n_points=n)
    T_gt = se3np.random_transform(rng, max_angle_rad=angle, max_trans=trans)
    src = base + rng.normal(scale=noise, size=base.shape)
    tgt = se3np.apply_T(T_gt, base + rng.normal(scale=noise, size=base.shape))
    return src.astype(np.float32), tgt.astype(np.float32), T_gt


def _errors(T_est, T_gt):
    E = np.asarray(T_est, np.float64) @ np.linalg.inv(T_gt)
    return se3np.rotation_angle_deg(E[:3, :3]), np.linalg.norm(E[:3, 3])


def test_nearest_neighbors_matches_scipy(rng):
    src = rng.normal(size=(257, 3)).astype(np.float32)
    tgt = rng.normal(size=(401, 3)).astype(np.float32)
    idx, dist = jax.jit(lambda a, b: nearest_neighbors(a, b, block_rows=64))(
        jnp.asarray(src), jnp.asarray(tgt)
    )
    d_ref, i_ref = cKDTree(tgt).query(src)
    np.testing.assert_array_equal(np.asarray(idx), i_ref)
    np.testing.assert_allclose(np.asarray(dist), d_ref, rtol=1e-4, atol=1e-5)


def test_nearest_neighbors_respects_target_mask(rng):
    src = rng.normal(size=(64, 3)).astype(np.float32)
    tgt = rng.normal(size=(128, 3)).astype(np.float32)
    m = np.ones(128, np.float32)
    m[64:] = 0.0  # padded tail
    idx, _ = nearest_neighbors(jnp.asarray(src), jnp.asarray(tgt), mask_tgt=jnp.asarray(m))
    assert np.asarray(idx).max() < 64
    d_ref, i_ref = cKDTree(tgt[:64]).query(src)
    np.testing.assert_array_equal(np.asarray(idx), i_ref)


def test_icp_point_converges_from_perturbed_init(rng):
    src, tgt, T_gt = _cloud_pair(seed=7)
    # Initialization off by ~5 degrees / 2% scale — the coarse-estimate regime.
    T0 = T_gt @ se3np.random_transform(rng, max_angle_rad=0.12, max_trans=0.02)
    params = IcpParams(max_iters=30, max_corr_dist=0.2)
    res = jax.jit(lambda s, t, Ti: icp(s, t, params, T_init=Ti))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T0, dtype=jnp.float32)
    )
    rot_err, trans_err = _errors(res.T, T_gt)
    assert rot_err < 1.0 and trans_err < 0.01
    trace = np.asarray(res.rmse_trace)
    assert trace[-1] <= trace[0]  # monotone-ish convergence signal
    assert int(res.num_matched) > 700


def test_icp_identity_is_fixed_point():
    src, _, _ = _cloud_pair(seed=3, noise=0.0)
    params = IcpParams(max_iters=5, max_corr_dist=0.1)
    res = icp(jnp.asarray(src), jnp.asarray(src), params)
    rot_err, trans_err = _errors(res.T, np.eye(4))
    assert rot_err < 1e-3 and trans_err < 1e-5
    assert float(res.rmse) < 1e-6


def test_icp_trimmed_handles_partial_overlap(rng):
    src, tgt, T_gt = _cloud_pair(seed=11, n=1000, noise=0.001)
    # Chop a contiguous chunk out of the target: ~25% of source points have
    # no true counterpart, so untrimmed ICP drags the fit toward spurious
    # matches while trimmed ICP must stay accurate.
    keep = np.argsort(tgt[:, 0])[: int(0.75 * len(tgt))]
    tgt_part = tgt[keep]
    T0 = T_gt @ se3np.random_transform(rng, max_angle_rad=0.11, max_trans=0.015)
    trimmed = IcpParams(max_iters=30, max_corr_dist=0.3, trim_frac=0.7)
    res = icp(
        jnp.asarray(src), jnp.asarray(tgt_part), trimmed,
        T_init=jnp.asarray(T0, dtype=jnp.float32),
    )
    rot_err, trans_err = _errors(res.T, T_gt)
    assert rot_err < 1.5 and trans_err < 0.015


def test_icp_plane_converges(rng):
    src, tgt, T_gt = _cloud_pair(seed=23, n=1200, noise=0.001)
    normals = estimate_normals(jnp.asarray(tgt), k=12)
    T0 = T_gt @ se3np.random_transform(rng, max_angle_rad=0.11, max_trans=0.02)
    params = IcpParams(max_iters=15, max_corr_dist=0.2, variant="plane")
    res = jax.jit(
        lambda s, t, Ti, n: icp(s, t, params, T_init=Ti, tgt_normals=n)
    )(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T0, np.float32), normals)
    rot_err, trans_err = _errors(res.T, T_gt)
    assert rot_err < 1.0 and trans_err < 0.01


def test_icp_plane_requires_normals():
    src, tgt, _ = _cloud_pair(seed=2, n=64)
    with pytest.raises(ValueError, match="normals"):
        icp(jnp.asarray(src), jnp.asarray(tgt), IcpParams(variant="plane"))


def test_icp_batch_matches_single(rng):
    pairs = [_cloud_pair(seed=s, n=400) for s in (31, 32, 33)]
    src = jnp.stack([jnp.asarray(p[0]) for p in pairs])
    tgt = jnp.stack([jnp.asarray(p[1]) for p in pairs])
    T0 = jnp.stack([jnp.asarray(p[2], jnp.float32) for p in pairs])
    params = IcpParams(max_iters=8, max_corr_dist=0.2)
    batched = icp_batch(src, tgt, params, T_init=T0)
    for b in range(3):
        single = icp(src[b], tgt[b], params, T_init=T0[b])
        np.testing.assert_allclose(
            np.asarray(batched.T[b]), np.asarray(single.T), atol=1e-5
        )


def test_icp_unconstrained_holds_init():
    # Every match gated out by max_corr_dist: transform must not move.
    src = jnp.asarray(np.random.default_rng(0).normal(size=(32, 3)), jnp.float32)
    tgt = src + 10.0  # far away
    params = IcpParams(max_iters=4, max_corr_dist=0.01)
    res = icp(src, tgt, params)
    np.testing.assert_allclose(np.asarray(res.T), np.eye(4), atol=1e-6)
    assert int(res.num_matched) == 0
