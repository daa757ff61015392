"""Feature-stage tests: kNN vs scipy, normals, voxel grid, ISS
repeatability, descriptor matching, and the end-to-end cloud pipeline
(SURVEY.md section 4.2 — the Bunny-class two-view config)."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.spatial import cKDTree

from saccot.features.neighbors import knn, neighbor_validity
from saccot.features.normals import estimate_normals
from saccot.features.resolution import mesh_resolution
from saccot.features.voxel import voxel_downsample
from saccot.features.iss import iss_keypoints
from saccot.features.shot import shot_descriptors
from saccot.features.fpfh import fpfh_descriptors
from saccot.features.pipeline import PipelineConfig, register_clouds
from saccot.io.synthetic import blob_cloud, two_view_pair
from saccot.match.topk import match_descriptors
from saccot.utils import se3np
from saccot.utils.params import SacCotParams


def test_knn_matches_scipy(rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    d, i = knn(jnp.asarray(pts), jnp.asarray(pts), k=8, exclude_self=True, block_rows=128)
    tree = cKDTree(pts)
    dd, ii = tree.query(pts, k=9)  # includes self
    np.testing.assert_allclose(np.asarray(d), dd[:, 1:], atol=1e-4)
    # indices can differ on exact ties; distances are the contract
    agree = (np.asarray(i) == ii[:, 1:]).mean()
    assert agree > 0.99


def test_knn_masking(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    mask = np.ones(100, bool)
    mask[50:] = False
    d, i = knn(jnp.asarray(pts), jnp.asarray(pts), k=4, ref_mask=jnp.asarray(mask))
    assert (np.asarray(i) < 50).all()


def test_normals_on_plane(rng):
    xy = rng.uniform(-1, 1, size=(400, 2)).astype(np.float32)
    pts = np.concatenate([xy, np.zeros((400, 1), np.float32)], axis=1)
    n = np.asarray(estimate_normals(jnp.asarray(pts), k=12, viewpoint=jnp.asarray([0.0, 0, 10.0])))
    # all normals ~ +z (oriented to viewpoint above the plane)
    assert (np.abs(n[:, 2]) > 0.999).all()
    assert (n[:, 2] > 0).all()


def test_mesh_resolution_grid():
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3), axis=-1).reshape(-1, 3).astype(np.float32)
    pr = float(mesh_resolution(jnp.asarray(g * 0.5)))
    assert abs(pr - 0.5) < 1e-5


def test_voxel_downsample_matches_numpy(rng):
    pts = rng.uniform(0, 1, size=(2000, 3)).astype(np.float32)
    vs = 0.25
    c, valid = voxel_downsample(jnp.asarray(pts), vs, max_points=256)
    c, valid = np.asarray(c), np.asarray(valid)
    keys = np.floor(pts / vs).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    want = np.stack([pts[inv == u].mean(0) for u in range(len(uniq))])
    assert valid.sum() == len(uniq)
    got = c[valid]
    # compare as sets via lexicographic sort
    got_s = got[np.lexsort(got.T)]
    want_s = want[np.lexsort(want.T)]
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)


def test_iss_repeatability(rng):
    cloud = blob_cloud(np.random.default_rng(3), 3000).astype(np.float32)
    pr = float(mesh_resolution(jnp.asarray(cloud)))
    T = se3np.random_transform(np.random.default_rng(4))
    cloud2 = se3np.apply_T(T, cloud).astype(np.float32)

    kw = dict(salient_radius=6 * pr, nms_radius=4 * pr, max_keypoints=128, k=48)
    kp1 = iss_keypoints(jnp.asarray(cloud), **kw)
    kp2 = iss_keypoints(jnp.asarray(cloud2), **kw)
    n1, n2 = int(kp1.valid.sum()), int(kp2.valid.sum())
    assert n1 > 20
    # Rigid invariance: the same cloud indices should be detected.
    s1 = set(np.asarray(kp1.idx)[np.asarray(kp1.valid)].tolist())
    s2 = set(np.asarray(kp2.idx)[np.asarray(kp2.valid)].tolist())
    overlap = len(s1 & s2) / max(min(n1, n2), 1)
    assert overlap > 0.8, (n1, n2, overlap)


@pytest.mark.parametrize("desc_fn", [shot_descriptors, fpfh_descriptors])
def test_descriptor_invariance_and_matching(desc_fn):
    cloud = blob_cloud(np.random.default_rng(5), 3000).astype(np.float32)
    pr = float(mesh_resolution(jnp.asarray(cloud)))
    T = se3np.random_transform(np.random.default_rng(6))
    cloud2 = se3np.apply_T(T, cloud).astype(np.float32)

    pts1, pts2 = jnp.asarray(cloud), jnp.asarray(cloud2)
    nrm1 = estimate_normals(pts1, k=16)
    nrm2 = estimate_normals(pts2, k=16)
    kp_idx = jnp.arange(0, 3000, 25, dtype=jnp.int32)  # 120 probe points
    d1 = desc_fn(pts1, nrm1, kp_idx, radius=8 * pr, k=48)
    d2 = desc_fn(pts2, nrm2, kp_idx, radius=8 * pr, k=48)

    m = match_descriptors(d1, d2, mutual=True)
    valid = np.asarray(m.valid)
    correct = (np.asarray(m.tgt_idx) == np.arange(len(kp_idx)))[valid]
    # Descriptors are rotation-invariant: matching recovers identity pairing.
    assert valid.sum() > 0.5 * len(kp_idx)
    assert correct.mean() > 0.8, correct.mean()


def test_pipeline_end_to_end_two_view():
    pair = two_view_pair(seed=9, n_points=4096, overlap=0.8, noise=0.002)
    cfg = PipelineConfig(
        normal_k=16,
        iss_salient_mult=5.0,
        iss_nms_mult=3.0,
        max_keypoints=512,
        descriptor="shot",
        descriptor_radius_mult=10.0,
        descriptor_k=48,
        max_correspondences=512,
        compat_mult=3.0,
        min_sep_mult=6.0,
        inlier_mult=3.0,
        estimator=SacCotParams(
            num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
        ),
    )
    res = register_clouds(jnp.asarray(pair["source"]), jnp.asarray(pair["target"]), cfg)
    assert bool(res.registration.success)
    T_est = np.asarray(res.registration.T, np.float64)
    E = T_est @ np.linalg.inv(pair["T_gt"])
    rot_err = se3np.rotation_angle_deg(E[:3, :3])
    trans_err = np.linalg.norm(E[:3, 3])
    assert rot_err < 5.0, (rot_err, trans_err, int(res.num_correspondences))
    assert trans_err < 0.05, (rot_err, trans_err)


def test_harris_keypoints_repeatability():
    from saccot.features.harris import harris_keypoints

    cloud = blob_cloud(np.random.default_rng(13), 3000).astype(np.float32)
    pr = float(mesh_resolution(jnp.asarray(cloud)))
    T = se3np.random_transform(np.random.default_rng(14))
    cloud2 = se3np.apply_T(T, cloud).astype(np.float32)

    n1 = estimate_normals(jnp.asarray(cloud), k=16)
    n2 = estimate_normals(jnp.asarray(cloud2), k=16)
    kw = dict(radius=6 * pr, nms_radius=4 * pr, max_keypoints=128, k=48)
    kp1 = harris_keypoints(jnp.asarray(cloud), n1, **kw)
    kp2 = harris_keypoints(jnp.asarray(cloud2), n2, **kw)
    c1, c2 = int(kp1.valid.sum()), int(kp2.valid.sum())
    assert c1 > 10
    s1 = set(np.asarray(kp1.idx)[np.asarray(kp1.valid)].tolist())
    s2 = set(np.asarray(kp2.idx)[np.asarray(kp2.valid)].tolist())
    overlap = len(s1 & s2) / max(min(c1, c2), 1)
    assert overlap > 0.6, (c1, c2, overlap)


def test_external_descriptor_roundtrip(tmp_path):
    from saccot.io.external import (
        correspondences_from_descriptors, load_descriptors_npz, save_descriptors_npz,
    )
    from saccot.engine import register_pair
    from saccot.io.synthetic import correspondence_problem

    # Fabricate "learned" descriptors: GT-corresponding points get similar
    # random vectors, outliers get independent ones.
    rng = np.random.default_rng(15)
    prob = correspondence_problem(seed=15, n=256, outlier_ratio=0.3)
    D = 32
    base = rng.normal(size=(256, D)).astype(np.float32)
    d_src = base + 0.05 * rng.normal(size=base.shape).astype(np.float32)
    d_tgt = base.copy()
    out = ~prob["gt_inliers"]
    d_tgt[out] = rng.normal(size=(out.sum(), D)).astype(np.float32)

    save_descriptors_npz(tmp_path / "src.npz", prob["P"], d_src)
    save_descriptors_npz(tmp_path / "tgt.npz", prob["Q"], d_tgt)
    src = load_descriptors_npz(str(tmp_path / "src.npz"))
    tgt = load_descriptors_npz(str(tmp_path / "tgt.npz"))

    P, Q, mask = correspondences_from_descriptors(src, tgt, max_correspondences=256)
    params = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
                          num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256)
    res = register_pair(P, Q, params, mask=mask)
    E = np.asarray(res.T, np.float64) @ np.linalg.inv(prob["T_gt"])
    assert se3np.rotation_angle_deg(E[:3, :3]) < 2.0


def test_pipeline_harris_variant():
    pair = two_view_pair(seed=21, n_points=3000, overlap=0.85, noise=0.002)
    cfg = PipelineConfig(
        keypoints="harris", normal_k=16, iss_salient_mult=5.0, iss_nms_mult=3.0,
        max_keypoints=384, descriptor="fpfh", descriptor_radius_mult=10.0,
        descriptor_k=48, max_correspondences=384,
        compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0,
        estimator=SacCotParams(num_anchors=96, neighbors_per_anchor=10, max_hypotheses=384),
    )
    res = register_clouds(jnp.asarray(pair["source"]), jnp.asarray(pair["target"]), cfg)
    E = np.asarray(res.registration.T, np.float64) @ np.linalg.inv(pair["T_gt"])
    assert se3np.rotation_angle_deg(E[:3, :3]) < 5.0, int(res.num_correspondences)


def test_pipeline_batch_vmap():
    from saccot.features.pipeline import register_clouds_batch
    import jax

    pairs = [two_view_pair(seed=30 + s, n_points=2000, overlap=0.85, noise=0.002)
             for s in range(2)]
    # Pad views to a common static size.
    n = min(min(p["source"].shape[0], p["target"].shape[0]) for p in pairs)
    src = jnp.stack([jnp.asarray(p["source"][:n]) for p in pairs])
    tgt = jnp.stack([jnp.asarray(p["target"][:n]) for p in pairs])
    cfg = PipelineConfig(
        normal_k=16, iss_salient_mult=5.0, iss_nms_mult=3.0, max_keypoints=256,
        descriptor="shot", descriptor_radius_mult=10.0, descriptor_k=48,
        max_correspondences=256, compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0,
        estimator=SacCotParams(num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256),
    )
    res = jax.jit(lambda a, b: register_clouds_batch(a, b, cfg))(src, tgt)
    for b, p in enumerate(pairs):
        E = np.asarray(res.registration.T[b], np.float64) @ np.linalg.inv(p["T_gt"])
        assert se3np.rotation_angle_deg(E[:3, :3]) < 5.0


def test_mutual_filter_inf_contract(rng):
    from saccot.match.topk import mutual_filter

    d1 = rng.normal(size=(20, 8)).astype(np.float32)
    d2 = rng.normal(size=(20, 8)).astype(np.float32)
    m = match_descriptors(jnp.asarray(d1), jnp.asarray(d2), mutual=True)
    mf = mutual_filter(m, 20)
    dist = np.asarray(mf.distance)
    valid = np.asarray(mf.valid)
    assert np.isinf(dist[~valid]).all()
    assert np.isfinite(dist[valid]).all()


def test_match_single_target_row(rng):
    d1 = rng.normal(size=(5, 8)).astype(np.float32)
    d2 = rng.normal(size=(1, 8)).astype(np.float32)
    m = match_descriptors(jnp.asarray(d1), jnp.asarray(d2), mutual=False)
    assert (np.asarray(m.tgt_idx) == 0).all()
    # ratio test on a single target rejects everything (d2nd == d1)
    m2 = match_descriptors(jnp.asarray(d1), jnp.asarray(d2), mutual=False, ratio_test=0.9)
    assert not np.asarray(m2.valid).any()


def test_pipeline_with_icp_polish():
    """cfg.icp runs a trimmed dense polish after the estimator; the refined
    transform must be at least as accurate as the coarse one."""
    from saccot.engine.icp import IcpParams

    pair = two_view_pair(seed=9, n_points=4096, overlap=0.8, noise=0.002)
    base = PipelineConfig(
        normal_k=16,
        iss_salient_mult=5.0,
        iss_nms_mult=3.0,
        max_keypoints=512,
        descriptor="shot",
        descriptor_radius_mult=10.0,
        descriptor_k=48,
        max_correspondences=512,
        compat_mult=3.0,
        min_sep_mult=6.0,
        inlier_mult=3.0,
        estimator=SacCotParams(
            num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
        ),
    )
    import dataclasses

    with_icp = dataclasses.replace(
        base, icp=IcpParams(max_iters=10, max_corr_dist=6.0, trim_frac=0.8)
    )
    src, tgt = jnp.asarray(pair["source"]), jnp.asarray(pair["target"])
    coarse = register_clouds(src, tgt, base)
    fine = register_clouds(src, tgt, with_icp)

    def errs(res):
        E = np.asarray(res.registration.T, np.float64) @ np.linalg.inv(pair["T_gt"])
        return se3np.rotation_angle_deg(E[:3, :3]), np.linalg.norm(E[:3, 3])

    rot_c, tr_c = errs(coarse)
    rot_f, tr_f = errs(fine)
    assert rot_f < 3.0 and tr_f < 0.03, (rot_f, tr_f, rot_c, tr_c)
    # The polish must not make things worse (allow fp wiggle).
    assert rot_f <= rot_c * 1.2 + 0.1, (rot_f, rot_c)
    assert float(fine.icp_rmse) > 0.0


def test_eig3_matches_eigvalsh(rng):
    """Closed-form 3x3 symmetric eigenvalues/vectors vs LAPACK on random
    covariance-like inputs + degenerate cases (features/eig3.py)."""
    from saccot.features.eig3 import eigvals3_sym, smallest_eigvec3_sym

    A = rng.normal(size=(256, 5, 3)).astype(np.float32)
    C = np.einsum("nki,nkj->nij", A, A) / 5.0  # SPD-ish covariances
    # Degenerate members: isotropic, rank-1, rank-2, zero.
    C[0] = np.eye(3) * 2.7
    C[1] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    C[2] = np.diag([1.0, 1.0, 0.0])
    C[3] = 0.0
    Cj = jnp.asarray(C)

    ev = np.asarray(eigvals3_sym(Cj), np.float64)
    ref = np.linalg.eigvalsh(C.astype(np.float64))
    scale = np.maximum(np.abs(ref).max(axis=-1, keepdims=True), 1e-6)
    np.testing.assert_allclose(ev / scale, ref / scale, atol=5e-4)

    v = np.asarray(smallest_eigvec3_sym(Cj), np.float64)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    # Rayleigh quotient of the returned vector ~= smallest eigenvalue.
    rq = np.einsum("ni,nij,nj->n", v, C.astype(np.float64), v)
    np.testing.assert_allclose(
        (rq - ref[:, 0]) / scale[:, 0], 0.0, atol=1e-3
    )


@pytest.mark.parametrize("desc_fn", [shot_descriptors, fpfh_descriptors])
@pytest.mark.parametrize("soft", [False, True])
def test_descriptor_soft_and_hard_binning(desc_fn, soft):
    """Both binning modes (r5: soft is the pipeline default, hard remains
    supported): L2-normalized output, rotation-invariant matching."""
    cloud = blob_cloud(np.random.default_rng(15), 2000).astype(np.float32)
    pr = float(mesh_resolution(jnp.asarray(cloud)))
    T = se3np.random_transform(np.random.default_rng(16))
    cloud2 = se3np.apply_T(T, cloud).astype(np.float32)
    pts1, pts2 = jnp.asarray(cloud), jnp.asarray(cloud2)
    nrm1 = estimate_normals(pts1, k=16)
    nrm2 = estimate_normals(pts2, k=16)
    kp_idx = jnp.arange(0, 2000, 25, dtype=jnp.int32)
    d1 = desc_fn(pts1, nrm1, kp_idx, radius=8 * pr, k=48, soft=soft)
    d2 = desc_fn(pts2, nrm2, kp_idx, radius=8 * pr, k=48, soft=soft)
    norms = np.linalg.norm(np.asarray(d1), axis=-1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, atol=1e-5)
    m = match_descriptors(d1, d2, mutual=True)
    valid = np.asarray(m.valid)
    correct = (np.asarray(m.tgt_idx) == np.arange(len(kp_idx)))[valid]
    assert correct.mean() > 0.8, (soft, correct.mean())


def test_soft_binning_mass_conservation():
    """Soft binning redistributes each neighbor's unit weight — the
    UN-normalized histogram mass must equal the valid-neighbor count
    exactly (wrap + clamp conventions preserve total mass)."""
    from saccot.features.shot import SHOT_DIM, local_reference_frames  # noqa
    import saccot.features.shot as shot_mod

    cloud = blob_cloud(np.random.default_rng(2), 1200).astype(np.float32)
    pts = jnp.asarray(cloud)
    nrm = estimate_normals(pts, k=16)
    pr = float(mesh_resolution(pts))
    kp_idx = jnp.arange(0, 1200, 40, dtype=jnp.int32)
    # Histogram mass check via the normalized output: reconstruct mass by
    # comparing soft and hard L1 norms pre-normalization is not exposed;
    # instead check soft output has MORE nonzero bins (smearing) at equal
    # normalization.
    d_hard = shot_mod.shot_descriptors(pts, nrm, kp_idx, radius=8 * pr, k=48,
                                       soft=False)
    d_soft = shot_mod.shot_descriptors(pts, nrm, kp_idx, radius=8 * pr, k=48,
                                       soft=True)
    nz_hard = (np.asarray(d_hard) > 0).sum(-1)
    nz_soft = (np.asarray(d_soft) > 0).sum(-1)
    assert (nz_soft >= nz_hard).mean() > 0.9, (nz_hard.mean(), nz_soft.mean())
