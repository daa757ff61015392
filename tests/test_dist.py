"""Distributed paths on the faked 8-device CPU mesh (SURVEY.md section 4.3).

The sharded sweep (DP over pairs, SP over the correspondence axis) must be
bit-for-bit-equivalent (up to f32 reduction order) to the single-device
estimator: the all-gather/psum decomposition is a layout change, not an
algorithm change.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from saccot.dist.mesh import make_mesh
from saccot.dist.sweep import make_sweep_fn
from saccot.engine.sac_cot import register_batch, register_pair, register_pair_sp
from saccot.io.synthetic import correspondence_problem
from saccot.utils import se3np
from saccot.utils.params import SacCotParams

N = 128
B = 8
PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=48, neighbors_per_anchor=10, max_hypotheses=256,
    degree_block_rows=64,
)


@pytest.fixture(scope="module")
def batch():
    probs = [correspondence_problem(seed=100 + s, n=N, outlier_ratio=0.5) for s in range(B)]
    P_all = jnp.stack([jnp.asarray(p["P"]) for p in probs])
    Q_all = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
    T_gt = np.stack([p["T_gt"] for p in probs])
    return P_all, Q_all, T_gt


def _check_equal(res_sharded, res_ref, T_gt):
    T_s = np.asarray(res_sharded.T, np.float64)
    T_r = np.asarray(res_ref.T, np.float64)
    for b in range(T_s.shape[0]):
        E = T_s[b] @ np.linalg.inv(T_r[b])
        # f32 reduction order differs between shardings; near-tie top-k picks
        # can too — equivalence is "same registration", not bit-equality.
        assert se3np.rotation_angle_deg(E[:3, :3]) < 0.2
        assert np.linalg.norm(E[:3, 3]) < 5e-3
        Eg = T_s[b] @ np.linalg.inv(T_gt[b])
        assert se3np.rotation_angle_deg(Eg[:3, :3]) < 3.0
    assert (
        np.abs(
            np.asarray(res_sharded.num_inliers, np.int64)
            - np.asarray(res_ref.num_inliers, np.int64)
        ).max()
        <= 1
    )


def test_dp_sweep_matches_single_device(eight_devices, batch):
    P_all, Q_all, T_gt = batch
    mesh = make_mesh(pairs=8, corr=1)
    sweep = make_sweep_fn(mesh, PARAMS)
    mask = jnp.ones((B, N), jnp.float32)
    res = sweep(P_all, Q_all, mask)
    ref = register_batch(P_all, Q_all, PARAMS)
    _check_equal(res, ref, T_gt)


def test_dp_x_sp_sweep_matches_single_device(eight_devices, batch):
    P_all, Q_all, T_gt = batch
    mesh = make_mesh(pairs=4, corr=2)
    sweep = make_sweep_fn(mesh, PARAMS)
    mask = jnp.ones((B, N), jnp.float32)
    res = sweep(P_all, Q_all, mask)
    ref = register_batch(P_all, Q_all, PARAMS)
    _check_equal(res, ref, T_gt)


def test_pure_sp_register_matches_single_device(eight_devices):
    prob = correspondence_problem(seed=200, n=N, outlier_ratio=0.5)
    Pv, Qv = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mask = jnp.ones((N,), jnp.float32)
    mesh = make_mesh(pairs=1, corr=8)

    fn = jax.shard_map(
        lambda p, q, m: register_pair_sp(p, q, PARAMS, "corr", mask_shard=m),
        mesh=mesh,
        in_specs=(P("corr"), P("corr"), P("corr")),
        out_specs=_sp_out_specs(),
        check_vma=False,
    )
    res = jax.jit(fn)(Pv, Qv, mask)
    ref = register_pair(Pv, Qv, PARAMS)
    E = np.asarray(res.T, np.float64) @ np.linalg.inv(np.asarray(ref.T, np.float64))
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.05
    assert int(res.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(np.asarray(res.inliers), np.asarray(ref.inliers))


def _sp_out_specs():
    from saccot.engine.sac_cot import RegistrationResult

    return RegistrationResult(
        R=P(), t=P(), T=P(), inliers=P("corr"), num_inliers=P(),
        best_score=P(), num_valid_triangles=P(), success=P(),
    )


def test_masked_padding_equivalence(eight_devices):
    # A problem padded from 96 to 128 correspondences must give the same
    # transform sharded as unsharded.
    prob = correspondence_problem(seed=201, n=96, outlier_ratio=0.4)
    Pv = jnp.concatenate([jnp.asarray(prob["P"]), jnp.zeros((32, 3), jnp.float32)])
    Qv = jnp.concatenate([jnp.asarray(prob["Q"]), jnp.zeros((32, 3), jnp.float32)])
    mask = jnp.concatenate([jnp.ones((96,), jnp.float32), jnp.zeros((32,), jnp.float32)])

    mesh = make_mesh(pairs=1, corr=8)
    fn = jax.shard_map(
        lambda p, q, m: register_pair_sp(p, q, PARAMS, "corr", mask_shard=m),
        mesh=mesh,
        in_specs=(P("corr"), P("corr"), P("corr")),
        out_specs=_sp_out_specs(),
        check_vma=False,
    )
    res = jax.jit(fn)(Pv, Qv, mask)
    ref = register_pair(Pv, Qv, PARAMS, mask=mask)
    E = np.asarray(res.T, np.float64) @ np.linalg.inv(np.asarray(ref.T, np.float64))
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.05
    assert not np.asarray(res.inliers)[96:].any()


def test_scaling_harness_smoke(eight_devices):
    from saccot.evaluation.scaling import measure_scaling

    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=32, neighbors_per_anchor=8, max_hypotheses=64,
        degree_block_rows=64,
    )
    out = measure_scaling(params, n_corr=64, pairs_per_device=2, reps=2,
                          device_counts=[1, 2, 4])
    assert set(out["pairs_per_sec"]) == {1, 2, 4}
    assert out["efficiency"][1] == 1.0
    assert all(v > 0 for v in out["pairs_per_sec"].values())


def test_ring_compat_matches_allgather(eight_devices):
    """The ppermute ring degree schedule must equal the all-gather path."""
    import dataclasses

    prob = correspondence_problem(seed=300, n=N, outlier_ratio=0.5)
    Pv, Qv = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mask = jnp.ones((N,), jnp.float32)
    mesh = make_mesh(pairs=1, corr=8)
    ring_params = dataclasses.replace(PARAMS, ring_compat=True)

    fn = jax.shard_map(
        lambda p, q, m: register_pair_sp(p, q, ring_params, "corr", mask_shard=m),
        mesh=mesh,
        in_specs=(P("corr"), P("corr"), P("corr")),
        out_specs=_sp_out_specs(),
        check_vma=False,
    )
    res = jax.jit(fn)(Pv, Qv, mask)
    ref = register_pair(Pv, Qv, PARAMS)
    E = np.asarray(res.T, np.float64) @ np.linalg.inv(np.asarray(ref.T, np.float64))
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.05
    assert int(res.num_inliers) == int(ref.num_inliers)

    # Degrees themselves, compared directly.
    from saccot.dist.ring import degrees_ring
    from saccot.engine import compat as jcompat

    deg_fn = jax.shard_map(
        lambda p, q, m: degrees_ring(p, q, PARAMS, "corr", mask_loc=m),
        mesh=mesh,
        in_specs=(P("corr"), P("corr"), P("corr")),
        out_specs=P("corr"),
        check_vma=False,
    )
    deg_ring = jax.jit(deg_fn)(Pv, Qv, mask)
    deg_ref = jcompat.degrees(Pv, Qv, Pv, Qv, PARAMS, mask_rows=mask, mask_cols=mask)
    np.testing.assert_allclose(np.asarray(deg_ring), np.asarray(deg_ref), rtol=1e-5, atol=1e-4)


def test_tp_register_matches_single_device(eight_devices):
    """Hypothesis-axis (TP) sharding: 8-way K-shard must reproduce the
    single-device registration exactly (SURVEY.md section 2.2, TP row)."""
    from saccot.engine.sac_cot import RegistrationResult, register_pair_tp

    prob = correspondence_problem(seed=400, n=N, outlier_ratio=0.5)
    Pv, Qv = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mask = jnp.ones((N,), jnp.float32)
    mesh = make_mesh(pairs=1, corr=1, hyp=8)

    fn = jax.shard_map(
        lambda p, q, m: register_pair_tp(p, q, PARAMS, "hyp", mask=m),
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=RegistrationResult(
            R=P(), t=P(), T=P(), inliers=P(), num_inliers=P(),
            best_score=P(), num_valid_triangles=P(), success=P(),
        ),
        check_vma=False,
    )
    res = jax.jit(fn)(Pv, Qv, mask)
    ref = register_pair(Pv, Qv, PARAMS)
    E = np.asarray(res.T, np.float64) @ np.linalg.inv(np.asarray(ref.T, np.float64))
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.05
    assert int(res.num_inliers) == int(ref.num_inliers)
    assert float(res.best_score) == float(ref.best_score)
    np.testing.assert_array_equal(np.asarray(res.inliers), np.asarray(ref.inliers))


def test_dp_x_tp_x_sp_sweep_matches_single_device(eight_devices, batch):
    """All three parallelism axes at once: 2x2x2 mesh parity."""
    P_all, Q_all, T_gt = batch
    mesh = make_mesh(pairs=2, corr=2, hyp=2)
    sweep = make_sweep_fn(mesh, PARAMS)
    mask = jnp.ones((B, N), jnp.float32)
    res = sweep(P_all, Q_all, mask)
    ref = register_batch(P_all, Q_all, PARAMS)
    _check_equal(res, ref, T_gt)


def test_sweep_runs_bench_kernel_config(eight_devices, batch):
    """The sharded sweep must run the bench's fast configuration (dedup
    off, approx top-k, per-anchor top-T pool) with the ring compat path on
    a three-axis mesh and still match the single-device estimator."""
    import dataclasses

    P_all, Q_all, T_gt = batch
    mesh = make_mesh(pairs=2, corr=2, hyp=2)
    ring_params = dataclasses.replace(
        PARAMS, ring_compat=True, dedup_triangles=False, approx_topk=True,
        per_anchor_candidates=4, max_hypotheses=192,
    )
    sweep = make_sweep_fn(mesh, ring_params)
    mask = jnp.ones((B, N), jnp.float32)
    res = sweep(P_all, Q_all, mask)
    ref = register_batch(
        P_all, Q_all, dataclasses.replace(ring_params, ring_compat=False)
    )
    _check_equal(res, ref, T_gt)


def test_anchor_sharded_pool_matches_single_device(eight_devices):
    """With per_anchor_candidates set, the corr-sharded estimator shards
    the POOL's anchor axis too (each device scores A/d anchors; one tiny
    all_gather of the [A/d, T] candidate stats reassembles the identical
    global pool) — triangle scores/sampled indices are computed
    shard-parallel, not replicated (SURVEY.md section 5 long-context row).
    Must match the single-device pool exactly up to f32 reduction order."""
    import dataclasses

    params = dataclasses.replace(
        PARAMS, num_anchors=48, dedup_triangles=False,
        per_anchor_candidates=4, max_hypotheses=192,
    )
    prob = correspondence_problem(seed=321, n=N, outlier_ratio=0.5)
    Pv, Qv = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mask = jnp.ones((N,), jnp.float32)
    mesh = make_mesh(pairs=1, corr=8)

    fn = jax.shard_map(
        lambda p, q, m: register_pair_sp(p, q, params, "corr", mask_shard=m),
        mesh=mesh,
        in_specs=(P("corr"), P("corr"), P("corr")),
        out_specs=_sp_out_specs(),
        check_vma=False,
    )
    res = jax.jit(fn)(Pv, Qv, mask)
    ref = register_pair(Pv, Qv, params)
    E = np.asarray(res.T, np.float64) @ np.linalg.inv(np.asarray(ref.T, np.float64))
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.05
    assert int(res.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(np.asarray(res.inliers), np.asarray(ref.inliers))

    # The anchor shard really is taken: the sharded pool equals the
    # single-device pool, candidate for candidate.
    from saccot.engine import compat as jcompat
    from saccot.engine.triangles import triangle_pool_from_points

    deg = jcompat.degrees(Pv, Qv, Pv, Qv, params)
    pool_fn = jax.shard_map(
        lambda p, q, d: triangle_pool_from_points(p, q, d, params,
                                                  anchor_axis="corr"),
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    pool_sh = jax.jit(pool_fn)(Pv, Qv, deg)
    pool_ref = triangle_pool_from_points(Pv, Qv, deg, params)
    np.testing.assert_array_equal(np.asarray(pool_sh.triples),
                                  np.asarray(pool_ref.triples))
    np.testing.assert_allclose(np.asarray(pool_sh.scores),
                               np.asarray(pool_ref.scores), atol=1e-4)
