"""Multi-device dry-run steps for the SLAM/BA layer.

Builds a tiny synthetic BA problem, shards the landmark axis over the
mesh's "corr" axis inside shard_map, and executes one jitted
Schur-complement GN step with the real psum reductions — validating the
distributed-BA program compiles and runs on an N-device mesh.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from saccot.slam.ba import BAProblem, BAResult, bundle_adjust
from saccot.utils import se3np


def _tiny_problem(n_poses=4, n_landmarks=64, obs=2, seed=0):
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(n_poses - 1):
        gt.append(gt[-1] @ se3np.random_transform(rng, max_angle_rad=0.3, max_trans=0.3))
    gt = np.stack(gt).astype(np.float32)
    lm = rng.uniform(-1, 1, size=(n_landmarks, 3)).astype(np.float32)
    obs_pose = rng.integers(0, n_poses, size=(n_landmarks, obs)).astype(np.int32)
    Tinv = np.linalg.inv(gt)[obs_pose]
    z = (np.einsum("lgij,lj->lgi", Tinv[..., :3, :3], lm) + Tinv[..., :3, 3]).astype(np.float32)
    z += rng.normal(scale=0.01, size=z.shape).astype(np.float32)
    pert = np.stack([se3np.exp_se3(rng.normal(scale=0.03, size=6)) for _ in range(n_poses)])
    init = (gt @ pert).astype(np.float32)
    init[0] = np.eye(4, dtype=np.float32)
    return BAProblem(
        poses=jnp.asarray(init),
        landmarks=jnp.asarray(lm + rng.normal(scale=0.02, size=lm.shape).astype(np.float32)),
        obs_pose=jnp.asarray(obs_pose),
        obs_z=jnp.asarray(z),
        obs_w=jnp.ones((n_landmarks, obs), jnp.float32),
    )


def dryrun_ba_step(mesh: Mesh, landmark_blocks: int = 0) -> BAResult:
    """Two GN steps of landmark-sharded BA over the mesh's "corr" axis.

    The problem has 32 landmarks per block, `landmark_blocks` blocks
    (default: one per "corr" device), so a one-device mesh can solve the
    same problem as a sharded one for comparison.
    """
    corr = mesh.shape["corr"]
    # obs=4: multi-view tracks, so the gate exercises the same G>2 coupling
    # structure the production track-BA builds (slam/frontend).
    prob = _tiny_problem(n_landmarks=32 * (landmark_blocks or max(corr, 1)),
                         obs=4)

    if corr == 1:
        res = bundle_adjust(prob, iters=2)
    else:
        def local(landmarks, obs_pose, obs_z, obs_w):
            lp = BAProblem(
                poses=prob.poses, landmarks=landmarks,
                obs_pose=obs_pose, obs_z=obs_z, obs_w=obs_w,
            )
            return bundle_adjust(lp, iters=2, axis_name="corr")

        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("corr"), P("corr"), P("corr"), P("corr")),
            out_specs=BAResult(
                poses=P(), landmarks=P("corr"), initial_cost=P(), final_cost=P(),
                lam=P(),
            ),
            check_vma=False,
        )
        args = (prob.landmarks, prob.obs_pose, prob.obs_z, prob.obs_w)
        if jax.process_count() > 1:
            # Multi-process run (scripts/multiprocess_dryrun.py): every
            # process built the identical host-local problem (same seed);
            # stitch them into global arrays the sharded program accepts.
            from jax.experimental import multihost_utils

            args = multihost_utils.host_local_array_to_global_array(
                args, mesh, (P(), P(), P(), P())
            )
        res = jax.jit(fn)(*args)
    jax.block_until_ready(res.poses)
    ic, fc = float(res.initial_cost), float(res.final_cost)
    assert fc <= ic, f"BA dryrun cost went up: {ic} -> {fc}"
    print(f"dryrun BA ok on mesh corr={corr}: cost {ic:.4f} -> {fc:.4f}")
    return res


def dryrun_pgo_step(mesh: Mesh):
    """One edge-sharded distributed-PGO solve over the mesh's "corr" axis:
    edges sharded, poses replicated, one [M, 6] psum per CG step."""
    from saccot.slam.posegraph import (
        PGOResult, PoseGraph, odometry_chain_init, optimize_pose_graph,
    )

    d = mesh.shape["corr"]
    rng = np.random.default_rng(3)
    M = 8
    gt = [np.eye(4)]
    for _ in range(M - 1):
        gt.append(gt[-1] @ se3np.random_transform(rng, max_angle_rad=0.3,
                                                  max_trans=0.3))
    gt = np.stack(gt)
    ei, ej, meas = [], [], []
    for i in range(M - 1):
        Z = np.linalg.inv(gt[i]) @ gt[i + 1]
        pert = se3np.exp_se3(rng.normal(scale=0.02, size=6))
        ei.append(i); ej.append(i + 1); meas.append(Z @ pert)
    ei.append(0); ej.append(M - 1)
    meas.append(np.linalg.inv(gt[0]) @ gt[M - 1])
    E = len(ei)
    Ep = -(-E // max(d, 1)) * max(d, 1)
    pad = Ep - E
    ei = np.asarray(ei + [0] * pad, np.int32)
    ej = np.asarray(ej + [0] * pad, np.int32)
    meas = np.concatenate([np.stack(meas)] + [np.eye(4)[None]] * pad).astype(np.float32)
    w = np.asarray([1.0] * E + [0.0] * pad, np.float32)
    poses0 = odometry_chain_init(jnp.asarray(meas[: M - 1]))

    if d == 1:
        g = PoseGraph(poses=poses0, edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
                      meas=jnp.asarray(meas), weight=jnp.asarray(w))
        res = optimize_pose_graph(g, iters=3, solver="pcg")
    else:
        def local(ei_s, ej_s, meas_s, w_s):
            g = PoseGraph(poses=poses0, edge_i=ei_s, edge_j=ej_s,
                          meas=meas_s, weight=w_s)
            return optimize_pose_graph(g, iters=3, solver="pcg",
                                       axis_name="corr")

        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("corr"), P("corr"), P("corr"), P("corr")),
            out_specs=PGOResult(poses=P(), final_cost=P(), initial_cost=P()),
            check_vma=False,
        )
        args = (jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(meas), jnp.asarray(w))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            args = multihost_utils.host_local_array_to_global_array(
                args, mesh, (P(), P(), P(), P())
            )
        res = jax.jit(fn)(*args)
    jax.block_until_ready(res.poses)
    ic, fc = float(res.initial_cost), float(res.final_cost)
    assert fc <= ic + 1e-9, f"PGO dryrun cost went up: {ic} -> {fc}"
    print(f"dryrun distributed PGO ok on mesh corr={d}: cost {ic:.4f} -> {fc:.4f}")
    return res
