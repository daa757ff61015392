"""128-scan sequence with loop closures through the real-file sequence mode.

Generates a structured synthetic scene (clustered geometric texture over a
~20 m extent), renders a 128-scan circular trajectory to KITTI-format .bin
files, and runs the real-file sequence mode end to end on the default
device:
native-prefetch loading, per-scan features, odometry chaining, loop
proposal/confirmation, and the (now matrix-free PCG) robust pose graph at
M=128. Reports ATE before/after PGO and wall time.

Usage: python scripts/exp_sequence128.py [n_scans] [outdir]
(outdir defaults to build/seq128 under the repository root.)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

n_scans = int(sys.argv[1]) if len(sys.argv) > 1 else 128
outdir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "seq128")

from saccot.io.synthetic import blob_cloud
from saccot.utils import se3np


def make_world(rng, n_points=160_000, extent=20.0, n_clusters=160):
    """Clustered 'boulder field': deformed-sphere SURFACES (blob_cloud),
    not volumetric Gaussians — local-feature registration needs surfaces
    with well-defined normals (a volumetric cluster scene measurably fails
    to register; that run is the negative control, not a bug)."""
    centers = rng.uniform(-extent / 2, extent / 2, size=(n_clusters, 3))
    centers[:, 2] *= 0.15  # mostly a ground-plane scene
    pts = []
    per = n_points // n_clusters
    for c in centers:
        scale = rng.uniform(0.4, 1.1)
        surf = blob_cloud(rng, per) * scale
        Rm = se3np.random_transform(rng, max_angle_rad=3.0, max_trans=0.0)[:3, :3]
        pts.append(surf @ Rm.T + c)
    return np.concatenate(pts)[:n_points]


def main():
    rng = np.random.default_rng(11)
    os.makedirs(outdir, exist_ok=True)
    world = make_world(rng)
    print(f"world: {world.shape[0]} pts, extent ~{np.ptp(world[:, 0]):.1f} m")

    # Circular trajectory, one full loop back to the start.
    R = 6.0
    ang = np.linspace(0, 2 * np.pi, n_scans)
    poses = []
    for a in ang:
        T = np.eye(4)
        T[:3, :3] = se3np.exp_so3(np.array([0.0, 0.0, a]))
        T[0, 3] = np.cos(a) * R
        T[1, 3] = np.sin(a) * R
        poses.append(T)

    view_radius = 11.0
    max_scan = 80_000
    for i, pose in enumerate(poses):
        pos = pose[:3, 3]
        d = np.linalg.norm(world - pos, axis=1)
        vis = world[d < view_radius]
        if len(vis) > max_scan:
            vis = vis[rng.choice(len(vis), size=max_scan, replace=False)]
        scan = se3np.apply_T(np.linalg.inv(pose), vis)
        scan = scan + rng.normal(scale=0.01, size=scan.shape)
        raw = np.concatenate([scan, np.zeros((len(scan), 1))], axis=1)
        raw.astype("<f4").tofile(os.path.join(outdir, f"{i:06d}.bin"))
    np.savetxt(os.path.join(outdir, "poses.txt"),
               np.stack([p[:3, :].reshape(-1) for p in poses]))
    print(f"wrote {n_scans} scans to {outdir}")

    from saccot.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from saccot.cli.sequence import default_sequence_config, run_sequence_files

    cfg = default_sequence_config(metric_scale=0.25)
    t0 = time.time()
    out = run_sequence_files(
        outdir, fmt="kitti", poses_path=os.path.join(outdir, "poses.txt"),
        cfg=cfg, max_pts=max_scan, bucket=81920,
        loops=True, loop_min_gap=8, max_loops=24, loop_min_inliers=10,
        loop_radius=2.5,
        pgo_iters=12,
    )
    wall = time.time() - t0
    print(f"scans={out['scans']} pairs={out['pairs']} "
          f"mean_inliers={out['mean_inliers']:.0f}")
    print(f"mean rot err {out['mean_rot_err_deg']:.3f} deg, "
          f"mean trans err {out['mean_trans_err']:.4f} m")
    print(f"loop candidates {out.get('loop_candidates')} "
          f"closures {out.get('loop_closures')}")
    print(f"ATE odometry {out['ate_rmse']:.4f} -> optimized "
          f"{out.get('ate_rmse_optimized', float('nan')):.4f} (M={n_scans}, PCG PGO)")
    print(f"wall {wall:.1f} s = {wall / out['pairs'] * 1e3:.0f} ms/pair incl. features")


if __name__ == "__main__":
    main()
