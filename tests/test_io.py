"""IO loaders, padding/bucketing, checkpoint resume, and CLI smoke tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from saccot.io import loaders


@pytest.fixture
def cloud(rng):
    return rng.normal(size=(100, 3)).astype(np.float32)


def test_ply_binary_roundtrip(tmp_path, cloud):
    path = tmp_path / "c.ply"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(cloud)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(cloud.astype("<f4").tobytes())
    got = loaders.load_ply(str(path))
    np.testing.assert_allclose(got, cloud, atol=1e-6)


def test_ply_ascii_roundtrip(tmp_path, cloud):
    path = tmp_path / "c.ply"
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {len(cloud)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    body = "\n".join(" ".join(f"{v:.6f}" for v in row) for row in cloud)
    path.write_text(header + body + "\n")
    got = loaders.load_ply(str(path))
    np.testing.assert_allclose(got, cloud, atol=1e-5)


def test_pcd_binary_roundtrip(tmp_path, cloud):
    path = tmp_path / "c.pcd"
    header = (
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        f"COUNT 1 1 1\nWIDTH {len(cloud)}\nHEIGHT 1\n"
        f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(cloud)}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(cloud.astype("<f4").tobytes())
    got = loaders.load_pcd(str(path))
    np.testing.assert_allclose(got, cloud, atol=1e-6)


def test_kitti_bin_roundtrip(tmp_path, cloud):
    path = tmp_path / "scan.bin"
    raw = np.concatenate([cloud, np.zeros((len(cloud), 1), np.float32)], axis=1)
    raw.astype("<f4").tofile(path)
    got = loaders.load_kitti_bin(str(path))
    np.testing.assert_allclose(got, cloud, atol=1e-6)


def test_kitti_poses(tmp_path):
    T = np.tile(np.eye(4), (3, 1, 1))
    T[1, :3, 3] = [1, 2, 3]
    rows = T[:, :3, :].reshape(3, 12)
    path = tmp_path / "poses.txt"
    np.savetxt(path, rows)
    got = loaders.load_kitti_poses(str(path))
    np.testing.assert_allclose(got, T, atol=1e-9)


def test_gt_log(tmp_path):
    T = np.eye(4)
    T[:3, 3] = [0.5, -1.0, 2.0]
    lines = ["0 1 52"] + [" ".join(str(v) for v in row) for row in T]
    path = tmp_path / "gt.log"
    path.write_text("\n".join(lines) + "\n")
    got = loaders.load_gt_log(str(path))
    np.testing.assert_allclose(got[(0, 1)], T)


def test_native_prefetch_reader(tmp_path, rng):
    from saccot.io import native

    if not native.available():
        pytest.skip("native library not built")
    clouds = [rng.normal(size=(50 + 10 * i, 3)).astype(np.float32) for i in range(12)]
    paths = []
    for i, c in enumerate(clouds):
        p = tmp_path / f"{i:04d}.bin"
        raw = np.concatenate([c, np.zeros((len(c), 1), np.float32)], axis=1)
        raw.astype("<f4").tofile(p)
        paths.append(str(p))
    # Ordered delivery from a 4-thread pool with a small window.
    reader = native.prefetch_reader(paths, "kitti", max_pts=1000, threads=4, window=3)
    if reader is None:
        pytest.skip("prefetcher entry points missing from .so")
    with reader:
        got = list(reader)
    assert len(got) == len(clouds)
    for g, c in zip(got, clouds):
        np.testing.assert_allclose(g, c, atol=1e-6)
    # Unreadable files yield None without breaking the stream order.
    bad = native.prefetch_reader([paths[0], str(tmp_path / "nope.bin"), paths[1]],
                                 "kitti", max_pts=1000, threads=2, window=2)
    with bad:
        out = list(bad)
    assert out[1] is None
    np.testing.assert_allclose(out[0], clouds[0], atol=1e-6)
    np.testing.assert_allclose(out[2], clouds[1], atol=1e-6)


def test_pad_cloud_bucket(cloud):
    pts, mask = loaders.pad_cloud(cloud, 128)
    assert pts.shape == (128, 3) and mask.sum() == 100
    pts2, mask2 = loaders.pad_cloud(cloud, 64)
    assert pts2.shape == (64, 3) and mask2.sum() == 64
    assert loaders.bucket_for(100) == 1024
    assert loaders.bucket_for(5000) == 8192


def test_sweep_checkpoint_resume(tmp_path):
    from saccot.utils.checkpoint import SweepCheckpointer

    path = str(tmp_path / "ck")
    ck = SweepCheckpointer(path)
    assert not ck.is_done(0)
    ck.record(0, dict(T=np.eye(4)[None].repeat(4, 0)))
    ck.record(1, dict(T=2 * np.eye(4)[None].repeat(4, 0)))

    ck2 = SweepCheckpointer(path)
    assert ck2.is_done(0) and ck2.is_done(1) and not ck2.is_done(2)
    merged = ck2.merged()
    assert merged["T"].shape == (8, 4, 4)
    np.testing.assert_allclose(merged["T"][4], 2 * np.eye(4))


def test_cli_slam_smoke():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "saccot.cli.main", "slam", "--cpu",
         "--scans", "4", "--corr", "128"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["config"] == "slam"
    assert metrics["edges_registered"] == metrics["edges"]


def test_fault_injection_resume(tmp_path):
    """Kill the sweep after shard 0, rerun with the same checkpoint, verify
    it resumes and completes (SURVEY.md section 5, failure detection)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ckpt = str(tmp_path / "ck")
    args = [sys.executable, "-m", "saccot.cli.main", "threedmatch", "--cpu",
            "--pairs", "8", "--corr", "256", "--ckpt", ckpt]
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # batch=16 default means 8 pairs = 1 shard; use pairs=32 -> 2 shards
    args[6] = "32"
    first = subprocess.run(args + ["--fail-after-shard", "0"],
                           capture_output=True, text=True, timeout=600, env=env, cwd=cwd)
    assert first.returncode == 17, (first.returncode, first.stderr[-500:])

    second = subprocess.run(args, capture_output=True, text=True, timeout=600,
                            env=env, cwd=cwd)
    assert second.returncode == 0, second.stderr[-2000:]
    metrics = json.loads(second.stdout.strip().splitlines()[-1])
    assert metrics["pairs"] == 32
    assert metrics["recall"] > 0.9


def test_sequence_files_mode(tmp_path):
    """Odometry over a directory of KITTI .bin scans: prefetch -> features ->
    register -> chain -> ATE vs ground-truth poses."""
    from saccot.cli.sequence import default_sequence_config, run_sequence_files
    from saccot.io.synthetic import blob_cloud
    from saccot.utils import se3np

    rng = np.random.default_rng(7)
    world = blob_cloud(rng, 1500).astype(np.float64)
    n_scans = 4
    poses = [np.eye(4)]
    for _ in range(n_scans - 1):
        dT = se3np.random_transform(rng, max_angle_rad=0.15, max_trans=0.08)
        poses.append(poses[-1] @ dT)
    for i, pose in enumerate(poses):
        scan = se3np.apply_T(np.linalg.inv(pose), world)
        scan = scan + rng.normal(scale=0.002, size=scan.shape)
        raw = np.concatenate([scan, np.zeros((len(scan), 1))], axis=1)
        raw.astype("<f4").tofile(tmp_path / f"{i:06d}.bin")
    np.savetxt(tmp_path / "poses.txt",
               np.stack([p[:3, :].reshape(-1) for p in poses]))

    cfg = default_sequence_config(metric_scale=0.05)
    out = run_sequence_files(
        str(tmp_path), fmt="kitti", poses_path=str(tmp_path / "poses.txt"),
        cfg=cfg, max_pts=2000, bucket=2048,
    )
    assert out["scans"] == n_scans and out["pairs"] == n_scans - 1
    assert out["mean_rot_err_deg"] < 3.0, out
    assert out["ate_rmse"] < 0.1, out
    assert len(out["trajectory"]) == n_scans


def test_slam_state_checkpoint(tmp_path):
    from saccot.utils.checkpoint import restore_slam_state, save_slam_state

    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[2, :3, 3] = [1, 2, 3]
    lm = np.arange(12, dtype=np.float32).reshape(4, 3)
    save_slam_state(str(tmp_path / "slam"), poses, lm, gn_iter=3)
    state = restore_slam_state(str(tmp_path / "slam"))
    np.testing.assert_allclose(state["poses"], poses)
    np.testing.assert_allclose(state["landmarks"], lm)
    assert int(state["gn_iter"]) == 3


def test_cli_files_mode(tmp_path):
    """Register two PLY files end-to-end through the CLI (the reference's
    primary user workflow)."""
    from saccot.io.synthetic import two_view_pair
    from saccot.utils import se3np

    pair = two_view_pair(seed=41, n_points=1500, overlap=0.85, noise=0.002)

    def write_ply(path, pts):
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\nend_header\n"
        )
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(pts.astype("<f4").tobytes())

    write_ply(tmp_path / "src.ply", pair["source"])
    write_ply(tmp_path / "tgt.ply", pair["target"])
    np.savetxt(tmp_path / "gt.txt", pair["T_gt"])

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "saccot.cli.main", "files", "--cpu",
         "--src", str(tmp_path / "src.ply"), "--tgt", str(tmp_path / "tgt.ply"),
         "--gt", str(tmp_path / "gt.txt")],
        capture_output=True, text=True, timeout=500, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["success"]
    assert metrics["rot_err_deg"] < 5.0, metrics
    assert np.asarray(metrics["T"]).shape == (4, 4)


def test_sequence_loop_closure_mode(tmp_path):
    """Sequence mode with --loops: candidates proposed from trajectory
    self-proximity, confirmed by registration, robust PGO tightens ATE
   ."""
    from saccot.cli.sequence import default_sequence_config, run_sequence_files
    from saccot.io.synthetic import blob_cloud
    from saccot.utils import se3np

    rng = np.random.default_rng(17)
    world = blob_cloud(rng, 1500).astype(np.float64)
    # Circular trajectory returning to the start: scans 0 and 5 overlap.
    n_scans = 6
    ang = np.linspace(0, 2 * np.pi, n_scans)
    poses = []
    for a in ang:
        T = np.eye(4)
        T[:3, :3] = se3np.exp_so3(np.array([0.0, 0.0, a * 0.05]))
        T[0, 3] = np.cos(a) * 0.12 - 0.12
        T[1, 3] = np.sin(a) * 0.12
        poses.append(T)
    for i, pose in enumerate(poses):
        scan = se3np.apply_T(np.linalg.inv(pose), world)
        scan = scan + rng.normal(scale=0.002, size=scan.shape)
        raw = np.concatenate([scan, np.zeros((len(scan), 1))], axis=1)
        raw.astype("<f4").tofile(tmp_path / f"{i:06d}.bin")
    np.savetxt(tmp_path / "poses.txt",
               np.stack([p[:3, :].reshape(-1) for p in poses]))

    cfg = default_sequence_config(metric_scale=0.05)
    out = run_sequence_files(
        str(tmp_path), fmt="kitti", poses_path=str(tmp_path / "poses.txt"),
        cfg=cfg, max_pts=2000, bucket=2048,
        loops=True, loop_min_gap=3, loop_min_inliers=10,
    )
    assert out["loop_candidates"] >= 1
    assert out["loop_closures"] >= 1, out
    assert "ate_rmse_optimized" in out
    # The robust PGO must not corrupt the trajectory; with confirmed loops
    # it should be at least as good as raw odometry (small slack for the
    # f32 solve).
    assert out["ate_rmse_optimized"] <= out["ate_rmse"] * 1.2 + 1e-4, out


def test_cli_u3m_allpairs_smoke():
    """U3M all-pairs sweep (r5; BASELINE.json:8 'full pairwise registration
    sweep'): V views of one model, all V(V-1)/2 pairs, recall over the
    overlap-eligible subset + per-band table."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "saccot.cli.main", "u3m", "--cpu",
         "--views", "5"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["views"] == 5
    assert metrics["pairs"] == 10  # complete 5*4/2 pair list
    assert metrics["eligible_pairs"] >= 4
    assert metrics["recall"] >= 0.75, metrics
    assert "recall_by_overlap_band" in metrics
