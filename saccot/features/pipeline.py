"""Full registration pipeline: clouds in, transform out.

The jitted equivalent of the reference's whole L1-L5 call stack
(SURVEY.md section 3.1): voxel downsample -> normals -> ISS keypoints ->
SHOT/FPFH descriptors -> GEMM+top-k matching -> SAC-COT estimation, all
inside one jitted program with static shapes. Thresholds are expressed in
mesh-resolution multiples (the paper's convention); the geometry is rescaled
to resolution units inside the trace, so the estimator's static thresholds
stay config constants even though the resolution is data-dependent.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from saccot.engine.icp import IcpParams, icp as icp_refine
from saccot.engine.sac_cot import RegistrationResult, _register_pair
from saccot.features.fpfh import fpfh_descriptors
from saccot.features.iss import iss_keypoints, Keypoints
from saccot.features.normals import estimate_normals
from saccot.features.resolution import mesh_resolution
from saccot.features.shot import shot_descriptors
from saccot.features.voxel import voxel_downsample
from saccot.match.topk import match_descriptors, mutual_filter
from saccot.utils.params import SacCotParams


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the cloud->transform pipeline.

    All radii/thresholds are multiples of the source cloud's mesh
    resolution `pr` unless `metric_scale` is set, in which case they are
    multiples of that metric value (scene-scale datasets).
    """

    # preprocessing
    voxel_mult: float = 0.0          # voxel size in pr units; 0 disables
    max_cloud_points: int = 8192     # static budget after downsampling
    normal_k: int = 16
    # approx_max_k neighbor selection for the sampling-tolerant stages
    # (normals/ISS/descriptor supports; ~99% neighbor recall where the
    # backend approximates, features/neighbors.py). Matching and mesh
    # resolution stay exact. Recall-checked on the bunny/u3m configs.
    approx_knn: bool = True

    # keypoints
    keypoints: str = "iss"           # "iss" | "harris"
    iss_salient_mult: float = 4.0
    iss_nms_mult: float = 3.0
    iss_gamma21: float = 0.975
    iss_gamma32: float = 0.975
    harris_k: float = 0.04
    max_keypoints: int = 1024

    # descriptors
    descriptor: str = "shot"         # "shot" | "fpfh"
    descriptor_radius_mult: float = 8.0
    descriptor_k: int = 64
    # Soft (linear-interpolated) histogram binning for SHOT/FPFH: the
    # PCL-style robustness mechanism. Default ON (a noise-sweep A/B found
    # it better at high noise); set False for the hard-binned variant.
    descriptor_soft: bool = True

    # matching
    max_correspondences: int = 1024
    mutual: bool = True
    ratio_test: float = 0.0

    # estimator thresholds in pr units
    compat_mult: float = 5.0
    min_sep_mult: float = 8.0
    inlier_mult: float = 5.0
    estimator: SacCotParams = SacCotParams()

    # optional dense-cloud ICP polish of the estimated transform
    # (engine/icp.py); distances inside IcpParams are in pr units, matching
    # every other threshold here. None disables.
    icp: Optional["IcpParams"] = None

    metric_scale: Optional[float] = None

    def __post_init__(self):
        if self.descriptor not in ("shot", "fpfh"):
            raise ValueError(f"unknown descriptor {self.descriptor!r}")
        if self.keypoints not in ("iss", "harris"):
            raise ValueError(f"unknown keypoint detector {self.keypoints!r}")


class PipelineResult(NamedTuple):
    registration: RegistrationResult
    resolution: jnp.ndarray
    num_keypoints_src: jnp.ndarray
    num_keypoints_tgt: jnp.ndarray
    num_correspondences: jnp.ndarray
    # Final weighted inlier RMSE of the ICP polish, in pr units; 0 when the
    # config has icp=None.
    icp_rmse: jnp.ndarray = 0.0
    # Matched correspondence sets in METRIC units ([max_correspondences, 3]
    # each; registration.inliers masks them) — what the SLAM layer needs to
    # derive [6, 6] edge information matrices (slam/frontend.edge_information)
    # instead of crude inlier-count weights. 0-sized placeholder when absent.
    corr_P: jnp.ndarray = 0.0
    corr_Q: jnp.ndarray = 0.0


def extract_features(
    points: jnp.ndarray,
    cfg: PipelineConfig,
    pr: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[Keypoints, jnp.ndarray]:
    """Keypoints + descriptors for one cloud. pr: mesh resolution scalar."""
    # ONE shared self-kNN feeds normals + ISS saliency + ISS NMS: the
    # ascending-sorted columns slice exactly to each consumer's k, cutting
    # three full N^2 kNN passes per scan to one.
    from saccot.features.neighbors import knn as _knn

    kk = max(cfg.normal_k, 32)
    nbrs = _knn(points, points, k=kk, query_mask=mask, ref_mask=mask,
                exclude_self=False, approx=cfg.approx_knn)
    normals = estimate_normals(points, k=cfg.normal_k, mask=mask,
                               neighbors=nbrs)
    if cfg.keypoints == "harris":
        from saccot.features.harris import harris_keypoints

        kps = harris_keypoints(
            points,
            normals,
            radius=cfg.iss_salient_mult * pr,
            nms_radius=cfg.iss_nms_mult * pr,
            max_keypoints=cfg.max_keypoints,
            harris_k=cfg.harris_k,
            mask=mask,
        )
    else:
        kps = iss_keypoints(
            points,
            salient_radius=cfg.iss_salient_mult * pr,
            nms_radius=cfg.iss_nms_mult * pr,
            max_keypoints=cfg.max_keypoints,
            gamma21=cfg.iss_gamma21,
            gamma32=cfg.iss_gamma32,
            mask=mask,
            neighbors=nbrs,
        )
    r_desc = cfg.descriptor_radius_mult * pr
    if cfg.descriptor == "shot":
        desc = shot_descriptors(points, normals, kps.idx, r_desc,
                                k=cfg.descriptor_k, mask=mask,
                                approx=cfg.approx_knn,
                                soft=cfg.descriptor_soft)
    else:
        desc = fpfh_descriptors(points, normals, kps.idx, r_desc,
                                k=cfg.descriptor_k, mask=mask,
                                approx=cfg.approx_knn,
                                soft=cfg.descriptor_soft)
    return kps, desc


def _register_clouds(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    cfg: PipelineConfig,
    src_mask: Optional[jnp.ndarray],
    tgt_mask: Optional[jnp.ndarray],
) -> PipelineResult:
    src = src.astype(jnp.float32)
    tgt = tgt.astype(jnp.float32)

    if cfg.metric_scale is not None:
        pr = jnp.asarray(cfg.metric_scale, jnp.float32)
    else:
        pr = mesh_resolution(src, mask=src_mask)

    if cfg.voxel_mult > 0:
        # Voxel size in pr units is data-dependent; static shapes force a
        # fixed budget. (Radii keep using the *original* resolution scale.)
        src, src_mask = voxel_downsample(src, cfg.voxel_mult * pr, cfg.max_cloud_points, src_mask)
        tgt, tgt_mask = voxel_downsample(tgt, cfg.voxel_mult * pr, cfg.max_cloud_points, tgt_mask)

    kp_s, d_s = extract_features(src, cfg, pr, mask=src_mask)
    kp_t, d_t = extract_features(tgt, cfg, pr, mask=tgt_mask)

    matches = match_descriptors(
        d_s, d_t, mask_src=kp_s.valid, mask_tgt=kp_t.valid,
        mutual=cfg.mutual, ratio_test=cfg.ratio_test,
    )
    matches = mutual_filter(matches, cfg.max_correspondences)
    P = kp_s.xyz[matches.src_idx]
    Q = kp_t.xyz[matches.tgt_idx]
    cmask = matches.valid.astype(jnp.float32)

    # Thresholds scale with the (traced) resolution, so they cannot live in
    # the static params. Instead the *geometry* is rescaled to resolution
    # units — exactly equivalent, and params stay static.
    inv_pr = 1.0 / jnp.maximum(pr, 1e-12)
    params = dataclasses.replace(
        cfg.estimator,
        compat_tau=float(cfg.compat_mult),
        min_separation=float(cfg.min_sep_mult),
        inlier_tau=float(cfg.inlier_mult),
    )
    reg = _register_pair(P * inv_pr, Q * inv_pr, cmask, params)

    icp_rmse = jnp.float32(0.0)
    if cfg.icp is not None:
        # Dense polish on the (downsampled) clouds in resolution units, so
        # IcpParams distances follow the same pr-multiple convention; the
        # coarse estimate (still in pr units here) seeds it.
        pol = icp_refine(
            src * inv_pr, tgt * inv_pr, cfg.icp, T_init=reg.T,
            mask_src=src_mask, mask_tgt=tgt_mask,
        )
        reg = reg._replace(R=pol.R, t=pol.t, T=pol.T)
        icp_rmse = pol.rmse

    # Un-scale the translation back to metric units (R is scale-free).
    t_metric = reg.t * pr
    reg = reg._replace(
        t=t_metric,
        T=reg.T.at[:3, 3].set(t_metric),
    )
    return PipelineResult(
        registration=reg,
        resolution=pr,
        num_keypoints_src=jnp.sum(kp_s.valid).astype(jnp.int32),
        num_keypoints_tgt=jnp.sum(kp_t.valid).astype(jnp.int32),
        num_correspondences=jnp.sum(matches.valid).astype(jnp.int32),
        icp_rmse=icp_rmse,
    )


class ScanFeatures(NamedTuple):
    """Per-scan features, reusable across every pair the scan appears in."""

    kp_xyz: jnp.ndarray    # [max_keypoints, 3]
    kp_valid: jnp.ndarray  # [max_keypoints] bool
    desc: jnp.ndarray      # [max_keypoints, D]
    resolution: jnp.ndarray  # scalar pr used for this scan's radii


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_scan_features(
    points: jnp.ndarray,
    cfg: PipelineConfig,
    mask: Optional[jnp.ndarray] = None,
) -> ScanFeatures:
    """One scan -> keypoints + descriptors, computed once.

    Sequence workloads (odometry, SLAM frontends) register each scan against
    its neighbors; recomputing features per *pair* (as `register_clouds`
    does for the two-cloud workflow) doubles the feature cost. This entry
    computes them per *scan*; pair `register_scan_features` with it.
    """
    points = points.astype(jnp.float32)
    if cfg.metric_scale is not None:
        pr = jnp.asarray(cfg.metric_scale, jnp.float32)
    else:
        pr = mesh_resolution(points, mask=mask)
    if cfg.voxel_mult > 0:
        points, mask = voxel_downsample(points, cfg.voxel_mult * pr, cfg.max_cloud_points, mask)
    kps, desc = extract_features(points, cfg, pr, mask=mask)
    return ScanFeatures(kp_xyz=kps.xyz, kp_valid=kps.valid, desc=desc, resolution=pr)


@functools.partial(jax.jit, static_argnames=("cfg",))
def register_scan_features(
    src: ScanFeatures,
    tgt: ScanFeatures,
    cfg: PipelineConfig,
) -> PipelineResult:
    """Match + estimate between two scans' precomputed features.

    Thresholds use the source scan's resolution, matching `register_clouds`'
    convention (identical results when both scans share a metric_scale).
    """
    matches = match_descriptors(
        src.desc, tgt.desc, mask_src=src.kp_valid, mask_tgt=tgt.kp_valid,
        mutual=cfg.mutual, ratio_test=cfg.ratio_test,
    )
    matches = mutual_filter(matches, cfg.max_correspondences)
    P = src.kp_xyz[matches.src_idx]
    Q = tgt.kp_xyz[matches.tgt_idx]
    cmask = matches.valid.astype(jnp.float32)

    pr = src.resolution
    inv_pr = 1.0 / jnp.maximum(pr, 1e-12)
    params = dataclasses.replace(
        cfg.estimator,
        compat_tau=float(cfg.compat_mult),
        min_separation=float(cfg.min_sep_mult),
        inlier_tau=float(cfg.inlier_mult),
    )
    reg = _register_pair(P * inv_pr, Q * inv_pr, cmask, params)
    t_metric = reg.t * pr
    reg = reg._replace(t=t_metric, T=reg.T.at[:3, 3].set(t_metric))
    return PipelineResult(
        registration=reg,
        resolution=pr,
        num_keypoints_src=jnp.sum(src.kp_valid).astype(jnp.int32),
        num_keypoints_tgt=jnp.sum(tgt.kp_valid).astype(jnp.int32),
        num_correspondences=jnp.sum(matches.valid).astype(jnp.int32),
        corr_P=P,
        corr_Q=Q,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def register_clouds(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    cfg: PipelineConfig,
    src_mask: Optional[jnp.ndarray] = None,
    tgt_mask: Optional[jnp.ndarray] = None,
) -> PipelineResult:
    """End-to-end: two raw clouds -> rigid transform (target = T * source)."""
    return _register_clouds(src, tgt, cfg, src_mask, tgt_mask)


def register_clouds_batch(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    cfg: PipelineConfig,
    src_mask: Optional[jnp.ndarray] = None,
    tgt_mask: Optional[jnp.ndarray] = None,
) -> PipelineResult:
    """vmap of the full pipeline over a leading batch of cloud pairs.

    src/tgt: [B, N, 3]; masks optional [B, N]. This is the unit a
    pipeline-level sweep DP-shards over the "pairs" mesh axis, mirroring
    engine.sac_cot.register_batch for raw-cloud inputs.
    """
    B = src.shape[0]
    if src_mask is None:
        src_mask = jnp.ones(src.shape[:2], jnp.float32)
    if tgt_mask is None:
        tgt_mask = jnp.ones(tgt.shape[:2], jnp.float32)
    fn = lambda s, t, sm, tm: _register_clouds(s, t, cfg, sm, tm)
    return jax.vmap(fn)(src, tgt, src_mask, tgt_mask)
