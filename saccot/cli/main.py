"""Command-line entry point: `python -m saccot.cli.main <config> [options]`.

The reference's `main(argc, argv)` equivalent (SURVEY.md section 1.2, L6):
pick a benchmark config, run it, print the metrics dict as one JSON line on
stdout (diagnostics to stderr, per-pair records to --log as JSONL).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from saccot.cli.configs import CONFIGS
from saccot.cli.runners import run_config
from saccot.dist.mesh import init_distributed
from saccot.utils.logging import JsonlLogger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="saccot", description=__doc__)
    ap.add_argument(
        "config",
        choices=sorted(CONFIGS) + ["files", "sequence", "ablate", "external"],
        help="benchmark config, 'files' to register two cloud files, "
             "'sequence' to run odometry over a directory of scans, "
             "'ablate' for the paper-style sampler comparison "
             "(random / edge-guided / triangle-guided at equal budgets), or "
             "'external' for the real-3DMatch protocol (per-fragment .npz "
             "descriptors + gt.log -> RE/TE recall)",
    )
    ap.add_argument("--src", type=str, default=None, help="source cloud file (files mode)")
    ap.add_argument("--tgt", type=str, default=None, help="target cloud file (files mode)")
    ap.add_argument("--dir", type=str, default=None,
                    help="scan directory or comma-separated files (sequence mode)")
    ap.add_argument("--fmt", choices=["kitti", "ply"], default="kitti",
                    help="scan format (sequence mode)")
    ap.add_argument("--poses", type=str, default=None,
                    help="KITTI-format ground-truth poses (sequence mode)")
    ap.add_argument("--stride", type=int, default=1, help="scan stride (sequence mode)")
    ap.add_argument("--loops", action="store_true",
                    help="propose + confirm loop closures and optimize the "
                         "robust pose graph (sequence mode)")
    ap.add_argument("--descriptor", choices=["shot", "fpfh"], default="shot")
    ap.add_argument("--gt", type=str, default=None,
                    help="optional 4x4 ground-truth transform (whitespace text) to evaluate against")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=None, help="override pair count")
    ap.add_argument("--scans", type=int, default=None, help="override scan count (slam)")
    ap.add_argument("--views", type=int, default=None,
                    help="override view count (u3m all-pairs sweep)")
    ap.add_argument("--corr", type=int, default=None, help="override correspondence count")
    ap.add_argument("--log", type=str, default=None, help="JSONL per-pair log path")
    ap.add_argument("--ckpt", type=str, default=None, help="sweep checkpoint dir")
    ap.add_argument("--batch", type=int, default=None,
                    help="device batch size for the sweep configs (default 16)")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--icp", action="store_true",
                    help="dense trimmed-ICP polish after the estimator "
                         "(pipeline configs: bunny, u3m)")
    ap.add_argument("--outliers", type=str, default="0.8,0.9,0.95",
                    help="comma-separated outlier ratios (ablate mode)")
    ap.add_argument("--budget", type=int, default=512,
                    help="sample budget K shared by all samplers (ablate mode)")
    ap.add_argument("--fail-after-shard", type=int, default=None,
                    help="fault injection: crash after checkpointing this shard")
    ap.add_argument("--gt-log", type=str, default=None,
                    help="3DMatch-style gt.log of ground-truth pair transforms "
                         "(external mode)")
    ap.add_argument("--max-corr", type=int, default=2048,
                    help="correspondence cap per pair (external mode)")
    ap.add_argument("--out-log", type=str, default=None,
                    help="write estimated transforms as a 3DMatch-style .log "
                         "(external mode; consumable by the standard "
                         "Redwood/3DMatch evaluation scripts)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from saccot.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    init_distributed()

    if args.config == "files":
        from saccot.cli.files import register_files

        if not args.src or not args.tgt:
            ap.error("files mode requires --src and --tgt")
        metrics = register_files(args.src, args.tgt, descriptor=args.descriptor,
                                 gt_path=args.gt)
        print(json.dumps(metrics))
        return 0

    if args.config == "external":
        from saccot.cli.external import run_external

        if not args.dir or not args.gt_log:
            ap.error("external mode requires --dir and --gt-log")
        kw = {}
        if args.log:
            kw["log"] = JsonlLogger(args.log)
        metrics = run_external(
            args.dir, args.gt_log, max_correspondences=args.max_corr,
            out_log=args.out_log, **kw
        )
        print(json.dumps(metrics))
        return 0

    if args.config == "sequence":
        from saccot.cli.sequence import run_sequence_files

        if not args.dir:
            ap.error("sequence mode requires --dir")
        kw = {}
        if args.log:
            kw["log"] = JsonlLogger(args.log)
        metrics = run_sequence_files(
            args.dir, fmt=args.fmt, poses_path=args.poses, stride=args.stride,
            loops=args.loops, **kw
        )
        metrics.pop("trajectory", None)  # keep the stdout JSON line compact
        print(json.dumps(metrics))
        return 0

    if args.config == "ablate":
        import dataclasses as _dc

        from saccot.evaluation.ablation import format_table, run_sampler_ablation
        from saccot.cli.configs import _OBJ_PARAMS

        params = _dc.replace(_OBJ_PARAMS, max_hypotheses=args.budget)
        res = run_sampler_ablation(
            params,
            outlier_ratios=tuple(float(x) for x in args.outliers.split(",")),
            n_pairs=args.pairs or 32,
            n_corr=args.corr or 1000,
            seed=args.seed or 0,
        )
        print(format_table(res), file=sys.stderr)
        print(json.dumps({"recall": {s: {str(k): v for k, v in row.items()}
                                     for s, row in res["recall"].items()},
                          "budget": res["budget"]}))
        return 0

    cfg = CONFIGS[args.config]
    overrides = {}
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.pairs is not None:
        overrides["n_pairs"] = args.pairs
    if args.scans is not None:
        overrides["n_scans"] = args.scans
    if args.corr is not None:
        overrides["n_corr"] = args.corr
    if args.views is not None:
        overrides["n_views"] = args.views
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.icp:
        if cfg.pipeline is None:
            ap.error(f"--icp applies to pipeline configs, not {cfg.name!r}")
        from saccot.engine.icp import IcpParams

        cfg = dataclasses.replace(
            cfg,
            pipeline=dataclasses.replace(
                cfg.pipeline,
                icp=IcpParams(max_iters=10, max_corr_dist=6.0, trim_frac=0.8),
            ),
        )

    kw = {}
    if args.log:
        kw["log"] = JsonlLogger(args.log)
    if args.ckpt and cfg.kind in ("sweep", "slam"):
        kw["ckpt"] = args.ckpt
    if args.fail_after_shard is not None and cfg.kind == "sweep":
        kw["fail_after_shard"] = args.fail_after_shard
    if args.batch is not None and cfg.kind == "sweep":
        kw["batch"] = args.batch

    metrics = run_config(cfg, **kw)
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
