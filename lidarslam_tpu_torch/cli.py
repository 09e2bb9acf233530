"""Command line: offline replay, golden-run comparison, map export.

The production front end of the engine (the role LidarSlamNode plays in
the reference, minus ROS): feed a sweep sequence (synthetic or a directory of
PCD sweeps), write `Poses.csv` / `Evaluators.csv` in the reference regression
format, optionally save maps, and compare runs against a golden reference
with the CI thresholds (eval.yaml:11-13).

The PyTorch port's copy of `lidarslam_tpu/cli.py`: the same subcommands,
flags, output files and JSON last lines, driving the port's `Slam`. Every
command that computes (run, extract, serve) runs on the CUDA device, and
fails where there is none, unless `--cpu` asks for the CPU (the plain
PyTorch versions); aggregate and compare are host numpy.

Usage:
  python -m lidarslam_tpu_torch.cli run --synthetic 30 --out results/
  python -m lidarslam_tpu_torch.cli run --config configs/slam_config_outdoor.yaml \
      --pcd-dir sweeps/ --rate 10 --out results/
  python -m lidarslam_tpu_torch.cli --cpu run --synthetic 5 --out results/
  python -m lidarslam_tpu_torch.cli compare --res results/ --ref golden/
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _device(args) -> str:
    """The device of every command that computes: the CUDA device unless
    `--cpu` asks for the CPU. There is no fallback: without a CUDA device
    the command ends here."""
    if args.cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lidarslam_tpu_torch: no CUDA device (torch.cuda.is_available() "
                         "is False); pass --cpu to run on the CPU")
    return "cuda"


def _build_slam(args):
    import dataclasses

    from lidarslam_tpu_torch import Slam, SlamConfig
    from lidarslam_tpu_torch.config import EgoMotionMode, ExtractorConfig, UndistortionMode

    if args.config:
        from lidarslam_tpu_torch.io.yaml_config import load_config
        cfg = load_config(args.config)
        # only override capacities the user explicitly passed — a yaml
        # configured for a 64-beam sensor must keep its tpu.n_rings
        ekw = {}
        if args.rings is not None:
            ekw["n_rings"] = args.rings
        if args.max_ring_points is not None:
            ekw["max_ring_points"] = args.max_ring_points
        if args.max_keypoints is not None:
            ekw["max_keypoints"] = args.max_keypoints
        cfg = dataclasses.replace(
            cfg, verbosity=max(cfg.verbosity, args.verbosity),
            extractor=dataclasses.replace(cfg.extractor, **ekw))
    else:
        cfg = SlamConfig(
            ego_motion_mode=EgoMotionMode(args.ego_motion),
            undistortion=UndistortionMode(args.undistortion),
            use_blobs=args.use_blobs,
            extractor=ExtractorConfig(n_rings=args.rings or 16,
                                      max_ring_points=args.max_ring_points or 2048,
                                      max_keypoints=args.max_keypoints or 2048),
            verbosity=args.verbosity,
        )
    if getattr(args, "log_dir", None):
        from lidarslam_tpu_torch.config import LoggingStorage
        cfg = dataclasses.replace(cfg, logging_storage=LoggingStorage.DISK,
                                  logging_dir=args.log_dir)
    return Slam(cfg, device=_device(args))


def _frames_from_args(args):
    if args.synthetic:
        from lidarslam_tpu_torch.io import synthetic
        sensor = synthetic.SensorModel(n_rings=args.rings or 16)
        return synthetic.generate_sequence(n_frames=args.synthetic, sensor=sensor,
                                           motion_distortion=args.undistortion > 0)
    if getattr(args, "kitti_dir", None):
        from lidarslam_tpu_torch.io import kitti
        return list(kitti.load_sequence(args.kitti_dir, rate=args.rate,
                                        limit=args.limit or None))
    if args.pcd_dir:
        from lidarslam_tpu_torch.io import pcd
        frames = []
        for i, path in enumerate(sorted(glob.glob(os.path.join(args.pcd_dir, "*.pcd")))):
            data = pcd.load_pcd(path)
            n = len(data["xyz"])
            frames.append({
                "xyz": data["xyz"],
                "intensity": data.get("intensity", __import__("numpy").zeros(n)),
                "laser_id": data.get("laser_id", __import__("numpy").zeros(n, int)),
                "time": data.get("time", __import__("numpy").zeros(n)),
                "stamp": i / args.rate,
                "seq": i,
            })
        return frames
    raise SystemExit("need --synthetic N, --pcd-dir DIR or --kitti-dir DIR")


def cmd_run(args):
    import numpy as np
    from lidarslam_tpu_torch.io import csv_log

    slam = _build_slam(args)
    frames = _frames_from_args(args)
    os.makedirs(args.out, exist_ok=True)

    poses, evals, summaries = [], [], []
    if getattr(args, "follow", False):
        # live output stream: the vtkSlam port surface as a subscription
        # (outputs.FrameOutput); frames run through the streaming path and
        # every flushed frame is reported as it lands
        import time as _time

        def on_frame(o):
            p = o.pose[:3, 3]
            print(f"frame {o.frame_index}: stamp {o.stamp:.3f} "
                  f"pos [{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}] "
                  f"matches {o.n_matches} overlap {o.overlap:.2f}"
                  f"{' KF' if o.is_keyframe else ''}", flush=True)
            poses.append((o.stamp, o.pose))
            summaries.append({"overlap": o.overlap, "n_matches": o.n_matches,
                              "failure": o.failure,
                              "comply_motion_limits": o.comply_motion_limits,
                              "covariance": o.covariance, "pose": o.pose})

        slam.subscribe(on_frame)
        t0 = _time.perf_counter()
        for i, f in enumerate(frames):
            slam.add_frame_async(f)
            if (i + 1) % 16 == 0:
                slam.flush()
        slam.flush()
        per = (_time.perf_counter() - t0) / max(len(poses), 1)
        evals = [(s, r["overlap"], r["n_matches"], per)
                 for (s, _), r in zip(poses, summaries)]
    else:
        for i, f in enumerate(frames):
            r = slam.add_frame(f)
            if "skipped" in r:
                print(f"frame {i}: skipped ({r['skipped']})", file=sys.stderr)
                continue
            poses.append((f["stamp"], r["pose"]))
            evals.append((f["stamp"], r["overlap"], r["n_matches"], r["duration"]))
            summaries.append(r)
            if args.verbosity >= 1:
                p = r["pose"][:3, 3]
                print(f"frame {i}: pos [{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}] "
                      f"matches {r['n_matches']} {r['duration']*1000:.0f} ms")

    csv_log.write_poses_csv(os.path.join(args.out, "Poses.csv"), poses)
    csv_log.write_evaluators_csv(os.path.join(args.out, "Evaluators.csv"), evals)
    csv_log.write_kitti_poses(os.path.join(args.out, "poses_kitti.txt"), poses)
    csv_log.write_tum_poses(os.path.join(args.out, "poses_tum.txt"), poses)
    if args.save_maps:
        slam.save_maps_to_pcd(os.path.join(args.out, "map_"))
    from lidarslam_tpu_torch.io import export
    export.write_trajectory_csv(os.path.join(args.out, "Trajectory.csv"),
                                slam, extras=summaries)
    export.save_trajectory_ply(os.path.join(args.out, "trajectory.ply"), slam)
    if getattr(args, "vtp", False):
        # ParaView-consumable outputs (the vtkSlam port payloads as files)
        from lidarslam_tpu_torch.io import vtp as vtp_mod
        vtp_mod.write_trajectory_vtp(os.path.join(args.out, "trajectory.vtp"),
                                     slam)
        for k in slam.cfg.used_types:
            pts, inten, _, _ = slam.get_map_points(k)
            vtp_mod.write_point_cloud_vtp(
                os.path.join(args.out, f"map_{k.name.lower()}.vtp"), pts,
                {"Intensity": inten})
    n_agg = None
    if args.aggregate:
        n_agg = export.save_aggregated_pcd(
            os.path.join(args.out, "aggregated.pcd"), slam)
    d = np.array([e[3] for e in evals])
    print(json.dumps({"frames": len(poses),
                      "mean_frame_ms": round(float(d.mean() * 1000), 2) if len(d) else None,
                      "aggregated_points": n_agg,
                      "out": args.out}))


def cmd_extract(args):
    """Standalone keypoint extraction: run only the front-end over a
    sweep sequence and dump per-type keypoint PCDs plus (optionally) a
    per-point debug-score cloud. The vtkSpinningSensorKeypointExtractor
    surface (paraview_wrapping vtkSSKE; debug arrays per SSKE.cxx:640-680),
    detached from the full SLAM loop. The port's extractor runs eagerly on
    the command's device."""
    import numpy as np

    from lidarslam_tpu_torch.config import ExtractorConfig, KEYPOINT_NAMES
    from lidarslam_tpu_torch.io import pcd
    from lidarslam_tpu_torch.ops.extractor import extract_keypoints
    from lidarslam_tpu_torch.ops.frame import (build_range_image,
                                               estimate_azimuthal_resolution)

    if args.config:
        from lidarslam_tpu_torch.io.yaml_config import load_config
        ecfg = load_config(args.config).extractor
        if args.rings is not None:
            import dataclasses
            ecfg = dataclasses.replace(ecfg, n_rings=args.rings)
    else:
        ecfg = ExtractorConfig(n_rings=args.rings or 16)
    device = _device(args)
    frames = _frames_from_args(args)
    os.makedirs(args.out, exist_ok=True)

    def host(t):
        return t.cpu().numpy()

    summary = []
    for i, f in enumerate(frames):
        ri = build_range_image(f["xyz"], f["intensity"], f["laser_id"],
                               f["time"], ecfg.n_rings, ecfg.max_ring_points,
                               device=device)
        az = float(estimate_azimuthal_resolution(ri))
        ext = extract_keypoints(ri, az, ecfg, with_debug=args.debug)
        counts = {}
        for name, kp in (("edge", ext.edges), ("plane", ext.planes),
                         ("blob", ext.blobs)):
            if name == "blob" and not args.blobs:
                continue
            n = int(kp.count)
            counts[name] = n
            pcd.save_pcd(os.path.join(args.out, f"frame_{i:04d}_{name}.pcd"),
                         host(kp.xyz)[:n],
                         intensity=host(kp.intensity)[:n],
                         time=host(kp.time)[:n],
                         laser_id=host(kp.ring)[:n])
        if args.debug:
            m = host(ri.valid)
            labels = sum(host(ext.debug[f"{KEYPOINT_NAMES[t]}_keypoint"]).astype(np.float32)
                         * (t + 1) for t in (0, 1, 2))
            extra = {k: host(ext.debug[k]).astype(np.float32)[m]
                     for k in ("sin_angle", "saliency", "depth_gap",
                               "intensity_gap", "point_validity")}
            extra["keypoint_label"] = labels[m]
            pcd.save_pcd_fields(
                os.path.join(args.out, f"frame_{i:04d}_debug.pcd"),
                host(ri.xyz)[m], extra)
        summary.append({"frame": i, "azimuthal_resolution": az, **counts})
        if args.verbosity >= 1:
            print(f"frame {i}: {counts}", file=sys.stderr)

    with open(os.path.join(args.out, "extraction.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({"frames": len(summary), "out": args.out}))


def cmd_aggregate(args):
    """Offline re-aggregation: DISK keypoint log + Trajectory.csv ->
    world-frame PCD (the vtkSlam aggregated output, detached from a live
    run so long logs can be exported after the fact, e.g. post-PGO)."""
    from lidarslam_tpu_torch.io import export, pcd

    traj = export.read_trajectory_csv(args.trajectory)
    types = args.types.split(",") if args.types else None
    agg = export.aggregate_disk_log(args.log_dir, traj, types=types,
                                    undistort=not args.no_undistort)
    pcd.save_pcd(args.out, agg["xyz"], intensity=agg["intensity"],
                 time=agg["time"], label=agg["label"], binary=True)
    print(json.dumps({"points": int(len(agg["xyz"])),
                      "frames": int(agg["frame_id"].max() + 1),
                      "out": args.out}))


def cmd_compare(args):
    from lidarslam_tpu_torch.io import csv_log

    res = csv_log.read_poses_csv(os.path.join(args.res, "Poses.csv"))
    ref = csv_log.read_poses_csv(os.path.join(args.ref, "Poses.csv"))
    res_e = ref_e = None
    try:
        res_e = csv_log.read_evaluators_csv(os.path.join(args.res, "Evaluators.csv"))
        ref_e = csv_log.read_evaluators_csv(os.path.join(args.ref, "Evaluators.csv"))
    except OSError:
        pass
    cmp = csv_log.compare_to_reference(res, ref, res_e, ref_e,
                                       position_threshold=args.position_threshold,
                                       angle_threshold_deg=args.angle_threshold,
                                       time_threshold=args.time_threshold)
    for m in cmp.messages:
        print(m, file=sys.stderr)
    print(json.dumps({"success": bool(cmp.success),
                      "max_position_error_m": round(cmp.max_position_error, 5),
                      "max_angle_error_deg": round(cmp.max_angle_error, 3),
                      "mean_time_delta_s": round(cmp.mean_time_delta, 5),
                      "n_compared": cmp.n_compared}))
    return 0 if cmp.success else 1


def cmd_serve(args):
    from lidarslam_tpu_torch.server import SlamServer

    slam = _build_slam(args)
    server = SlamServer(slam, host=args.host, port=args.port,
                        stream=not args.no_stream)
    print(f"[lidarslam_tpu_torch] serving on {args.host}:{server.server_address[1]}"
          f" (stream={not args.no_stream})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lidarslam_tpu_torch")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions) instead of "
                         "the CUDA device")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="process a sweep sequence")
    run.add_argument("--config", help="reference-style yaml config (configs/*.yaml)")
    run.add_argument("--synthetic", type=int, default=0, metavar="N")
    run.add_argument("--pcd-dir")
    run.add_argument("--kitti-dir", help="KITTI velodyne dir of .bin sweeps")
    run.add_argument("--limit", type=int, default=0, help="max frames to process")
    run.add_argument("--rate", type=float, default=10.0, help="sweeps per second")
    run.add_argument("--out", required=True)
    run.add_argument("--rings", type=int, default=None,
                     help="override the range-image ring count (default: from "
                          "--config's tpu.n_rings, else 16)")
    run.add_argument("--max-ring-points", type=int, default=None)
    run.add_argument("--max-keypoints", type=int, default=None)
    run.add_argument("--ego-motion", type=int, default=1,
                     help="0 none, 1 extrapolation, 2 registration, 3 both")
    run.add_argument("--undistortion", type=int, default=0,
                     help="0 none, 1 once, 2 refined")
    run.add_argument("--use-blobs", action="store_true")
    run.add_argument("--save-maps", action="store_true")
    run.add_argument("--vtp", action="store_true",
                     help="also write trajectory.vtp + map_*.vtp "
                          "(ParaView-consumable VTK XML PolyData)")
    run.add_argument("--aggregate", action="store_true",
                     help="write aggregated.pcd (world-frame logged frames)")
    run.add_argument("--log-dir",
                     help="write the keypoint log as PCDs here (DISK storage)")
    run.add_argument("--verbosity", type=int, default=0)
    run.add_argument("--follow", action="store_true",
                     help="stream frames and print each result live "
                          "(subscription over the streaming path)")
    run.set_defaults(fn=cmd_run)

    ext = sub.add_parser("extract",
                         help="run only the keypoint extractor over a sequence")
    ext.add_argument("--config", help="reference-style yaml config")
    ext.add_argument("--synthetic", type=int, default=0, metavar="N")
    ext.add_argument("--pcd-dir")
    ext.add_argument("--kitti-dir")
    ext.add_argument("--limit", type=int, default=0)
    ext.add_argument("--rate", type=float, default=10.0)
    ext.add_argument("--rings", type=int, default=None)
    ext.add_argument("--out", required=True)
    ext.add_argument("--blobs", action="store_true", help="also dump blob keypoints")
    ext.add_argument("--debug", action="store_true",
                     help="dump per-point score clouds (SSKE debug arrays)")
    ext.add_argument("--undistortion", type=int, default=0, help=argparse.SUPPRESS)
    ext.add_argument("--verbosity", type=int, default=0)
    ext.set_defaults(fn=cmd_extract)

    agg = sub.add_parser("aggregate",
                         help="re-aggregate a DISK keypoint log to one PCD")
    agg.add_argument("--log-dir", required=True)
    agg.add_argument("--trajectory", required=True,
                     help="Trajectory.csv from a run (post-PGO poses allowed)")
    agg.add_argument("--out", required=True)
    agg.add_argument("--types", help="comma list: edge,plane,blob")
    agg.add_argument("--no-undistort", action="store_true")
    agg.set_defaults(fn=cmd_aggregate)

    srv = sub.add_parser("serve",
                         help="serve the engine over TCP (the LidarSlamNode "
                              "process, socket transport)")
    srv.add_argument("--config", help="reference-style yaml config")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8342)
    srv.add_argument("--no-stream", action="store_true",
                     help="synchronous per-frame processing (poses return "
                          "per frame instead of per flush)")
    srv.add_argument("--rings", type=int, default=None)
    srv.add_argument("--max-ring-points", type=int, default=None)
    srv.add_argument("--max-keypoints", type=int, default=None)
    srv.add_argument("--ego-motion", type=int, default=1)
    srv.add_argument("--undistortion", type=int, default=0)
    srv.add_argument("--use-blobs", action="store_true")
    srv.add_argument("--verbosity", type=int, default=0)
    srv.set_defaults(fn=cmd_serve)

    cmp = sub.add_parser("compare", help="compare a run against a golden run")
    cmp.add_argument("--res", required=True)
    cmp.add_argument("--ref", required=True)
    cmp.add_argument("--position-threshold", type=float, default=0.01)
    cmp.add_argument("--angle-threshold", type=float, default=5.0)
    cmp.add_argument("--time-threshold", type=float, default=0.005)
    cmp.set_defaults(fn=cmd_compare)

    args = ap.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
