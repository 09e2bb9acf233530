"""Benchmark of lidarslam_tpu_torch, the PyTorch/CUDA port: one run of one cell.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for. A cell (`BENCHMARK.json`, `workloads`) is a configuration
(`slambench/configs/<config>.json`: the upstream outdoor preset with a
sensor block) under a traffic mix (`slambench/traffic/<mix>.json`: a closed
city-block circuit and the path that drives it). Set-up, counted from the
start of this script to the first timed sweep: render one lap of the
circuit on the card from the seed (`raycast.py`), build
`lidarslam_tpu_torch.Slam` from the preset through the port's yaml loader,
and warm it up with the mix's first sweeps. Then for `--seconds`:

- live (`add_frame`, closed loop): each sweep's call is timed from the
  hand-over of its host arrays to the return of its pose; the median and
  90th percentile of all of them are `live_p50_ms`, `live_p90_ms`;
- log (`add_frame_async` as fast as it accepts, `flush` at the end): the
  sweeps whose poses came back over the time from the first enqueue to the
  return of the flush are `log_sweeps_per_s`.

With `--trace 1` a few more sweeps run under torch.profiler after the
window and the per-layer readers (`slambench/metrics/<name>.py`) read them.
Every run then holds each returned pose against the reference
(`check.py`), prints each compared number beside its limit as the last
lines of stderr, and prints one JSON line last on stdout.

Exit codes: 2 where torch finds no CUDA device or fewer than the cell asks
for, 3 where the process loaded JAX or the JAX package; no result either way.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the build and kernel caches the run may touch, at fixed paths inside the
# checkout (the port builds its k-NN kernel and native ingest into
# lidarslam_tpu_torch/_build/ by itself)
CACHE = ROOT / ".slambench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "lidarslam_tpu")
# sweeps run under the profiler with --trace 1: live calls, log sweeps
TRACE_SWEEPS = {"live": 4, "log": 16}


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the run must not load,
    compared whole (lidarslam_tpu_torch is not lidarslam_tpu)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def use_checkout_caches():
    """Point the build and kernel caches at fixed directories inside the
    checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def host_sample() -> tuple:
    """(wall s, this process's CPU s, its involuntary context switches)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), ru.ru_utime + ru.ru_stime, ru.ru_nivcsw


def host_note(a: tuple, b: tuple):
    """What the host did between two `host_sample`s, on stderr: the share of
    a core this process used, how often it was switched out, its threads."""
    wall, cpu, nivcsw = b[0] - a[0], b[1] - a[1], b[2] - a[2]
    note(f"host over the window: this process {100 * cpu / wall:.1f}% of a core, "
         f"{nivcsw} involuntary switches, {_threads()} threads, {os.cpu_count()} cores")


def _threads() -> int:
    try:
        with open("/proc/self/status") as f:
            return int(next(ln for ln in f if ln.startswith("Threads:")).split()[1])
    except (OSError, StopIteration):
        return 0


def note(msg: str):
    """A progress line on stderr, stamped with seconds since the start."""
    print(f"[slambench {time.perf_counter() - _T0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def percentile(samples, q: float) -> float:
    """The q-th percentile of all samples (linear between closest ranks,
    numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(samples, np.float64), q))


class Drive:
    """The rendered lap, replayed lap after lap with stamps continuing:
    sweep j is the lap's sweep j mod n at stamp j * sweep_duration."""

    def __init__(self, circuit, lap: dict):
        self.circuit = circuit
        self.lap = lap
        self.n = circuit.n_sweeps

    def frame(self, j: int) -> dict:
        k = j % self.n
        o0, o1 = self.lap["offsets"][k], self.lap["offsets"][k + 1]
        return {"xyz": self.lap["xyz"][o0:o1], "intensity": self.lap["intensity"][o0:o1],
                "laser_id": self.lap["laser_id"][o0:o1], "time": self.lap["time"][o0:o1],
                "stamp": j * self.circuit.sweep_duration}

    def reference(self, n: int):
        return self.circuit.sweep_poses(n).numpy()


def slam_config(cfg: dict):
    """The port's SlamConfig of a configuration file, through the port's
    yaml loader (what `cli run --config` builds)."""
    from lidarslam_tpu_torch.io import yaml_config

    return yaml_config.config_from_tree({"slam": cfg["slam"], "tpu": cfg["tpu"]})


class Run:
    """What one run records: every sweep's pose (NaN until it comes back)
    and failure flag, keyed by sweep index."""

    def __init__(self):
        self.poses = {}
        self.failed = {}

    def record(self, j: int, out: dict):
        self.poses[j] = out["pose"]
        self.failed[j] = bool(out["failure"])


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _live(slam, drive, rec, j0, n_or_seconds, by_count=False):
    """add_frame from sweep j0 on, for `n_or_seconds` sweeps (by_count) or
    seconds: (per-call seconds, next sweep index)."""
    samples = []
    j = j0
    start = time.perf_counter()
    while (len(samples) < n_or_seconds) if by_count else \
            (time.perf_counter() - start < n_or_seconds):
        frame = drive.frame(j)
        t0 = time.perf_counter()
        out = slam.add_frame(frame)
        samples.append(time.perf_counter() - t0)
        rec.record(j, out)
        j += 1
    return samples, j


def _log(slam, drive, rec, j0, n_or_seconds, by_count=False):
    """add_frame_async from sweep j0 on, for `n_or_seconds` sweeps or
    seconds, then flush: (seconds from the first enqueue to the flush's
    return, sweeps whose poses came back, next sweep index)."""
    j = j0
    accepted = []
    start = time.perf_counter()
    while (j - j0 < n_or_seconds) if by_count else \
            (time.perf_counter() - start < n_or_seconds):
        if slam.add_frame_async(drive.frame(j)) >= 0:
            accepted.append(j)
        j += 1
    outs = slam.flush()
    elapsed = time.perf_counter() - start
    for jj, out in zip(accepted, outs):
        rec.record(jj, out)
    return elapsed, min(len(outs), len(accepted)), j


def execute(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
            bench=None, sensor_override=None, lap_sweeps=None) -> dict:
    """One run of a cell: the result dict (without printing). Tests pass
    `device="cpu"` with a smaller sensor and lap (the first `lap_sweeps`
    sweeps rendered, for windows that stay inside them)."""
    import numpy as np
    import torch

    from slambench import check, circuit as circuit_mod, raycast, spec, traceread

    bench = bench or spec.benchmark()
    wl = spec.workload(bench, workload)
    cfg_file = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    limits = spec.limits(workload)
    sensor = dict(cfg_file["sensor"], **(sensor_override or {}))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    note(f"torch {torch.__version__} ready on {device}")

    # the drive: one lap cast on the device, its range noise from the seed
    seed_bits = int(seed) & (2**63 - 1)
    circ = circuit_mod.make_circuit(mix, sensor)
    if lap_sweeps is not None:
        circ = dataclasses.replace(circ, n_sweeps=int(lap_sweeps))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits)
    lap = raycast.render_lap(circ, sensor, gen, device)
    drive = Drive(circ, lap)
    note(f"rendered a lap of {circ.n_sweeps} sweeps, {len(lap['time'])} points, "
         f"{len(circ.boxes)} boxes, {len(circ.cylinders)} poles")
    del gen
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    from lidarslam_tpu_torch import Slam

    slam = Slam(slam_config(cfg_file), device=device)
    note("Slam built")
    rec = Run()
    path = mix["path"]
    warm = int(mix["warmup_sweeps"])
    if path == "live":
        _, j = _live(slam, drive, rec, 0, warm, by_count=True)
        _sync(device)
        t_first = time.perf_counter()
        h0 = host_sample()
        samples, j_end = _live(slam, drive, rec, j, seconds)
        host_note(h0, host_sample())
        window_s = sum(samples)
        ms_per_sweep = 1000.0 * window_s / max(len(samples), 1)
        handed = len(samples)
        tenths = [1000.0 * percentile(samples[k * len(samples) // 10:(k + 1) * len(samples) // 10]
                                      or samples, 50) for k in range(10)]
        note("window's median ms by tenth: " + " ".join(f"{v:.1f}" for v in tenths))
        e2e = {"live_p50_ms": 1000.0 * percentile(samples, 50),
               "live_p90_ms": 1000.0 * percentile(samples, 90)}
    elif path == "log":
        _, _, j = _log(slam, drive, rec, 0, warm, by_count=True)
        _sync(device)
        t_first = time.perf_counter()
        h0 = host_sample()
        window_s, n_back, j_end = _log(slam, drive, rec, j, seconds)
        host_note(h0, host_sample())
        handed = j_end - j
        ms_per_sweep = 1000.0 * window_s / max(n_back, 1)
        e2e = {"log_sweeps_per_s": n_back / window_s}
    else:
        raise ValueError(f"traffic {wl['traffic']!r}: unknown path {path!r}")
    e2e["setup_s"] = t_first - _T0
    note(f"window: {handed} sweeps handed in, {ms_per_sweep:.3f} ms a sweep")

    traced, busy_s, trace_window_s = None, None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        _sync(device)
        with profile(activities=acts) as prof:
            w0 = time.perf_counter()
            if path == "live":
                _live(slam, drive, rec, j_end, TRACE_SWEEPS[path], by_count=True)
            else:
                _log(slam, drive, rec, j_end, TRACE_SWEEPS[path], by_count=True)
            _sync(device)
            trace_window_s = time.perf_counter() - w0
        traced = traceread.from_profile(prof, sweeps=TRACE_SWEEPS[path], path=path,
                                        untraced_ms_per_sweep=ms_per_sweep)
        busy_s = traced.busy_ms() / 1000.0
        del prof
        note(f"traced {TRACE_SWEEPS[path]} sweeps: {len(traced.device)} device records")
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    # the program's state goes before the reference runs
    n_total = max(rec.poses) + 1 if rec.poses else 0
    poses = np.full((n_total, 4, 4), np.nan)
    for jj, p in rec.poses.items():
        poses[jj] = p
    n_failed = sum(rec.failed.get(jj, False) for jj in range(j, n_total))
    del slam
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values = check.readings(poses, drive.reference(n_total), first_judged=j)
    note("reference compared")
    correct, checks = check.judge(values, limits)
    n_missing = values["missing"]

    metrics = {}
    if not trace:
        for m in spec.metrics_for(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in spec.metrics_for(bench, workload, "per_layer"):
            v = spec.reader(m["name"])(traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": int(handed),
              "failed": int(n_failed + n_missing), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_s
        dev["window_s"] = trace_window_s
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_gaps()}
    result["checks"] = checks
    return result


def emit(result: dict):
    """Each compared number beside its limit as the last lines of stderr,
    then the result as the last line of stdout."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from slambench import spec

    bench = spec.benchmark()
    chips = int(spec.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
