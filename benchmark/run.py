"""Benchmark of c2ray_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell (``BENCHMARK.json`` -> ``workloads``) names a
configuration (``configs/``) and a traffic file (``workloads/``).  Set-up
builds the kernel libraries the cell launches, writes the cell's seeded
inputs under the temporary directory, builds ``Run3D`` and runs the
first step of a cycle as a warm-up.  The window then replays whole
cycles of the cell's slices through ``Run3D.run`` until `--seconds`
have passed.  With
``--trace 0`` the result carries the end-to-end metrics (`step_s`: the
window's wall over its timesteps; `setup_s`: process start to the first
timed step), with ``--trace 1`` the per-layer metrics (``metrics/``),
read from the window's counts and spans and one cycle under
torch.profiler, with the device's busy time and a breakdown.  After the
window the port's outputs of the first cycle are held against the plain
reference in float64 (``harness/check.py``); each compared number is
printed beside its limit, last on standard error and last in the
result's line, which is the last line on standard output.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "c2ray_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    import torch

    out = {"kind": torch.cuda.get_device_name(0)}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
        out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        out["power_limit"] = "not read"
    return out


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(name, seed, seconds, traced, device="cuda", mesh=None,
             workdir=None, t_start=None, fault=None, overrides=None):
    """One run of cell `name`; returns (result dict, compared numbers
    [(name, value, limit)]).  `device`, `mesh`, `overrides` (traffic
    keys) and `fault` serve the tests, which run the harness on the CPU
    at a few cells with the port's plain versions, and with a fault
    planted under the timed path."""
    import torch

    from harness import spec
    from harness.cell import Cell

    t_start = _T_START if t_start is None else t_start
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="c2ray_bench_")
    try:
        cell = Cell(name, seed, device=device, mesh=mesh, workdir=workdir,
                    overrides=overrides, fault=fault)
        cell.setup()
        log(f"set-up: {cell.timings}")
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        wall, cycles, steps = cell.window(seconds, spans=bool(traced))
        log(f"window: {wall:.3f} s, {cycles} cycles, {steps} steps, "
            f"{cell.probe.iterations} iterations")
        if traced:
            log("steps (wall s, iterations, subbox radius): "
                + ", ".join(f"({w:.4f}, {n}, {r})"
                            for w, n, r in cell.probe.step_walls))
        metrics = {}
        dev = {"platform": "gpu" if device != "cpu" else "cpu",
               "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                        else "cpu"),
               "count": 1}
        if device != "cpu":
            dev["power_limit"] = card()["power_limit"]
        result = {"correct": False, "attempted": steps, "failed": 0}
        if traced:
            t0 = time.perf_counter()
            tr = cell.traced(wall, cycles)
            log(f"traced cycle: {tr['profiled_wall_s']:.3f} s, read in "
                f"{time.perf_counter() - t0:.3f} s; events fallback "
                f"{tr['events_fallback']}; launches {tr['launched']}, "
                f"recorded {tr['summary']['layer_launches']}; device s by "
                f"layer {tr['summary']['layer_device_s']}; busy "
                f"{tr['summary']['busy_s']}; not counted "
                f"{tr['summary']['skipped']}")
            for m in spec.metrics_of(cell.spec, name, "per_layer"):
                v = spec.metric_reader(m["name"]).read(tr)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev["busy_s"] = tr["summary"]["busy_s"]
            dev["window_s"] = tr["profiled_wall_s"]
            result["breakdown"] = {
                "device_ops": [[k, v] for k, v in
                               tr["summary"]["device_ops"]],
                "idle_gaps": [[k, v] for k, v in
                              tr["summary"]["idle_gaps"]]}
        else:
            metrics["step_s"] = {"value": wall / steps, "unit": "s"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        dev["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                    if device != "cpu" else 0)
        cell.release()
        t0 = time.perf_counter()
        ref = cell.reference()
        detail = {}
        nums, _, _ = cell.judged(ref, detail=detail)
        log(f"reference: {time.perf_counter() - t0:.3f} s")
        for k in nums:
            part = {d: v for d, v in detail.items() if d.startswith(k + ".")}
            if part:
                worst = max(part, key=lambda d: part[d])
                log(f"worst part of {k}: {worst} {part[worst]!r}")
        limits = cell.traffic["check"]["limits"]
        compared = [(k, nums[k], limits.get(k)) for k in nums]
        correct = all(lim is not None and math.isfinite(v) and v <= lim
                      for _, v, lim in compared)
        result.update(correct=correct, metrics=metrics, device=dev)
        result["check"] = {k: {"value": v, "limit": lim}
                           for k, v, lim in compared}
        return result, compared
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    args = parse(argv)
    from harness import spec

    bench = spec.benchmark()
    entry = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the program's caches stay inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    torch.set_num_threads(4)
    result, compared = run_cell(args.workload, args.seed, args.seconds,
                                args.trace)
    found = forbidden_modules()
    if found:
        print(f"modules that must not load: {found}", file=sys.stderr)
        return 3
    for k, v, lim in compared:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    sys.exit(main())
