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
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name, seed, seconds, traced, device="cuda", mesh=None,
             workdir=None, t_start=None, fault=None, overrides=None):
    """One run of cell `name`; returns (result dict, compared numbers
    [(name, value, limit)]).  A cell in the source-parallel mode runs on
    its n_devices ranks, one process each in a process group (NCCL on
    the cards, gloo on the CPU), after this process has built the
    kernel libraries once.  `device`, `mesh`, `overrides` (traffic keys)
    and `fault` serve the tests, which run the harness on the CPU at a
    few cells with the port's plain versions, and with a fault planted
    under the timed path (`fault(port)`, on every rank: a module-level
    function)."""
    from harness import ranks, spec
    from harness.cell import build_libraries, engine_of, ranks_of, run3d_of

    t_start = _T_START if t_start is None else t_start
    traffic = spec.traffic(name)
    traffic.update(overrides or {})
    cfg = spec.config(spec.cell(spec.benchmark(), name)["config"])
    run3d = run3d_of(cfg, traffic, mesh)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="c2ray_bench_")
    args = (name, seed, seconds, traced, device, mesh, workdir, t_start,
            fault, overrides)
    try:
        if run3d.get("parallel") is None:
            out = ranks.part(*args)
            return out["result"], out["compared"]
        from c2ray_tpu_torch.parallel.launch import launch

        if device != "cpu":
            build_libraries(engine_of(run3d))
        parts = launch(ranks.part, ranks_of(run3d), args=args,
                       device="cpu" if device == "cpu" else "cuda",
                       threads=1 if device == "cpu" else 4)
        return ranks.merge(parts)
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
    from harness.ranks import forbidden_modules

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
