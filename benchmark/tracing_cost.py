"""The cost of the program's spans, and what they read, on one cell.

    python3 benchmark/tracing_cost.py --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

from the root of a checkout, on a machine with a card.  After the
cell's set-up (as ``run.py`` makes it), four windows of whole cycles,
`--seconds` each, with the program's tracing off, on, on and off
(``c2ray_tpu_torch/utils/clocks.py``) give `step_s` with and without
spans and the spans a step keeps.  Then one cycle with tracing on runs
under torch.profiler, the program's counters reset before it, read by
``harness/trace.summarize`` (as the benchmark's per-layer metrics read
a traced run) and by ``harness/spans.span_summary`` (by the program's
spans).  Prints one JSON line, and writes it to `--out`: the windows,
the cycle's spans and counters, the span and counter readings
(`sweeps_per_iter`, `sweep_glue_ms_per_iter`, `sweep_glue_gb_per_iter`,
`slice_host_ms_per_step`, `loop_idle_pct`) beside the benchmark's own
per-layer readings of the same cycle, and their cross-checks.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def slice_host_ms_per_step(records):
    """Host wall of the `c2ray.slice` spans less the `c2ray.step.evolve3d`
    spans inside them, per `c2ray.step` span, in ms (records as
    `clocks.snapshot` gives them)."""
    def under_slice(i):
        while i >= 0:
            if records[i][0] == "c2ray.slice":
                return True
            i = records[i][3]
        return False

    dur = lambda r: r[2] - r[1]
    host = sum(dur(r) for r in records if r[0] == "c2ray.slice")
    evolve = sum(dur(r) for i, r in enumerate(records)
                 if r[0] == "c2ray.step.evolve3d" and under_slice(i))
    steps = sum(r[0] == "c2ray.step" for r in records)
    return (host - evolve) / steps * 1e-6 if steps else None


def readings(snap, by_span, iterations, cycle_wall):
    """The five span and counter readings of one profiled cycle."""
    from harness import spans

    c = snap["counters"]
    glue_in_sweep = sum(s for (p, layer), s in
                        by_span["device_by_path"].items()
                        if layer == "glue" and p and "c2ray.sweep" in p)
    return {
        "sweeps_per_iter": c.get("evolve3d.sweeps", 0) / iterations,
        "sweep_glue_ms_per_iter": glue_in_sweep / iterations * 1e3,
        "sweep_glue_gb_per_iter": (c.get("sweep.zeroed_bytes", 0)
                                   + c.get("sweep.summed_bytes", 0))
        / iterations * 1e-9,
        "slice_host_ms_per_step": slice_host_ms_per_step(snap["records"]),
        "loop_idle_pct": 100.0 * spans.inside(by_span["idle_by_path"],
                                              "c2ray.step.evolve3d")
        / cycle_wall,
    }


def _top(d, n=12):
    return [[" > ".join(k) if isinstance(k, tuple) else str(k), v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def measure(name, seed, seconds, device="cuda", mesh=None, overrides=None):
    import torch

    from c2ray_tpu_torch.utils import clocks
    from harness import spans, spec, trace
    from harness.cell import Cell

    cell = Cell(name, seed, device=device, mesh=mesh, overrides=overrides,
                workdir=tempfile.mkdtemp(prefix="c2ray_spans_"))
    cell.setup()
    out = {"cell": name, "seed": seed, "setup": cell.timings,
           "windows": []}
    walls_off = []
    for on in (False, True, True, False):
        clocks.reset()
        clocks.tracing(on)
        wall, cycles, steps = cell.window(seconds)
        clocks.tracing(False)
        snap = clocks.snapshot()
        w = {"tracing": on, "step_s": wall / steps, "wall_s": wall,
             "cycles": cycles, "steps": steps,
             "spans_per_step": len(snap["records"]) / steps}
        if on:
            w["slice_host_ms_per_step"] = slice_host_ms_per_step(
                snap["records"])
        else:
            walls_off.append(wall / cycles)
        out["windows"].append(w)
    cycle_wall = sum(walls_off) / len(walls_off)

    p = cell.probe
    p.labels = True
    p.reset_counts()
    clocks.reset()
    clocks.tracing(True)
    t0 = time.perf_counter()
    prof = trace.profile(cell.cycle)
    wall = time.perf_counter() - t0
    clocks.tracing(False)
    snap = clocks.snapshot()
    layers = {k: v["kernels"] for k, v in spec.layers().items()}
    summary = trace.summarize(prof, layers)
    by_span = spans.span_summary(prof, layers)
    del prof
    its, steps = p.iterations, p.steps
    dev_s = summary["layer_device_s"]
    busy = summary["busy_s"]
    new = readings(snap, by_span, its, cycle_wall)
    idle_evolve = spans.inside(by_span["idle_by_path"], "c2ray.step.evolve3d")
    idle_none = by_span["idle_by_path"].get((), 0.0)
    out["cycle"] = {
        "profiled_wall_s": wall, "cycle_wall_s": cycle_wall,
        "iterations": its, "steps": steps, "chem_passes": p.chem_passes,
        "counters": snap["counters"], "spans": snap["spans"],
        "n_spans": len(snap["records"]),
        "benchmark": {
            "glue_ms_per_iter": dev_s.get("glue", 0.0) / its * 1e3,
            "sweep_ms_per_iter": dev_s.get("sweep", 0.0) / its * 1e3,
            "chem_ms_per_iter": dev_s.get("chemistry", 0.0) / its * 1e3,
            "device_idle_pct": 100.0 * (1.0 - busy / cycle_wall),
            "busy_s": busy, "skipped": summary["skipped"]},
        "spans_and_counters": new,
        "checks": {
            "sweeps_x_iterations_per_step": new["sweeps_per_iter"]
            * its / steps,
            "chem_passes_per_step": p.chem_passes / steps,
            "sweep_glue_le_glue": new["sweep_glue_ms_per_iter"]
            <= dev_s.get("glue", 0.0) / its * 1e3,
            "idle_evolve3d_s": idle_evolve,
            "idle_other_spans_s": by_span["idle_s"] - idle_evolve
            - idle_none,
            "idle_no_span_s": idle_none,
            "idle_s": by_span["idle_s"],
            "busy_plus_idle_s": busy + by_span["idle_s"],
            "device_span_s": summary["span_s"]},
        "launch_found": by_span["launch_found"],
        "device_by_span": _top({(p_ or ("none",)) + (layer,): s
                                for (p_, layer), s in
                                by_span["device_by_path"].items()
                                if p_ is not None}),
        "idle_by_span": _top({p_ or ("none",): s for p_, s in
                              by_span["idle_by_path"].items()}),
    }
    cell.release()
    shutil.rmtree(cell.workdir, ignore_errors=True)
    if device != "cpu":
        out["card"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    torch.set_num_threads(4)
    out = measure(args.workload, args.seed, args.seconds)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    sys.exit(main())
