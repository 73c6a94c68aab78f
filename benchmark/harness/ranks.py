"""One process's part of a benchmark run, on one rank or on several.

`part` runs a cell in the calling process: set-up, the window, the
traced cycle with ``--trace 1``, and on rank 0 the check.  A cell on
one rank runs it in the command's own process; a cell in the
source-parallel mode runs it on each of its ranks (started by
``c2ray_tpu_torch.parallel.launch``: one process a card with NCCL, or
gloo on the CPU in the tests), and `merge` joins the ranks' parts into
rank 0's result.
"""

import math
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "c2ray_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
        return q.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def part(name, seed, seconds, traced, device, mesh, workdir, t_start,
         fault=None, overrides=None) -> dict:
    """This process's part of one run of cell `name`: {"rank", "counts"
    (the window's steps, iterations and trace calls), "memory_peak_bytes",
    "forbidden"}, and on rank 0 also "result" and "compared"
    [(name, value, limit)].  `t_start` is the command's start on the
    host's monotonic clock (time.perf_counter, one clock for every
    process of the host)."""
    import torch

    from harness import spec
    from harness.cell import Cell

    cell = Cell(name, seed, device=device, mesh=mesh, workdir=workdir,
                overrides=overrides, fault=fault)
    rank0 = cell.rank == 0
    say = log if rank0 else (lambda *a: None)
    cell.setup()
    say(f"set-up: {cell.timings}")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    wall, cycles, steps = cell.window(seconds, spans=bool(traced))
    setup_s = cell.window_t0 - t_start
    p = cell.probe
    counts = dict(steps=p.steps, iterations=p.iterations,
                  traces=len(p.traces), chem_passes=p.chem_passes)
    say(f"window: {wall:.3f} s, {cycles} cycles, {steps} steps, "
        f"{p.iterations} iterations")
    if traced:
        say("steps (wall s, iterations, subbox radius): "
            + ", ".join(f"({w:.4f}, {n}, {r})" for w, n, r in p.step_walls))
    metrics = {}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell.ranks}
    if device != "cpu" and rank0:
        dev["power_limit"] = power_limit()
    result = {"correct": False, "attempted": steps, "failed": 0}
    if traced:
        t0 = time.perf_counter()
        tr = cell.traced(wall, cycles)
        if rank0:
            say(f"traced cycle: {tr['profiled_wall_s']:.3f} s, read in "
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
    out = {"rank": cell.rank, "counts": counts,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if device != "cpu" else 0)}
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    cell.release()
    if rank0:
        t0 = time.perf_counter()
        ref = cell.reference()
        detail = {}
        nums, _, _ = cell.judged(ref, detail=detail)
        log(f"reference: {time.perf_counter() - t0:.3f} s")
        for k in nums:
            pd = {d: v for d, v in detail.items() if d.startswith(k + ".")}
            if pd:
                worst = max(pd, key=lambda d: pd[d])
                log(f"worst part of {k}: {worst} {pd[worst]!r}")
        limits = cell.traffic["check"]["limits"]
        compared = [(k, nums[k], limits.get(k)) for k in nums]
        correct = all(lim is not None and math.isfinite(v) and v <= lim
                      for _, v, lim in compared)
        result.update(correct=correct, metrics=metrics, device=dev)
        result["check"] = {k: {"value": v, "limit": lim}
                           for k, v, lim in compared}
        out.update(result=result, compared=compared)
    out["forbidden"] = forbidden_modules()
    return out


def merge(parts: list) -> tuple:
    """Rank 0's (result, compared), with the device's count and the
    peak memory of the fullest card, after checking that every rank ran
    the same steps and loaded none of `FORBIDDEN`; the ranks' window
    counts go to the result as "ranks", before "check", which stays
    last."""
    found = sorted({m for q in parts for m in q["forbidden"]})
    if found:
        raise RuntimeError(f"modules that must not load, in a rank: {found}")
    head = parts[0]
    steps = [q["counts"]["steps"] for q in parts]
    if len(set(steps)) != 1:
        raise RuntimeError(f"the ranks ran different steps: {steps}")
    result = head["result"]
    result["device"]["count"] = len(parts)
    result["device"]["memory_peak_bytes"] = max(q["memory_peak_bytes"]
                                                for q in parts)
    check = result.pop("check")
    result["ranks"] = [q["counts"] for q in parts]
    result["check"] = check
    return result, head["compared"]
