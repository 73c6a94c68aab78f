"""Glue bytes of the sweep per convergence iteration, in GB: the
per-source column cubes, rate slabs and loss partials the sweep
allocates zeroed for each source group, and the slabs its masked sum
over the group's sources reads (the program's counters
sweep.zeroed_bytes + sweep.summed_bytes over evolve3d.iterations,
c2ray_tpu_torch/utils/clocks.py), over the traced run's process: the
warm-up step, the window's cycles and the profiled cycle."""

from harness import spans


def read(trace):
    c = spans.counters()
    if not c or not c.get("evolve3d.iterations"):
        return None
    moved = c.get("sweep.zeroed_bytes", 0) + c.get("sweep.summed_bytes", 0)
    return moved / c["evolve3d.iterations"] * 1e-9
