"""Whole-batch sweeps per convergence iteration of evolve3d: the
program's counters evolve3d.sweeps / evolve3d.iterations
(c2ray_tpu_torch/utils/clocks.py), over the traced run's process: the
warm-up step, the window's cycles and the profiled cycle.  1.0 when no
iteration is redone; each subbox doubling redoes the iteration's sweep
and its chemistry pass."""

from harness import spans


def read(trace):
    c = spans.counters()
    if not c or not c.get("evolve3d.iterations"):
        return None
    return c.get("evolve3d.sweeps", 0) / c["evolve3d.iterations"]
