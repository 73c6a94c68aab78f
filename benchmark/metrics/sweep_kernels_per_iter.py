"""Sweep kernels launched per convergence iteration of evolve3d: the
program's counters sweep.kernels / evolve3d.iterations
(c2ray_tpu_torch/utils/clocks.py), counted where the engines launch
them (the source cells' kernel and one a shell, or one a pyramid layer's
stage), over the traced run's process: the warm-up step, the window's
cycles and the profiled cycle.  None where the program has no such
counter."""

from harness import spans


def read(trace):
    c = spans.counters()
    if not c or not c.get("evolve3d.iterations") or "sweep.kernels" not in c:
        return None
    return c["sweep.kernels"] / c["evolve3d.iterations"]
