"""A frozen copy of the plain PyTorch / NumPy versions in
``c2ray_tpu_torch``: the pyramid sweep's `trace_plain`, the lockstep
chemistry pass, the rate tables, the photon budget, the cosmology, the
readers and the source model, taken when the benchmark was defined.

It imports nothing of the port, so a later change to the port does not
move the yardstick that judges it: the port's kernels and glue are
compared with this code, run in float64.  The CUDA paths of the copied
modules are cut out; what stays is the arithmetic of the port's plain
versions, line for line.
"""
