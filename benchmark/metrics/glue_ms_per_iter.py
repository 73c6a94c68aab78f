"""Device time of every device operation that no layer file claims
(PyTorch's kernels around the port's own: the field stack, zeroing and
summing the per-source slabs and column cubes, the state's copies, the
host's reads) per iteration of the profiled cycle, in ms."""


def read(trace):
    s = trace["summary"]["layer_device_s"].get("glue")
    if not s or not trace["iterations"]:
        return None
    return s / trace["iterations"] * 1e3
