"""Device time of the sweep layer's kernels (layers/sweep.json) per
iteration of the profiled cycle, in ms: torch.profiler's, or CUDA
events around the library's entries where the tracer kept fewer
records than the sweeps launched."""


def read(trace):
    s = trace["summary"]["layer_device_s"].get("sweep")
    if not s or not trace["iterations"]:
        return None
    return s / trace["iterations"] * 1e3
