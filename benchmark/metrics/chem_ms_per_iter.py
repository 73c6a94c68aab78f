"""Device time of the chemistry layer's kernel (layers/chemistry.json)
per iteration of the profiled cycle, in ms: torch.profiler's, or CUDA
events around the library's entry where the tracer kept fewer records
than the passes launched."""


def read(trace):
    s = trace["summary"]["layer_device_s"].get("chemistry")
    if not s or not trace["iterations"]:
        return None
    return s / trace["iterations"] * 1e3
