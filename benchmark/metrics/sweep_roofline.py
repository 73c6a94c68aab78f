"""The sweep's share of its roofline: the least time its work needs on
the card (roofline/sweep.py, counted from the problem: the sources,
their boxes, the live bands and nodes) over the device time of the
sweep layer's kernels in the profiled cycle, in %."""

from harness import spec


def read(trace):
    s = trace["summary"]["layer_device_s"].get("sweep")
    if not s or not trace["traces"]:
        return None
    least, _ = spec.roofline("sweep").least_seconds(trace["run3d"],
                                                    trace["traces"])
    return 100.0 * least / s
