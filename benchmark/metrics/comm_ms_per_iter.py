"""Device time of rank 0's collectives (NCCL kernels, layers/comm.json:
the rate grids' all-reduce, the state's all-gather after each chemistry
pass, the convergence count's and the dump clock's all-reduces) per
iteration of the profiled cycle, in ms.  A kernel's time includes its
wait for the slowest rank."""


def read(trace):
    s = trace["summary"]["layer_device_s"].get("comm")
    if not s or not trace["iterations"]:
        return None
    return s / trace["iterations"] * 1e3
