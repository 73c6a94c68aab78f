"""Wall/CPU phase timers.

Port of ``c2ray_tpu/utils/clocks.py`` (``code/clocks.f90``):
accumulating CPU + wall-clock counters with phase timestamps written to
a `Timings.log`.  On the GPU a phase boundary can first synchronize the
device (`torch.cuda.synchronize`), so queued kernels are charged to
the phase that launched them; `start_device_trace` /
`stop_device_trace` capture a ``torch.profiler`` trace of the card.
"""

import os
import time
from dataclasses import dataclass, field
from typing import Optional

_TRACE = None


@dataclass
class Clocks:
    """setup/update/report clocks (clocks.f90:59-147)."""

    log_path: Optional[str] = None
    _t0_wall: float = field(default_factory=time.time)
    _t0_cpu: float = field(default_factory=time.process_time)
    _last_wall: float = 0.0
    _last_cpu: float = 0.0

    def __post_init__(self):
        self._last_wall = self._t0_wall
        self._last_cpu = self._t0_cpu
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".",
                        exist_ok=True)
            with open(self.log_path, "a") as f:
                f.write(f"# clocks started {time.ctime()}\n")

    def timestamp_wallclock(self) -> float:
        """Seconds since setup (timestamp_wallclock, clocks.f90:142-147)."""
        return time.time() - self._t0_wall

    def update(self, label: str, sync=None):
        """Record a phase boundary; returns (d_wall, d_cpu) since the
        previous update (update_clocks + report pattern,
        clocks.f90:96-139).

        ``sync``: optional tensor; when it lies on a CUDA device, that
        device is synchronized before stamping, so device work is
        attributed to the right phase.
        """
        if sync is not None and getattr(sync, "is_cuda", False):
            import torch

            torch.cuda.synchronize(sync.device)
        now_w, now_c = time.time(), time.process_time()
        dw, dc = now_w - self._last_wall, now_c - self._last_cpu
        self._last_wall, self._last_cpu = now_w, now_c
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(f"{self.timestamp_wallclock():10.2f} {label}: "
                        f"wall={dw:.3f}s cpu={dc:.3f}s\n")
        return dw, dc

    def report(self):
        """Total accounting (report_clocks, clocks.f90:120-139)."""
        wall = time.time() - self._t0_wall
        cpu = time.process_time() - self._t0_cpu
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(f"# total wall={wall:.2f}s cpu={cpu:.2f}s\n")
        return wall, cpu


def start_device_trace(logdir: str):
    """Begin a ``torch.profiler`` trace of the host and the card; the
    Chrome trace goes to ``logdir/trace.json`` at `stop_device_trace`."""
    global _TRACE
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    _TRACE = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]), logdir)
    _TRACE[0].__enter__()


def stop_device_trace():
    """End the trace begun by `start_device_trace`; returns the
    profiler (its ``key_averages()`` sum the device time by kernel)."""
    global _TRACE
    if _TRACE is None:
        raise RuntimeError("no device trace is running")
    prof, logdir = _TRACE
    _TRACE = None
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return prof
