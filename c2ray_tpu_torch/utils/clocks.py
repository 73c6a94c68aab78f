"""Wall/CPU phase timers, and the program's spans and counters.

`Clocks` ports ``c2ray_tpu/utils/clocks.py`` (``code/clocks.f90``):
accumulating CPU + wall-clock counters with phase timestamps written to
a `Timings.log`.  On the GPU a phase boundary can first synchronize the
device (`torch.cuda.synchronize`), so queued kernels are charged to
the phase that launched them.

The tracer is one store per process:

- `count(name, n)` adds to a host integer, always: kernel launches
  (``launches.<library>[.route][.variant]``), iterations, sweeps, bytes.
  No counter reads the device.
- `span(name)` is a context manager around a piece of host work.  Off
  (the default) it tests one bool and returns a shared no-op context.
  After `tracing(True)` each span enters
  ``torch.profiler.record_function(name)``, so in a profiled run it lies
  on the profiler's host timeline beside the kernels it launches, and is
  kept in memory with its start and end (``time.time_ns``, the
  profiler's clock), its parent and the timestep it belongs to.
- `snapshot()` reads the counters and the kept spans (count, total and
  self seconds per name; self = total less the children's time), and
  `reset()` clears both.

No span or counter synchronises, reads the device, allocates on it or
launches anything.  Span names begin with ``c2ray.``.
"""

import os
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Optional

import torch

# spans kept and annotated (tracing); counters count either way
_ON = False
_OFF = nullcontext()
_COUNTS = {}
# kept spans: [name, start ns, end ns (0 while open), parent index or -1,
# slice index, step index, own index]
_RECORDS = []
_OPEN = []


def tracing(on: bool):
    """Switch the process's spans on or off."""
    global _ON
    _ON = bool(on)


def count(name: str, n: int = 1):
    """Add `n` to counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counter(name: str) -> int:
    """The value of counter `name` (0 if it never counted)."""
    return _COUNTS.get(name, 0)


def span(name: str, slice_index: Optional[int] = None,
         step_index: Optional[int] = None):
    """A span of host work.  `slice_index` / `step_index` name the
    timestep its work belongs to; a span that names none takes its
    parent's."""
    if not _ON:
        return _OFF
    return _Span(name, slice_index, step_index)


class _Span:
    __slots__ = ("_name", "_ids", "_rf", "_rec")

    def __init__(self, name, slice_index, step_index):
        self._name = name
        self._ids = (slice_index, step_index)

    def __enter__(self):
        sl, st = self._ids
        parent = _OPEN[-1] if _OPEN else None
        if parent is not None:
            sl = parent[4] if sl is None else sl
            st = parent[5] if st is None else st
        rec = [self._name, time.time_ns(), 0,
               -1 if parent is None else parent[6], sl, st, len(_RECORDS)]
        _RECORDS.append(rec)
        _OPEN.append(rec)
        self._rec = rec
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._rec[2] = time.time_ns()
        if _OPEN and _OPEN[-1] is self._rec:
            _OPEN.pop()
        return False


def snapshot() -> dict:
    """{"counters": {name: n}, "spans": {name: {"count", "total_s",
    "self_s"}}, "records": [(name, start ns, end ns, parent index, slice
    index, step index)]} of the closed spans kept since the last
    `reset` (a parent index points into "records", -1 for none)."""
    child_ns = [0] * len(_RECORDS)
    for r in _RECORDS:
        if r[2] and r[3] >= 0:
            child_ns[r[3]] += r[2] - r[1]
    spans = {}
    for r, c in zip(_RECORDS, child_ns):
        if not r[2]:
            continue
        s = spans.setdefault(r[0], {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (r[2] - r[1]) * 1e-9
        s["self_s"] += (r[2] - r[1] - c) * 1e-9
    return {"counters": dict(_COUNTS), "spans": spans,
            "records": [tuple(r[:6]) for r in _RECORDS]}


def reset():
    """Clear the counters and the kept spans (spans open now are not
    kept)."""
    _COUNTS.clear()
    _RECORDS.clear()
    _OPEN.clear()


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
