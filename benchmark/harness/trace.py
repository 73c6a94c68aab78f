"""Device time from torch.profiler, by layer, and the idle gaps by what
the host was doing.

`profile` runs a function under ``torch.profiler`` with CPU and CUDA
activities; `summarize` turns the trace into what the per-layer readers
take: device seconds of each layer (kernel name prefixes from
``layers/*.json``), of the rest (the glue: PyTorch's own kernels,
copies and fills), the kernels' counts, the device's busy seconds (the
union of every device operation's interval), the ten device operations
that took most time, and the ten longest kinds of idle gap, named by the
innermost benchmark span and the innermost host operation that covered
the gap's start.
"""

import re
from collections import defaultdict

import numpy as np
import torch

TOP = 10


def profile(fn):
    from torch.profiler import ProfilerActivity, profile as _profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
            # the tracer may keep no record of a window's last launches:
            # end the window on a launch that is not measured
            torch.empty(1, device="cuda").fill_(0.0)
            torch.cuda.synchronize()
    return prof


def short_name(name: str) -> str:
    """A device operation's name without 'void', namespaces and
    argument list: 'stage_kernel<float, true, 6>'."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(n):
        if ch in "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            n = n[:i]
            break
    head, _, rest = n.partition("<")
    head = head.split("::")[-1]
    return (head + ("<" + rest if rest else ""))[:120]


def matches(name: str, prefixes) -> bool:
    for p in prefixes:
        if re.search(r"(?:^|[\s:])" + re.escape(p) + r"\w*[<(]", name):
            return True
    return False


def summarize(prof, layers: dict) -> dict:
    """layers: {layer name: [kernel name prefixes]}."""
    from torch.autograd import DeviceType

    dev, host = [], []
    skipped = defaultdict(float)
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the benchmark's spans show on the device's timeline too,
            # and unnamed records (synchronisations) are not work
            if (not e.name or e.name.startswith("bench.")
                    or getattr(e, "is_user_annotation", False)):
                skipped[e.name] += (tr.end - tr.start) * 1e-6
                continue
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    per_layer = defaultdict(float)
    counts = defaultdict(int)
    by_op = defaultdict(float)
    for a, b, name in dev:
        s = (b - a) * 1e-6
        layer = next((ln for ln, pre in layers.items()
                      if matches(name, pre)), None)
        per_layer[layer or "glue"] += s
        counts[layer or "glue"] += 1
        by_op[short_name(name)] += s
    busy, gaps = _union(dev)
    return {
        "layer_device_s": dict(per_layer),
        "layer_launches": dict(counts),
        "busy_s": busy,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": _gap_names(gaps, host),
        "n_device_ops": len(dev),
        "skipped": dict(skipped),
        "span_s": ((max(b for _, b, _ in dev) - min(a for a, _, _ in dev))
                   * 1e-6 if dev else 0.0),
    }


def _union(dev):
    """(busy seconds, [(gap start, gap seconds)]) of device intervals in
    microseconds."""
    if not dev:
        return 0.0, []
    iv = sorted((a, b) for a, b, _ in dev)
    busy = 0.0
    gaps = []
    cur_a, cur_b = iv[0]
    for a, b in iv[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, (a - cur_b) * 1e-6))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy * 1e-6, gaps


def _gap_names(gaps, host, n_largest=400):
    """The idle gaps summed by what the host was doing at their start:
    '<benchmark span> / <innermost host op>', the ten largest sums."""
    if not gaps or not host:
        return []
    gaps = sorted(gaps, key=lambda g: -g[1])[:n_largest]
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    dur = ends - starts
    names = [h[2] for h in host]
    span = np.array([n.startswith("bench.") for n in names])
    sums = defaultdict(float)
    for t, s in gaps:
        cover = (starts <= t) & (ends > t)
        ctx = "outside spans"
        m = cover & span
        if m.any():
            ctx = names[int(np.flatnonzero(m)[np.argmin(dur[m])])]
        op = "no host op"
        m = cover & ~span
        if m.any():
            op = names[int(np.flatnonzero(m)[np.argmin(dur[m])])]
        sums[f"{ctx} / {op}"] += s
    return sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]


class EventTimer:
    """CUDA-event device time of the launches a library's entry points
    queue: stands in for a library of ``cuda_build`` (its `_LIBS` entry)
    so that every launching entry called through it is timed between two
    events on the current stream (the `*_slots` queries launch nothing)."""

    def __init__(self, lib):
        self._lib = lib
        self.pairs = []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        return fn if name.endswith("_slots") else _TimedFn(fn, self.pairs)

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) * 1e-3


class _TimedFn:
    """A ctypes function whose calls are bracketed by CUDA events; its
    argtypes and restype are the function's own."""

    def __init__(self, fn, pairs):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_pairs", pairs)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self._fn(*args)
        b.record()
        self._pairs.append((a, b))
        return out
