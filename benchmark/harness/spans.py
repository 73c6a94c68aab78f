"""The program's own counters and spans (``c2ray_tpu_torch/utils/clocks.py``),
read from the benchmark's side.

`counters()` reads the program's counter store, which counts in every
run, traced or not (None for a program that has none).

With the program's tracing on (``clocks.tracing(True)``) every span
enters ``torch.profiler.record_function``, so a profiled cycle carries
the spans on its host timeline, on the clock of the kernels they launch.
`span_summary` reads such a profile:

- each device operation's time goes to the path of ``c2ray.`` spans
  open at its launch: the operation's correlation id names its runtime
  call on the host (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), whose
  start is the launch;
- the device's idle time goes, instant by instant, to the path of spans
  open over it: a gap that runs from one span into the next is split
  between them by overlap.

A path is the tuple of open span names, outermost first; () where no
span is open.  The program's annotations on the device's own timeline
are skipped, as `trace.summarize` skips them.
"""

from bisect import bisect_right
from collections import defaultdict

from . import trace

PREFIX = "c2ray."


def counters():
    """{name: count} of the program's counter store, or None."""
    try:
        from c2ray_tpu_torch.utils.clocks import snapshot
    except ImportError:
        return None
    return snapshot()["counters"]


def segments(spans):
    """The host timeline cut where a span begins or ends: [(start, end,
    path of open span names)], in time order, over the union of `spans`
    [(start, end, name)] (nested, as one thread opens them)."""
    ev = []
    for i, (s, e, _) in enumerate(spans):
        if e > s:
            # at one instant ends come first, the later-opened first;
            # starts the longer first
            ev.append((s, 1, -e, i))
            ev.append((e, 0, -s, i))
    ev.sort()
    out, stack, t_prev = [], [], None
    for t, opening, _, i in ev:
        if stack and t > t_prev:
            out.append((t_prev, t, tuple(spans[j][2] for j in stack)))
        t_prev = t
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
    return out


class Timeline:
    """Point and interval lookups on `segments`."""

    def __init__(self, segs):
        self.starts = [a for a, _, _ in segs]
        self.segs = segs

    def path_at(self, t):
        i = bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return ()

    def overlaps(self, a, b):
        """[(path, length)] of [a, b): each segment's overlap, and () for
        the rest."""
        out = []
        covered = 0.0
        i = max(bisect_right(self.starts, a) - 1, 0)
        while i < len(self.segs) and self.segs[i][0] < b:
            s, e, path = self.segs[i]
            w = min(b, e) - max(a, s)
            if w > 0:
                out.append((path, w))
                covered += w
            i += 1
        if b - a - covered > 0:
            out.append(((), b - a - covered))
        return out


def device_by_path(device_ops, launch_at, timeline):
    """{(path, kind): seconds} of `device_ops` [(start us, end us, kind,
    correlation id)]: each at the path open at its launch, launch_at[id]
    (us); ops whose launch is unknown go to the path None."""
    out = defaultdict(float)
    for a, b, kind, corr in device_ops:
        t = launch_at.get(corr)
        path = None if t is None else timeline.path_at(t)
        out[(path, kind)] += (b - a) * 1e-6
    return dict(out)


def idle_by_path(gaps, timeline):
    """{path: seconds} of the idle `gaps` [(start us, end us)], each split
    over the spans open during it."""
    out = defaultdict(float)
    for a, b in gaps:
        for path, w in timeline.overlaps(a, b):
            out[path] += w * 1e-6
    return dict(out)


def span_summary(prof, layers: dict) -> dict:
    """The profile `prof` by the program's spans.  layers: {layer name:
    [kernel name prefixes]}, as `trace.summarize` takes; a device
    operation no layer claims is glue.  Returns device seconds by (path,
    layer), idle seconds by path, the idle total, and how the launches
    were found (by the runtime call, by the operator, not at all)."""
    from torch.autograd import DeviceType

    spans, dev = [], []
    launch_at, op_at = {}, {}
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if (not e.name or e.name.startswith("bench.")
                    or e.name.startswith(PREFIX)
                    or getattr(e, "is_user_annotation", False)):
                continue
            dev.append((tr.start, tr.end, e.name, e.id,
                        getattr(e, "linked_correlation_id", 0)))
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith("cu"):   # cudaLaunchKernel, ...
                launch_at[e.id] = tr.start
                continue
            if e.name.startswith(PREFIX):
                spans.append((tr.start, tr.end, e.name))
            op_at.setdefault(e.id, tr.start)
    found = {"runtime": 0, "operator": 0, "none": 0}
    ops = []
    at = {}
    for a, b, name, corr, linked in dev:
        layer = next((ln for ln, pre in layers.items()
                      if trace.matches(name, pre)), "glue")
        key = (corr, linked)
        if corr in launch_at:
            at[key] = launch_at[corr]
            found["runtime"] += 1
        elif linked in op_at:
            at[key] = op_at[linked]
            found["operator"] += 1
        else:
            found["none"] += 1
        ops.append((a, b, layer, key))
    timeline = Timeline(segments(spans))
    _, gaps = trace._union([(a, b, n) for a, b, n, _, _ in dev])
    gaps = [(t, t + s * 1e6) for t, s in gaps]
    idle = idle_by_path(gaps, timeline)
    return {"device_by_path": device_by_path(ops, at, timeline),
            "idle_by_path": idle,
            "idle_s": sum(idle.values()),
            "launch_found": found,
            "n_spans": len(spans)}


def inside(by_path: dict, name: str) -> float:
    """Seconds of `by_path` ({path: s}) under a span called `name`."""
    return sum(s for p, s in by_path.items() if p and name in p)
