"""The program's spans and counters from the benchmark's side
(harness/spans.py and the counter readers), on hand-built events: a
device operation goes to the spans open at its runtime launch, an idle
gap that straddles two spans is split between them by overlap, and the
benchmark's own summary of a profile is the same with the program's
annotations present."""

import bench_path  # noqa: F401  (the import path; first)

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from c2ray_tpu_torch.utils import clocks
from harness import spans, spec, trace

LAYERS = {"sweep": ["stage_kernel"], "chemistry": ["chemistry_kernel"]}
SWEEP = "void stage_kernel<float, true, 6>(Params)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>(int)"
CHEM = "void chemistry_kernel<float, false>(Params)"


def _ev(name, start, end, device=DeviceType.CPU, id=0, linked=0,
        annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           linked_correlation_id=linked,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _cycle(program=True):
    """A cycle's events (us): the benchmark's reset, a slice read, then a
    step whose evolve3d sweeps (a fill and the kernel) and runs the
    chemistry.  `program`: with the program's spans, host and device."""
    cpu = [
        _ev("bench.reset", 0, 100),
        _ev("cudaMemsetAsync", 110, 112, id=1),
        _ev("cudaLaunchKernel", 120, 125, id=2),
        _ev("cudaLaunchKernel", 400, 404, id=3),
        _ev("aten::copy_", 500, 510, id=40),
    ]
    dev = [
        _ev(FILL, 115, 130, DeviceType.CUDA, id=1),
        _ev(SWEEP, 130, 300, DeviceType.CUDA, id=2),
        _ev(CHEM, 410, 450, DeviceType.CUDA, id=3),
        # a copy whose runtime call the tracer kept no record of: found
        # through its operator
        _ev("Memcpy DtoH", 505, 508, DeviceType.CUDA, id=9, linked=40),
    ]
    prog = []
    if program:
        prog = [
            _ev("c2ray.slice", 90, 600, id=20),
            _ev("c2ray.slice.read", 90, 105, id=21),
            _ev("c2ray.step", 106, 590, id=22),
            _ev("c2ray.step.evolve3d", 106, 470, id=23),
            _ev("c2ray.sweep", 108, 126, id=24),
            _ev("c2ray.chemistry", 399, 405, id=25),
            _ev("c2ray.step.budget", 480, 590, id=26),
            # the annotations on the device's timeline
            _ev("c2ray.sweep", 115, 300, DeviceType.CUDA, annotation=True),
            _ev("c2ray.chemistry", 410, 450, DeviceType.CUDA,
                annotation=True),
        ]
    return _Prof(sorted(cpu + dev + prog, key=lambda e: e.time_range.start))


def test_segments_give_the_innermost_path():
    segs = spans.segments([(0, 100, "a"), (10, 20, "b"), (20, 50, "c"),
                           (30, 40, "d"), (60, 60, "empty")])
    assert segs == [(0, 10, ("a",)), (10, 20, ("a", "b")),
                    (20, 30, ("a", "c")), (30, 40, ("a", "c", "d")),
                    (40, 50, ("a", "c")), (50, 100, ("a",))]
    tl = spans.Timeline(segs)
    assert tl.path_at(35) == ("a", "c", "d")
    assert tl.path_at(100) == () and tl.path_at(-1) == ()


def test_a_gap_straddling_two_spans_is_split_by_overlap():
    tl = spans.Timeline(spans.segments([(0, 40, "reset"),
                                        (60, 200, "slice"),
                                        (60, 160, "read")]))
    got = spans.idle_by_path([(30, 170), (250, 260)], tl)
    assert got == pytest.approx({("reset",): 10e-6, (): 30e-6,
                                 ("slice", "read"): 100e-6,
                                 ("slice",): 10e-6})
    assert sum(got.values()) == pytest.approx(150e-6)
    assert spans.inside(got, "slice") == pytest.approx(110e-6)


def test_device_time_goes_to_the_spans_open_at_the_launch():
    tl = spans.Timeline(spans.segments([(0, 100, "step"),
                                        (10, 20, "sweep")]))
    ops = [(30, 90, "sweep", 1), (95, 99, "glue", 2), (96, 97, "glue", 7)]
    got = spans.device_by_path(ops, {1: 15, 2: 50}, tl)
    assert got == pytest.approx({(("step", "sweep"), "sweep"): 60e-6,
                                 (("step",), "glue"): 4e-6,
                                 (None, "glue"): 1e-6})


def test_span_summary_of_a_hand_built_cycle():
    s = spans.span_summary(_cycle(), LAYERS)
    assert s["launch_found"] == {"runtime": 3, "operator": 1, "none": 0}
    sweep = ("c2ray.slice", "c2ray.step", "c2ray.step.evolve3d",
             "c2ray.sweep")
    assert s["device_by_path"] == pytest.approx({
        (sweep, "glue"): 15e-6, (sweep, "sweep"): 170e-6,
        (sweep[:3] + ("c2ray.chemistry",), "chemistry"): 40e-6,
        (("c2ray.slice", "c2ray.step", "c2ray.step.budget"), "glue"):
            3e-6})
    # gaps: 300-410 (evolve3d's, the chemistry's launch inside it) and
    # 450-505 (evolve3d to 470, then the step, then the budget)
    idle = s["idle_by_path"]
    assert idle == pytest.approx({
        sweep[:3]: 124e-6, sweep[:3] + ("c2ray.chemistry",): 6e-6,
        ("c2ray.slice", "c2ray.step"): 10e-6,
        ("c2ray.slice", "c2ray.step", "c2ray.step.budget"): 25e-6})
    assert s["idle_s"] == pytest.approx(165e-6)
    evolve = spans.inside(idle, "c2ray.step.evolve3d")
    assert evolve == pytest.approx(130e-6)
    # to evolve3d, to the other spans and to none: the whole idle time
    other = sum(v for p, v in idle.items()
                if p and "c2ray.step.evolve3d" not in p)
    assert evolve + other + idle.get((), 0.0) == pytest.approx(s["idle_s"])


def test_the_benchmarks_summary_is_unchanged_by_the_programs_spans():
    with_spans = trace.summarize(_cycle(True), LAYERS)
    without = trace.summarize(_cycle(False), LAYERS)
    for k in ("layer_device_s", "layer_launches", "busy_s", "device_ops",
              "n_device_ops", "span_s"):
        assert with_spans[k] == without[k], k
    assert with_spans["layer_device_s"]["glue"] == pytest.approx(18e-6)


def test_the_counter_readers_read_the_programs_store():
    read = {n: spec.metric_reader(n).read
            for n in ("sweeps_per_iter", "sweep_glue_gb_per_iter")}
    clocks.reset()
    try:
        assert all(r({}) is None for r in read.values())
        clocks.count("evolve3d.iterations", 6)
        clocks.count("evolve3d.sweeps", 10)
        clocks.count("sweep.zeroed_bytes", 9 * 10**9)
        clocks.count("sweep.summed_bytes", 3 * 10**9)
        assert read["sweeps_per_iter"]({}) == pytest.approx(10 / 6)
        assert read["sweep_glue_gb_per_iter"]({}) == pytest.approx(2.0)
    finally:
        clocks.reset()


def test_tracing_cost_on_the_cpu():
    """tracing_cost.measure end to end at 16^3: the windows with tracing
    on keep spans and those with it off none, and the profiled cycle's
    readings agree with the probe's counts."""
    import tracing_cost

    out = tracing_cost.measure("cubep3m_250.early_heating", 2**31 + 7, 0.0,
                               device="cpu", mesh=16,
                               overrides=dict(n_sources=2, n_low_mass=1))
    assert [w["tracing"] for w in out["windows"]] == [False, True, True,
                                                      False]
    assert all((w["spans_per_step"] > 0) == w["tracing"]
               for w in out["windows"])
    c = out["cycle"]
    checks, got = c["checks"], c["spans_and_counters"]
    assert checks["sweeps_x_iterations_per_step"] == pytest.approx(
        checks["chem_passes_per_step"])
    assert got["sweeps_per_iter"] >= 1.0 and got["slice_host_ms_per_step"] > 0
    assert c["counters"]["evolve3d.iterations"] == c["iterations"]
    # tracing is off again afterwards
    assert clocks.span("c2ray.a") is clocks.span("c2ray.b")
    clocks.reset()
