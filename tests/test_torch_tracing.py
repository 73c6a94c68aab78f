"""The program's spans and counters (c2ray_tpu_torch/utils/clocks.py).

Off, a span keeps nothing and never enters the profiler; counters count
either way.  On, one `Run3D.run` on the benchmark's seeded CPU inputs
(its cubep3m generator at 16^3, float64, the plain versions) gives the
span tree of the driver, evolve3d and the pyramid sweep, with parents
and timestep identifiers; `evolve3d.sweeps` counts every redone sweep;
a span's self time is its time less its children's; the spans lie on
the profiler's clock.  No JAX.
"""

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

from c2ray_tpu_torch.config import run3d_config_from_dict
from c2ray_tpu_torch.driver import Run3D
from c2ray_tpu_torch.sweep.evolve3d import _subbox_radii
from c2ray_tpu_torch.utils import clocks

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CELL = "cubep3m_250.early_heating"
SEED = 2**31 + 11

# span -> its parent (None: outermost) as Run3D.run opens them on the
# pyramid engine with catalog sources and density files
PARENT = {
    "c2ray.slice": None,
    "c2ray.slice.read": "c2ray.slice",
    "c2ray.slice.upload": "c2ray.slice",
    "c2ray.slice.catalog": "c2ray.slice",
    "c2ray.slice.h1_to_host": "c2ray.slice",
    "c2ray.slice.suppression": "c2ray.slice",
    "c2ray.step": "c2ray.slice",
    "c2ray.step.evolve3d": "c2ray.step",
    "c2ray.step.budget": "c2ray.step",
    "c2ray.iteration": "c2ray.step.evolve3d",
    "c2ray.iteration.read": "c2ray.iteration",
    "c2ray.sweep": "c2ray.iteration",
    "c2ray.chemistry": "c2ray.iteration",
    "c2ray.sweep.stack": "c2ray.sweep",
    "c2ray.sweep.group": "c2ray.sweep",
    "c2ray.sweep.sum": "c2ray.sweep",
}

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_store():
    clocks.tracing(False)
    clocks.reset()
    yield
    clocks.tracing(False)
    clocks.reset()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The benchmark cell's seeded inputs at 16^3, 4 sources."""
    sys.path.insert(0, str(BENCH))
    try:
        from harness import spec

        cfg = spec.config("cubep3m_250")
        traffic = spec.traffic(CELL)
        traffic.update(n_sources=4, n_low_mass=1)
        made = spec.generator(cfg["generator"]).make(
            cfg, traffic, SEED, str(tmp_path_factory.mktemp("cubep3m")),
            device="cpu", mesh=16)
    finally:
        sys.path.remove(str(BENCH))
    run3d = dict(made["run3d"], device="cpu", dtype="float64")
    return run3d, int(traffic["num_slices"])


def _run(inputs, subbox_start=8):
    """One Run3D.run of the cell's slices; returns (run, its stats)."""
    run3d, n = inputs
    run = Run3D(run3d_config_from_dict(run3d))
    run.evolve_cfg = dataclasses.replace(run.evolve_cfg,
                                         subbox_start=subbox_start)
    stats = [s for sl in run.run(nz0=0, num_slices=n, write_output=False)
             for s in sl]
    return run, stats


def test_off_keeps_no_span_and_enters_no_profiler_scope(inputs,
                                                        monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert clocks.span("c2ray.x") is clocks.span("c2ray.y")
    _, stats = _run(inputs)
    snap = clocks.snapshot()
    assert snap["records"] == [] and snap["spans"] == {}
    # counters count with tracing off
    assert snap["counters"]["evolve3d.iterations"] == sum(
        s.n_iterations for s in stats)
    assert snap["counters"]["sweep.groups"] >= snap["counters"][
        "evolve3d.sweeps"] > 0


def test_a_run_gives_the_span_tree(inputs):
    clocks.tracing(True)
    run, stats = _run(inputs, subbox_start=2)
    snap = clocks.snapshot()
    recs = snap["records"]
    names = {r[0] for r in recs}
    assert names == set(PARENT)
    for name, start, end, parent, sl, st in recs:
        assert start <= end
        want = PARENT[name]
        assert (parent < 0) if want is None else recs[parent][0] == want
        if parent >= 0:
            p = recs[parent]
            assert p[1] <= start and end <= p[2]
        # every span of a step shares the step's (slice, step); the
        # slice's own spans have no step
        assert sl == 0
        in_step = name.startswith(("c2ray.step", "c2ray.iteration",
                                   "c2ray.sweep", "c2ray.chemistry"))
        assert (st is not None) == in_step
        if parent >= 0 and in_step and recs[parent][0] != "c2ray.slice":
            assert (sl, st) == tuple(recs[parent][4:6])
    steps = [r for r in recs if r[0] == "c2ray.step"]
    assert [r[5] for r in steps] == list(range(len(stats)))
    c, s = snap["counters"], snap["spans"]
    assert s["c2ray.slice"]["count"] == 1
    assert s["c2ray.iteration"]["count"] == c["evolve3d.iterations"] == sum(
        x.n_iterations for x in stats)
    assert s["c2ray.sweep"]["count"] == s["c2ray.chemistry"]["count"] \
        == c["evolve3d.sweeps"]
    assert s["c2ray.sweep.group"]["count"] == c["sweep.groups"]
    assert all(n.startswith("c2ray.") for n in s)


def test_sweeps_count_every_subbox_doubling(inputs):
    """Each doubling redoes the iteration: the run's sweeps are its
    iterations plus the doublings from the first radius to the last."""
    run, stats = _run(inputs, subbox_start=2)
    radii = _subbox_radii(run.evolve_cfg)
    assert len(radii) == 3
    c = clocks.snapshot()["counters"]
    n_it = sum(s.n_iterations for s in stats)
    doublings = radii.index(stats[-1].subbox_radius)
    assert doublings > 0
    assert c["evolve3d.iterations"] == n_it
    assert c["evolve3d.sweeps"] == n_it + doublings
    # one group a sweep at 4 sources; the masked sum reads each slab
    M = run.config.mesh
    assert c["sweep.groups"] == c["evolve3d.sweeps"]
    assert c["sweep.summed_bytes"] == c["sweep.groups"] * 4 * M**3 * 4 * 8


def test_self_time_is_time_less_the_childrens(monkeypatch):
    ticks = iter([0, 10, 30, 40, 50, 60, 70, 100])
    monkeypatch.setattr(clocks.time, "time_ns", lambda: next(ticks))
    clocks.tracing(True)
    with clocks.span("c2ray.a", slice_index=3, step_index=1):
        with clocks.span("c2ray.b"):
            pass
        with clocks.span("c2ray.c"):
            with clocks.span("c2ray.b"):
                pass
    snap = clocks.snapshot()
    got = {k: (v["count"], round(v["total_s"] * 1e9),
               round(v["self_s"] * 1e9)) for k, v in snap["spans"].items()}
    assert got == {"c2ray.a": (1, 100, 50), "c2ray.b": (2, 30, 30),
                   "c2ray.c": (1, 30, 20)}
    assert [r[3:] for r in snap["records"]] == [
        (-1, 3, 1), (0, 3, 1), (0, 3, 1), (2, 3, 1)]
    clocks.reset()
    assert clocks.snapshot() == {"counters": {}, "spans": {},
                                 "records": []}


def test_spans_lie_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    clocks.tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with clocks.span("c2ray.timed"):
            torch.ones(64).sum()
            time.sleep(0.002)
    rec = clocks.snapshot()["records"][0]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "c2ray.timed"]
    assert len(ev) == 1
    # the profiler's event lies inside the kept span, within a millisecond
    # at either end
    assert 0 <= ev[0].start_ns() - rec[1] < 1_000_000
    assert 0 <= rec[2] - ev[0].end_ns() < 1_000_000


def test_counters_add_without_tracing():
    clocks.count("c2ray.test")
    clocks.count("c2ray.test", 4)
    assert clocks.counter("c2ray.test") == 5
    assert clocks.counter("never") == 0
    assert clocks.snapshot()["counters"] == {"c2ray.test": 5}
