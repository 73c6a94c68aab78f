"""Wrappers around the port's layer entries, from the benchmark's side.

`Probe.install` replaces, for the life of a run, the names through which
the port calls its layers:

- ``driver.evolve3d`` (the timestep loop, once per step),
- ``driver.photon_budget`` (once per step, last in it: the warm-up
  ends its cycle here after one step),
- ``sweep.evolve3d.sweep_pyramid_source_batch`` (the pyramid engine's
  entry, once per sweep: an iteration sweeps again when its subbox grows),
- ``sweep.pyramid_sweep.trace_cuda`` / ``trace_plain`` (one source group
  of a sweep),
- ``sweep.evolve3d.global_chemistry_pass`` (once per iteration).

Each wrapper calls the port's own function with the same arguments and
returns its result.  Around the calls the probe counts steps,
iterations and sweeps (with their source counts and extents, which the
roofline count reads), times the evolve3d calls between two
synchronisations when asked (`spans`), labels the calls for the
profiler, and keeps, for the steps a `Capture` names, the tensors the
correctness check judges: references to the states and rate grids the
port produced, and copies of the rate slabs of a sample of sources.
"""

import sys
import time
from contextlib import nullcontext

import torch


class StepLimit(Exception):
    """Raised once a cycle has taken `Probe.stop_after` steps."""


class Capture:
    """What to keep of one cycle: step `start` (its input state and
    sources and its first iteration) and step `last` (its last iteration
    with the slabs of `n_sample` sources drawn by `rng` once the step's
    source count is known, its output state and budget), and the
    ionized fraction each slice began with (the suppression's input)."""

    def __init__(self, start: int, last: int, n_sample: int, rng,
                 steps_per_slice: int):
        self.start, self.last = start, last
        self.n_sample = n_sample
        self.rng = rng
        self.steps_per_slice = steps_per_slice
        self.sample = []
        self.records = {}
        self.slice_h1 = {}

    def wants(self, step):
        return step in (self.start, self.last)

    def step_begins(self, step, state, n_sources):
        if step % self.steps_per_slice == 0:
            self.slice_h1[step // self.steps_per_slice] = state.h1
        if step == self.last:
            n = min(self.n_sample, n_sources)
            self.sample = sorted(int(s) for s in self.rng.choice(
                n_sources, size=n, replace=False))


class Probe:
    def __init__(self, port, spans=False, labels=False):
        self.port = port
        self.spans = spans
        self.labels = labels
        self._saved = []
        self.capture = None
        self._iter_rec = None
        self._sweep = None
        # end the cycle (StepLimit) once this many of its steps are done
        self.stop_after = None
        self.reset_counts()

    # -- counts ------------------------------------------------------------
    def reset_counts(self):
        self.steps = 0
        self.iterations = 0
        self.evolve_s = 0.0
        # (wall, iterations, subbox radius) of each step, with spans
        self.step_walls = []
        # (S, Rf, Rb, lls) of every trace call: the work of the sweeps
        self.traces = []
        self.chem_passes = 0
        self.cycle_step = 0

    def begin_cycle(self, capture=None):
        self.cycle_step = 0
        self.capture = capture

    # -- install -----------------------------------------------------------
    def _patch(self, module, name, fn):
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def install(self, run=None):
        """Wrap the port's layer entries, and the slice-level methods of
        the Run3D object `run` (labels only)."""
        p = self.port
        if run is not None:
            for name in ("prepare_slice", "slice_sources"):
                self._patch(run, name, self._wrap_label(
                    getattr(run, name), "bench." + name))
        self._patch(p.driver, "evolve3d", self._wrap_evolve(p.driver.evolve3d))
        self._patch(p.driver, "photon_budget",
                    self._wrap_budget(p.driver.photon_budget))
        self._patch(p.evolve, "sweep_pyramid_source_batch",
                    self._wrap_sweep(p.evolve.sweep_pyramid_source_batch))
        self._patch(p.evolve, "global_chemistry_pass",
                    self._wrap_chem(p.evolve.global_chemistry_pass))
        for name in ("trace_cuda", "trace_plain"):
            self._patch(p.pyramid, name,
                        self._wrap_trace(getattr(p.pyramid, name)))
        return self

    def uninstall(self):
        while self._saved:
            module, name, fn = self._saved.pop()
            setattr(module, name, fn)

    def label(self, name):
        return self._label(name)

    def _wrap_label(self, fn, name):
        def labelled(*a, **kw):
            with self._label(name):
                return fn(*a, **kw)
        return labelled

    def _label(self, name):
        return (torch.profiler.record_function(name) if self.labels
                else nullcontext())

    def _record(self):
        c = self.capture
        if c is None or not c.wants(self.cycle_step):
            return None
        return c.records.setdefault(self.cycle_step, {})

    # -- wrappers ----------------------------------------------------------
    def _wrap_evolve(self, fn):
        def evolve3d(cfg, state, srcpos, nflux, dt, **kw):
            if self.capture is not None:
                self.capture.step_begins(self.cycle_step, state,
                                         int(srcpos.shape[0]))
            rec = self._record()
            if rec is not None:
                rec.update(state_in=state, srcpos=srcpos, nflux=nflux,
                           dt=float(dt), dr=kw.get("dr"),
                           ccf=kw.get("cosmo_cool_factor"),
                           lls_grid=kw.get("lls_grid"), iterations=[])
            self._iter_rec = rec
            with self._label("bench.evolve3d"):
                if self.spans:
                    _sync(state.ndens)
                    t0 = time.perf_counter()
                out = fn(cfg, state, srcpos, nflux, dt, **kw)
                if self.spans:
                    _sync(state.ndens)
                    w = time.perf_counter() - t0
                    self.evolve_s += w
                    self.step_walls.append((w, int(out[1].n_iterations),
                                            int(out[1].subbox_radius)))
            self.steps += 1
            self.iterations += int(out[1].n_iterations)
            if rec is not None:
                rec.update(state_out=out[0], stats=out[1])
            self._iter_rec = None
            return out
        return evolve3d

    def _wrap_budget(self, fn):
        def photon_budget(*a, **kw):
            with self._label("bench.photon_budget"):
                out = fn(*a, **kw)
            rec = self._record()
            if rec is not None:
                rec["budget"] = out
            self.cycle_step += 1
            if self.stop_after is not None and \
                    self.cycle_step >= self.stop_after:
                raise StepLimit(self.cycle_step)
            return out
        return photon_budget

    def _wrap_sweep(self, fn):
        def sweep(cfg, fields, srcpos, nflux, radius=None, **kw):
            rec = self._iter_rec
            if rec is not None:
                self._sweep = dict(radius=radius, slabs={}, offset=0)
            with self._label("bench.sweep"):
                out = fn(cfg, fields, srcpos, nflux, radius=radius, **kw)
            if rec is not None:
                self._sweep["rates"] = out
            return out
        return sweep

    def _wrap_trace(self, fn):
        def trace(cfg, fstack, srcpos, nflux, Rf, Rb, *a, lls=None, **kw):
            out = fn(cfg, fstack, srcpos, nflux, Rf, Rb, *a, lls=lls, **kw)
            S = int(srcpos.shape[0])
            self.traces.append((S, int(Rf), int(Rb), lls is not None))
            rec = self._iter_rec
            c = self.capture
            if (rec is not None and c is not None
                    and self.cycle_step == c.last):
                sw = self._sweep
                lo = sw["offset"]
                for s in c.sample:
                    if lo <= s < lo + S:
                        sw["slabs"][s] = (out[0][s - lo].clone(),
                                          out[1][s - lo].clone(),
                                          out[2][s - lo].clone())
                sw["offset"] = lo + S
            return out
        return trace

    def _wrap_chem(self, fn):
        def chem(cfg, state, rates, dt, cosmo_cool_factor=None):
            with self._label("bench.chemistry"):
                out = fn(cfg, state, rates, dt, cosmo_cool_factor)
            self.chem_passes += 1
            rec = self._iter_rec
            if rec is not None:
                it = dict(pre=state, rates=rates, post=out[0],
                          radius=self._sweep["radius"],
                          slabs=self._sweep["slabs"])
                its = rec["iterations"]
                # the first and the latest iteration of the step
                its[min(len(its), 1):] = [it]
            return out
        return chem


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class Port:
    """The port's modules whose names the probe replaces."""

    def __init__(self):
        import c2ray_tpu_torch.driver  # noqa: F401
        import c2ray_tpu_torch.sweep.pyramid_sweep  # noqa: F401

        self.driver = sys.modules["c2ray_tpu_torch.driver"]
        self.evolve = sys.modules["c2ray_tpu_torch.sweep.evolve3d"]
        self.pyramid = sys.modules["c2ray_tpu_torch.sweep.pyramid_sweep"]
        self.global_pass = sys.modules["c2ray_tpu_torch.sweep.global_pass"]
        self.cuda_build = sys.modules["c2ray_tpu_torch.cuda_build"]
        self._patched = []

    def patch(self, module, name, fn):
        """Replace a name of one of the port's modules (the tests' faults);
        `restore` puts every one back."""
        self._patched.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def restore(self):
        while self._patched:
            module, name, fn = self._patched.pop()
            setattr(module, name, fn)
