"""Wrappers around the port's layer entries, from the benchmark's side.

`Probe.install` replaces, for the life of a run, the names through which
the port calls its layers, on whichever path ``Run3D`` takes:

- ``driver.evolve3d`` and, in the source-parallel mode,
  ``parallel.parallel_evolve3d`` (the timestep loop, once per step),
- ``driver.photon_budget`` (once per step, last in it: the warm-up
  ends its cycle here after one step),
- the sweep engines' batch entries, once per sweep (an iteration sweeps
  again when its subbox grows): ``sweep_pyramid_source_batch`` and the
  shell engine's ``sweep_sources_accumulate``, as ``sweep.evolve3d``
  and ``parallel.sharding`` import them,
- one source group of a sweep: ``sweep.pyramid_sweep.trace_cuda`` /
  ``trace_plain`` and ``sweep.source_sweep.shell_sweep_cuda`` /
  ``shell_sweep_plain``,
- ``global_chemistry_pass`` (once per iteration; a rank's block of
  cells in the source-parallel mode),
- in the source-parallel mode ``sharding.make_parallel_iteration`` (the
  iteration over the whole grid) and ``sharding.psum_rates`` (the rate
  grids summed over the ranks).

Each wrapper calls the port's own function with the same arguments and
returns its result.  Around the calls the probe counts steps,
iterations and sweeps (with their source counts and extents, which the
roofline count reads, and each trace's kernel launches), times the
evolve3d calls between two synchronisations when asked (`spans`),
labels the calls for the profiler, and keeps, for the steps a
`Capture` names, the tensors the correctness check judges: references
to the states and rate grids the port produced (the whole grid, summed
over the ranks), and copies of the rate slabs of a sample of the
sources this process traces.
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
        """`n_sources`: the first rows of the step's source list that
        this process traces (all of them on one rank; rank 0's block in
        the source-parallel mode), from which the sample is drawn."""
        if step % self.steps_per_slice == 0:
            self.slice_h1[step // self.steps_per_slice] = state.h1
        if step == self.last:
            n = min(self.n_sample, n_sources)
            self.sample = sorted(int(s) for s in self.rng.choice(
                n_sources, size=n, replace=False))


class Probe:
    def __init__(self, port, spans=False, labels=False, ranks=1):
        self.port = port
        # the ranks of the source-parallel mode: each traces a block of
        # ceil(S / ranks) sources, rank 0 the first
        self.ranks = ranks
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
        # the kernels each trace call launched
        self.trace_launches = []
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
        self._patch(p.parallel, "parallel_evolve3d",
                    self._wrap_evolve(p.parallel.parallel_evolve3d))
        self._patch(p.driver, "photon_budget",
                    self._wrap_budget(p.driver.photon_budget))
        for module in (p.evolve, p.sharding):
            for name in ("sweep_pyramid_source_batch",
                         "sweep_sources_accumulate"):
                self._patch(module, name,
                            self._wrap_sweep(getattr(module, name)))
        self._patch(p.evolve, "global_chemistry_pass",
                    self._wrap_chem(p.evolve.global_chemistry_pass,
                                    whole=True))
        self._patch(p.sharding, "global_chemistry_pass",
                    self._wrap_chem(p.sharding.global_chemistry_pass,
                                    whole=False))
        self._patch(p.sharding, "make_parallel_iteration",
                    self._wrap_make_iteration(
                        p.sharding.make_parallel_iteration))
        self._patch(p.sharding, "psum_rates",
                    self._wrap_psum(p.sharding.psum_rates))
        for name in ("trace_cuda", "trace_plain"):
            self._patch(p.pyramid, name,
                        self._wrap_trace(getattr(p.pyramid, name)))
        for name in ("shell_sweep_cuda", "shell_sweep_plain"):
            self._patch(p.source_sweep, name,
                        self._wrap_shell_trace(getattr(p.source_sweep, name)))
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
                S = int(srcpos.shape[0])
                self.capture.step_begins(self.cycle_step, state,
                                         min(S, -(-S // self.ranks)))
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
        def sweep(*a, **kw):
            rec = self._iter_rec
            if rec is not None:
                self._sweep = dict(radius=kw.get("radius"), slabs={},
                                   offset=0)
            with self._label("bench.sweep"):
                out = fn(*a, **kw)
            if rec is not None:
                self._sweep["rates"] = out
            return out
        return sweep

    def _wrap_psum(self, fn):
        def psum_rates(rates, *a, **kw):
            out = fn(rates, *a, **kw)
            if self._iter_rec is not None:
                self._sweep["rates"] = out
            return out
        return psum_rates

    def _trace_done(self, out, S, Rf, Rb, lls, launches):
        """Count one trace call of S sources over the extents [-Rb, Rf]
        and keep the slabs of the sampled sources among them."""
        self.traces.append((S, int(Rf), int(Rb), bool(lls)))
        self.trace_launches.append(int(launches))
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

    def _wrap_trace(self, fn):
        def trace(cfg, fstack, srcpos, nflux, Rf, Rb, *a, lls=None, **kw):
            out = fn(cfg, fstack, srcpos, nflux, Rf, Rb, *a, lls=lls, **kw)
            # the source-cell kernel, then three stages a layer
            self._trace_done(out, int(srcpos.shape[0]), Rf, Rb,
                             lls is not None, 1 + 3 * int(Rf))
            return out
        return trace

    def _wrap_shell_trace(self, fn):
        def trace(cfg, shells, fstack, srcpos, nflux):
            out = fn(cfg, shells, fstack, srcpos, nflux)
            # the source-cell kernel, then one a shell; the extents of
            # the table, the homogeneous LLS column of the configuration
            self._trace_done(out, int(srcpos.shape[0]), shells.hi[0],
                             -shells.lo[0], cfg.coldensh_LLS > 0.0,
                             1 + shells.n_shells)
            return out
        return trace

    def _iteration_done(self, pre, post, rates=None):
        """Keep an iteration of a captured step: the whole-grid state it
        began from, the rates its chemistry took (default: the sweep's,
        summed over the ranks), the whole-grid state after its
        chemistry, the sweep's radius and the sampled slabs."""
        rec = self._iter_rec
        if rec is None:
            return
        sw = self._sweep
        it = dict(pre=pre, rates=sw["rates"] if rates is None else rates,
                  post=post, radius=sw["radius"], slabs=sw["slabs"])
        its = rec["iterations"]
        # the first and the latest iteration of the step
        its[min(len(its), 1):] = [it]

    def _wrap_chem(self, fn, whole):
        """`whole`: the pass runs over the whole grid (one rank), and
        its input and output are the iteration's; else over a rank's
        block, and the iteration wrapper keeps the whole grid."""
        def chem(cfg, state, rates, dt, cosmo_cool_factor=None):
            with self._label("bench.chemistry"):
                out = fn(cfg, state, rates, dt, cosmo_cool_factor)
            self.chem_passes += 1
            if whole:
                self._iteration_done(state, out[0], rates)
            return out
        return chem

    def _wrap_make_iteration(self, fn):
        def make_parallel_iteration(*a, **kw):
            iteration = fn(*a, **kw)

            def parallel_iteration(state, *ia, **ikw):
                out = iteration(state, *ia, **ikw)
                self._iteration_done(state, out[0])
                return out
            return parallel_iteration
        return make_parallel_iteration


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class Port:
    """The port's modules whose names the probe replaces."""

    def __init__(self):
        import c2ray_tpu_torch.driver  # noqa: F401
        import c2ray_tpu_torch.parallel.sharding  # noqa: F401
        import c2ray_tpu_torch.sweep.pyramid_sweep  # noqa: F401

        self.driver = sys.modules["c2ray_tpu_torch.driver"]
        self.evolve = sys.modules["c2ray_tpu_torch.sweep.evolve3d"]
        self.pyramid = sys.modules["c2ray_tpu_torch.sweep.pyramid_sweep"]
        self.source_sweep = sys.modules["c2ray_tpu_torch.sweep.source_sweep"]
        # the package, whose name the driver imports at each call, and
        # the module of the source-parallel iteration
        self.parallel = sys.modules["c2ray_tpu_torch.parallel"]
        self.sharding = sys.modules["c2ray_tpu_torch.parallel.sharding"]
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
