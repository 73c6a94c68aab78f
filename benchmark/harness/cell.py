"""One cell of the benchmark: set-up, the timed window of whole cycles,
the traced cycle and the correctness check.

A cycle replays the cell's slices through the port's normal entry,
``Run3D.run(nz0=0, num_slices=n, write_output=False)``, from the state
that set-up left.  Set-up builds the ``Run3D`` object and its tables
once, restarts it from the cell's slice cubes where the cell says so,
and keeps every attribute the driver changes while it runs; `reset`
puts them back, the state as a fresh copy of the same tensors, so every
cycle does the same work.  The reset is inside the window.
"""

import gc
import time

import numpy as np
import torch

from . import check, probe, spec, trace


# the control's chemistry stops after this many lockstep iterations:
# in bfloat16 the fixed point's 1% test is never met (400 of 400 at 32^3
# against 2 in float64), the iterate stops moving once the damping has
# begun (iteration 50), and its readings at 55, 60 and 400 iterations
# agree to every digit at 32^3; at 128^3 400 iterations of the heating
# sub-cycle run for hours
CONTROL_CHEM_ITER = 60

# the kernel libraries the cells launch, built together in set-up
LIBRARIES = ("pyramid_sweep", "chemistry")


class Cell:
    def __init__(self, name: str, seed: int, device="cuda", mesh=None,
                 workdir=None, overrides=None, fault=None):
        self.spec = spec.benchmark()
        self.entry = spec.cell(self.spec, name)
        self.name = name
        self.seed = int(seed)
        self.cfg = spec.config(self.entry["config"])
        self.traffic = spec.traffic(name)
        self.traffic.update(overrides or {})
        # the tests' faults, planted under the timed path before the
        # probe wraps it: fault(port) patches the port's module names
        self.fault = fault
        self.device = torch.device(device)
        self.mesh = mesh
        self.workdir = workdir
        self.num_slices = int(self.traffic["num_slices"])

    # -- set-up ------------------------------------------------------------
    def setup(self, warmup=True):
        from c2ray_tpu_torch.config import run3d_config_from_dict
        from c2ray_tpu_torch.driver import Run3D

        t = self.timings = {}
        t0 = time.perf_counter()
        self.port = probe.Port()
        if self.device.type == "cuda":
            _build(self.port.cuda_build, LIBRARIES)
        t["import_build_s"] = time.perf_counter() - t0
        gen = spec.generator(self.cfg["generator"])
        self.inputs = gen.make(self.cfg, self.traffic, self.seed,
                               self.workdir, device=self.device,
                               mesh=self.mesh)
        run3d = dict(self.inputs["run3d"])
        run3d["device"] = str(self.device)
        if self.device.type == "cpu":
            # the tests' runs: the port's plain versions, in float64
            run3d["dtype"] = "float64"
        self.run3d = run3d
        t["inputs_s"] = time.perf_counter() - t0 - sum(t.values())
        self.run = Run3D(run3d_config_from_dict(run3d))
        if self.inputs["restart_z"] is not None:
            self.run.restart_from_slice(self.inputs["restart_z"])
        t["run3d_s"] = time.perf_counter() - t0 - sum(t.values())
        self.steps_per_cycle = (self.num_slices
                                * self.run.config.steps_per_slice)
        self._initial = dict(self.run.__dict__)
        self._initial_state = self.run.state
        if self.fault is not None:
            self.fault(self.port)
        self.probe = probe.Probe(self.port).install(self.run)
        if warmup:
            self.warm_up()
        t["warmup_s"] = time.perf_counter() - t0 - sum(t.values())

    def warm_up(self):
        """The first step of a cycle, on the cell's own shapes: every
        kernel and grid size the window runs (the subbox grows to its
        radius within the step); the probe ends the cycle after it."""
        self.probe.stop_after = 1
        try:
            self.cycle()
        except probe.StepLimit:
            self.synchronize()
        finally:
            self.probe.stop_after = None

    def reset(self):
        self.run.__dict__.update(self._initial)
        st = self._initial_state
        self.run.state = (None if st is None else
                          type(st)(*(t.clone() for t in st)))

    def cycle(self, capture=None):
        with self.probe.label("bench.cycle"):
            with self.probe.label("bench.reset"):
                self.reset()
            self.probe.begin_cycle(capture)
            self.run.run(nz0=0, num_slices=self.num_slices,
                         write_output=False)
            self.synchronize()

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, spans=False):
        """Whole cycles until `seconds` have passed, at least one; the
        first keeps what the check judges.  Returns (wall seconds,
        cycles, steps)."""
        p = self.probe
        p.spans = spans
        p.reset_counts()
        rng = np.random.default_rng(self.seed)
        last = int(rng.integers(self.steps_per_cycle))
        self.capture = probe.Capture(
            start=0, last=last,
            n_sample=int(self.traffic["check"]["sources"]), rng=rng,
            steps_per_slice=self.run.config.steps_per_slice)
        t0 = time.perf_counter()
        cycles = 0
        while True:
            self.cycle(self.capture if cycles == 0 else None)
            cycles += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        if p.steps != cycles * self.steps_per_cycle:
            raise RuntimeError(f"{p.steps} steps in {cycles} cycles of "
                               f"{self.steps_per_cycle}")
        return wall, cycles, p.steps

    # -- the traced cycle --------------------------------------------------
    def traced(self, window_wall, cycles):
        """The per-layer trace: the window's counts and spans, one cycle
        under torch.profiler, and, for a layer whose kernels the tracer
        kept fewer records of than were launched, one more cycle timed
        by CUDA events around its library's entries."""
        p = self.probe
        counts = dict(steps=p.steps, iterations=p.iterations,
                      evolve_s=p.evolve_s, window_s=window_wall,
                      cycles=cycles)
        p.labels = True
        p.spans = False
        p.reset_counts()
        walls = []

        def timed_cycle():
            t0 = time.perf_counter()
            self.cycle()
            walls.append(time.perf_counter() - t0)

        prof = trace.profile(timed_cycle)
        iterations, traces = p.iterations, list(p.traces)
        chem_passes = p.chem_passes
        layers = spec.layers()
        summary = trace.summarize(prof, {k: v["kernels"]
                                         for k, v in layers.items()})
        del prof
        launched = dict(
            sweep_kernels=sum(1 + 3 * rf for _, rf, _, _ in traces),
            chem_passes=chem_passes)
        fallback = {}
        for lname, ld in layers.items():
            want = launched.get(ld.get("launches_counted_as"), 0)
            got = summary["layer_launches"].get(lname, 0)
            if self.device.type == "cuda" and want and got < want:
                fallback[lname] = ld["library"]
        timed = {}
        if fallback:
            timers = {}
            libs = self.port.cuda_build._LIBS
            for lname, lib in fallback.items():
                timers[lname] = trace.EventTimer(libs[lib])
                libs[lib] = timers[lname]
            try:
                self.cycle()
            finally:
                for lname, lib in fallback.items():
                    libs[lib] = timers[lname]._lib
            for lname, t in timers.items():
                timed[lname] = t.seconds()
                summary["busy_s"] += max(
                    0.0, timed[lname]
                    - summary["layer_device_s"].get(lname, 0.0))
                summary["layer_device_s"][lname] = timed[lname]
        return dict(
            counts=counts, summary=summary, traces=traces,
            iterations=iterations, launched=launched,
            events_fallback=timed, run3d=self.run3d,
            cycle_wall_s=window_wall / cycles, profiled_wall_s=walls[0])

    # -- the check ---------------------------------------------------------
    def release(self):
        """Drop the program's state and tables (the captures stay)."""
        self.probe.uninstall()
        if self.fault is not None:
            self.port.restore()
        self.run = None
        self._initial = self._initial_state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64):
        from reference.run3d import Reference

        return Reference(self.run3d, restart_z=self.inputs["restart_z"],
                         dtype=dtype, device=self.device)

    def judged(self, ref, detail=None):
        """(numbers, the reference's outputs, the steps' scalars): the
        port's outputs of the captured cycle against `ref` (a float64
        Reference); `detail` receives each part's reading."""
        cap = self.capture
        steps = ref.steps(self.num_slices)
        want = check.Judged.from_control(ref, cap.records, cap.start,
                                         cap.last, steps, cap.sample,
                                         cap.slice_h1)
        got = check.Judged.from_port(cap.records, cap.start, cap.last,
                                     _program_flux_scale(self.run3d),
                                     cap.sample)
        return check.numbers(got, want, detail), want, steps

    def control(self, want, steps, dtype=torch.bfloat16, detail=None):
        """The numbers of the reference computed in `dtype`, put in the
        port's place, its chemistry cut at CONTROL_CHEM_ITER."""
        from reference.run3d import Reference

        cap = self.capture
        ctrl = Reference(self.run3d, restart_z=self.inputs["restart_z"],
                         dtype=dtype, device=self.device,
                         chem_max_iter=CONTROL_CHEM_ITER)
        got = check.Judged.from_control(ctrl, cap.records, cap.start,
                                        cap.last, steps, cap.sample,
                                        cap.slice_h1)
        return check.numbers(got, want, detail)


def _program_flux_scale(run3d) -> float:
    """The factor the port's losses are scaled by: 1 in float64, the
    summed S_star otherwise (build_quadrature_tables)."""
    if run3d.get("dtype", "float64") == "float64":
        return 1.0
    return float(sum(s["S_star"] for s in run3d["sed"].values()))


def _build(cuda_build, names):
    """The kernel libraries the cell launches, built together into the
    port's fixed build directory inside the checkout."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(cuda_build.load, n) for n in names]:
            f.result()

