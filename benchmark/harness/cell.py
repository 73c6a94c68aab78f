"""One cell of the benchmark: set-up, the timed window of whole cycles,
the traced cycle and the correctness check.

A cycle replays the cell's slices through the port's normal entry,
``Run3D.run(nz0=0, num_slices=n, write_output=False)``, from the state
that set-up left.  Set-up builds the ``Run3D`` object and its tables
once, restarts it from the cell's slice cubes where the cell says so,
and keeps every attribute the driver changes while it runs; `reset`
puts them back, the state as a fresh copy of the same tensors, so every
cycle does the same work.  The reset is inside the window.

A cell whose traffic runs ``Run3D`` in the source-parallel mode
(``run3d.parallel`` "source") runs as one `Cell` a rank, each in its own
process inside an initialised process group (`harness.ranks`): rank 0
makes the inputs and hands their paths to the others, rank 0 decides
after each cycle whether the window goes on and every rank follows, and
rank 0 alone keeps what the check judges and traces its cycle.
"""

import gc
import time

import numpy as np
import torch
import torch.distributed as dist

from . import check, probe, spec, trace


# the control's chemistry stops after this many lockstep iterations:
# in bfloat16 the fixed point's 1% test is never met (400 of 400 at 32^3
# against 2 in float64), the iterate stops moving once the damping has
# begun (iteration 50), and its readings at 55, 60 and 400 iterations
# agree to every digit at 32^3; at 128^3 400 iterations of the heating
# sub-cycle run for hours
CONTROL_CHEM_ITER = 60

# the kernel libraries a cell launches, by the sweep engine it runs,
# built together in set-up (by the parent, before a source-parallel
# cell's ranks start)
LIBRARIES = {"pyramid": ("pyramid_sweep", "group_accumulate", "chemistry"),
             "shells": ("shell_sweep", "chemistry")}


def run3d_of(cfg: dict, traffic: dict, mesh=None) -> dict:
    """The configuration's Run3D keys with the traffic's over them, at
    `mesh` where it is given: what the generator hands Run3D."""
    run3d = dict(cfg["run3d"])
    run3d.update(traffic.get("run3d", {}))
    if mesh is not None:
        run3d["mesh"] = int(mesh)
    return run3d


def engine_of(run3d: dict) -> str:
    """The sweep engine Run3D picks (`sweep.evolve3d.sweep_engine`): the
    pyramid engine at the full periodic extents, +M/2 / -(M/2 - 1) (an
    even mesh and no max_subbox below M/2 - 1), else the shells."""
    M = int(run3d["mesh"])
    cap = run3d.get("max_subbox")
    lo = M // 2 - 1 + M % 2
    if cap is not None:
        lo = min(lo, int(cap))
    return "pyramid" if lo == M // 2 - 1 else "shells"


def ranks_of(run3d: dict) -> int:
    """The processes a run takes: n_devices ranks in the source-parallel
    mode, else one."""
    mode = run3d.get("parallel")
    if mode is None:
        return 1
    if mode != "source":
        raise ValueError(f"the benchmark runs Run3D on one rank or in the "
                         f"source-parallel mode, not parallel={mode!r}")
    return int(run3d["n_devices"])


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
        run3d = run3d_of(self.cfg, self.traffic, mesh)
        self.engine = engine_of(run3d)
        self.ranks = ranks_of(run3d)
        self.rank = dist.get_rank() if dist.is_initialized() else 0

    # -- set-up ------------------------------------------------------------
    def setup(self, warmup=True):
        from c2ray_tpu_torch.config import run3d_config_from_dict
        from c2ray_tpu_torch.driver import Run3D

        t = self.timings = {}
        t0 = time.perf_counter()
        self.port = probe.Port()
        if self.device.type == "cuda":
            build_libraries(self.engine)
        t["import_build_s"] = time.perf_counter() - t0
        # rank 0 writes the inputs once; the ranks read the same files
        inputs = [None]
        if self.rank == 0:
            gen = spec.generator(self.cfg["generator"])
            inputs[0] = gen.make(self.cfg, self.traffic, self.seed,
                                 self.workdir, device=self.device,
                                 mesh=self.mesh)
        if self.ranks > 1:
            dist.broadcast_object_list(inputs, src=0)
        self.inputs = inputs[0]
        run3d = dict(self.inputs["run3d"])
        run3d["device"] = str(self.device)
        if self.device.type == "cpu":
            # the tests' runs: the port's plain versions, in float64
            run3d["dtype"] = "float64"
        self.run3d = run3d
        t["inputs_s"] = time.perf_counter() - t0 - sum(t.values())
        self.run = Run3D(run3d_config_from_dict(run3d))
        picked = self.port.evolve.sweep_engine(self.run.evolve_cfg)
        if picked != self.engine:
            raise RuntimeError(f"Run3D sweeps with the {picked} engine, "
                               f"the benchmark built {self.engine}")
        if self.inputs["restart_z"] is not None:
            self.run.restart_from_slice(self.inputs["restart_z"])
        t["run3d_s"] = time.perf_counter() - t0 - sum(t.values())
        self.steps_per_cycle = (self.num_slices
                                * self.run.config.steps_per_slice)
        self._initial = dict(self.run.__dict__)
        self._initial_state = self.run.state
        if self.fault is not None:
            self.fault(self.port)
        self.probe = probe.Probe(self.port, ranks=self.ranks).install(
            self.run)
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

    def rank0_says(self, flag: bool) -> bool:
        """Rank 0's `flag`, on every rank (one broadcast of an int)."""
        if self.ranks == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        dist.broadcast(t, src=0)
        return bool(int(t))

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, spans=False):
        """Whole cycles until `seconds` have passed on rank 0, at least
        one; the first keeps (on rank 0) what the check judges.  Returns
        (wall seconds, cycles, steps)."""
        p = self.probe
        p.spans = spans
        p.reset_counts()
        rng = np.random.default_rng(self.seed)
        last = int(rng.integers(self.steps_per_cycle))
        self.capture = None
        if self.rank == 0:
            self.capture = probe.Capture(
                start=0, last=last,
                n_sample=int(self.traffic["check"]["sources"]), rng=rng,
                steps_per_slice=self.run.config.steps_per_slice)
        if self.ranks > 1:
            dist.barrier()
        t0 = self.window_t0 = time.perf_counter()
        cycles = 0
        while True:
            self.cycle(self.capture if cycles == 0 else None)
            cycles += 1
            if self.rank0_says(time.perf_counter() - t0 >= seconds):
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

        # rank 0's cycle under the profiler; the other ranks run theirs
        prof = trace.profile(timed_cycle) if self.rank == 0 else None
        if prof is None:
            timed_cycle()
        iterations, traces = p.iterations, list(p.traces)
        chem_passes = p.chem_passes
        launched = dict(sweep_kernels=sum(p.trace_launches),
                        chem_passes=chem_passes)
        layers = spec.layers()
        summary, fallback = None, {}
        libs = self.port.cuda_build._LIBS
        if prof is not None:
            summary = trace.summarize(prof, {k: v["kernels"]
                                             for k, v in layers.items()})
            del prof
            for lname, ld in layers.items():
                want = launched.get(ld.get("launches_counted_as"), 0)
                got = summary["layer_launches"].get(lname, 0)
                if self.device.type == "cuda" and want and got < want:
                    # the layer's libraries this cell loaded (a layer
                    # file names one, or a list: one per sweep engine)
                    lib = ld["library"]
                    names = [n for n in (lib if isinstance(lib, list)
                                         else [lib]) if n in libs]
                    if names:
                        fallback[lname] = names
        timed = {}
        if self.rank0_says(bool(fallback)):
            timers = {}
            for lname, names in fallback.items():
                for n in names:
                    timers[lname, n] = trace.EventTimer(libs[n])
                    libs[n] = timers[lname, n]
            try:
                self.cycle()
            finally:
                for (lname, n), t in timers.items():
                    libs[n] = t._lib
            for lname, names in fallback.items():
                timed[lname] = sum(timers[lname, n].seconds() for n in names)
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


def build_libraries(engine: str):
    """The kernel libraries a cell of `engine` launches, built together
    into the port's fixed build directory inside the checkout."""
    from concurrent.futures import ThreadPoolExecutor

    from c2ray_tpu_torch import cuda_build

    names = LIBRARIES[engine]
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(cuda_build.load, n) for n in names]:
            f.result()
