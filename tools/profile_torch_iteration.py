"""Profile the port's 3D iteration on one GPU: device time by kernel.

    python3 tools/profile_torch_iteration.py [--heating] [--lls]
        [--photon-losses] [--engine pyramid|octant|shells] [--iters N]
        [--lanes G1,G2,...]

Runs the bench configuration of ``chip_smoke.py`` (128^3 x 8 sources,
float32, isothermal or with heating) through `make_evolve3d_iteration`;
`--lls` gives the sweep a per-cell LLS grid (seeded, 1e14-1e17 cm^-2
per cell: the LLS variant of the sweep kernel), `--photon-losses` turns
on band tracking and the photon-loss redistribution, `--engine` picks
the sweep engine (`Evolve3DConfig.engine`): one warm-up iteration,
then N iterations timed without the profiler and the same N
iterations again under ``torch.profiler``.  Prints the
device time per iteration of each kernel, the wall per iteration
(unprofiled and profiled), and the device's idle share (1 - device
time / unprofiled wall, so the profiler's own overhead is not counted
as idle; the port runs on one stream, so device time does not overlap
itself).

    python3 tools/profile_torch_iteration.py --octant [--lanes G1,...]
        [--parent DIR] [--json PATH]

`--octant` splits the octant kernel's device time by plane group
(chip_smoke.octant_plane_groups) at phase 16's state, isothermal and
heating, with each group's cell steps, beside the pyramid kernel's by
layer group on the same inputs; with `--lanes` it runs every plane at
each lane count per cell in turns (the lanes are a choice of the
wrapper per launch, octant_sweep._plane_lanes, so no rebuild); with
`--parent DIR` (a `git archive` of another commit under build/) it
times the parent's octant and halo-pack kernels against this tree's in
turns and counts the other kernel sources' functions whose SASS equals
the parent's; `--json` writes each plane's device ms.

`--lanes` alone times the pyramid and shell kernels instead, at the same
configuration, isothermal and with heating, once built as they are for
each lane count G per cell (a power of two dividing 32): each build
compiles csrc/pyramid_sweep.cu and csrc/shell_sweep.cu from a copy of
csrc/ under build/lanes<G>/ with band_rates.cuh's kCellLanes = G, and
the counts run in turns (G1, G2, ..., G2, G1), CUDA events, mean of 5
calls after a warm-up each.

    python3 tools/profile_torch_iteration.py --builds --parent DIR
        [--before DIR]

`--builds` holds this tree's kernel build against the parent's (DIR, a
`git archive` of that commit under build/): the seven kernel sources of
each built all at once, as chip_smoke.py's phase 2 builds them (wall
and per-source seconds, the parent first), the SASS of each function of
the parent's sweep, 1D and halo sources against this build's, and the
fixed quadrature rule's pyramid, shell and octant sweeps at 128^3 x 8
float32 on phase 16's state (isothermal and heating) timed in turns
with the parent build (parent, this, this, parent; CUDA events).  With
`--before DIR` (another checkout) its three sweep sources are built too
and its tau-table and "auto" sweeps timed in turns with this tree's.

    python3 tools/profile_torch_iteration.py --oned [--auto] [--steps N]
        [--parent DIR]

`--oned` profiles the 1D kernel (csrc/evolve1d.cu) on test 1 at 10000
shells instead, in the three variants of chip_smoke.py's phase 12
(quadrature isothermal and heating, tau tables): N float32 10 Myr steps
(default 12) and one float64 step from the initial state each.  It
builds a second copy of the kernel, under build/oned_split/, with
clock64() stamps inserted into the march (stamp_evolve1d), which give
the cycles of each part (fits, incoming side, outgoing side, lane
reduction, doric, thermal sub-cycle, convergence, per-shell work), and
prints them per fixed-point iteration.  With `--parent DIR` (a checkout
of another commit, e.g. a `git archive` under build/), its
csrc/evolve1d.cu is built too and the two builds run in turns (parent,
this, this, parent) on the same inputs: float32 ms per iteration and
thermal sub-steps per iteration over the N steps, the float64 step
wall; and each build's issue floor (kernel_study.sass_issue_floor: SASS
instructions per iteration).  It also builds the parent's 3D kernel
sources that share the 1D kernel's headers (chemistry, pyramid, shell
and octant sweeps) and counts the
kernel functions whose SASS equals this tree's.  With `--auto` the runs
are the "auto" quadrature tables' (test 1's 1e5 K blackbody, 7 blocks),
isothermal and heating, instead of phase 12's three, and a stamped copy
of csrc/band_rates.cuh (stamp_band_rates) adds the cycles of each pass
of the "auto" route: per block of commit e7dcd29's design, per slot of
this tree's row deal; the parent build then runs through its own
"auto" entries (kernel_study.parent_evolve1d).

    python3 tools/profile_torch_iteration.py --oned --auto
        --variants V1,V2,... [--steps N]

times copies of csrc/ with one change each to the row deal
(ONED_ROW_VARIANTS, built under build/oned_<name>/: two slots a turn,
rows of 4 or 6 nodes, fences, the split's stamps, ...) in turns with
this build on the "auto" steps, isothermal and heating, float32.

    python3 tools/profile_torch_iteration.py --chem [--parent DIR]
        [--variants V1,V2,...]

`--chem` profiles the 3D chemistry kernel (csrc/chemistry.cu) on the
inputs of chip_smoke.py's phase 4 (isothermal) and 5 (heating) main
paths: each of the 4 timed iterations, the pass after them (phase
kernel times' inputs) and the first iteration of an evolve3d timestep
(chem_inputs).  A copy of the kernel built under build/chem_split_<key>/
with clock64() stamps (kernel_study.stamp_chemistry; it also stamps the one-thread-
per-cell kernel of commit 8446144) gives each cell's iterations and
summed thermal sub-steps (histograms, sums, the warp efficiency in cell
order), cycles per part (loads, fits, doric, blend, thermal, convergence,
stores) and each block's residency (achieved occupancy); the SASS per
pass of the fixed-point loop and of the thermal sub-step
(kernel_study.sass_loop_mix), registers and theoretical occupancy; the
kernel's device ms (torch.profiler) and the wrapper call's (CUDA
events).  With `--parent DIR` (a `git archive` of another commit) its
kernel runs the same split and is timed in turns, and the outputs and
counters are compared bit for bit.  With `--variants` it instead builds
each variant of CHEM_VARIANTS ("a+b" applies both: edits of a copy of
csrc/ under build/chem_<name>/) and times them against this
build (and the parent's) in turns, with their bits compared.

    python3 tools/profile_torch_iteration.py --ploss [--parent DIR]

`--ploss` profiles the photon-loss kernel (csrc/photon_losses.cu) at
phase 8's state: the band loop's SASS per band and cell
(kernel_study.sass_per_band), registers, the kernel's device ms, the
wrapper call's and the device time of each kernel one call launches;
with `--parent` the parent's kernel in turns.

    python3 tools/profile_torch_iteration.py --route tau|auto
        [--variants V1,V2,...]

`--route` splits the pyramid sweep kernel on a rate route at phase 4's
and 5's states (128^3 x 8 float32, the route's own iterations):
knock-out copies of csrc/ (ROUTE_VARIANTS, built under
build/route_<name>/) timed in turns with this build (CUDA events):
on the tau tables the table reads replaced by their position's residual
(`noread`), the positions by a constant row (`nopos`), both; on the
"auto" blocks one runtime-K instantiation for every block (`onek`).
`--variants` times those of ROUTE_VARIANTS instead (e.g. lanes1,lanes4:
the route's kernels at 1 or 4 lanes per cell, uncapped: the tau
route's heating kernels without their cap on resident blocks).  Also the fixed 6-node rule's sweep at
the same state, the route's stage
kernels' registers, spills and theoretical occupancy (ptxas -v), and on
the blocks the node terms of each lane of a cell.
"""

import argparse
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the SASS readers and the stamped chemistry build, shared with
# chip_smoke.py
from kernel_study import (  # noqa: E402
    _CHEM_STAMPS, _stamp, achieved_occupancy, build_chem_split, build_oned,
    chem_layout, chem_pass_with, chem_split_run, chem_split_stats,
    comparable_sass, kernel_sass, oned_block_rows, parent_evolve1d,
    parent_oned_tables, parent_photon_losses, sass_loop_mix, sass_per_band,
    with_library)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--heating", action="store_true")
    ap.add_argument("--lls", action="store_true")
    ap.add_argument("--photon-losses", action="store_true")
    ap.add_argument("--engine", default="pyramid",
                    choices=("pyramid", "octant", "shells"))
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--mesh", type=int, default=128)
    ap.add_argument("--sources", type=int, default=8)
    ap.add_argument("--lanes", default=None)
    ap.add_argument("--oned", action="store_true")
    ap.add_argument("--auto", action="store_true")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--octant", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--chem", action="store_true")
    ap.add_argument("--ploss", action="store_true")
    ap.add_argument("--variants", default=None)
    ap.add_argument("--builds", action="store_true")
    ap.add_argument("--before", default=None)
    ap.add_argument("--route", default=None, choices=("tau", "auto"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_iteration: needs a CUDA GPU")
    if args.chem:
        if args.variants:
            time_chem_variants(args.variants.split(","), args.mesh,
                               args.sources, args.parent)
        else:
            profile_chem(args.mesh, args.sources, args.parent)
        return
    if args.ploss:
        profile_ploss(args.mesh, args.sources, args.parent)
        return
    if args.route:
        profile_route(args.route, args.mesh, args.sources,
                      args.variants.split(",") if args.variants else None)
        return
    if args.oned:
        if args.variants:
            time_oned_variants(args.variants.split(","), args.steps)
        else:
            profile_oned(args.steps, args.parent, args.auto)
        return
    if args.octant:
        profile_octant(args.mesh, args.sources, args.lanes, args.parent,
                       args.json)
        return
    if args.builds:
        if not args.parent:
            sys.exit("--builds needs --parent DIR")
        profile_builds(args.mesh, args.sources, args.parent, args.before)
        return

    import dataclasses

    import chip_smoke as cs
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import make_evolve3d_iteration
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    M, S = args.mesh, args.sources
    cfg, _ = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, dev, args.heating)
    cfg = dataclasses.replace(cfg, engine=args.engine)
    if args.photon_losses:
        cfg = dataclasses.replace(
            cfg, add_photon_losses=True,
            sweep=dataclasses.replace(cfg.sweep, track_band_loss=True))
    kw = {}
    if args.lls:
        kw["lls_grid"] = torch.as_tensor(
            10.0 ** np.random.RandomState(8).uniform(14.0, 17.0, M**3),
            dtype=torch.float32, device=dev)
    srcpos, nflux = bench_sources(M, S, dev)
    state = initial_grid_state(np.full((M,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                               1.0e4, dtype=torch.float32, device=dev)
    if args.lanes:
        time_lanes([int(g) for g in args.lanes.split(",")], state, srcpos,
                   nflux, M)
        return
    iteration = make_evolve3d_iteration(cfg)
    start = iteration(state, srcpos, nflux, 1.0e14, **kw)[0]

    def run():
        """Wall seconds per iteration of the N iterations after the
        warm-up (each run starts from the same state)."""
        state = start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state = iteration(state, srcpos, nflux, 1.0e14, **kw)[0]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.iters

    wall = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_profiled = run()

    # device-side rows only: the CPU operators that launched the kernels
    # carry the same device time again
    rows = sorted(((e.self_device_time_total / args.iters,
                    e.count // args.iters, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    variant = f"{args.engine} engine, " + (
        "heating" if args.heating else "isothermal") + (
        " + LLS grid" if args.lls else "") + (
        " + photon losses" if args.photon_losses else "")
    print(f"{cs.smi_line()}; {variant} {M}^3 x {S} float32, {args.iters} "
          f"profiled iterations")
    print(f"wall per iteration {wall * 1e3:.3f} ms ({wall_profiled * 1e3:.3f} "
          f"ms profiled), device time {busy:.3f} ms, idle share "
          f"{1.0 - busy / (wall * 1e3):.4f} of the unprofiled wall")
    for us, count, key in rows[:20]:
        print(f"  {us / 1e3:9.3f} ms  {count:5d} launches  {key[:90]}")


def bench_sources(M, S, dev):
    """The bench's sources (chip_smoke.phase_main's): positions and
    blackbody fluxes from RandomState(7)."""
    rng = np.random.RandomState(7)
    srcpos = torch.as_tensor(rng.randint(0, M, size=(S, 3)), device=dev)
    nflux = torch.as_tensor(np.concatenate(
        [rng.uniform(0.5, 2.0, (S, 1)), np.zeros((S, 2))], axis=1),
        dtype=torch.float32, device=dev)
    return srcpos, nflux


def bench_state(M, S, heating, dev, engine, iters=4, tables="quad"):
    """(config, state, srcpos, nflux) of chip_smoke.py's phase 16 on
    `engine`: the bench configuration in float32 after a warm-up
    iteration and `iters` more from the initial state, on the rate
    route `tables` (chip_smoke.setup's)."""
    import dataclasses

    import chip_smoke as cs
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import make_evolve3d_iteration

    cfg, _ = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, dev, heating,
                      tables=tables)
    cfg = dataclasses.replace(cfg, engine=engine)
    srcpos, nflux = bench_sources(M, S, dev)
    state = initial_grid_state(np.full((M,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                               1.0e4, dtype=torch.float32, device=dev)
    iteration = make_evolve3d_iteration(cfg)
    for _ in range(iters + 1):
        state = iteration(state, srcpos, nflux, 1.0e14)[0]
    return cfg, state, srcpos, nflux


def parent_octant_sweep(lib, cfg, fstack, srcpos, nflux):
    """One octant sweep through a parent build's library: through this
    tree's wrapper where the parent has its entry points, else through
    the earlier entry points of the kernel that launched one thread per
    position of each plane (with octant_sweep_slots)."""
    import ctypes

    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import octant_sweep as oc
    from c2ray_tpu_torch.sweep.source_sweep import _kernel_tables, _type_args

    if not hasattr(lib, "octant_sweep_slots"):
        cuda_build._LIBS["octant_sweep"] = lib
        try:
            return oc.octant_sweep_cuda(cfg, fstack, srcpos, nflux)
        finally:
            del cuda_build._LIBS["octant_sweep"]
    M, S = fstack.shape[0], srcpos.shape[0]
    R = M // 2
    dtype, device = fstack.dtype, fstack.device
    packed, types, K, heat = _kernel_tables(cfg, dtype)
    sp = srcpos.to(dtype=torch.int32).contiguous()
    nfl = nflux.to(dtype=dtype).contiguous()
    lib.octant_sweep_slots.argtypes = [ctypes.c_int]
    lib.octant_sweep_slots.restype = ctypes.c_int
    ring = torch.zeros((S, 8, 4, R + 1, R + 1, 3), dtype=dtype, device=device)
    slab = torch.zeros((S, M**3, 4), dtype=dtype, device=device)
    partials = torch.zeros((S, lib.octant_sweep_slots(M)), dtype=dtype,
                           device=device)
    fn = getattr(lib, "octant_sweep_" + ("heat_" if heat else "")
                 + ("f32" if dtype == torch.float32 else "f64"))
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                   + [ctypes.c_double] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    cuda_build.check(fn(P(fstack.contiguous()), P(sp), P(nfl), P(packed),
                        P(ring), P(slab), P(partials), M, S, K, len(types),
                        *_type_args(types), float(cfg.dr),
                        float(cfg.vol / cfg.flux_scale),
                        float(cfg.coldensh_LLS), float(cfg.max_coldensh),
                        cuda_build.stream_of(fstack)), "parent octant sweep")
    return slab, partials.sum(dim=1)


class EarlierSweepEntries:
    """A sweep library built from a commit before the rate routes, called
    through this tree's wrappers: its sweep entries took no route
    arguments, so each call drops the four pointers (the route ints and
    the photo, heat and hbin tables, sweep/source_sweep.py:_route_args)
    that this tree's entries take before the stream; the fixed rule's
    arguments before them are the same."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if "_sweep_" not in name or name.endswith("_slots"):
            return fn
        return _WithoutRoute(fn)


class _WithoutRoute:
    def __init__(self, fn):
        self.__dict__["fn"] = fn

    def __setattr__(self, key, value):
        if key == "argtypes":
            value = list(value[:-5]) + list(value[-1:])
        setattr(self.fn, key, value)

    def __call__(self, *args):
        return self.fn(*args[:-5], args[-1])


BUILD_SOURCES = ("pyramid_sweep", "chemistry", "photon_losses", "evolve1d",
                 "shell_sweep", "octant_sweep", "domain_halo")
SWEEP_SOURCES = ("pyramid_sweep", "shell_sweep", "octant_sweep")


def build_all(src, out, names):
    """nvcc on each source `names` of the kernel directory `src` into
    out/lib<name>.so, all started together, as chip_smoke.py's phase 2
    does: (wall s, {name: s}, {name: the compiler's report})."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t = time.perf_counter()
        proc = build_oned(src, out / f"lib{name}.so", source=name)
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}/{name}.cu:\n{log}")
        return name, (time.perf_counter() - t, log)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        done = dict(pool.map(one, names))
    return (time.perf_counter() - t0, {n: t for n, (t, _) in done.items()},
            {n: log for n, (_, log) in done.items()})


def profile_builds(M, S, parent, before=None, reps=5):
    """The route switch against the build before it (`parent`, a `git
    archive` of that commit): both builds of the seven kernel sources
    timed (each build all sources at once, parent first); the SASS of
    every function of the parent's sweep, 1D and halo sources against
    this build's (kernel_study.comparable_sass); and the fixed rule's
    sweep kernels (pyramid, shell, octant engine; isothermal and
    heating) at M^3 x S float32 on phase 16's state, timed in turns
    (parent, this, this, parent; CUDA events, mean of `reps` calls after
    a warm-up).  With `before` (another checkout, e.g. the route
    kernels' previous design), its sweep sources are built too and its
    tau-table and "auto" sweeps are timed in turns with this build's."""
    import ctypes
    import shutil

    import chip_smoke as cs

    from c2ray_tpu_torch import cuda_build

    base = cuda_build.BUILD_DIR.parent / "builds"
    dirs = {"parent": Path(parent) / "c2ray_tpu_torch" / "csrc",
            "this": cuda_build.CSRC}
    print(cs.smi_line())
    for key in ("parent", "this"):
        wall, secs, logs = build_all(dirs[key], base / key, BUILD_SOURCES)
        print(f"build of {key}: {wall:.1f} s wall, the {len(secs)} sources "
              f"at once (" + ", ".join(f"{n}.cu {t:.1f} s"
                                       for n, t in secs.items()) + ")",
              flush=True)
    # this build is cuda_build's too: later runs in this checkout load it
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for n in BUILD_SOURCES:
        so = cuda_build.library_path(n)
        if not so.exists():
            shutil.copy(base / "this" / f"lib{n}.so", so)
            so.with_suffix(".log").write_text(logs[n])
    if before:
        dirs["before"] = Path(before) / "c2ray_tpu_torch" / "csrc"
        build_all(dirs["before"], base / "before", SWEEP_SOURCES)
    for n in ("pyramid_sweep", "shell_sweep", "octant_sweep", "evolve1d",
              "domain_halo"):
        mine = comparable_sass(base / "this" / f"lib{n}.so")
        theirs = comparable_sass(base / "parent" / f"lib{n}.so")
        differ = [k for k, v in theirs.items() if mine.get(k) != v]
        print(f"SASS {n}.cu: {len(theirs) - len(differ)} of {len(theirs)} "
              f"parent functions equal here" + "".join(
                  f"\n  differs: {k[:140]}" for k in differ), flush=True)

    def libs(key):
        """{source: library} of build `key` for this tree's wrappers."""
        out = {}
        for n in SWEEP_SOURCES:
            lib = ctypes.CDLL(str(base / key / f"lib{n}.so"))
            out[n] = EarlierSweepEntries(lib) if key == "parent" else lib
        return out

    cases = [("quad", e, ("parent", "this", "this", "parent"))
             for e in ENGINES]
    if before:
        cases += [(r, e, ("before", "this", "this", "before"))
                  for r in ("tau", "auto") for e in ENGINES]
    sweeps_in_turns({key: libs(key) for key in dirs}, M, S, cases, reps)


ENGINES = ("pyramid", "shells", "octant")


def sweeps_in_turns(loaded, M, S, cases, reps=5):
    """The sweep kernels of several builds timed in turns at M^3 x S
    float32 on phase 16's state, isothermal and heating: `loaded` maps
    a build's key to its {source: library}, which this tree's wrappers
    call in that build's turn (through cuda_build's table of loaded
    libraries; "this" is loaded again after each case); `cases` are
    (route, engine, turns), turns e.g. ("parent", "this", "this",
    "parent"); CUDA events, mean of `reps` calls after a warm-up.
    Prints each case; returns {(route, engine, heating): {key: [ms,
    ...]}}."""
    import chip_smoke as cs

    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    dev = torch.device("cuda", 0)
    out = {}
    cuda_build._LIBS.update(loaded["this"])
    for heating in (False, True):
        _, state, srcpos, nflux = bench_state(M, S, heating, dev, "pyramid")
        for route, engine, turns in cases:
            cfg, _ = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, dev,
                              heating, tables=route)
            kern = cs.route_trace_fns(engine, M)[0]
            args = (cfg.sweep, ps.stack_sweep_fields(cfg.sweep,
                                                     cs.fields_of(state)),
                    srcpos, nflux)
            ms = {}
            for key in turns:
                cuda_build._LIBS.update(loaded[key])
                ms.setdefault(key, []).append(
                    cs.event_ms(lambda: kern(*args), reps))
            cuda_build._LIBS.update(loaded["this"])
            a, b = turns[0], turns[1]
            print(f"{engine} sweep, {route}, "
                  f"{'heating' if heating else 'isothermal'}, {M}^3 x {S} "
                  f"float32: {a} " + " / ".join(f"{t:.3f}" for t in ms[a])
                  + f" ms, {b} " + " / ".join(f"{t:.3f}" for t in ms[b])
                  + f" ms; {b}/{a} {sum(ms[b]) / sum(ms[a]):.4f}",
                  flush=True)
            out[(route, engine, heating)] = ms
    return out


def fixed_rule_against_parent(parent, M=128, S=8, reps=5):
    """The fixed quadrature rule's pyramid, shell and octant sweeps of
    this build against those of `parent` (a checkout of another commit),
    in turns (sweeps_in_turns): the parent's three sweep sources built
    under build/builds/parent, called through EarlierSweepEntries when
    they predate the rate routes' arguments."""
    import ctypes

    from c2ray_tpu_torch import cuda_build

    src = Path(parent) / "c2ray_tpu_torch" / "csrc"
    base = cuda_build.BUILD_DIR.parent / "builds" / "parent"
    build_all(src, base, SWEEP_SOURCES)
    routed = (src / "table_rates.cuh").exists()
    loaded = {"parent": {n: (lambda lib: lib if routed
                             else EarlierSweepEntries(lib))(
                  ctypes.CDLL(str(base / f"lib{n}.so")))
                  for n in SWEEP_SOURCES},
              "this": {n: cuda_build.load(n) for n in SWEEP_SOURCES}}
    cases = [("quad", e, ("parent", "this", "this", "parent"))
             for e in ENGINES]
    return sweeps_in_turns(loaded, M, S, cases, reps)


def print_split(label, ms, rows, what):
    """One sweep's device ms by groups of layers or planes
    (chip_smoke.grouped_launches rows) against its CUDA-event time."""
    busy = sum(r[2] for r in rows)
    cells = sum(r[3] for r in rows)
    print(f"  {label}: sweep {ms:.3f} ms (CUDA events), device {busy:.3f} "
          f"ms, launch gaps and other work {ms - busy:.3f} ms; "
          f"{cells} cell steps, {1e6 * busy / cells:.3f} ns each")
    for name, n, t, c, ns in rows:
        print(f"    {what} {name}: {n} launches, {t:.3f} ms, {c} cell steps "
              f"({c / cells:.1%}), {ns:.3f} ns per cell step")


def profile_octant(M, S, lanes, parent, json_path=None):
    """--octant: the octant kernel at phase 16's state, isothermal and
    heating: device ms by plane group (chip_smoke.octant_plane_groups)
    with the cell steps of each group, against the pyramid kernel by
    layer group on the same inputs; with `lanes` the planes forced to
    each lane count in turns; with `parent` (a checkout of another
    commit) its octant and halo-pack kernels against this tree's in
    turns (parent, this, this, parent), and whether the other kernel
    sources compile to the parent's SASS.  `json_path`: each plane's
    device ms and cell steps, per variant and lane count, as JSON."""
    import json

    import ctypes

    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.parallel import halo
    from c2ray_tpu_torch.sweep import octant_sweep as oc
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    dev = torch.device("cuda", 0)
    R = M // 2
    print(f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {M}^3 x {S} float32")
    base = cuda_build.BUILD_DIR.parent
    same_sass = ("chemistry", "pyramid_sweep", "shell_sweep", "evolve1d",
                 "photon_losses")
    plibs = {}
    if parent:
        psrc = Path(parent).resolve() / "c2ray_tpu_torch" / "csrc"
        jobs = {(key, n): build_oned(src, base / f"octant_{key}" /
                                     f"lib{n}.so", source=n)
                for key, src in (("this", cuda_build.CSRC),
                                 ("parent", psrc))
                for n in same_sass + ("octant_sweep", "domain_halo")
                if key == "parent" or n in same_sass}
        for (key, n), proc in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the {key} {n}.cu:\n{out}")
        plibs = {n: ctypes.CDLL(str(base / "octant_parent" / f"lib{n}.so"))
                 for n in ("octant_sweep", "domain_halo")}
        for n in same_sass:
            mine = comparable_sass(base / "octant_this" / f"lib{n}.so")
            theirs = comparable_sass(base / "octant_parent" / f"lib{n}.so")
            same = sum(mine.get(k) == v for k, v in theirs.items())
            print(f"{n}.cu: {same} of {len(theirs)} kernel functions' SASS "
                  f"equal to the parent's ({len(mine)} in this build)")
    groups = cs.octant_plane_groups(R)
    ocells = cs.octant_plane_cells(M, S)
    pcells = cs.pyramid_layer_cells(M, S)
    Rf, Rb = ps.trace_extents(M)
    planes = {"cells": ocells}
    for heating in (False, True):
        cfg, state, srcpos, nflux = bench_state(M, S, heating, dev, "octant")
        sw = cfg.sweep
        fstack = ps.stack_sweep_fields(sw, cs.fields_of(state))
        octant = lambda: oc.octant_sweep_cuda(sw, fstack, srcpos, nflux)
        pyramid = lambda: ps.trace_cuda(sw, fstack, srcpos, nflux, Rf, Rb)
        v = "heating" if heating else "isothermal"
        print(f"{v}, phase 16's state:")
        for label, fn, kernel, n, grp, cells, per, what in (
                ("octant kernel", octant, "plane_kernel", 3 * R, groups,
                 ocells, 1, "planes"),
                ("pyramid kernel", pyramid, "stage_kernel", 3 * Rf,
                 cs.LAYER_GROUPS, pcells, 3, "layers")):
            ms = cs.event_ms(fn, 3)
            durs, _ = cs.launch_profile(fn, kernel, n)
            print_split(label, ms, cs.grouped_launches(durs, grp, cells, per),
                        what)
            planes[f"{v} {label}"] = durs
        if lanes:
            choose = oc._plane_lanes
            order = [int(g) for g in lanes.split(",")]
            try:
                for G in order + order[::-1]:
                    oc._plane_lanes = lambda n, G=G: G
                    ms = cs.event_ms(octant, 3)
                    durs, _ = cs.launch_profile(octant, "plane_kernel", 3 * R)
                    print_split(f"octant kernel, every plane at G = {G}", ms,
                                cs.grouped_launches(durs, groups, ocells),
                                "planes")
                    planes.setdefault(f"{v} G = {G}", []).append(durs)
            finally:
                oc._plane_lanes = choose
        if parent:
            po = lambda: parent_octant_sweep(plibs["octant_sweep"], sw,
                                             fstack, srcpos, nflux)
            a, b = po(), octant()
            for x, y, w in ((a[0][..., :3], b[0][..., :3], "rates"),
                            (a[0][..., 3], b[0][..., 3], "heat"),
                            (a[1], b[1], "photon loss")):
                torch.testing.assert_close(
                    x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max()),
                    msg=f"parent vs this octant kernel, {w}")
            for key in ("parent", "this", "this", "parent"):
                ms = cs.event_ms(po if key == "parent" else octant, 3)
                print(f"  octant sweep {v}, {key}: {ms:.3f} ms")
    if parent:
        c = cs.halo_case(M, 1, R, torch.float32, dev)
        pack = (c["fields"], M, 1e-20, c["left"], c["right"], c["H"])
        ref = halo.halo_pack_plain(*pack)
        for key in ("parent", "this", "this", "parent"):
            if key == "parent":
                cuda_build._LIBS["domain_halo"] = plibs["domain_halo"]
            else:
                cuda_build._LIBS.pop("domain_halo", None)
            if not torch.equal(halo.halo_pack_cuda(*pack), ref):
                raise AssertionError(f"{key} halo_pack differs from plain")
            ms = cs.event_ms(lambda: halo.halo_pack_cuda(*pack), 10)
            print(f"  halo_pack {M}^3, world size 1, radius {R}, {key}: "
                  f"{ms:.4f} ms")
        cuda_build._LIBS.pop("domain_halo", None)
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps(planes))


def build_with_lanes(G):
    """{name: ctypes library} of csrc/pyramid_sweep.cu and shell_sweep.cu
    built, both nvcc at once, from a copy of csrc/ with kCellLanes = G."""
    import ctypes
    import re
    import shutil
    import subprocess

    from c2ray_tpu_torch import cuda_build

    d = cuda_build.BUILD_DIR.parent / f"lanes{G}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    h = d / "band_rates.cuh"
    text, n = re.subn(r"constexpr int kCellLanes = \d+;",
                      f"constexpr int kCellLanes = {G};", h.read_text())
    if n != 1:
        raise RuntimeError("kCellLanes not found in band_rates.cuh")
    h.write_text(text)
    names = ("pyramid_sweep", "shell_sweep")
    procs = [subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                               "-o", str(d / f"lib{n}.so"),
                               str(d / f"{n}.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n in names]
    for p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed at {G} lanes per cell:\n{out}")
    return {n: ctypes.CDLL(str(d / f"lib{n}.so")) for n in names}


def time_lanes(lanes, state, srcpos, nflux, M):
    """The pyramid and shell kernels' times at each lane count, in
    turns."""
    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import build_shell_table
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps
    from c2ray_tpu_torch.sweep import source_sweep as ss

    libs = {G: build_with_lanes(G) for G in lanes}
    table = build_shell_table(M)
    Rf, Rb = ps.trace_extents(M)
    print(f"{cs.smi_line()}; {M}^3 x {srcpos.shape[0]} float32, kernel ms "
          f"per lane count G in turns")
    for heating in (False, True):
        cfg = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, state.h1.device,
                       heating)[0].sweep
        fstack = ps.stack_sweep_fields(cfg, cs.fields_of(state))
        for G in lanes + lanes[::-1]:
            cuda_build._LIBS.update(libs[G])
            pyr = cs.event_ms(lambda: ps.trace_cuda(cfg, fstack, srcpos,
                                                    nflux, Rf, Rb), 5)
            shell = cs.event_ms(lambda: ss.shell_sweep_cuda(
                cfg, table, fstack, srcpos, nflux), 5)
            print(f"  {'heating' if heating else 'isothermal'} G = {G}: "
                  f"pyramid {pyr:.3f} ms, shell {shell:.3f} ms")


SPLIT_PARTS = ("fits", "incoming", "outgoing", "reduction", "doric",
               "thermal", "convergence", "shell")

# The stamps of stamp_evolve1d: lane 0 adds up the clock64() cycles of
# each part of the march, from the stamp before it to its own (each
# after a __syncwarp()), and the launch leaves them in g_split.
_SPLIT_DEFS = """
enum SplitPart {
  kSplitFits, kSplitIn, kSplitOut, kSplitReduce, kSplitDoric,
  kSplitThermal, kSplitConv, kSplitShell, kSplitParts
};
__device__ unsigned long long g_split[kSplitParts];
__device__ unsigned long long g_blk_split[2 * kSplitBlocks];
#define SPLIT_INIT()                                  \\
  for (int q = lane; q < 2 * kSplitBlocks; q += 32) s_blk_split[q] = 0; \\
  unsigned long long split_c[kSplitParts] = {};       \\
  long long split_t = clock64()
#define SPLIT(part)                                   \\
  do {                                                \\
    __syncwarp();                                     \\
    const long long split_n = clock64();              \\
    split_c[part] += split_n - split_t;               \\
    split_t = split_n;                                \\
  } while (0)
#define SPLIT_STORE()                                 \\
  if (lane == 0) {                                    \\
    for (int q = 0; q < kSplitParts; ++q) g_split[q] = split_c[q]; \\
  }                                                   \\
  __syncwarp();                                       \\
  for (int q = lane; q < 2 * kSplitBlocks; q += 32) g_blk_split[q] = s_blk_split[q]

"""
_SPLIT_ENTRY = """
// The last launch's cycles per part (SplitPart order) into
// out[kSplitParts]; returns the cudaError_t of the copy.
extern "C" int evolve1d_split(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, c2ray::g_split,
                              sizeof(unsigned long long) * c2ray::kSplitParts);
}
// The last launch's cycles per block of "auto" tables into
// out[2 * kSplitBlocks]: the outgoing side's, then the incoming side's.
extern "C" int evolve1d_block_split(unsigned long long* out) {
  return cudaMemcpyFromSymbol(
      out, c2ray::g_blk_split,
      sizeof(unsigned long long) * 2 * c2ray::kSplitBlocks);
}
"""
# (pattern, stamp): each pattern matches once in csrc/evolve1d.cu; its
# named group "at" (a zero-width position) is where the stamp goes
_SPLIT_AT = (
    (r"(?P<at>)// kK: the quadrature table's K", _SPLIT_DEFS),
    (r"int it_sum = 0, it_max = 0, sub_max = 0, sub_sum = 0;(?P<at>)",
     "\n  SPLIT_INIT();"),
    (r"spread_fits<T, false>\(fo, t0, T\(1\), rates, y\);(?P<at>)",
     "\n    SPLIT(kSplitShell);"),
    (r"(?P<at>)\n    int nit = 0;", "\n    SPLIT(kSplitIn);"),
    (r"(?P<at>)\n      // photo rates from the incoming columns",
     "\n      SPLIT(kSplitFits);"),
    (r"(?P<at>)\n      for \(int q = 0; q < \(kHeat \? 4 : 3\); \+\+q\)",
     "\n      SPLIT(kSplitOut);"),
    (r"(?P<at>)\n      const T pHI = ", "\n      SPLIT(kSplitReduce);"),
    (r"(?P<at>)\n      T temper1_new = t0, avg_t_new = avg_t;",
     "\n      SPLIT(kSplitDoric);"),
    (r"(?P<at>)\n      done = conv1d\(", "\n      SPLIT(kSplitThermal);"),
    (r"\n      \+\+nit;(?P<at>)", "\n      SPLIT(kSplitConv);"),
    (r"(?P<at>)\n  if \(lane == 0\) \{\n    a\.counters\[0\]",
     "\n  SPLIT_STORE();"),
)


def stamp_evolve1d(text):
    """csrc/evolve1d.cu's `text` with the clock64() stamps of the split
    per part and the entries evolve1d_split / evolve1d_block_split that
    read them; raises if the kernel no longer has a place that a stamp
    goes to."""
    return _stamp(text, _SPLIT_AT, "evolve1d.cu") + _SPLIT_ENTRY


# The stamps of "auto" tables in csrc/band_rates.cuh: lane 0 adds up the
# cycles of each block's pass (outgoing side per iteration, incoming
# side per shell) in shared memory, from a __syncwarp() before the pass
# to one after it; each stamp costs a shared-memory add (~30 cycles).
_BLOCK_SPLIT_DEFS = """
constexpr int kSplitBlocks = 64;
__shared__ unsigned long long s_blk_split[2 * kSplitBlocks];
#define BLOCK_SPLIT_BEGIN() \\
  __syncwarp();             \\
  const long long blk_t = clock64()
#define BLOCK_SPLIT_END(slot)                                       \\
  do {                                                              \\
    __syncwarp();                                                   \\
    if (lane == 0) s_blk_split[slot] += clock64() - blk_t;          \\
  } while (0)

"""
# per design of the block functions, the stamps' places (as _SPLIT_AT);
# the first design whose places are all found is stamped
_BLOCK_SPLIT_AT = {
    # commit e7dcd29: blocks_in / blocks_out run band_in / band_out per
    # block
    "blocks": (
        (r"(?P<at>)// ---- \"auto\" tables in the 1D march",
         _BLOCK_SPLIT_DEFS),
        (r"int lane, int nlanes\) \{\n  for \(int i = 0; i < nblk; "
         r"\+\+i\) \{(?P<at>)", "\n    BLOCK_SPLIT_BEGIN();"),
        (r"in \+ blk\[3\], lane, nlanes\);\n    \}\);(?P<at>)",
         "\n    BLOCK_SPLIT_END(kSplitBlocks + i);"),
        (r"out\[q\] = T\(0\);\n  for \(int i = 0; i < nblk; \+\+i\) "
         r"\{(?P<at>)", "\n    BLOCK_SPLIT_BEGIN();"),
        (r"for \(int q = 0; q < 4; \+\+q\) out\[q\] \+= o\[q\];(?P<at>)",
         "\n    BLOCK_SPLIT_END(i);"),
    ),
    # this tree: rows_in / rows_out deal the rows a slot a turn; a pass
    # is a slot
    "rows": (
        (r"(?P<at>)// ---- \"auto\" tables in the 1D march",
         _BLOCK_SPLIT_DEFS),
        (r"for \(int s = 0; s < slots; \+\+s\) \{(?P<at>)\n    row_in<",
         "\n    BLOCK_SPLIT_BEGIN();"),
        (r"cin, in \+ s \* I \+ lane\);(?P<at>)",
         "\n    BLOCK_SPLIT_END(kSplitBlocks + s);"),
        (r"for \(int s = 0; s < slots; \+\+s\) \{(?P<at>)\n    row_out<",
         "\n    BLOCK_SPLIT_BEGIN();"),
        (r"inv_vol, y, acc, hacc, hcomp\);(?P<at>)",
         "\n    BLOCK_SPLIT_END(s);"),
    ),
}


# the blocks whose cycles the stamped build keeps (kSplitBlocks)
SPLIT_BLOCKS = 64


def stamp_band_rates(text):
    """(csrc/band_rates.cuh's `text` with the per-pass stamps of "auto"
    tables, the design stamped): the first design of _BLOCK_SPLIT_AT
    whose places are all found; raises if none fits."""
    for design, places in _BLOCK_SPLIT_AT.items():
        if all(len(re.findall(p, text)) == 1 for p, _ in places):
            return _stamp(text, places, "band_rates.cuh"), design
    raise RuntimeError("no design of _BLOCK_SPLIT_AT fits band_rates.cuh")


def chem_inputs(M, S, heating, dev, iters=4):
    """The chemistry pass's inputs on chip_smoke.py's phase 4 (heating:
    5) main path in float32: (chemistry config, dt, [(label, state,
    rates)]) of each of the `iters` timed iterations after the warm-up,
    of the pass after them that phase_kernel_times times, and of the
    first iteration of an evolve3d timestep from the initial state."""
    import chip_smoke as cs
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import evolve3d, make_evolve3d_iteration
    from c2ray_tpu_torch.sweep import global_pass as gp

    cfg, _ = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, dev, heating)
    srcpos, nflux = bench_sources(M, S, dev)
    state0 = initial_grid_state(np.full((M,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                                1.0e4, dtype=torch.float32, device=dev)
    dt = 1.0e14
    iteration = make_evolve3d_iteration(cfg, return_rates=True)
    s = iteration(state0, srcpos, nflux, dt)[0]
    out = []
    for k in range(iters):
        nxt, _, _, _, rates = iteration(s, srcpos, nflux, dt)
        out.append((f"timed iteration {k + 1}", s, rates))
        s = nxt
    # chip_smoke.phase_kernel_times' inputs: a sweep of the state after
    # the timed iterations
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    out.append(("after the timed iterations", s,
                ps.sweep_pyramid_source_batch(cfg.sweep, cs.fields_of(s),
                                              srcpos, nflux)))

    class Captured(Exception):
        pass

    first = []

    def capture(chem, state, rates, dt, ccf=None):
        first.append((state, rates))
        raise Captured

    real = gp.chemistry_pass_cuda, gp.chemistry_pass_plain
    gp.chemistry_pass_cuda = gp.chemistry_pass_plain = capture
    try:
        evolve3d(cfg, state0, srcpos, nflux, dt)
    except Captured:
        pass
    finally:
        gp.chemistry_pass_cuda, gp.chemistry_pass_plain = real
    out.append(("evolve3d's first iteration", *first[0]))
    return cfg.chem, dt, out


def theoretical_occupancy(regs, block_threads, warps_per_sm=64):
    """Resident warps per SM that `regs` registers a thread allow (64K
    registers per SM, allocated per warp in units of 256), as a share of
    64."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(65536 // (per_warp * (block_threads // 32)),
                 2048 // block_threads, 32)
    return blocks * block_threads / 32 / warps_per_sm


def ptxas_registers(log, kernel):
    """{instantiation: registers} of `kernel` from a ptxas -v log."""
    return {k: v[0] for k, v in ptxas_usage(log, kernel).items()}


def ptxas_usage(log, kernel):
    """{instantiation: (registers, spill store bytes, spill load bytes)}
    of `kernel` from a ptxas -v log."""
    use, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*" + kernel + r"\S*)'",
                      line)
        if m:
            cur, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            use[cur] = (int(m.group(1)), *spill)
            cur = None
    return use


def sass_between_clocks(listing):
    """Instructions between consecutive clock reads (S2UR/CS2R of
    SR_CLOCKLO) of a stamped listing, in address order: [before the
    first read, after read 1, ..., after the last read]."""
    lines = [ln for ln in listing.splitlines()
             if re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln)]
    marks = [i for i, ln in enumerate(lines) if "SR_CLOCKLO" in ln]
    edges = [0] + [m + 1 for m in marks] + [len(lines)]
    return [b - a for a, b in zip(edges, edges[1:])]


def device_rows(fn):
    """{kernel name: device ms} of the kernels that one fn() launches
    (torch.profiler over two calls, halved)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = e.name[:60]
            rows[k] = rows.get(k, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 2e3
    return rows


def profile_chem(M, S, parent):
    """--chem: the chemistry kernel at phase 4's and 5's states; with
    `parent` (a checkout of another commit) its kernel too, in turns."""
    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import global_pass as gp

    dev = torch.device("cuda", 0)
    print(f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; chemistry at {M}^3 float32, the states "
          f"of phase 4 (isothermal) and 5 (heating)")
    cuda_build.load("chemistry")
    builds = {"this": cuda_build.CSRC}
    if parent:
        builds["parent"] = Path(parent).resolve() / "c2ray_tpu_torch" / "csrc"
    split = {k: build_chem_split(k, src) for k, src in builds.items()}
    plain = {"this": cuda_build.load("chemistry")}
    logs = {"this": cuda_build.build_log("chemistry")}
    if parent:
        import ctypes

        d = cuda_build.BUILD_DIR.parent / "chem_parent"
        proc = build_oned(builds["parent"], d / "libchemistry.so",
                          source="chemistry")
        logs["parent"] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's chemistry.cu:\n"
                               f"{logs['parent']}")
        plain["parent"] = ctypes.CDLL(str(d / "libchemistry.so"))
    for key in builds:
        block = split[key][2]
        for name, r in sorted(ptxas_registers(logs[key],
                                              "chemistry_kernel").items()):
            print(f"  {key}: {name}: {r} registers, {block} threads a block, "
                  f"theoretical occupancy "
                  f"{theoretical_occupancy(r, block):.3f}")
    for heating in (False, True):
        v = "heating" if heating else "isothermal"
        flag = int(heating)
        for key in builds:
            layout = split[key][1]
            path = (cuda_build.library_path("chemistry") if key == "this"
                    else cuda_build.BUILD_DIR.parent / "chem_parent"
                    / "libchemistry.so")
            sass = kernel_sass(path)
            fname = next(k for k in sass if re.search(
                rf"chemistry_kernelIfLb{flag}E", k))
            inner = "ldg" if heating else None
            mix = sass_loop_mix(sass[fname], "ex2", inner)
            print(f"{v}, {key} build: SASS per pass of the fixed-point loop "
                  f"{mix['loop']}; thermal sub-step {mix['inner']}; entry to "
                  f"exit through the loop once {mix['whole']}")
            stamped = kernel_sass(cuda_build.BUILD_DIR.parent
                                     / f"chem_split_{key}" / "libchemistry.so")
            sfn = next(k for k in stamped if re.search(
                rf"chemistry_kernelIfLb{flag}E", k))
            between = sass_between_clocks(stamped[sfn])
            labels = ("prologue",) + _CHEM_STAMPS[layout, heating] + ("after",)
            print(f"  {key} stamped build, SASS between the clock reads in "
                  f"address order: " + (
                      ", ".join(f"{a} {b}" for a, b in zip(labels, between))
                      if len(between) == len(labels) else
                      f"{between} (not attributable to the {len(labels)} "
                      f"parts)"))
        chem, dt, cases = chem_inputs(M, S, heating, dev)
        for label, state, rates in cases:
            call = lambda: gp.chemistry_pass_cuda(chem, state, rates, dt)
            ref = chem_pass_with(plain["this"], "this", chem, state, rates, dt)
            print(f"  {v}, {label}: conv_flag, largest iterations, largest "
                  f"sub-steps of an iteration {ref[1].tolist()}")
            for key in builds:
                lib, layout, block = split[key]
                nit, nsub, cycles, blocks, sout = chem_split_run(
                    lib, layout, chem, state, rates, dt)
                same = (torch.equal(sout[0], ref[0])
                        and torch.equal(sout[1], ref[1]))
                _, lines = chem_split_stats(nit, nsub, cycles, heating)
                print(f"    {key} build, stamped: outputs and counters equal "
                      f"to this build's: {same}; achieved occupancy "
                      f"{achieved_occupancy(blocks, block):.3f}")
                for line in lines:
                    print(f"      {line}")
            rows = device_rows(call)
            print(f"    this build, device ms by kernel of one call: " + ", ".join(
                f"{k} {t:.4f}" for k, t in sorted(rows.items(),
                                                  key=lambda kv: -kv[1])))
            order = ["parent", "this", "this", "parent"] if parent else ["this"]
            res = []
            for key in order:
                f = (call if key == "this" else
                     lambda: chem_pass_with(plain[key], "8446144" if
                                            split[key][1] == "8446144" else
                                            "this", chem, state, rates, dt))
                res.append((key, cs.event_ms(f, 5),
                            cs.launch_profile(f, "chemistry_kernel", 1)[0][0]))
            print(f"    in turns (wrapper call ms, CUDA events; kernel device "
                  f"ms, torch.profiler): " + ", ".join(
                      f"{k} {a:.4f} / {b:.4f}" for k, a, b in res))
            if parent:
                pout = chem_pass_with(plain["parent"], split["parent"][1],
                                      chem, state, rates, dt)
                print(f"    outputs and counters equal to the parent's: "
                      f"{torch.equal(pout[0], ref[0])} / "
                      f"{torch.equal(pout[1], ref[1])}")


# Variants of the chemistry kernel that --chem --variants times against
# this build in turns: [(file in csrc/, pattern, replacement), ...], each
# pattern found once; "a+b" applies both.
_SMEM_BYTES = "kHeat ? sizeof(T) * kTempPoints * 5 : 0"
# the kernel's hand-out test, and one with the busy lanes' vote
_HAND_OUT = (r"const unsigned want = __ballot_sync\(kAll, need\);\n"
             r"    if \(want\) \{")


def _hand_out(cond, tail=None):
    return ("const unsigned want = __ballot_sync(kAll, need);\n"
            "    const unsigned busy = __ballot_sync(kAll, !need && i < n);\n"
            + (f"    const bool tail = __any_sync(kAll, {tail});\n" if tail
               else "")
            + f"    if (want && ({cond})) {{")


CHEM_VARIANTS = {
    # div_flat (the bits of IEEE `/`, float64 arithmetic, no branch) for
    # the divisions of the 3D pass
    "flat": [("chemistry.cuh",
              r"(struct PerCell \{[^}]*?)return a / b;",
              r"\1return div_flat(a, b);")],
    # the cooling table staged in shared memory by each block instead of
    # read through __ldg (16 KB in float32, under the 48 KB default)
    "smem": [("chemistry.cuh",
              r"(struct PerCell \{\s*static constexpr bool kSpread = false, "
              r"kSharedTable = )false", r"\1true"),
             ("chemistry.cu", r"(  __shared__ Rates<T> fixed;\n)",
              r"\1  extern __shared__ __align__(16) unsigned char smem[];\n"
              r"  if constexpr (kHeat) {\n"
              r"    T* cool_s = reinterpret_cast<T*>(smem);\n"
              r"    for (int k = threadIdx.x; k < kTempPoints * 5; "
              r"k += blockDim.x)\n"
              r"      cool_s[k] = cool[k];\n"
              r"    cool = cool_s;\n"
              r"  }\n"),
             ("chemistry.cu", r"kernel, kBlock, 0\)",
              f"kernel, kBlock, {_SMEM_BYTES})"),
             ("chemistry.cu", r"kBlock, 0, stream>>>",
              f"kBlock, {_SMEM_BYTES}, stream>>>")],
    # kMinBlocks resident blocks of kBlock threads an SM (the register
    # cap 65536 / (kBlock kMinBlocks))
    "min2": [("chemistry.cu", r"constexpr int kMinBlocks = \d+;",
              "constexpr int kMinBlocks = 2;")],
    "min3": [("chemistry.cu", r"constexpr int kMinBlocks = \d+;",
              "constexpr int kMinBlocks = 3;")],
    "min5": [("chemistry.cu", r"constexpr int kMinBlocks = \d+;",
              "constexpr int kMinBlocks = 5;")],
    # other hand-outs: a warp takes cells for its free lanes at once only
    # while one of its cells has run k iterations (a front's tail), else
    # once all its lanes are free ("tail<k>"); only once all are free, its
    # 32 neighbours together ("whole"); once 8 (16) lanes are free or all
    # are ("batch8", "batch16")
    **{f"tail{k}": [("chemistry.cu", _HAND_OUT, _hand_out(
        "!busy || tail", f"!need && i < n && c.nit >= {k}"))]
       for k in (2, 3, 4, 6, 8)},
    "whole": [("chemistry.cu", _HAND_OUT, _hand_out("!busy"))],
    **{f"batch{k}": [("chemistry.cu", _HAND_OUT, _hand_out(
        f"__popc(want) >= {k} || !busy"))] for k in (8, 16)},
    # a lane runs its cell's iterations to the end before it returns to
    # the hand-out (the warp waits for its slowest lane there, so this
    # takes cells only for a whole free warp, as "whole")
    "inner": [("chemistry.cu",
               r"(bool finished = c\.nit >= max_iter;\n    )if \(!finished\) \{",
               r"\1while (!finished) {")],
    # as many blocks as cells / kBlock (every lane's first cell from the
    # launch, no block resident for the whole pass), twice the resident
    # blocks
    "gridfull": [("chemistry.cu",
                  r"\(long long\)std::max\(per_sm, 1\) \* sms",
                  "(n + kBlock - 1) / kBlock")],
    "grid2x": [("chemistry.cu", r"\(long long\)std::max\(per_sm, 1\) \* sms",
                "2LL * std::max(per_sm, 1) * sms")],
    # k resident blocks an SM (of the 4 that fit), 8k warps
    **{f"grid{k}": [("chemistry.cu",
                     r"\(long long\)std::max\(per_sm, 1\) \* sms",
                     f"{k}LL * sms")] for k in (1, 2, 3)},
    # blocks of 128 threads
    "block128": [("chemistry.cu", r"constexpr int kBlock = \d+;",
                  "constexpr int kBlock = 128;")],
}


def apply_chem_variant(name, read, write):
    """Apply the edits of CHEM_VARIANTS for each part of `name` ("a+b":
    both) through read(file) -> text and write(file, text); raises if a
    pattern is not found exactly once."""
    for part in name.split("+"):
        for fname, pattern, repl in CHEM_VARIANTS[part]:
            text, k = re.subn(pattern, repl, read(fname))
            if k != 1:
                raise RuntimeError(f"variant {part}: {k} places in {fname}")
            write(fname, text)


def build_chem_variant(name):
    """csrc/chemistry.cu built from a copy of csrc/ under
    build/chem_<name>/ with the edits of apply_chem_variant: (nvcc
    process, directory)."""
    import shutil

    from c2ray_tpu_torch import cuda_build

    d = cuda_build.BUILD_DIR.parent / f"chem_{name.replace('+', '_')}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    apply_chem_variant(name, lambda f: (d / f).read_text(),
                       lambda f, t: (d / f).write_text(t))
    return build_oned(d, d / "libchemistry.so", source="chemistry"), d


def time_chem_variants(names, M, S, parent=None):
    """The chemistry kernel of each variant (and of the parent build,
    with `parent`) against this build, in turns (this, v1, ..., vk, vk,
    ..., v1, this), at phase 4's first timed iteration, the pass after
    them and evolve3d's first iteration, and at every input of phase 5
    (chem_inputs): kernel device ms, and whether each one's outputs and
    counters equal this build's and the parent's."""
    import ctypes

    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build

    dev = torch.device("cuda", 0)
    print(f"{cs.smi_line()}; chemistry variants at {M}^3 float32")
    this = cuda_build.load("chemistry")
    jobs = {n: build_chem_variant(n) for n in names if n != "contig"}
    libs = {"this": (this, "this")}
    if parent:
        psrc = Path(parent).resolve() / "c2ray_tpu_torch" / "csrc"
        d = cuda_build.BUILD_DIR.parent / "chem_parent"
        jobs["parent"] = (build_oned(psrc, d / "libchemistry.so",
                                     source="chemistry"), d)
    for n, (proc, d) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{out}")
        use = ptxas_usage(out, "chemistry_kernel")
        print(f"  {n}: registers, spill store / load bytes (f32 isothermal, "
              f"heating) " + ", ".join(
                  f"{r} ({s} / {l})" for k, (r, s, l) in sorted(use.items())
                  if "kernelIf" in k))
        text = (d / "chemistry.cu").read_text() if n != "parent" else (
            Path(parent).resolve() / "c2ray_tpu_torch" / "csrc"
            / "chemistry.cu").read_text()
        libs[n] = (ctypes.CDLL(str(d / "libchemistry.so")), chem_layout(text))
    # "contig": this build on contiguous copies of the rate rows (the
    # sweep hands them over as strided views of its (n, 4) slab)
    rows = {"contig": lambda r: r._replace(**{
        k: getattr(r, k).contiguous()
        for k in ("phih", "phihe0", "phihe1", "phiheat")})}
    if "contig" in names:
        libs["contig"] = libs["this"]
    order = ["this"] + list(names) + (["parent"] if parent else [])
    order = order + order[::-1]
    for heating in (False, True):
        chem, dt, cases = chem_inputs(M, S, heating, dev)
        picks = cases if heating else [cases[0], cases[4], cases[5]]
        for label, state, rates in picks:
            given = {k: rows.get(k, lambda r: r)(rates) for k in libs}
            outs = {k: chem_pass_with(*libs[k], chem, state, given[k], dt)
                    for k in libs}
            eq = lambda a, b: (torch.equal(outs[a][0], outs[b][0])
                               and torch.equal(outs[a][1], outs[b][1]))
            res = {}
            for key in order:
                f = lambda: chem_pass_with(*libs[key], chem, state,
                                           given[key], dt)
                res.setdefault(key, []).append(
                    cs.launch_profile(f, "chemistry_kernel", 1)[0][0])
            print(f"  {'heating' if heating else 'isothermal'}, {label}: "
                  f"kernel device ms (torch.profiler, two turns) " + ", ".join(
                      f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
                      for k, v in res.items()))
            print("    outputs and counters equal to this build's: " + ", ".join(
                f"{k} {eq(k, 'this')}" for k in libs if k != "this")
                + ("; to the parent's: " + ", ".join(
                    f"{k} {eq(k, 'parent')}" for k in libs if k != "parent")
                   if parent else ""))


def profile_ploss(M, S, parent):
    """--ploss: the photon-loss kernel at phase 8's state."""
    import dataclasses

    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import make_evolve3d_iteration
    from c2ray_tpu_torch.sweep import photon_losses as pls
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    dev = torch.device("cuda", 0)
    cfg, _ = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, dev)
    cfg = dataclasses.replace(
        cfg, add_photon_losses=True,
        sweep=dataclasses.replace(cfg.sweep, track_band_loss=True))
    srcpos, nflux = bench_sources(M, S, dev)
    s = initial_grid_state(np.full((M,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                           1.0e4, dtype=torch.float32, device=dev)
    iteration = make_evolve3d_iteration(cfg)
    for _ in range(5):
        s = iteration(s, srcpos, nflux, 1.0e14)[0]
    f = cs.fields_of(s)
    rates = ps.sweep_pyramid_source_batch(cfg.sweep, f, srcpos, nflux)
    vos = cfg.sweep.vol / cfg.sweep.flux_scale
    tables = cfg.sweep.tables
    nb = tables.sigma_HI.shape[0]
    call = lambda: pls.distribute_photon_losses_cuda(tables, rates, f, vos)
    print(f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; photon losses at {M}^3 x {nb} bands "
          f"float32, phase 8's state")
    call()
    sass = kernel_sass(cuda_build.library_path("photon_losses"))
    for name, listing in sorted(sass.items()):
        if "photon_losses_kernelIf" in name:
            mix, per_pass = sass_per_band(listing)
            print(f"  {name}: per band (of {per_pass} a pass) " + ", ".join(
                f"{k} {v:.2f}" for k, v in mix.items() if v))
    for name, r in sorted(ptxas_registers(
            cuda_build.build_log("photon_losses"),
            "photon_losses_kernel").items()):
        print(f"  {name}: {r} registers")
    ms = cs.event_ms(call, 20)
    kms = cs.launch_profile(call, "photon_losses_kernel", 1)[0][0]
    b = cs.photon_losses_bound(M**3, nb)
    print(f"  wrapper call {ms:.4f} ms (CUDA events, mean of 20), kernel "
          f"{kms:.4f} ms device (torch.profiler); bound {b[0]:.4f} ms "
          f"({b[1]})")
    print("  device ms by kernel of one call: " + ", ".join(
        f"{k} {t:.4f}" for k, t in sorted(device_rows(call).items(),
                                          key=lambda kv: -kv[1])))
    if parent:
        import ctypes

        psrc = Path(parent).resolve() / "c2ray_tpu_torch" / "csrc"
        d = cuda_build.BUILD_DIR.parent / "ploss_parent"
        proc = build_oned(psrc, d / "libphoton_losses.so",
                          source="photon_losses")
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's "
                               f"photon_losses.cu:\n{out}")
        plib = ctypes.CDLL(str(d / "libphoton_losses.so"))
        pcall = lambda: parent_photon_losses(plib, tables, rates, f, vos)
        res = []
        for key in ("parent", "this", "this", "parent"):
            fn = pcall if key == "parent" else call
            res.append((key, cs.event_ms(fn, 20),
                        cs.launch_profile(fn, "photon_losses_kernel",
                                          1)[0][0]))
        print("  in turns (wrapper call ms, kernel device ms): " + ", ".join(
            f"{k} {a:.4f} / {b:.4f}" for k, a, b in res))


def oned_runs(steps, auto=False):
    """(name, heating, table, mono, dtype, steps) of the profiled 1D
    runs: phase 12's three variants, or with `auto` the "auto" blocks
    isothermal and heating (chip_smoke.ONED_AUTO)."""
    import chip_smoke as cs

    variants = ([(name, iso, True, "auto") for name, iso in cs.ONED_AUTO]
                if auto else
                [(name, iso, quad, False) for name, iso, quad in cs.ONED_MAIN])
    return [(name, not iso, not quad, mono, dtype, n)
            for name, iso, quad, mono in variants
            for dtype, n in ((torch.float32, steps), (torch.float64, 1))]


def profile_oned(steps, parent, auto=False):
    """--oned: the 1D kernel's split per part (with `auto`, per block of
    the "auto" tables too) and, with a parent build, the two builds in
    turns."""
    import ctypes
    import shutil

    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.onedim import evolve as ev1

    dev = torch.device("cuda", 0)
    base = cuda_build.BUILD_DIR.parent
    stamped = base / "oned_split"
    shutil.rmtree(stamped, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, stamped)
    (stamped / "evolve1d.cu").write_text(
        stamp_evolve1d((cuda_build.CSRC / "evolve1d.cu").read_text()))
    text, design = stamp_band_rates(
        (cuda_build.CSRC / "band_rates.cuh").read_text())
    (stamped / "band_rates.cuh").write_text(text)
    jobs = {"split": build_oned(stamped, stamped / "libevolve1d.so")}
    shared = ("chemistry", "pyramid_sweep", "shell_sweep", "octant_sweep")
    if parent:
        psrc = Path(parent).resolve() / "c2ray_tpu_torch" / "csrc"
        jobs["parent"] = build_oned(psrc,
                                    base / "oned_parent" / "libevolve1d.so")
        sass_jobs = {(key, n): build_oned(
            src, base / f"oned_{key}" / f"lib{n}.so", source=n)
            for key, src in (("this", cuda_build.CSRC), ("parent", psrc))
            for n in shared}
    libs = {"this": cuda_build.load("evolve1d")}
    logs = {"this": cuda_build.build_log("evolve1d")}
    for key, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {key} build:\n{out}")
        libs[key] = ctypes.CDLL(str(base / f"oned_{key}" / "libevolve1d.so"))
        logs[key] = out
    print(f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; 1D test 1, mesh {cs.ONED_FULL_MESH}")
    for key in ("this", "parent"):
        if key in logs:
            print(f"ptxas, {key} build (registers, spill stores, spill "
                  f"loads in bytes): " + ", ".join(
                      f"{k[k.index('evolve1d_kernel') + 15:]}: {v}"
                      for k, v in sorted(ptxas_usage(
                          logs[key], "evolve1d_kernel").items())))

    def step_with(key, run, dt):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        if key == "parent":
            out = parent_evolve1d(libs[key], run.ctx, run.state, dt)
        else:
            out = with_library("evolve1d", libs[key],
                               lambda: ev1.evolve1d_cuda(run.ctx, run.state,
                                                         dt))
        run.state, nits, run.last_counters = out
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), run.last_counters.tolist()

    def runs_of(key, name, heat, table, mono, dtype, n, split=None,
                blk=None):
        """ms, iterations, thermal sub-steps summed over n steps from
        the initial state with build `key`; with `split` the cycles per
        part added in, with `blk` those per block."""
        lib = libs[key]
        run = cs.oned_run(1, cs.ONED_FULL_MESH, dtype, dev, not heat,
                          not table, mono)
        # pack the tables before the first timed launch
        ev1._kernel_tables(run.ctx, dtype, dev)
        if key == "parent" and mono == "auto":
            parent_oned_tables(run.ctx, dtype, dev)
        ms = its = subs = 0
        for _ in range(n):
            t, c = step_with(key, run, 10.0 * cs.MYR)
            ms, its, subs = ms + t, its + c[0], subs + c[3]
            for out, entry in ((split, "evolve1d_split"),
                               (blk, "evolve1d_block_split")):
                if out is not None:
                    part = (ctypes.c_ulonglong * len(out))()
                    cuda_build.check(getattr(lib, entry)(part), entry)
                    for q in range(len(out)):
                        out[q] += part[q]
        return ms, its, subs

    print("cycles per fixed-point iteration by part (clock64 stamps, "
          "lane 0; the effective clock is the stamped launches' cycles "
          "over their CUDA-event time)")
    for name, heat, table, mono, dtype, n in oned_runs(steps, auto):
        split = [0] * len(SPLIT_PARTS)
        blk = [0] * (2 * SPLIT_BLOCKS)
        ms, its, subs = runs_of("split", name, heat, table, mono, dtype, n,
                                split, blk)
        ghz = sum(split) / (ms * 1e6)
        parts = ", ".join(f"{p} {c / its:.0f}" for p, c in
                          zip(SPLIT_PARTS, split))
        print(f"  {name} {str(dtype)[6:]} x {n}: {its} iterations, "
              f"{subs / its:.3f} thermal sub-steps per iteration; "
              f"{sum(split) / its:.0f} cycles ({1e3 * ms / its:.3f} us) per "
              f"iteration at {ghz:.3f} GHz: {parts}")
        if mono == "auto":
            small = cs.oned_run(1, 8, dtype, dev, not heat, True, "auto")
            blocks, (nodes, rows, slots) = oned_block_rows(small.ctx)
            passes = ([f"block {b}" for b in blocks] if design == "blocks"
                      else [f"slot {i}" for i in range(slots)])
            shells = n * cs.ONED_FULL_MESH
            print(f"    blocks (K, bands, live lanes) {blocks}; the row "
                  f"deal: {nodes} nodes in {rows} rows of "
                  f"{ev1.ROW_NODES}, {slots} slots; per pass of the "
                  f"{design!r} design: outgoing cycles per iteration, "
                  f"incoming cycles per shell: " + "; ".join(
                      f"{p}: {blk[i] / its:.0f}, "
                      f"{blk[SPLIT_BLOCKS + i] / shells:.0f}"
                      for i, p in enumerate(passes)))

    floors = {key: cs.oned_issue_floors(
        None if key == "this" else base / f"oned_{key}" / "libevolve1d.so")
        for key in libs if key in ("this", "parent")}
    print(f"issue floors, SASS instructions per iteration (heat, table, "
          f"K): {floors}")
    if parent:
        for (key, n), proc in sass_jobs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the {key} {n}.cu:\n{out}")
        for n in shared:
            mine = comparable_sass(base / "oned_this" / f"lib{n}.so")
            theirs = comparable_sass(base / "oned_parent" / f"lib{n}.so")
            same = sum(mine.get(k) == v for k, v in theirs.items())
            print(f"{n}.cu: {same} of {len(theirs)} kernel functions' SASS "
                  f"equal to the parent's ({len(mine)} in this build)")
    order = ["parent", "this", "this", "parent"] if parent else ["this"]
    print("builds in turns: " + ", ".join(order))
    for name, heat, table, mono, dtype, n in oned_runs(steps, auto):
        for key in order:
            ms, its, subs = runs_of(key, name, heat, table, mono, dtype,
                                    n)
            print(f"  {name} {str(dtype)[6:]} x {n} {key}: {ms:.3f} ms, "
                  f"{its} iterations, {1e3 * ms / its:.4f} us per "
                  f"iteration, {subs / its:.3f} sub-steps per iteration")


# --oned --auto --variants: copies of csrc/ with one change each to the
# "auto" route's row deal (edits as ROUTE_VARIANTS', or a function of a
# file's text), and the onedim module's constants that the change needs
# (the packing's row size)
ONED_ROW_VARIANTS = {
    # two slots a turn in one body, for their rows' chains to interleave
    "pairs": ([("band_rates.cuh",
                r"#pragma unroll 1\n  for \(int s = 0; s < slots; \+\+s\) \{\n"
                r"    row_out<T, kHeat>\(tab \+ s \* R \+ lane, in \+ s \* I "
                r"\+ lane, cin, cout,\n\s+inv_vol, y, acc, hacc, hcomp\);\n  \}",
                "int s = 0;\n  for (; s + 1 < slots; s += 2) {\n"
                "    row_out<T, kHeat>(tab + s * R + lane, in + s * I + lane, "
                "cin, cout,\n                      inv_vol, y, acc, hacc, "
                "hcomp);\n    row_out<T, kHeat>(tab + (s + 1) * R + lane, "
                "in + (s + 1) * I + lane, cin,\n                      cout, "
                "inv_vol, y, acc, hacc, hcomp);\n  }\n  if (s < slots) {\n"
                "    row_out<T, kHeat>(tab + s * R + lane, in + s * I + lane, "
                "cin, cout,\n                      inv_vol, y, acc, hacc, "
                "hcomp);\n  }")], {}),
    # the rate side fenced by __syncwarp() before and after
    "sync": ([("evolve1d.cu",
               r"(\n        rows_out<T, kHeat>\(tab, a\.slots, cd, cout, "
               r"inv_vol, y, in, r,\n\s+lane\);)",
               r"\n        __syncwarp();\1\n        __syncwarp();")], {}),
    # the split's build (every stamp of stamp_evolve1d and
    # stamp_band_rates), and the stamps of the parts only
    "stamped": ([("evolve1d.cu", stamp_evolve1d),
                 ("band_rates.cuh", lambda t: stamp_band_rates(t)[0])], {}),
    "partstamps": ([("evolve1d.cu", stamp_evolve1d),
                    ("band_rates.cuh", lambda t: _stamp(
                        t, _BLOCK_SPLIT_AT["rows"][:1], "band_rates.cuh"))],
                   {}),
    # the rate side a call of its own (scheduled apart from the march),
    # its slot loop unrolled by 2, or the "auto" instantiations without
    # their launch bounds' one resident block
    "noinline": ([("band_rates.cuh",
                   r"__device__ __forceinline__ void rows_out\(",
                   "__device__ __noinline__ void rows_out(")], {}),
    "unroll2": ([("band_rates.cuh",
                  r"#pragma unroll 1(\n  for \(int s = 0; s < slots; \+\+s\) "
                  r"\{\n    row_out<)", r"#pragma unroll 2\1")], {}),
    "lb0": ([("evolve1d.cu",
              r"__launch_bounds__\(kLanes, kK == kBlockRoute \? 1 : 0\)",
              "__launch_bounds__(kLanes)")], {}),
    # rows of 4 or 6 nodes (fewer rows, more exponentials a lane)
    "rows4": ([("band_rates.cuh", r"constexpr int kRowNodes = \d+;",
                "constexpr int kRowNodes = 4;")], {"ROW_NODES": 4}),
    "rows6": ([("band_rates.cuh", r"constexpr int kRowNodes = \d+;",
                "constexpr int kRowNodes = 6;")], {"ROW_NODES": 6}),
}


def time_oned_variants(names, steps):
    """--oned --auto --variants: each variant of ONED_ROW_VARIANTS built
    from a copy of csrc/ under build/oned_<name>/ and run in turns with
    this build (this, variant, variant, this) on test 1's "auto" steps,
    isothermal and heating, float32: ms, iterations and us per
    iteration; the variants' registers and spills (ptxas)."""
    import contextlib
    import ctypes
    import shutil

    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.onedim import evolve as ev1

    dev = torch.device("cuda", 0)
    base = cuda_build.BUILD_DIR.parent
    procs = {}
    for name in names:
        d = base / f"oned_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        for fname, *edit in ONED_ROW_VARIANTS[name][0]:
            text, k = (edit[0]((d / fname).read_text()), 1) if callable(
                edit[0]) else re.subn(*edit, (d / fname).read_text())
            if k != 1:
                raise RuntimeError(f"variant {name}: {k} places for "
                                   f"{edit[0]!r} in {fname}")
            (d / fname).write_text(text)
        procs[name] = build_oned(d, d / "libevolve1d.so")
    libs = {"this": cuda_build.load("evolve1d")}
    print(f"{cs.smi_line()}; 1D test 1, mesh {cs.ONED_FULL_MESH}, "
          f"\"auto\" tables, float32, {steps} x 10 Myr")
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(base / f"oned_{name}" /
                                     "libevolve1d.so"))
        use = {k[k.index("evolve1d_kernel") + 15:][:18]: v
               for k, v in ptxas_usage(out, "evolve1d_kernel").items()
               if "Lin2E" in k}
        print(f"  {name}: ptxas (registers, spill stores, spill loads) of "
              f"the \"auto\" instantiations {use}")

    @contextlib.contextmanager
    def constants(name):
        saved = {k: getattr(ev1, k) for k in
                 ONED_ROW_VARIANTS.get(name, ((), {}))[1]}
        for k, v in ONED_ROW_VARIANTS.get(name, ((), {}))[1].items():
            setattr(ev1, k, v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(ev1, k, v)

    def steps_of(key, iso):
        run = cs.oned_run(1, cs.ONED_FULL_MESH, torch.float32, dev, iso,
                          True, "auto")
        with constants(key):
            ev1._kernel_tables(run.ctx, torch.float32, dev)
            ms = its = 0
            for _ in range(steps):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                run.state, _, c = with_library(
                    "evolve1d", libs[key],
                    lambda: ev1.evolve1d_cuda(run.ctx, run.state,
                                              10.0 * cs.MYR))
                end.record()
                torch.cuda.synchronize()
                ms += start.elapsed_time(end)
                its += int(c[0])
        return ms, its

    for name in names:
        for label, iso in (("isothermal", True), ("heating", False)):
            res = []
            for key in ("this", name, name, "this"):
                ms, its = steps_of(key, iso)
                res.append(f"{key} {ms:.3f} ms / {its} iterations = "
                           f"{1e3 * ms / its:.4f} us")
            print(f"  {name}, {label}: " + "; ".join(res))


# --route's knock-out copies of the rate routes: per variant, edits of
# this design and of the design before it (commit 91213d1: the tau
# tables read as word gathers, the blocks one cell_rates each), the first
# whose patterns are all found once applied; each edit is [(file in
# csrc/, pattern, replacement), ...]; "a+b" applies both.  An edit puts
# an early return at the top of a device function (the rest of its body
# is then dead code in the copy) or skips a switch.
_NOREAD = (r"\1\n  if (true) return {T((reinterpret_cast<size_t>(p) >> 4) & 7), "
           r"T(0.5), T(1), T(0.25)};")
ROUTE_VARIANTS = {
    # a table read made of its address and position (no load; the
    # positions still computed and used)
    "noread": (
        [("table_rates.cuh",
          r"(TauRec<float> load_rec\(const float\* p\) \{)",
          _NOREAD.replace("T(", "float(")),
         ("table_rates.cuh",
          r"(TauRec<double> load_rec\(const double\* p\) \{)",
          _NOREAD.replace("T(", "double("))],
        [("table_rates.cuh",
          r"(T table_read\(const T\* tab, int ncols, int col,\s*"
          r"const Pos<T>& p\) \{)",
          r"\1\n  if (true) return T(col) + p.r;")]),
    # a position is row 800 or 1200 (by tau > 1, so tau_in and tau_out
    # may differ): no log10, the reads still made, at two rows
    "nopos": (
        [("table_rates.cuh",
          r"(Pos<T> table_position\(T tau\) \{)",
          r"\1\n  if (true) {\n    Pos<T> q;\n"
          r"    q.i = tau > T(1) ? 1200 : 800;\n    q.i1 = q.i + 1;\n"
          r"    q.r = T(0.5);\n    return q;\n  }")],),
    # every row (block) of the "auto" route through the runtime-K
    # instantiation instead of the unrolled Ks
    "onek": (
        [("band_rates.cuh", r"(\n    switch \(K\) \{\n      case 3:\n"
          r"        group\()",
          r"\n    group(std::integral_constant<int, 0>{});\n    if (false)\1")],
        [("band_rates.cuh", r"(\n    switch \(d\.K\) \{)",
          r"\n    cell_rates<T, kHeat, false, 0>(rows, d, nfl3, cin, "
          r"cout, vol, y, o,\n                                   "
          r"nullptr, lane, nlanes);\n    if (false)\1")]),
    # the tau route's heating kernels without the cap on resident blocks
    # (table_rates.cuh: route_capped)
    "uncapped": ([("table_rates.cuh",
                   r"return kHeat && kK == kTableRoute;", "return false;")],),
    # the lanes per cell of the pyramid and shell kernels
    # (band_rates.cuh: kCellLanes), timed here on a route
    "lanes1": ([("band_rates.cuh", r"constexpr int kCellLanes = \d+;",
                 "constexpr int kCellLanes = 1;")],),
    "lanes4": ([("band_rates.cuh", r"constexpr int kCellLanes = \d+;",
                 "constexpr int kCellLanes = 4;")],),
}
# the variants --route times on each route (--variants: others)
ROUTE_SPLIT = {"tau": ("noread", "nopos", "noread+nopos"),
               "auto": ("onek",)}
# the kK of each route in the stage kernel's mangled name
ROUTE_MANGLED = {"tau": "Lin1E", "auto": "Lin2E"}


def apply_route_variant(name, read, write):
    """Apply ROUTE_VARIANTS' edits for each part of `name` ("a+b": both)
    through read(file) -> text and write(file, text): of each part the
    first set of edits whose patterns are each found exactly once;
    raises if no set fits."""
    for part in name.split("+"):
        for edits in ROUTE_VARIANTS[part]:
            texts, ok = {}, True
            for fname, pattern, repl in edits:
                text, k = re.subn(pattern, repl,
                                  texts.get(fname) or read(fname))
                ok = ok and k == 1
                texts[fname] = text
            if ok:
                for fname, text in texts.items():
                    write(fname, text)
                break
        else:
            raise RuntimeError(f"variant {part}: no set of edits fits csrc/")


def build_route_variant(name):
    """csrc/pyramid_sweep.cu built from a copy of csrc/ under
    build/route_<name>/ with the edits of ROUTE_VARIANTS: (nvcc process,
    directory)."""
    import shutil

    from c2ray_tpu_torch import cuda_build

    d = cuda_build.BUILD_DIR.parent / f"route_{name.replace('+', '_')}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    apply_route_variant(name, lambda f: (d / f).read_text(),
                        lambda f, t: (d / f).write_text(t))
    return build_oned(d, d / "libpyramid_sweep.so",
                      source="pyramid_sweep"), d


def lane_node_terms(blocks, lanes):
    """The node terms (K per band) each of a cell's `lanes` lanes sums on
    the "auto" route, blocks as packed_band_blocks gives them: lane j
    takes the bands j, j + lanes, ... of every block."""
    terms = [0] * lanes
    for _, _, nb, K, _ in blocks:
        for b in range(nb):
            terms[b % lanes] += K
    return terms


def group_node_terms(groups, lanes):
    """The node terms each of a cell's `lanes` lanes sums on the node
    groups (packed_node_groups) as band_rates.cuh:block_rates deals
    them: the rows in turn, continuing from group to group."""
    terms, first = [0] * lanes, 0
    for _, _, n, K, _ in groups:
        for e in range(n):
            terms[(first + e) % lanes] += K
        first = (first + n) % lanes
    return terms


def profile_route(route, M, S, variants=None, reps=5):
    """--route: the pyramid sweep kernel on `route` split by knock-out
    copies (ROUTE_SPLIT, or the ROUTE_VARIANTS named in `variants`),
    timed in turns with this build at phase 4's and 5's states."""
    import ctypes

    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.radiation import quadrature
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    dev = torch.device("cuda", 0)
    lanes = int(re.search(r"constexpr int kCellLanes = (\d+);",
                          (cuda_build.CSRC / "band_rates.cuh").read_text())
                .group(1))
    names = tuple(variants) if variants else ROUTE_SPLIT[route]
    procs = {v: build_route_variant(v) for v in names}
    this = cuda_build.load("pyramid_sweep")
    libs = {"this": this}
    for v, (proc, d) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for route variant {v}:\n{out}")
        libs[v] = ctypes.CDLL(str(d / "libpyramid_sweep.so"))
        use = ptxas_usage(out, "stage_kernel")
        for inst, (regs, st, ld) in sorted(use.items()):
            if ROUTE_MANGLED[route] in inst and "If" in inst:
                print(f"  variant {v}: {inst[:70]} {regs} registers, "
                      f"spills {st} / {ld} B", flush=True)
    print(f"{cs.smi_line()}; the {route} route's pyramid sweep, {M}^3 x {S} "
          f"float32")
    use = ptxas_usage(cuda_build.build_log("pyramid_sweep"), "stage_kernel")
    for inst, (regs, st, ld) in sorted(use.items()):
        if ROUTE_MANGLED[route] in inst or "Li6E" in inst:
            print(f"  {inst[:80]}: {regs} registers, spills {st} / {ld} B, "
                  f"theoretical occupancy "
                  f"{theoretical_occupancy(regs, 256):.3f}")
    Rf, Rb = ps.trace_extents(M)
    turns = ("this",) + names + names[::-1] + ("this",)
    for heating in (False, True):
        cfg, state, srcpos, nflux = bench_state(M, S, heating, dev,
                                                "pyramid", tables=route)
        fstack = ps.stack_sweep_fields(cfg.sweep, cs.fields_of(state))
        quad = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, dev,
                        heating)[0].sweep
        ms = {}
        for key in turns:
            cuda_build._LIBS["pyramid_sweep"] = libs[key]
            ms.setdefault(key, []).append(cs.event_ms(
                lambda: ps.trace_cuda(cfg.sweep, fstack, srcpos, nflux, Rf,
                                      Rb), reps))
        cuda_build._LIBS["pyramid_sweep"] = this
        fixed = cs.event_ms(lambda: ps.trace_cuda(quad, fstack, srcpos,
                                                  nflux, Rf, Rb), reps)
        label = "heating" if heating else "isothermal"
        base = sum(ms["this"]) / len(ms["this"])
        print(f"  {label}: this build " + " / ".join(
            f"{t:.3f}" for t in ms["this"]) + f" ms; the fixed 6-node rule "
            f"{fixed:.3f} ms", flush=True)
        for v in names:
            t = sum(ms[v]) / len(ms[v])
            print(f"    {v}: " + " / ".join(f"{x:.3f}" for x in ms[v])
                  + f" ms, {base - t:+.3f} ms against this build "
                  f"({(base - t) / base:.1%})", flush=True)
        if route == "auto":
            blocks = quadrature.packed_band_blocks(
                cfg.sweep.tables, torch.float32, heating)[1]
            line = (f"    blocks (band count, K): "
                    f"{[(b[2], b[3]) for b in blocks]}, node terms per lane "
                    f"dealt a block at a time "
                    f"{lane_node_terms(blocks, lanes)}")
            # a tree before the node groups (a parent's split) has none
            if hasattr(quadrature, "packed_node_groups"):
                groups = quadrature.packed_node_groups(
                    cfg.sweep.tables, torch.float32, heating)[1]
                line += (f"; node groups (rows, K) "
                         f"{[(g[2], g[3]) for g in groups]}, dealt in turn "
                         f"{group_node_terms(groups, lanes)}")
            print(line)


if __name__ == "__main__":
    main()
