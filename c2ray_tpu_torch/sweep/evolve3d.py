"""The 3D multi-source timestep: iterate {sweep all sources, apply rates}
until the grid converges.

Port of ``c2ray_tpu/sweep/evolve3d.py`` (``evolve3D``,
evolve.F90:78-229) with its three sweep engines: pyramid (the default),
skewed octant and L1 shells.  The convergence loop runs in Python: its
trip count is physical, data dependent and small.  The subbox radius is
a runtime integer of the sweep, so nothing is built per radius (JAX's
`iteration_cache` of compiled programs has no counterpart: `evolve3d`
accepts it and ignores it).
"""

import time as _time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..radiation.quadrature import QuadTables, source_blocks
from ..state import GridState, begin_timestep, finish_timestep
from ..utils.clocks import count, span
from .geometry import ShellTable, build_shell_table
from .global_pass import ChemistryConfig, global_chemistry_pass
from .octant_sweep import sweep_octant_source_batch
from .photon_losses import distribute_photon_losses
from .pyramid_sweep import sweep_pyramid_source_batch
from .source_sweep import (RateGrids, SourceFields, SweepConfig,
                           sweep_sources_accumulate)

# c2ray_parameters.f90:26 and evolve.F90:147,177
CONVERGENCE_FRACTION = 2.5e-4
MAX_GLOBAL_ITER = 500

# evolve_source.F90:133-144: keep growing the subbox while more than
# this fraction of the sources' photons escapes it
MIN_FRACTION_OF_PHOTONS = 1.0e-10


@dataclass(frozen=True)
class Evolve3DConfig:
    sweep: SweepConfig
    chem: ChemistryConfig
    # trace extents of the shell engine (sweep/geometry.py); None = the
    # full periodic table, build_shell_table(mesh)
    shells: Optional[ShellTable] = None
    convergence_fraction: float = CONVERGENCE_FRACTION
    max_iterations: int = MAX_GLOBAL_ITER
    # "pyramid": dominant-axis pyramid engine (each cell evaluated
    # once; even mesh); "octant": dense skewed-octant engine (plane
    # ring, no column cube; even mesh); "shells": sparse L1-shell
    # engine (general extents).  Extents other than the full periodic
    # ones (+M/2 / -(M/2-1): an odd mesh, a max_subbox table) always
    # take the shell engine.
    engine: str = "pyramid"
    # expanding-subbox trace (evolve_source.F90:114-144; pyramid engine
    # at full extents only): start at subbox_start cells, double while
    # the escaping photon fraction exceeds min_fraction_of_photons,
    # capped at M/2
    use_subbox: bool = True
    subbox_start: int = 8
    min_fraction_of_photons: float = MIN_FRACTION_OF_PHOTONS
    # recycle escaped photons into the grid (sweep/photon_losses.py);
    # needs sweep.track_band_loss.  The reported photon_loss stays the
    # raw escape (it drives the expanding subbox and the photon budget)
    add_photon_losses: bool = False


class Evolve3DStats(NamedTuple):
    n_iterations: int
    conv_flag: int
    photon_loss: float
    subbox_radius: int = 0
    # photons/s absorbed in LLSs during the last iteration
    # (photonstatistics.f90:59)
    lls_loss: float = 0.0


def _scaled_source_strength(sweep_cfg: SweepConfig, nflux) -> float:
    """Total photon rate of the batch in the sweep's scaled flux units:
    with quadrature tables the sum over source types of NormFlux * the
    type's rate (its coefficients summed over the blocks of "auto"
    tables) / flux_scale; with tau tables, as in JAX, the summed NormFlux
    (c2ray_tpu/sweep/evolve3d.py:77-95)."""
    t = sweep_cfg.tables
    if not isinstance(t, QuadTables):
        return float(torch.sum(torch.as_tensor(nflux)))
    total = 0.0
    for sq, j in ((t.bb, 0), (t.pl, 1), (t.qso, 2)):
        if sq is None:
            continue
        a_sum = sum(float(torch.sum(b.A_photo)) for b in source_blocks(sq))
        total += a_sum * float(torch.sum(nflux[:, j]))
    return total


def _subbox_radii(cfg: Evolve3DConfig):
    R = cfg.sweep.mesh // 2
    radii = []
    r = cfg.subbox_start
    while r < R:
        radii.append(r)
        r *= 2
    radii.append(R)
    return radii


_ENGINES = ("pyramid", "octant", "shells")


def _full_extent(cfg: Evolve3DConfig) -> bool:
    """Whether the trace extents are the full periodic ones, +M/2 /
    -(M/2-1) (JAX evolve3d.py:121: the test is the lower extent)."""
    M = cfg.sweep.mesh
    lo = (cfg.shells.lo[0] if cfg.shells is not None
          else -(M // 2 - 1 + M % 2))
    return lo == -(M // 2 - 1)


def sweep_engine(cfg: Evolve3DConfig) -> str:
    """The engine an iteration runs: cfg.engine at full extents, else
    the shell engine (JAX evolve3d.py:119-122)."""
    if cfg.engine not in _ENGINES:
        raise ValueError(f"unknown sweep engine {cfg.engine!r}; one of "
                         f"{_ENGINES}")
    return cfg.engine if _full_extent(cfg) else "shells"


def make_evolve3d_iteration(cfg: Evolve3DConfig, radius=None,
                            return_rates=False):
    """One {sweep + global chemistry pass} iteration; `radius` bounds
    the trace (None = full).  The returned function maps
    (state, srcpos, nflux, dt, dr=None, vol_over_scale=None,
    cosmo_cool_factor=None, lls_grid=None) to
    (new state, conv_flag, photon_loss, lls_loss), all on the state's
    device, and with `return_rates` the iteration's RateGrids after
    them (what a mid-iteration dump stores).  `dr` and its
    host-computed dr^3/flux_scale override the sweep's cell size;
    `cosmo_cool_factor` overrides the chemistry config's
    (JAX evolve3d.py:182-184); `lls_grid` (mesh^3,) gives each cell's
    LLS column.

    The engine is `sweep_engine(cfg)`.  `radius` reaches the pyramid
    engine only; `dr`, `vol_over_scale` and `lls_grid` the pyramid and
    shell engines (JAX's shell engine drops them: a decided deviation,
    ROADMAP Queue 3).  The octant engine, as JAX's, traces the
    configuration's cell size and homogeneous LLS column."""
    engine = sweep_engine(cfg)
    if cfg.add_photon_losses and not (engine == "pyramid"
                                      and cfg.sweep.track_band_loss):
        raise ValueError(
            "add_photon_losses needs the pyramid engine with "
            "SweepConfig(track_band_loss=True)")
    shells = cfg.shells
    if engine == "shells" and shells is None:
        shells = build_shell_table(cfg.sweep.mesh)

    def sweep(fields, srcpos, nflux, dr, vol_over_scale, lls_grid):
        if engine == "octant":
            return sweep_octant_source_batch(cfg.sweep, fields, srcpos, nflux)
        if engine == "shells":
            return sweep_sources_accumulate(cfg.sweep, shells, fields, srcpos,
                                            nflux, dr=dr,
                                            vol_over_scale=vol_over_scale,
                                            lls_grid=lls_grid)
        return sweep_pyramid_source_batch(cfg.sweep, fields, srcpos, nflux,
                                          radius=radius, dr=dr,
                                          vol_over_scale=vol_over_scale,
                                          lls_grid=lls_grid)

    def iteration(state: GridState, srcpos, nflux, dt, dr=None,
                  vol_over_scale=None, cosmo_cool_factor=None,
                  lls_grid=None):
        fields = SourceFields(ndens=state.ndens, h_av0=state.h_av0,
                              h_av1=state.h_av1, he_av0=state.he_av0,
                              he_av1=state.he_av1)
        with span("c2ray.sweep"):
            rates = sweep(fields, srcpos, nflux, dr, vol_over_scale,
                          lls_grid)
            if cfg.add_photon_losses:
                vos = (vol_over_scale if vol_over_scale is not None
                       else cfg.sweep.vol / cfg.sweep.flux_scale)
                rates = distribute_photon_losses(cfg.sweep.tables, rates,
                                                 fields, vos)
        with span("c2ray.chemistry"):
            new_state, conv_flag = global_chemistry_pass(
                cfg.chem, state, rates, dt, cosmo_cool_factor)
        out = (new_state, conv_flag, rates.photon_loss, rates.lls_loss)
        return out + (rates,) if return_rates else out

    return iteration


def subbox_iteration(call, r_idx: int, n_radii: int, loss_wall):
    """One convergence iteration (the span ``c2ray.iteration``):
    `call(r)` sweeps the batch at radius index r and runs the chemistry
    pass; while a larger radius is left and more than `loss_wall`
    escapes, the radius doubles and the iteration is redone
    (evolve_source.F90:114-144), each a sweep of its own.  Returns (the
    last call's output, its radius index, conv_flag, photon_loss,
    lls_loss), the scalars read on the host (``c2ray.iteration.read``:
    where the host waits for the device)."""
    with span("c2ray.iteration"):
        count("evolve3d.iterations")
        while True:
            count("evolve3d.sweeps")
            out = call(r_idx)
            if r_idx + 1 >= n_radii:
                break
            with span("c2ray.iteration.read"):
                contained = float(out[2]) <= loss_wall
            if contained:
                break
            r_idx += 1
        with span("c2ray.iteration.read"):
            scalars = (int(out[1]), float(out[2]), float(out[3]))
    return (out, r_idx) + scalars


def evolve3d(cfg: Evolve3DConfig, state: GridState, srcpos, nflux, dt,
             iteration_fn=None, dr=None, cosmo_cool_factor=None,
             iteration_cache=None, initial_radius=None, lls_grid=None,
             dump_dir=None, dump_interval_s=900.0, start_from_dump=False):
    """Full evolve3D (evolve.F90:78-229).

    srcpos: (S, 3) int; nflux: (S, 3).  Returns (new state,
    Evolve3DStats).  With `cfg.use_subbox` (the pyramid engine at full
    extents; otherwise subbox_radius is 0) each iteration's sweep runs
    on an adaptive subbox radius: while the photon fraction escaping the
    current radius exceeds `min_fraction_of_photons`, the radius doubles
    and the sweep is redone (evolve_source.F90:114-144); the radius
    carries over to the next iteration.  `initial_radius` seeds it (the
    driver passes the previous step's).  `iteration_fn` replaces the
    adaptive iteration by a fixed one; `iteration_cache` is accepted for
    the JAX signature and ignored.

    `dr` (float) overrides the sweep's cell size, passed on with its
    dr^3/flux_scale computed on the host in float64 (the cosmological
    driver rescales it every step).  `cosmo_cool_factor` (float) is the
    step's adiabatic cooling factor 2(dz/dt)/(1+z)
    (cosmology.f90:207-234, thermal.f90:76).  `lls_grid` (mesh^3,) is
    each cell's LLS column for every sweep of the step.

    `dump_dir` enables the reference's mid-iteration checkpoints: every
    `dump_interval_s` wall seconds the pre-iteration state and that
    iteration's rate grids go to alternating iterdump slots
    (evolve.F90:199-212, 233-275).  `start_from_dump=True` resumes
    mid-timestep: the dumped rates are re-applied with one chemistry
    pass and the loop continues from the dumped iteration count
    (evolve.F90:279-367).
    """
    from ..io.checkpoint import load_iterdump, save_iterdump

    del iteration_cache   # nothing is compiled per radius
    if iteration_fn is not None and dump_dir is not None:
        raise ValueError(
            "dump_dir requires the internally-built iteration "
            "(return_rates=True); pass dump_dir OR iteration_fn, not "
            "both")
    adaptive = (iteration_fn is None and cfg.use_subbox
                and cfg.engine == "pyramid" and _full_extent(cfg))
    want_rates = dump_dir is not None
    radii = _subbox_radii(cfg) if adaptive else [cfg.sweep.mesh // 2]
    if iteration_fn is None:
        iterations = [make_evolve3d_iteration(
            cfg, radius=None if i == len(radii) - 1 else r,
            return_rates=want_rates) for i, r in enumerate(radii)]
    else:
        iterations = [iteration_fn]
    total_strength = _scaled_source_strength(cfg.sweep, nflux)
    loss_wall = cfg.min_fraction_of_photons * max(total_strength, 1e-300)
    r_idx = 0
    if adaptive and initial_radius is not None:
        while r_idx + 1 < len(radii) and radii[r_idx] < initial_radius:
            r_idx += 1
    kw = {}
    if dr is not None:
        kw = {"dr": float(dr),
              "vol_over_scale": float(dr) ** 3 / cfg.sweep.flux_scale}
    if cosmo_cool_factor is not None:
        kw["cosmo_cool_factor"] = float(cosmo_cool_factor)
    if lls_grid is not None:
        kw["lls_grid"] = lls_grid

    n = state.mesh3
    conv_criterion = min(int(cfg.convergence_fraction * n),
                         int(srcpos.shape[0]))
    niter = 0
    conv_flag = n
    if start_from_dump:
        # mid-timestep resume: the pre-iteration state and its rates,
        # re-applied with one chemistry pass (evolve.F90:137-141)
        niter, st_np, rt_np, meta = load_iterdump(
            dump_dir, GridState, RateGrids, with_meta=True)
        dtype, device = state.ndens.dtype, state.ndens.device
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        state = GridState(*(as_t(x) for x in st_np))
        rates = RateGrids(*(None if x is None else as_t(x) for x in rt_np))
        state, conv_dev = global_chemistry_pass(
            cfg.chem, state, rates, dt,
            None if cosmo_cool_factor is None else float(cosmo_cool_factor))
        conv_flag = int(conv_dev)
        if adaptive and meta.get("subbox_radius"):
            while (r_idx + 1 < len(radii)
                   and radii[r_idx] < int(meta["subbox_radius"])):
                r_idx += 1
    else:
        state = begin_timestep(state)
    ploss = lls_loss = 0.0
    radius_used = 0
    last_dump = _time.time()
    while True:
        # convergence test at loop head (evolve.F90:154-182); at least
        # two iterations so sources can interact
        if conv_flag < conv_criterion and niter > 1:
            break
        if niter > cfg.max_iterations:
            break
        niter += 1
        prev_state = state
        out, r_idx, conv_flag, ploss, lls_loss = subbox_iteration(
            lambda r: iterations[r](state, srcpos, nflux, dt, **kw), r_idx,
            len(iterations), loss_wall)
        radius_used = radii[r_idx] if adaptive else 0
        state = out[0]
        # mid-iteration checkpoint (write_iteration_dump,
        # evolve.F90:199-212): the pre-iteration state and this
        # iteration's rates determine the post-iteration state
        if want_rates and _time.time() - last_dump >= dump_interval_s:
            save_iterdump(dump_dir, niter, prev_state, out[4],
                          subbox_radius=radius_used)
            last_dump = _time.time()

    state = finish_timestep(state)
    return state, Evolve3DStats(n_iterations=niter, conv_flag=conv_flag,
                                photon_loss=ploss, subbox_radius=radius_used,
                                lls_loss=lls_loss)
