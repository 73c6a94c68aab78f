"""Source-parallel SPMD iteration over a torch.distributed group.

Port of ``c2ray_tpu/parallel/sharding.py``: the reference's MPI model
(master_slave.F90:62-95, evolve.F90:505-548).  Every rank holds the
whole grid; the padded source list is split into contiguous blocks,
rank d tracing rows [d K, (d+1) K); the partial rate grids are summed
over the ranks (JAX's psum, the reference's MPI_ALLREDUCE); each rank
then runs the chemistry on its own contiguous block of mesh^3/D cells,
the convergence count is summed and the new state gathered, so that the
next sweep sees the whole grid on every rank.

Launch one process per device (``torchrun``, or `parallel.launch`) and
initialise the default process group first; `ParallelConfig.group`
picks another.  JAX's `split_chem` and `iteration_cache` exist only for
the TPU (ROADMAP "Not ported"): they are accepted and ignored.
"""

import time as _time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..state import GridState, begin_timestep, finish_timestep
from ..sweep.evolve3d import (Evolve3DConfig, Evolve3DStats, _full_extent,
                              _scaled_source_strength, _subbox_radii,
                              subbox_iteration, sweep_engine)
from ..sweep.geometry import build_shell_table
from ..sweep.global_pass import global_chemistry_pass
from ..sweep.octant_sweep import sweep_octant_source_batch
from ..sweep.pyramid_sweep import sweep_pyramid_source_batch
from ..sweep.source_sweep import (RateGrids, SourceFields,
                                  sweep_sources_accumulate)
from ..utils.clocks import span
from . import comm

# the fields the chemistry pass writes: what the ranks gather
CHEM_FIELDS = ("h_int0", "h_int1", "he_int0", "he_int1", "he_int2",
               "h_av0", "h_av1", "he_av0", "he_av1", "he_av2",
               "t_inter", "t_av")


@dataclass(frozen=True)
class ParallelConfig:
    cfg: Evolve3DConfig
    # the torch.distributed group over which the work splits (the JAX
    # package's 1D device Mesh); None is the default group
    group: Any = None


def pad_sources(srcpos, nflux, n_devices: int):
    """Pad the source list to a multiple of n_devices with zero-flux
    no-op entries (handled inside the sweep)."""
    s = srcpos.shape[0]
    pad = (-s) % n_devices
    if pad:
        srcpos = np.concatenate(
            [srcpos, np.zeros((pad, 3), dtype=srcpos.dtype)], axis=0)
        nflux = np.concatenate(
            [nflux, np.zeros((pad, 3), dtype=nflux.dtype)], axis=0)
    return srcpos, nflux


def _refuse_photon_losses(cfg: Evolve3DConfig):
    # JAX's parallel iterations never redistribute the escaped photons
    # (sharding.py:104-141, domain.py:417-427); the port refuses the
    # combination rather than drop the option silently (ROADMAP Queue 3)
    if cfg.add_photon_losses:
        raise ValueError("add_photon_losses is not supported by the "
                         "parallel iterations (the JAX package's never "
                         "redistribute the photon losses)")


def _rank_block(n: int, D: int, d: int) -> slice:
    if n % D:
        raise ValueError(f"{n} not divisible by {D} ranks")
    b = n // D
    return slice(d * b, (d + 1) * b)


def psum_rates(rates: RateGrids, group=None) -> RateGrids:
    """The rate grids and losses summed over the ranks, in one
    all-reduce; the grids come back as contiguous (n,) tensors."""
    n = rates.phih.shape[0]
    parts = [rates.phih, rates.phihe0, rates.phihe1, rates.phiheat,
             rates.photon_loss.reshape(1), rates.lls_loss.reshape(1)]
    bands = rates.photon_loss_bands
    if bands is not None:
        parts.append(bands)
    total = comm.psum(torch.cat(parts), group)
    rest = total[4 * n:]
    return RateGrids(phih=total[:n], phihe0=total[n:2 * n],
                     phihe1=total[2 * n:3 * n], phiheat=total[3 * n:4 * n],
                     photon_loss=rest[0], lls_loss=rest[1],
                     photon_loss_bands=None if bands is None else rest[2:])


def gather_fields(state: GridState, names, group=None):
    """{name: the ranks' (b,) blocks of state.<name> gathered in rank
    order} in one all-gather."""
    blk = torch.stack([getattr(state, k) for k in names])      # (F, b)
    g = comm.all_gather(blk.unsqueeze(0), group)               # (D, F, b)
    full = g.permute(1, 0, 2).reshape(len(names), -1)
    return {k: full[i] for i, k in enumerate(names)}


def _cell_block(state: GridState, sl: slice) -> GridState:
    cl = state.clumping
    return GridState(*(t[sl] for t in state[:-1]),
                     clumping=cl if cl.ndim == 0 else cl[sl])


def make_parallel_iteration(pcfg: ParallelConfig, radius: int = None,
                            return_rates: bool = False,
                            split_chem: bool = None):
    """One source-parallel {sweep + chemistry} iteration.

    The returned function maps (state, srcpos, nflux, dt, dr=None,
    vol_over_scale=None, cosmo_cool_factor=None, lls_grid=None) to
    (new state, conv_flag, photon_loss, lls_loss) (+ the summed
    RateGrids with `return_rates`), as `make_evolve3d_iteration`'s does.
    `state` is the whole grid, the same on every rank; srcpos / nflux
    the padded list (`pad_sources`), whose rank-d block of rows rank d
    traces; the results are the same on every rank.  The engine is
    `sweep_engine(cfg)`; as in `make_evolve3d_iteration`, `radius`
    reaches the pyramid engine only, `dr`, `vol_over_scale` and
    `lls_grid` the pyramid and shell engines."""
    del split_chem
    cfg = pcfg.cfg
    group = pcfg.group
    _refuse_photon_losses(cfg)
    engine = sweep_engine(cfg)
    shells = cfg.shells
    if engine == "shells" and shells is None:
        shells = build_shell_table(cfg.sweep.mesh)
    D, d = comm.axis_size(group), comm.rank(group)

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
        mine = _rank_block(srcpos.shape[0], D, d)
        fields = SourceFields(ndens=state.ndens, h_av0=state.h_av0,
                              h_av1=state.h_av1, he_av0=state.he_av0,
                              he_av1=state.he_av1)
        with span("c2ray.sweep"):
            rates = psum_rates(sweep(fields, srcpos[mine], nflux[mine], dr,
                                     vol_over_scale, lls_grid), group)
        cells = _rank_block(state.mesh3, D, d)
        with span("c2ray.chemistry"):
            blk, conv = global_chemistry_pass(
                cfg.chem, _cell_block(state, cells),
                rates._replace(phih=rates.phih[cells],
                               phihe0=rates.phihe0[cells],
                               phihe1=rates.phihe1[cells],
                               phiheat=rates.phiheat[cells]),
                dt, cosmo_cool_factor)
            conv = comm.psum(conv, group)
            new_state = state._replace(**gather_fields(blk, CHEM_FIELDS,
                                                       group))
        out = (new_state, conv, rates.photon_loss, rates.lls_loss)
        return out + (rates,) if return_rates else out

    return iteration


def _step_kwargs(cfg, dr, cosmo_cool_factor, lls_grid):
    kw = {}
    if dr is not None:
        kw = {"dr": float(dr),
              "vol_over_scale": float(dr) ** 3 / cfg.sweep.flux_scale}
    if cosmo_cool_factor is not None:
        kw["cosmo_cool_factor"] = float(cosmo_cool_factor)
    if lls_grid is not None:
        kw["lls_grid"] = lls_grid
    return kw


def dump_due(last_dump, interval_s, device, group=None) -> bool:
    """Whether a mid-iteration dump is due on any rank: the ranks'
    clocks differ, and a dump gathers, so all must agree."""
    return comm.any_rank(_time.time() - last_dump >= interval_s, device,
                         group)


def parallel_evolve3d(pcfg: ParallelConfig, state: GridState, srcpos,
                      nflux, dt, iteration_fn=None, dr=None,
                      cosmo_cool_factor=None, iteration_cache=None,
                      initial_radius=None, lls_grid=None,
                      dump_dir=None, dump_interval_s=900.0,
                      start_from_dump=False, split_chem=None):
    """Source-parallel evolve3D: `evolve3d`'s convergence protocol
    (evolve.F90:147-181) with the adaptive subbox (pyramid engine at
    full extents) over `make_parallel_iteration`.  `state` is the whole
    grid on every rank and so is the result.  srcpos / nflux: the whole
    source list (numpy or tensors), padded here.  Mid-iteration dumps
    are written by rank 0 in the single-device format, so a dump
    resumes in any mode and in either package."""
    from ..io.checkpoint import load_iterdump, save_iterdump

    del iteration_cache, split_chem
    cfg = pcfg.cfg
    group = pcfg.group
    D = comm.axis_size(group)
    if iteration_fn is not None and dump_dir is not None:
        raise ValueError(
            "dump_dir requires the internally-built iteration "
            "(return_rates=True); pass dump_dir OR iteration_fn, not "
            "both")
    dtype, device = state.ndens.dtype, state.ndens.device
    host = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    sp, nf = pad_sources(host(srcpos), host(nflux), D)
    srcpos = torch.as_tensor(sp, dtype=torch.int32, device=device)
    nflux = torch.as_tensor(nf, dtype=dtype, device=device)

    adaptive = (iteration_fn is None and cfg.use_subbox
                and cfg.engine == "pyramid" and _full_extent(cfg))
    want_rates = dump_dir is not None
    radii = _subbox_radii(cfg) if adaptive else [cfg.sweep.mesh // 2]
    if iteration_fn is None:
        iterations = [make_parallel_iteration(
            pcfg, radius=None if i == len(radii) - 1 else r,
            return_rates=want_rates) for i, r in enumerate(radii)]
    else:
        iterations = [iteration_fn]
    total_strength = _scaled_source_strength(cfg.sweep, nflux)
    loss_wall = cfg.min_fraction_of_photons * max(total_strength, 1e-300)
    r_idx = 0
    if adaptive and initial_radius is not None:
        while r_idx + 1 < len(radii) and radii[r_idx] < initial_radius:
            r_idx += 1
    kw = _step_kwargs(cfg, dr, cosmo_cool_factor, lls_grid)

    n = state.mesh3
    num_src = int(np.sum(np.any(nf > 0, axis=1)))
    conv_criterion = min(int(cfg.convergence_fraction * n), max(num_src, 1))
    niter = 0
    conv_flag = n
    if start_from_dump:
        niter, st_np, rt_np, meta = load_iterdump(
            dump_dir, GridState, RateGrids, with_meta=True)
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
        if want_rates and dump_due(last_dump, dump_interval_s, device,
                                   group):
            if comm.rank(group) == 0:
                save_iterdump(dump_dir, niter, prev_state, out[4],
                              subbox_radius=radius_used)
            last_dump = _time.time()

    state = finish_timestep(state)
    return state, Evolve3DStats(n_iterations=niter, conv_flag=conv_flag,
                                photon_loss=ploss, subbox_radius=radius_used,
                                lls_loss=lls_loss)
