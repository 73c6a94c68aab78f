"""Spatial domain decomposition of the transport sweep over a
torch.distributed group.

Port of ``c2ray_tpu/parallel/domain.py``.  Every (mesh^3,) field is cut
into x-slabs of S = mesh/D planes, rank d holding planes [d S, (d+1) S)
(the C-order flat blocks; `shard_state_slabs`).  Each source is traced
by one rank on a cubic window of Mw = min(2 radius + 2, mesh) cells
around it, which reaches up to H = Mw - Rb - 1 (+ balance_halo) planes
into the neighbouring slabs; so before the sweep each rank receives H
halo planes per side from its periodic neighbours (send/recv, several
hops when H > S), y and z wrap locally.  The traced windows are added
into a halo-extended rate slab, whose halos are folded back: y and z
locally, x by sending each halo chunk to its owner, who adds it.  The
chemistry runs on the rank's own slab; the photon and LLS losses and
the convergence count are summed over the ranks.

The device work around the traces is three kernels (`halo.py`,
``csrc/domain_halo.cu``); each window is traced by the pyramid sweep's
`trace_cuda` / `trace_plain` with the window as its field cube.  The
memory per rank is the halo-extended field and rate slabs,
(S+2H)(M+2H)^2 (C+4) values: O(mesh^3/D + H mesh^2) at small radii, and
more than replication at the full radius, so the adaptive ladder stops
where the domain mode would cost more than the replicated one
(`_domain_radii`), exactly as in the JAX package.
"""

import time as _time
import warnings

import numpy as np
import torch

from ..state import GridState, begin_timestep, finish_timestep
from ..sweep.evolve3d import (Evolve3DStats, _scaled_source_strength,
                              _subbox_radii, subbox_iteration)
from ..sweep.global_pass import global_chemistry_pass
from ..sweep.pyramid_sweep import trace_cuda, trace_extents, trace_plain
from ..sweep.source_sweep import RateGrids
from ..utils.clocks import span
from . import comm
# JAX's _cyclic_pad and its inverse for accumulands, _fold_cyclic, are
# the plain halo kernels' (halo.py)
from .halo import (_cyclic_pad, _fold_cyclic, fold_halo, halo_pack,
                   window_accumulate)
from .sharding import (ParallelConfig, _refuse_photon_losses, _step_kwargs,
                       dump_due, gather_fields)


# ---------------------------------------------------------------------------
# the halo messages (periodic, multi-hop when H > S)
# ---------------------------------------------------------------------------

def _perm(k, D):
    """ppermute pairs sending device d's value to device d+k (mod D),
    i.e. every device *receives from* d-k."""
    return [(d, (d + k) % D) for d in range(D)]


def _halo_messages(S: int, H: int):
    """The field exchange of `exchange_slab_halo` as messages
    (k, lo, hi, at): every rank sends its planes [lo, hi) to rank d+k,
    which puts them at halo-extended plane `at` (of S + 2H)."""
    hops = -(-H // S)
    msgs = []
    for k in range(1, hops + 1):
        # from d-k: its planes at offsets -k S + p, kept from offset -H
        lo = max(0, k * S - H)
        msgs.append((k, lo, S, H - k * S + lo))
        # from d+k: its planes at offsets k S + p, kept below S + H
        hi = min(S, H - (k - 1) * S)
        msgs.append((-k, 0, hi, H + k * S))
    return msgs


def _fold_messages(S: int, H: int):
    """The x fold of `fold_slab_halo` as messages (k, lo, hi, at), in
    the order the receiver adds them: every rank sends its halo-extended
    planes [lo, hi) to rank d+k, which adds them onto its planes
    [at, at + hi - lo).  Per hop j the chunk of the left pad, then the
    right pad's (domain.py:114-126; with H <= S the same two messages
    as :107-113).  Planes of the pads that hold JAX's zeros are not
    sent: adding them changes nothing."""
    hops = -(-H // S)
    pad = hops * S
    msgs = []
    for j in range(hops):
        p0 = max(j * S, pad - H)
        msgs.append((-(hops - j), p0 - pad + H, (j + 1) * S - pad + H,
                     p0 - j * S))
        p1 = min((j + 1) * S, H)
        msgs.append((j + 1, S + H + j * S, S + H + p1, 0))
    return msgs


def _halo_row(x: int, S: int, H: int) -> int:
    """Row of halo-extended plane x (in [0, H) or [S+H, S+2H)) in the
    halo planes laid end to end, left then right."""
    return x if x < H else x - S


def exchange_slab_halo(slab, H, group=None):
    """(S, ...) local x-slab -> (S+2H, ...) with H halo planes from each
    periodic neighbour (multi-hop if H > S)."""
    S = slab.shape[0]
    msgs = _halo_messages(S, H)
    got = comm.exchange([(slab[lo:hi], k) for k, lo, hi, _ in msgs], group)
    out = torch.empty((S + 2 * H,) + tuple(slab.shape[1:]), dtype=slab.dtype,
                      device=slab.device)
    out[H:H + S] = slab
    for (_, lo, hi, at), r in zip(msgs, got):
        out[at:at + hi - lo] = r
    return out


def fold_slab_halo(core, H, group=None):
    """Inverse of exchange_slab_halo for accumulands: (S+2H, ...) ->
    (S, ...), each halo chunk sent back to its owning rank and added
    there (the reverse boundary exchange)."""
    S = core.shape[0] - 2 * H
    msgs = _fold_messages(S, H)
    got = comm.exchange([(core[lo:hi], k) for k, lo, hi, _ in msgs], group)
    local = core[H:H + S].clone()
    for (_, lo, hi, at), r in zip(msgs, got):
        local[at:at + hi - lo] += r
    return local


# ---------------------------------------------------------------------------
# source assignment
# ---------------------------------------------------------------------------

def _pack_groups(srcpos, nflux, assign, n_dev, mesh):
    """Lay sources out as (D*K, 3) blocks with x replaced by the
    *slab-local offset* x - d*S (may be negative for borrowed
    sources); pad each device's block to K with zero-flux no-ops."""
    S = mesh // n_dev
    counts = np.bincount(assign, minlength=n_dev)
    K = max(int(counts.max()) if counts.size else 1, 1)
    sp = np.zeros((n_dev, K, 3), dtype=np.int32)
    nf = np.zeros((n_dev, K, nflux.shape[1]), dtype=nflux.dtype)
    fill = np.zeros(n_dev, dtype=np.int64)
    half = mesh // 2
    for i in range(srcpos.shape[0]):
        d = int(assign[i])
        if n_dev == 1:
            # S == mesh: the slab is the whole grid, so the absolute
            # coordinate is the window offset (the centered fold would
            # go negative for x >= mesh/2)
            off = int(srcpos[i, 0])
        else:
            # centered periodic offset relative to the slab start
            off = (int(srcpos[i, 0]) - d * S + half) % mesh - half
        sp[d, fill[d]] = (off, srcpos[i, 1], srcpos[i, 2])
        nf[d, fill[d]] = nflux[i]
        fill[d] += 1
    return sp.reshape(n_dev * K, 3), nf.reshape(n_dev * K, -1)


def group_sources_by_slab(srcpos, nflux, mesh: int, n_dev: int):
    """Assign each source to the device owning its x-slab; pad each
    group to the max per-slab count with zero-flux no-ops.

    Returns ((D*K, 3) int32, (D*K, 3) fluxes): rows [d K, (d+1) K) are
    rank d's sources, column 0 the slab-local x offset.  Zero-flux rows
    are skipped without a trace."""
    srcpos = np.asarray(srcpos)
    nflux = np.asarray(nflux)
    S = mesh // n_dev
    owner = (srcpos[:, 0].astype(np.int64) // S).astype(np.int64)
    return _pack_groups(srcpos, nflux, owner, n_dev, mesh)


def group_sources_balanced(srcpos, nflux, mesh: int, n_dev: int,
                           extra_halo: int):
    """Cost-balanced static source assignment (the SPMD replacement for
    the reference's master-slave queue, master_slave.F90:124-227).

    With `extra_halo = E` extra exchanged planes, device d can trace any
    source whose slab-local offset lies in [-(E+1), S+E-1]; each source
    goes to the least-loaded eligible device (ties to the owner), in x
    order."""
    srcpos = np.asarray(srcpos)
    nflux = np.asarray(nflux)
    S = mesh // n_dev
    E = int(extra_halo)
    half = mesh // 2
    load = np.zeros(n_dev, dtype=np.int64)
    assign = np.zeros(srcpos.shape[0], dtype=np.int64)
    order = np.argsort(srcpos[:, 0], kind="stable")
    for i in order:
        x = int(srcpos[i, 0])
        owner = x // S
        best, best_load = owner, load[owner]
        for d in range(n_dev):
            off = (x - d * S + half) % mesh - half
            if -(E + 1) <= off <= S + E - 1 and load[d] < best_load:
                best, best_load = d, load[d]
        assign[i] = best
        load[best] += 1
    return _pack_groups(srcpos, nflux, assign, n_dev, mesh)


def shard_state_slabs(state: GridState, group=None) -> GridState:
    """The rank's x-slab of every field of a whole-grid state (a scalar
    clumping broadcast to the slab)."""
    return GridState(*(shard_field(t, state.mesh3, group) for t in state))


def gather_state_slabs(state: GridState, group=None, dst=None,
                       names=GridState._fields):
    """The whole-grid fields `names` (all: a GridState) from the ranks'
    slabs, in one collective: every rank gets them, or with `dst` only
    rank dst (the others get None).  A subset of the fields comes as a
    {name: tensor} dict."""
    if dst is None:
        full = gather_fields(state, names, group)
    else:
        blk = torch.stack([getattr(state, k) for k in names])     # (F, b)
        g = comm.gather(blk.unsqueeze(0), dst, group)              # (D, F, b)
        if g is None:
            return None
        g = g.permute(1, 0, 2).reshape(len(names), -1)
        full = {k: g[i] for i, k in enumerate(names)}
    return GridState(**full) if names == GridState._fields else full


def shard_field(t, n: int, group=None):
    """The rank's x-slab of a whole-grid field of n cells (a 0-d value
    broadcast to the slab)."""
    sl = _slab(n, group)
    return t.expand(n)[sl].contiguous() if t.ndim == 0 else t[sl].contiguous()


def _slab(n: int, group=None) -> slice:
    D, d = comm.axis_size(group), comm.rank(group)
    if n % D:
        raise ValueError(f"{n} cells not divisible by {D} ranks")
    b = n // D
    return slice(d * b, (d + 1) * b)


# ---------------------------------------------------------------------------
# the sharded iteration
# ---------------------------------------------------------------------------

def max_domain_radius(mesh: int) -> int:
    """Largest supported trace radius: mesh/2 is the full periodic
    extent (+M/2 / -(M/2-1), evolve_source.F90:103-109); the window is
    then the whole torus (Mw = M)."""
    return mesh // 2


def _window_geometry(M: int, radius: int, extra_halo: int = 0):
    """(Mw, Rb, H) for a trace radius (the arithmetic of
    make_domain_iteration)."""
    Mw = min(2 * radius + 2, M)
    Rb = min(radius, Mw // 2 - 1)
    H = Mw - Rb - 1 + int(extra_halo)
    return Mw, Rb, H


def domain_memory_elements(M: int, D: int, radius: int,
                           extra_halo: int = 0,
                           n_channels: int = 5) -> int:
    """Per-device element count of the domain iteration's dominant live
    arrays at a trace radius: the halo-extended field slab
    (S+2H, M+2H, M+2H, C), the halo-extended rate accumulator (same
    extents, 4 channels), one trace window (Mw^3 * (C+4)) and the
    ~20-field state slab."""
    S = M // D
    Mw, _, H = _window_geometry(M, radius, extra_halo)
    halo_extended = (S + 2 * H) * (M + 2 * H) ** 2 * (n_channels + 4)
    window = Mw ** 3 * (n_channels + 4)
    state = 20 * M ** 3 // D
    return halo_extended + window + state


def replicated_memory_elements(M: int, n_channels: int = 5) -> int:
    """Per-device element count of the replicated source-parallel
    engine: full grid state (~20 fields), full rate grids (4), the
    stacked sweep field (C) and the full-extent trace working set."""
    return (20 + 4 + n_channels) * M ** 3 + (n_channels + 4) * M ** 3


def make_domain_iteration(pcfg: ParallelConfig, radius: int,
                          extra_halo: int = 0, return_rates: bool = False,
                          split_chem: bool = None):
    """One grid-sharded {halo exchange + windowed pyramid traces +
    reverse rate exchange + slab chemistry} iteration.

    The returned function maps (state, srcpos, nflux, dt, dr=None,
    vol_over_scale=None, cosmo_cool_factor=None, lls_grid=None) to
    (new slab state, conv_flag, photon_loss, lls_loss) (+ the slab's
    RateGrids with `return_rates`).  `state` is the rank's slab
    (`shard_state_slabs`); srcpos / nflux the grouped list of
    `group_sources_by_slab` / `group_sources_balanced` (all ranks'
    rows; column 0 the slab-local x offset); `lls_grid` the rank's slab
    of the LLS columns, or the whole grid.  conv_flag and the losses
    are summed over the ranks.  `radius` is the subbox trace radius, up
    to M/2 (the full periodic trace: a window of M planes, extents
    +M/2 / -(M/2-1) as the replicated engine's).  `extra_halo` widens
    the exchanged halo for borrowed sources.  `split_chem` is accepted
    and ignored (it exists for the TPU)."""
    del split_chem
    cfg = pcfg.cfg
    group = pcfg.group
    _refuse_photon_losses(cfg)
    D, d = comm.axis_size(group), comm.rank(group)
    M = cfg.sweep.mesh
    if M % D != 0:
        raise ValueError(f"mesh {M} not divisible by {D} devices")
    if M % 2:
        raise ValueError(f"the domain mode traces with the pyramid engine, "
                         f"which needs an even mesh, not {M}")
    S = M // D
    Rw = int(radius)
    if Rw < 1 or Rw > M // 2:
        raise ValueError(
            f"radius {Rw} outside [1, {max_domain_radius(M)}] for "
            f"mesh {M}")
    Mw, Rb, H = _window_geometry(M, Rw, extra_halo)
    if H > M:
        raise ValueError(f"halo of {H} planes exceeds the mesh {M}")
    halo_msgs = _halo_messages(S, H)
    fold_msgs = _fold_messages(S, H)
    # the received fold chunks, laid end to end: (first plane, local
    # plane, planes) per message, in the order they are added
    chunks, b0 = [], 0
    for _, lo, hi, at in fold_msgs:
        chunks.append((b0, at, hi - lo))
        b0 += hi - lo
    eps = cfg.sweep.epsilon
    # the trace's extents in the window: +Rw / -Rb
    Rf_w, _ = trace_extents(Mw, Rw)

    def _trace_slab(state: GridState, srcpos, nflux, lls_grid, dr,
                    vol_over_scale):
        dtype, device = state.ndens.dtype, state.ndens.device
        trace = trace_cuda if state.ndens.is_cuda else trace_plain
        fields = [state.ndens, state.h_av0, state.h_av1, state.he_av0,
                  state.he_av1]
        if lls_grid is not None:
            lls = torch.as_tensor(lls_grid, dtype=dtype,
                                  device=device).reshape(-1)
            if lls.shape[0] == M ** 3 and D > 1:
                lls = lls[_slab(M ** 3, group)]
            fields.append(lls)
        C = len(fields)

        # field halo exchange (the boundary-plane communication): the
        # left halo planes, then the right ones, received end to end
        got = torch.empty((2 * H, M, M, C), dtype=dtype, device=device)
        comm.exchange_into(
            [(halo_pack(fields, M, eps, planes=(lo, hi)), k,
              got[_halo_row(at, S, H):_halo_row(at, S, H) + hi - lo])
             for k, lo, hi, at in halo_msgs], group)
        pf = halo_pack(fields, M, eps, left=got[:H], right=got[H:], pad=H)

        rc = torch.zeros((S + 2 * H, M + 2 * H, M + 2 * H, 4), dtype=dtype,
                         device=device)
        pl = torch.zeros((), dtype=dtype, device=device)
        ll = torch.zeros((), dtype=dtype, device=device)
        sp = torch.as_tensor(srcpos).cpu().numpy()
        nf = torch.as_tensor(nflux, dtype=dtype, device=device)
        rows = _slab(sp.shape[0], group)
        live = np.any(torch.as_tensor(nflux).cpu().numpy()[rows] > 0.0,
                      axis=1)
        ctr = torch.full((1, 3), Rb, dtype=torch.int32, device=device)
        for i in np.flatnonzero(live):
            row = rows.start + int(i)
            # sp[0] is the slab-local x offset (the window may reach
            # into the halo for borrowed sources)
            start = [int(v) + H - Rb for v in sp[row]]
            if any(s < 0 or s + Mw > n for s, n in
                   zip(start, pf.shape[:3])):
                raise ValueError(f"source {sp[row]}'s window at {start} "
                                 f"leaves the halo-extended slab")
            win = pf[start[0]:start[0] + Mw, start[1]:start[1] + Mw,
                     start[2]:start[2] + Mw]
            # the window is the trace's field cube, its source at
            # (Rb, Rb, Rb): no ray wraps since Rb + Rw <= Mw - 1.  The
            # trace takes its mesh from the cube and never reads
            # cfg.sweep.mesh (the global one); the cell size is the
            # global one, through dr and vol_over_scale
            slab, ploss, lloss, _ = trace(
                cfg.sweep, win[..., :5].contiguous(), ctr, nf[row:row + 1],
                Rf_w, Rb, dr, vol_over_scale,
                lls=win[..., 5].contiguous() if C == 6 else None)
            window_accumulate(rc, slab.view(Mw, Mw, Mw, 4), start)
            pl = pl + ploss[0]
            ll = ll + lloss[0]

        # reverse exchange: fold the rate halos back onto their owners
        halos = torch.cat([fold_halo(rc, M, (0, H), planar=False),
                           fold_halo(rc, M, (S + H, S + 2 * H),
                                     planar=False)])
        recv = torch.empty((b0, M, M, 4), dtype=dtype, device=device)
        comm.exchange_into(
            [(halos[_halo_row(lo, S, H):_halo_row(lo, S, H) + hi - lo], k,
              recv[c[0]:c[0] + c[2]])
             for (k, lo, hi, _), c in zip(fold_msgs, chunks)], group)
        r4 = fold_halo(rc, M, (H, H + S), recv=recv, chunks=chunks)
        return r4, pl, ll

    def iteration(state: GridState, srcpos, nflux, dt, dr=None,
                  vol_over_scale=None, cosmo_cool_factor=None,
                  lls_grid=None):
        if state.mesh3 != S * M * M:
            raise ValueError(f"state must be the rank's slab of "
                             f"{S * M * M} cells, not {state.mesh3}")
        with span("c2ray.sweep"):
            r4, pl, ll = _trace_slab(state, srcpos, nflux, lls_grid, dr,
                                     vol_over_scale)
        rates = RateGrids(phih=r4[0], phihe0=r4[1], phihe1=r4[2],
                          phiheat=r4[3], photon_loss=pl, lls_loss=ll)
        with span("c2ray.chemistry"):
            new_state, conv = global_chemistry_pass(cfg.chem, state, rates,
                                                    dt, cosmo_cool_factor)
        # the losses and the convergence count summed in one all-reduce
        tot = comm.psum(torch.stack([pl.double(), ll.double(),
                                     conv.double()]), group)
        pl, ll = tot[0].to(pl.dtype), tot[1].to(pl.dtype)
        conv = tot[2].to(torch.int64)
        rates = rates._replace(photon_loss=pl, lls_loss=ll)
        out = (new_state, conv, pl, ll)
        return out + (rates,) if return_rates else out

    return iteration


def _domain_radii(cfg, n_dev: int = 1, extra_halo: int = 0,
                  cap_memory: bool = True, n_channels: int = 5):
    """The dyadic subbox ladder for the domain mode, up to the full
    periodic radius.  With `cap_memory` (the default) and more than one
    device it stops at the last rung whose per-device memory
    (`domain_memory_elements`) stays below the replicated engine's
    (`replicated_memory_elements`), with a warning: photons escaping
    the capped window are booked as photon_loss, the reference's
    max_subbox wall (evolve_source.F90:133-144)."""
    M = cfg.sweep.mesh
    rmax = max_domain_radius(M)
    radii = [r for r in _subbox_radii(cfg) if r <= rmax]
    if not radii or radii[-1] < rmax:
        radii.append(rmax)
    if cap_memory and n_dev > 1:
        budget = replicated_memory_elements(M, n_channels)
        capped = [r for r in radii
                  if domain_memory_elements(M, n_dev, r, extra_halo,
                                            n_channels) <= budget]
        if capped:
            capped_below = len(capped) < len(radii)
            radii = capped
        else:
            capped_below = True
            radii = radii[:1]
        if capped_below:
            warnings.warn(
                "domain-mode subbox ladder memory-capped at radius "
                f"{radii[-1]} (< full periodic {rmax}): photons "
                "escaping the capped window are booked as photon_loss "
                "(the reference's max_subbox wall, "
                "evolve_source.F90:133-144); pass cap_memory=False to "
                "force the full trace", stacklevel=3)
    return radii


def domain_evolve3d(pcfg: ParallelConfig, state: GridState, srcpos,
                    nflux, dt, radius=None, dr=None,
                    cosmo_cool_factor=None, iteration_cache=None,
                    initial_radius=None, lls_grid=None,
                    balance_halo: int = 0,
                    dump_dir=None, dump_interval_s=900.0,
                    start_from_dump=False, split_chem=None,
                    cap_memory: bool = True):
    """Grid-sharded evolve3D: the reference's convergence protocol
    (evolve.F90:147-181) over the domain-decomposed sweep, with the
    adaptive subbox ladder (`_domain_radii`) or a fixed `radius`.

    `state` is the rank's slab (`shard_state_slabs`), and so is the
    result; srcpos / nflux the whole source list (grouped here, by slab
    or with `balance_halo` = E > 0 cost-balanced with E extra halo
    planes); `lls_grid` the whole grid's or the slab's LLS columns.
    `dump_dir` writes mid-iteration dumps, gathered, from rank 0 in the
    single-device format; `start_from_dump` resumes one (of any mode):
    each rank re-applies the dumped rates on its slab.
    `iteration_cache` and `split_chem` are accepted and ignored."""
    from ..io.checkpoint import load_iterdump, save_iterdump

    del iteration_cache, split_chem
    cfg = pcfg.cfg
    group = pcfg.group
    n_dev = comm.axis_size(group)
    dtype, device = state.ndens.dtype, state.ndens.device
    host = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    srcpos, nflux = host(srcpos), host(nflux)
    if balance_halo > 0:
        sp, nf = group_sources_balanced(srcpos, nflux, cfg.sweep.mesh,
                                        n_dev, balance_halo)
    else:
        sp, nf = group_sources_by_slab(srcpos, nflux, cfg.sweep.mesh,
                                       n_dev)
    nf = torch.as_tensor(nf, dtype=dtype, device=device)

    want_rates = dump_dir is not None
    iterations = {}

    def iteration_at(r):
        if r not in iterations:
            iterations[r] = make_domain_iteration(
                pcfg, r, extra_halo=balance_halo, return_rates=want_rates)
        return iterations[r]

    adaptive = radius is None and cfg.use_subbox
    if adaptive:
        radii = _domain_radii(cfg, n_dev=n_dev, extra_halo=balance_halo,
                              cap_memory=cap_memory,
                              n_channels=6 if lls_grid is not None else 5)
        total_strength = _scaled_source_strength(
            cfg.sweep, torch.as_tensor(nflux))
        loss_wall = cfg.min_fraction_of_photons * max(total_strength,
                                                      1e-300)
        r_idx = 0
        if initial_radius is not None:
            while (r_idx + 1 < len(radii)
                   and radii[r_idx] < initial_radius):
                r_idx += 1
    else:
        radii = [radius if radius is not None
                 else max_domain_radius(cfg.sweep.mesh)]
        r_idx = 0
        loss_wall = None   # one radius: never read
    kw = _step_kwargs(cfg, dr, cosmo_cool_factor, lls_grid)

    n = cfg.sweep.mesh ** 3
    num_src = int(np.sum(np.any(nflux > 0, axis=1)))
    conv_criterion = min(int(cfg.convergence_fraction * n),
                         max(num_src, 1))

    niter = 0
    conv_flag = n
    if start_from_dump:
        # mid-timestep resume (evolve.F90:279-367): the dumped
        # pre-iteration state and rates, one chemistry pass on the slab
        niter, st_np, rt_np, meta = load_iterdump(
            dump_dir, GridState, RateGrids, with_meta=True)
        sl = _slab(n, group)
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        rstate = shard_state_slabs(GridState(*(as_t(x) for x in st_np)),
                                   group)
        rrates = RateGrids(*(None if x is None else
                             as_t(x[sl] if np.ndim(x) else x)
                             for x in rt_np))
        state, conv_dev = global_chemistry_pass(
            cfg.chem, rstate, rrates, dt,
            None if cosmo_cool_factor is None else float(cosmo_cool_factor))
        conv_flag = int(comm.psum(conv_dev, group))
        if adaptive and meta.get("subbox_radius"):
            r_sub = int(meta["subbox_radius"])
            while r_idx + 1 < len(radii) and radii[r_idx] < r_sub:
                r_idx += 1
    else:
        state = begin_timestep(state)
    ploss = lls_loss = 0.0
    last_dump = _time.time()
    while True:
        if conv_flag < conv_criterion and niter > 1:
            break
        if niter > cfg.max_iterations:
            break
        niter += 1
        prev_state = state
        out, r_idx, conv_flag, ploss, lls_loss = subbox_iteration(
            lambda r: iteration_at(radii[r])(state, sp, nf, dt, **kw),
            r_idx, len(radii), loss_wall)
        state = out[0]
        if want_rates and dump_due(last_dump, dump_interval_s, device,
                                   group):
            # gather the slabs and write the single-device format (a
            # dump of any mode resumes in any other)
            full = gather_state_slabs(prev_state, group)
            r = out[4]
            g = gather_fields(r, ("phih", "phihe0", "phihe1", "phiheat"),
                              group)
            rates = RateGrids(**g, photon_loss=r.photon_loss,
                              lls_loss=r.lls_loss)
            if comm.rank(group) == 0:
                save_iterdump(dump_dir, niter, full, rates,
                              subbox_radius=radii[r_idx])
            last_dump = _time.time()

    state = finish_timestep(state)
    return state, Evolve3DStats(n_iterations=niter, conv_flag=conv_flag,
                                photon_loss=ploss,
                                subbox_radius=radii[r_idx],
                                lls_loss=lls_loss)


__all__ = ["domain_evolve3d", "exchange_slab_halo", "fold_slab_halo",
           "gather_state_slabs", "shard_field", "group_sources_balanced",
           "group_sources_by_slab", "make_domain_iteration",
           "max_domain_radius", "shard_state_slabs",
           "domain_memory_elements", "replicated_memory_elements"]
