"""Pyramid short-characteristics sweep of a source batch.

Port of ``c2ray_tpu/sweep/pyramid_sweep.py``.  The domain around each
source splits into six dominant-axis pyramids (the partition cinterp's
dominant-axis choice induces, column_density.f90:107,199,275, ties
z > y > x).  A stage-m cell at |offset_m| = l reads its four cinterp
corners on layer l-1 along m only, so the causal order is: layers
l = 1..Rf, and within a layer stage x, then y, then z.

The JAX version carries only plane windows through a scan, because 3D
updates are expensive on a TPU.  Here every source keeps its 3D
outgoing-column cube cd[s] (source-centred, index ctr + offset with
ctr = M/2 - 1) and each (layer, stage) step reads its corners straight
from it.  `trace_plain` does that with index tensors; `trace_cuda`
launches the hand-written kernel ``csrc/pyramid_sweep.cu``, one launch
per (layer, stage) over (source, sign, u, v).  Both return the same
per-source rate slabs and losses (optionally the per-band escape and a
per-cell LLS column), which `sweep_pyramid_source_batch` sums over
sources in fixed order: on the card with the hand-written pass
``csrc/group_accumulate.cu`` (`accumulate_group_cuda`), which reads each
live slab once into the rate grids.

Memory: cd is S x M^3 x 3 and the slab S x M^3 x 4 values: 470 MB at
128^3 x 8 sources in float32, 3.8 GB at 256^3.  A batch is swept in
groups of sources (JAX's `_source_chunk`) so that a group's cd and slab
stay under `source_sweep._GROUP_BYTES`; the groups' sums are added in
order.  The kernel writes every cd cell it reads before reading it and
every loss slot, so `trace_cuda` zeroes neither; the slab only where the
extents leave cells of the cube unwritten (`zeroed_buffers`).
"""

import ctypes
import math

import torch

from .. import constants as const
from .. import cuda_build
from ..utils.clocks import count, span
from .cinterp import MIN_WEIGHT_DENOM, SQRT2, SQRT3, _SIGMAS
# stack_sweep_fields, _kernel_tables, _source_group and sweep_heats are
# also this module's names for its callers (the tests, chip_smoke.py)
from .source_sweep import (_ABU, RateGrids, SourceFields, SweepConfig,
                           _cell_rates, _kernel_tables, _nbytes, _route_args,
                           _same_device, _scalars, _source_group,
                           launch_counter, stack_sweep_fields, sweep_heats)

def trace_extents(M: int, radius=None):
    """Forward / backward trace extents (Rf, Rb): +M/2 / -(M/2-1) by
    default (evolve_source.F90:103-109), cut to +-radius."""
    R = M // 2
    if radius is None:
        return R, R - 1
    return min(radius, R), min(radius, R - 1)


def covers_cube(M: int, Rf: int, Rb: int) -> bool:
    """Whether the extents [-Rb, Rf] reach every cell of an M-cube along
    each axis, so that the sweep writes every slab cell exactly once.
    The stage kernels run the layers 1..Rf, so backward layers beyond
    Rf would stay unwritten."""
    return Rb <= Rf and Rf + Rb + 1 >= M


def zeroed_buffers(M: int, Rf: int, Rb: int, track: bool) -> tuple:
    """The buffers a sweep over [-Rb, Rf] must zero: the slab unless the
    extents cover the cube (cells outside the box read 0), the partials
    when no stage block runs (Rf = 0), and the band escape, which only
    blocks holding a boundary cell write.  The kernel writes every other
    element before anything reads it."""
    return ((() if covers_cube(M, Rf, Rb) else ("slab",))
            + (() if Rf >= 1 else ("partials",))
            + (("band_partials",) if track else ()))


def zeroed_bytes(shapes: dict, zeroed, itemsize: int) -> int:
    """The bytes a sweep zeroes (counter sweep.zeroed_bytes)."""
    return sum(math.prod(shapes[n]) for n in zeroed) * itemsize


def sweep_buffers(shapes: dict, zeroed, dtype, device) -> dict:
    """The buffers of `shapes`: zeroed where `zeroed` names them, else
    left as the allocator gives them, for the launches to overwrite."""
    return {n: (torch.zeros if n in zeroed else torch.empty)(
        shape, dtype=dtype, device=device) for n, shape in shapes.items()}


def trace_plain(cfg: SweepConfig, fstack, srcpos, nflux, Rf: int, Rb: int,
                dr=None, vol_over_scale=None, lls=None, track=False):
    """Plain PyTorch version of the sweep kernel.

    fstack: (M, M, M, 5) stacked fields; srcpos: (S, 3) int; nflux:
    (S, 3); `lls` (M^3,) per-cell LLS columns (position-dependent LLS,
    evolve_point.F90:177-180), in place of cfg.coldensh_LLS; `track`
    also returns the per-band escape.  Returns (slab (S, M^3, 4)
    per-source rates in absolute coordinates, photon_loss (S,),
    lls_loss (S,), photon_loss_bands (S, nbands) or None)."""
    _same_device(fstack, srcpos, nflux, cfg)
    M = fstack.shape[0]
    ctr = M // 2 - 1
    S = srcpos.shape[0]
    dtype, device = fstack.dtype, fstack.device
    dr, vos = _scalars(cfg, dtype, device, dr, vol_over_scale)
    abu = torch.tensor(_ABU, dtype=dtype, device=device)
    sig = torch.tensor(_SIGMAS, dtype=dtype, device=device)
    f = fstack.reshape(M**3, 5)
    sp = srcpos.to(dtype=torch.long)
    nfl = nflux.to(dtype=dtype)
    s_idx = torch.arange(S, device=device)

    cd = torch.zeros((S, M, M, M, 3), dtype=dtype, device=device)
    slab = torch.zeros((S, M**3, 4), dtype=dtype, device=device)
    ploss = torch.zeros(S, dtype=dtype, device=device)
    lloss = torch.zeros(S, dtype=dtype, device=device)
    plb = (torch.zeros((S, cfg.tables.sigma_HI.shape[0]), dtype=dtype,
                       device=device) if track else None)
    count("sweep.zeroed_bytes", _nbytes(cd, slab, ploss, lloss, plb))
    lls_cells = None if lls is None else lls.reshape(-1)

    def flat_of(off):
        """absolute flat index of (srcpos + off) mod M; off (..., 3)."""
        pos = torch.remainder(sp.view((S,) + (1,) * (off.ndim - 1) + (3,))
                              + off, M)
        return (pos[..., 0] * M + pos[..., 1]) * M + pos[..., 2]

    def base_cols(fc):
        return (torch.stack([fc[..., 1], fc[..., 3], fc[..., 4]], dim=-1)
                * fc[..., 0:1] * abu)

    # source cell (evolve_point.F90:140-151) seeds cd with half-cell
    # columns and gets its own rates
    flat0 = flat_of(torch.zeros(3, dtype=torch.long, device=device))
    f0 = f[flat0]
    bc0 = base_cols(f0)
    cc0 = bc0 * (0.5 * dr)
    cd[s_idx, ctr, ctr, ctr] = cc0
    phi0 = _cell_rates(cfg, torch.zeros_like(cc0), cc0, vos, nfl, f0[:, 2])
    slab[s_idx, flat0] = torch.stack(
        [phi0.photo_cell_HI / bc0[:, 0], phi0.photo_cell_HeI / bc0[:, 1],
         phi0.photo_cell_HeII / bc0[:, 2], phi0.heat], dim=-1)

    nfl_cells = nfl.view(S, 1, 1, 1, 3)
    sign = torch.tensor([1, -1], device=device).view(2, 1, 1)
    for l in range(1, Rf + 1):
        o = torch.arange(-l, l + 1, device=device)
        U, V = torch.meshgrid(o, o, indexing="ij")            # (W, W)
        su, sv = torch.sign(U), torch.sign(V)
        lf = torch.tensor(float(l), dtype=dtype, device=device)
        d_u, d_v = U.abs().to(dtype), V.abs().to(dtype)
        alam = (lf - 0.5) / lf
        du = 2.0 * torch.abs(alam * d_u - (d_u - 0.5))
        dv = 2.0 * torch.abs(alam * d_v - (d_v - 0.5))
        s1 = (1.0 - du) * (1.0 - dv)
        s2 = du * (1.0 - dv)
        s3 = (1.0 - du) * dv
        s4 = du * dv
        on_diag = (l == 1) & ((d_u == 1.0) | (d_v == 1.0))
        full_diag = (d_u == 1.0) & (d_v == 1.0)
        boost = torch.where(
            on_diag, torch.where(full_diag, torch.full_like(d_u, SQRT3),
                                 torch.full_like(d_u, SQRT2)),
            torch.ones_like(d_u))
        path_units = torch.sqrt((d_u * d_u + d_v * d_v) / (lf * lf) + 1.0)
        path = path_units * dr
        dist2 = d_u * d_u + d_v * d_v + lf * lf
        vol_ratio = 4.0 * const.pi * dist2 * path_units
        in_dom = (U >= -Rb) & (U <= Rf) & (V >= -Rb) & (V <= Rf)
        bnd_uv = (U == Rf) | (U == -Rb) | (V == Rf) | (V == -Rb)
        sign_ok = torch.tensor([l <= Rf, l <= Rb], device=device)
        on_bound = bnd_uv | torch.tensor(
            [l == Rf, l == Rb], device=device).view(2, 1, 1)   # (2, W, W)
        lls_scalar = (cfg.coldensh_LLS * path_units
                      if cfg.coldensh_LLS > 0.0 else None)

        for m in range(3):
            au, av = (1, 2) if m == 0 else ((0, 2) if m == 1 else (0, 1))
            lim_u = l - 1 if m == 0 else l
            lim_v = l if m == 2 else l - 1
            valid = (((U.abs() <= lim_u) & (V.abs() <= lim_v) & in_dom)[None]
                     & sign_ok.view(2, 1, 1))                 # (2, W, W)

            def offsets(om, ou, ov):
                off = torch.empty((2,) + U.shape + (3,), dtype=torch.long,
                                  device=device)
                off[..., m] = om
                off[..., au] = ou
                off[..., av] = ov
                return off

            def corner(off):
                # clamp: only invalid cells can point outside the cube
                i = torch.clamp(ctr + off, 0, M - 1)
                return cd[:, i[..., 0], i[..., 1], i[..., 2]]  # (S,2,W,W,3)

            om = sign * (l - 1)
            c4 = corner(offsets(om, U, V))                     # W
            c3 = corner(offsets(om, U - su, V))                # C_mu
            c2 = corner(offsets(om, U, V - sv))                # C_mv
            c1 = corner(offsets(om, U - su, V - sv))           # C_mm

            w = lambda s, c: s[..., None] / torch.clamp(c * sig,
                                                        min=MIN_WEIGHT_DENOM)
            w1, w2, w3, w4 = w(s1, c1), w(s2, c2), w(s3, c3), w(s4, c4)
            wsum = w1 + w2 + w3 + w4
            cd_in = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / wsum
            cd_in = cd_in * boost[..., None]
            off = offsets(sign * l, U, V)
            flat = flat_of(off)                                # (S,2,W,W)
            # the LLS column of the cell being entered
            # (pyramid_sweep.py:253-267), or the homogeneous one
            lls_add = (lls_cells[flat] * path_units if lls_cells is not None
                       else lls_scalar)
            if lls_add is not None:
                cd_in[..., 0] += lls_add
            fc = f[flat]
            bcols = base_cols(fc)
            cd_out = cd_in + bcols * path[..., None]
            phi = _cell_rates(cfg, cd_in, cd_out, vol_ratio * vos,
                              nfl_cells, fc[..., 2], track_bands=track)

            live = valid & (cd_in[..., 0] < cfg.max_coldensh)
            fl = live.to(dtype)
            rates = torch.stack(
                [fl * phi.photo_cell_HI / bcols[..., 0],
                 fl * phi.photo_cell_HeI / bcols[..., 1],
                 fl * phi.photo_cell_HeII / bcols[..., 2],
                 fl * phi.heat], dim=-1)
            ploss = ploss + torch.where(
                live & on_bound, phi.photo_out / vol_ratio,
                0.0).sum(dim=(1, 2, 3))
            if track:
                plb = plb + torch.where(
                    (live & on_bound)[..., None],
                    phi.photo_out_bands / vol_ratio[..., None],
                    0.0).sum(dim=(1, 2, 3))
            if lls_add is not None:
                # photons absorbed by the LLS fog (total_LLS_loss,
                # photonstatistics.f90:250-267)
                tau_lls = const.sigma_HI_at_ion_freq * lls_add
                lloss = lloss + torch.where(
                    live, phi.photo_in / vol_ratio * (-torch.expm1(-tau_lls)),
                    0.0).sum(dim=(1, 2, 3))

            # write the valid cells; the rest of cd and slab stays 0
            ov = ctr + off[valid]                              # (nv, 3)
            cd[:, ov[:, 0], ov[:, 1], ov[:, 2]] = cd_out[:, valid]
            slab[s_idx[:, None], flat[:, valid]] = rates[:, valid]
    return slab, ploss, lloss, plb


def trace_cuda(cfg: SweepConfig, fstack, srcpos, nflux, Rf: int, Rb: int,
               dr=None, vol_over_scale=None, lls=None, track=False):
    """The sweep kernel (``csrc/pyramid_sweep.cu``); same contract as
    `trace_plain`.

    Replaces pyramid_sweep.py:trace_centered + the source vmap of
    sweep_pyramid_source_batch, with quadrature.py:_one_source_quad
    inlined: its isothermal branch, or with heating its heating branch
    too (the per-species heating and the secondary-ionization terms);
    with `lls` the per-cell LLS channel, with `track` the band-resolved
    escape (track_bands).  Bound on the card by the K-node exponentials
    (about 400 per cell and source at the bench configuration), so the
    design spends nothing on data movement that a plane-window carry
    would save: corners are read straight from the 3D column cube,
    tables sit in shared memory, and the losses reduce per block with no
    atomics.
    """
    if not fstack.is_cuda:
        raise ValueError("the sweep kernel takes CUDA tensors")
    _same_device(fstack, srcpos, nflux, cfg)
    M = fstack.shape[0]
    S = srcpos.shape[0]
    dtype, device = fstack.dtype, fstack.device
    if not 0 < S <= 65535:
        raise ValueError(f"the sweep kernel takes 1..65535 sources, not {S}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep kernel takes float32/float64, not {dtype}")
    if M % 2 or fstack.shape != (M, M, M, 5):
        raise ValueError(f"fields must be (M, M, M, 5) with M even, got "
                         f"{tuple(fstack.shape)}")
    if lls is not None:
        lls = lls.reshape(-1)
        if lls.shape != (M**3,) or lls.dtype != dtype or lls.device != device:
            raise ValueError(f"lls must be ({M**3},) {dtype} on {device}")
        lls = lls.contiguous()
    kt = _kernel_tables(cfg, dtype, track)
    K, type_ints, route, route_ptrs = _route_args(kt)
    heat = kt.heat
    nb_all = cfg.tables.sigma_HI.shape[0]
    fields = fstack.contiguous()
    sp = srcpos.to(dtype=torch.int32).contiguous()
    nfl = nflux.to(dtype=dtype).contiguous()
    dr_t, vos_t = _scalars(cfg, torch.float64, "cpu", dr, vol_over_scale)

    lib = cuda_build.load("pyramid_sweep")
    lib.pyramid_sweep_slots.argtypes = [ctypes.c_int]
    lib.pyramid_sweep_slots.restype = ctypes.c_int
    nslots = max(lib.pyramid_sweep_slots(Rf), 1)
    shapes = dict(cd=(S, M, M, M, 3), slab=(S, M**3, 4),
                  partials=(S, nslots, 2))
    if track:
        shapes["band_partials"] = (S, nslots, nb_all)
    zeroed = zeroed_buffers(M, Rf, Rb, track)
    buf = sweep_buffers(shapes, zeroed, dtype, device)
    cd, slab, partials = buf["cd"], buf["slab"], buf["partials"]
    band_partials = buf.get("band_partials")
    name = ("pyramid_sweep_" + ("heat_" if heat else "")
            + ("track_" if track else "")
            + ("f32" if dtype == torch.float32 else "f64"))
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 16
                   + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    null = ctypes.c_void_p(None)
    err = fn(P(fields), P(sp), P(nfl), P(kt.packed),
             null if lls is None else P(lls), P(cd), P(slab), P(partials),
             null if band_partials is None else P(band_partials),
             M, S, Rf, Rb, K, type_ints[0], nb_all, *type_ints[1:],
             float(dr_t), float(vos_t), float(cfg.coldensh_LLS),
             float(cfg.max_coldensh), *route_ptrs,
             cuda_build.stream_of(fields))
    cuda_build.check(err, name)
    # one count a call (the 3 * Rf stage kernels of one sweep) in the
    # counter of its variant: the route's on the tau tables and the
    # "auto" blocks, else with a per-cell LLS grid, else with band
    # tracking, else the fixed rule's (isothermal or heating)
    if kt.K >= 0 and (lls is not None or track):
        count("launches.pyramid_sweep." + ("lls" if lls is not None
                                           else "track"))
    else:
        count(launch_counter("pyramid_sweep", kt))
    # the source cells' launch, then three stages a layer
    count("sweep.kernels", 1 + 3 * Rf)
    count("sweep.zeroed_bytes",
          zeroed_bytes(shapes, zeroed, fields.element_size()))
    if "slab" not in zeroed:
        count("sweep.covering_groups")
    losses = partials.sum(dim=1)
    plb = band_partials.sum(dim=1) if track else None
    return slab, losses[:, 0], losses[:, 1], plb


def accumulate_group_plain(rg, slab, live):
    """Plain version of `accumulate_group_cuda`: rg plus the sum over
    sources of the slabs (S, M^3, 4), a source that `live` (S,) drops
    adding 0."""
    return rg + torch.where(live[:, None, None], slab, 0.0).sum(dim=0)


def accumulate_group_cuda(rg, slab, live):
    """Adds the live sources' slabs (S, M^3, 4) into the rate grids rg
    (M^3, 4) in place and returns rg: per cell the slabs in source order
    (0 for a dropped source), then that sum into rg
    (``csrc/group_accumulate.cu``).  One pass: each live slab read once,
    rg read and written once; `live` stays on the device."""
    S = slab.shape[0]
    if not slab.is_cuda:
        raise ValueError("the group sum kernel takes CUDA tensors")
    if (slab.dtype not in (torch.float32, torch.float64)
            or rg.dtype != slab.dtype or live.dtype != torch.bool):
        raise TypeError(f"group sum takes float32/float64 slab and rg and "
                        f"a bool mask, not {slab.dtype}, {rg.dtype}, "
                        f"{live.dtype}")
    if (S < 1 or slab.shape[1:] != rg.shape or rg.shape[-1:] != (4,)
            or live.shape != (S,) or {rg.device, live.device} != {slab.device}
            or not (rg.is_contiguous() and slab.is_contiguous())
            or (rg.data_ptr() | slab.data_ptr()) % 16):
        raise ValueError(f"group sum takes slab (S, n, 4), rg (n, 4) and "
                         f"live (S,) on one device, slab and rg contiguous "
                         f"and 16-byte aligned: {tuple(slab.shape)}, "
                         f"{tuple(rg.shape)}, {tuple(live.shape)}")
    lib = cuda_build.load("group_accumulate")
    name = "group_accumulate_" + ("f32" if slab.dtype == torch.float32
                                  else "f64")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    words = rg.numel() * rg.element_size() // 16
    err = fn(P(rg), P(slab), P(live.contiguous()), S, words,
             cuda_build.stream_of(rg))
    cuda_build.check(err, name)
    count("launches.group_accumulate")
    return rg


def sweep_pyramid_source_batch(cfg: SweepConfig, fields: SourceFields,
                               srcpos_batch, nflux_batch, radius: int = None,
                               dr=None, vol_over_scale=None,
                               lls_grid=None) -> RateGrids:
    """Pyramid trace of a source batch (even cubic mesh; default trace
    extents +M/2 / -(M/2-1), evolve_source.F90:103-109).

    `radius` restricts the trace to a subbox of +-radius cells around
    each source (evolve_source.F90:114-144): rates outside are zero and
    photons crossing the subbox surface count as photon loss.  `dr` and
    `vol_over_scale` override the configuration's cell size and its
    host-computed dr^3/flux_scale.  `lls_grid` (mesh^3,) gives each
    cell's LLS column (the position-dependent LLS model, type 2,
    mat_ini_test.F90:667-763, and the driver's z-evolving type 1), in
    place of cfg.coldensh_LLS.  With cfg.track_band_loss the result
    carries photon_loss_bands.

    CUDA tensors go through the kernels, CPU tensors through the plain
    versions; sources whose fluxes are all zero contribute nothing, and a
    batch of no sources gives zero rates without launching anything.
    The batch is swept in groups of `_source_group` sources; each
    group's sum over its sources is added to the total in group order
    (with one group, the plain sum over sources).
    """
    M = cfg.mesh
    with span("c2ray.sweep.stack"):
        fstack = stack_sweep_fields(cfg, fields)
    dtype, device = fstack.dtype, fstack.device
    Rf, Rb = trace_extents(M, radius)
    if fstack.is_cuda:
        trace, accumulate = trace_cuda, accumulate_group_cuda
    elif device.type == "cpu":
        trace, accumulate = trace_plain, accumulate_group_plain
    else:
        raise ValueError(f"no sweep for device {device}")
    track = cfg.track_band_loss
    lls = (None if lls_grid is None else
           torch.as_tensor(lls_grid, dtype=dtype, device=device).reshape(-1))
    rg = torch.zeros((M**3, 4), dtype=dtype, device=device)
    pl = torch.zeros((), dtype=dtype, device=device)
    ll = torch.zeros((), dtype=dtype, device=device)
    plb = (torch.zeros(cfg.tables.sigma_HI.shape[0], dtype=dtype,
                       device=device) if track else None)
    S = srcpos_batch.shape[0]
    group = _source_group(cfg, S, M, fstack.element_size())
    for g0 in range(0, S, group):
        sp = srcpos_batch[g0:g0 + group]
        nf = nflux_batch[g0:g0 + group]
        with span("c2ray.sweep.group"):
            slab, ploss, lloss, plb_g = trace(cfg, fstack, sp, nf, Rf, Rb,
                                              dr, vol_over_scale, lls=lls,
                                              track=track)
        count("sweep.groups")
        with span("c2ray.sweep.sum"):
            live = torch.any(nf > 0.0, dim=1)
            rg = accumulate(rg, slab, live)
            pl = pl + torch.where(live, ploss, 0.0).sum()
            ll = ll + torch.where(live, lloss, 0.0).sum()
            if track:
                plb = plb + torch.where(live[:, None], plb_g,
                                        0.0).sum(dim=0)
        count("sweep.summed_bytes", _nbytes(slab))
    return RateGrids(phih=rg[:, 0], phihe0=rg[:, 1], phihe1=rg[:, 2],
                     phiheat=rg[:, 3], photon_loss=pl, lls_loss=ll,
                     photon_loss_bands=plb)
