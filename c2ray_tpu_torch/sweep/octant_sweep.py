"""Dense skewed-octant sweep of a source batch.

Port of ``c2ray_tpu/sweep/octant_sweep.py`` (``sweep_octant_source_batch``).
Inside one octant of a source (all offsets toward +-x, +-y, +-z, in the
octant frame (a, b, c) = |offset|) the causal hyperplane a+b+c = s is a
dense triangular slice, stored as a plane P_s[b, c]; every cinterp
corner of a cell on plane s lies on plane s-1, s-2 or s-3 at
[b or b-1, c or c-1]:

    corner (a-da, b-db, c-dc)  ->  plane s-da-db-dc at [b-db, c-dc]

so a sweep carries three planes, not a column cube.  Face cells shared
between octants are computed in each (their values agree: the corner
weights toward the unshared side are exactly 0, column_density.f90:
119-122 with du = 1), and each offset's rates come from one owner
octant: positive octants own the zero faces, negative octants reach
-(M/2-1).  JAX stitches the eight rate cubes back with rolls; here the
owner writes each cell's rates straight into the per-source slab in
absolute coordinates.

`octant_sweep_plain` does that with index tensors over (source, octant,
b, c) per plane; `octant_sweep_cuda` launches the hand-written kernel
``csrc/octant_sweep.cu``, one launch per plane over the plane's valid
positions only, at lanes per cell chosen by its width.  Both return
per-source rate slabs and photon losses, which
`sweep_octant_source_batch` sums over sources in fixed order.  As in
JAX, the LLS loss is 0 even with a
homogeneous LLS column (octant_sweep.py:328, ROADMAP Queue 3), and
`evolve3d`'s `dr`, `vol_over_scale` and `lls_grid` do not reach this
engine.
"""

import ctypes

import numpy as np
import torch

from .. import constants as const
from .. import cuda_build
from ..utils.clocks import count
from .cinterp import MIN_WEIGHT_DENOM, SQRT2, SQRT3, _SIGMAS
from .source_sweep import (_ABU, _BLOCK, RateGrids, SourceFields,
                           SweepConfig, _base_cols, _cell_rates,
                           _check_kernel_inputs, _kernel_tables,
                           _route_args, _same_device, _scalars,
                           _source_group, launch_counter,
                           stack_sweep_fields)

PLANE_LANES = (1, 2, 4, 8)        # kPlaneLanes of csrc/octant_sweep.cu


def _octant_signs():
    """The 8 sign triples; order fixed (octant o = 4 ix + 2 iy + iz, the
    sign negative where the bit is set)."""
    return [(sx, sy, sz) for sx in (1, -1) for sy in (1, -1)
            for sz in (1, -1)]


def _check_mesh(M: int):
    if M % 2 or M < 2:
        raise ValueError(f"the octant engine needs an even mesh, not {M}")


def plane_rows(M: int):
    """The valid positions of every causal plane s = 1..3R (R = M/2) of
    every octant, as rows of consecutive c: for plane s, octant o and b
    in max(0, s - vx - vz)..min(vy, s), c runs from max(0, s - b - vx)
    to min(vz, s - b) (v = R toward +, R - 1 toward -), the validity
    test of `octant_sweep_plain`.  Rows are ordered by (s, o, b).

    Returns numpy int arrays (row0 (3R + 1,): the first row of each
    plane; rows (n_rows, 4): [octant, b, first c, position of the row's
    first cell in its plane's compact order]; cells (3R,): valid
    positions per plane over the 8 octants)."""
    R = M // 2
    s = np.arange(1, 3 * R + 1)[:, None, None]
    o = np.arange(8)[None, :, None]
    b = np.arange(R + 1)[None, None, :]
    vmax = np.where(np.array(_octant_signs()) > 0, R, R - 1)      # (8, 3)
    vx, vy, vz = (vmax[:, k][None, :, None] for k in range(3))
    c_lo = np.maximum(0, s - b - vx)
    n = np.minimum(vz, s - b) - c_lo + 1
    keep = (b <= vy) & (n > 0)                                    # (3R, 8, R+1)
    shape = keep.shape
    sel = np.nonzero(keep)
    n_kept = n[sel]
    per_plane = np.bincount(sel[0], minlength=3 * R)
    row0 = np.concatenate([[0], np.cumsum(per_plane)])
    cells = np.bincount(sel[0], weights=n_kept, minlength=3 * R).astype(
        np.int64)
    ends = np.cumsum(n_kept)
    first = ends - n_kept - np.repeat(np.concatenate([[0], np.cumsum(
        cells)[:-1]]), per_plane)
    rows = np.stack([np.broadcast_to(o, shape)[sel],
                     np.broadcast_to(b, shape)[sel],
                     c_lo[sel], first], axis=1)
    return row0, rows, cells


# a plane of n cell steps over all its sources runs G lanes per cell, G
# of the first (bound, G) with n <= bound, else 1: chosen from every
# plane's device time at each G at the bench's 128^3 x 8 (tools/
# profile_torch_iteration.py --octant --lanes 1,2,4,8; PERF.md)
_LANES_BY_WIDTH = ((12288, 8), (24576, 4), (49152, 2))


def _plane_lanes(n: int) -> int:
    """Lanes per cell of a plane launch of n cell steps over all its
    sources: more lanes where the plane is far below a wave of the card
    (132 SMs x 2048 threads), where one cell's serial band loop sets the
    launch's time; one lane from a fifth of a wave up, where the lanes'
    repeated corner reads, interpolation and row search cost more than
    the shorter band loop saves."""
    for bound, G in _LANES_BY_WIDTH:
        if n <= bound:
            return G
    return 1


_PLANE_TABLES = {}


def _plane_table(M: int, device):
    """(row0, cells, the rows of plane_rows as an (n_rows, 4) int32 table
    on `device`), built once per mesh and device."""
    key = (M, str(device))
    if key not in _PLANE_TABLES:
        row0, rows, cells = plane_rows(M)
        _PLANE_TABLES[key] = (row0, cells, torch.as_tensor(
            rows, dtype=torch.int32).contiguous().to(device))
    return _PLANE_TABLES[key]


def plane_plan(S: int, row0, cells):
    """The launches of a sweep of S sources: per plane s = 1..3R a row
    [first row, rows, cells, lanes per cell, blocks per source, first
    loss slot] (int32, the kernel's PlanePlan), and the loss slots per
    source.  The blocks of a plane cover its cells times its lanes in
    blocks of _BLOCK threads; the planes' slots follow each other."""
    lanes = np.array([_plane_lanes(S * int(n)) for n in cells])
    nblk = -(-cells * lanes // _BLOCK)
    slot0 = np.concatenate([[0], np.cumsum(nblk)[:-1]])
    plan = np.stack([row0[:-1], np.diff(row0), cells, lanes, nblk, slot0],
                    axis=1).astype(np.int32)
    return np.ascontiguousarray(plan), int(nblk.sum())


def _shift_bc(p, db: int, dc: int):
    """Planes p[..., b, c, :] -> p[..., b-db, c-dc, :], zero-padded."""
    out = torch.zeros_like(p)
    B, C = p.shape[-3], p.shape[-2]
    out[..., db:, dc:, :] = p[..., :B - db, :C - dc, :]
    return out


def octant_sweep_plain(cfg: SweepConfig, fstack, srcpos, nflux):
    """Plain PyTorch version of the octant kernel.

    fstack: (M, M, M, 5) stacked fields (M even); srcpos: (S, 3) int;
    nflux: (S, 3).  Returns (slab (S, M^3, 4) per-source rates in
    absolute coordinates, photon_loss (S,)): JAX's one_source
    (octant_sweep.py:295-321) for each source, with its 8 octants side
    by side."""
    _same_device(fstack, srcpos, nflux, cfg)
    M = fstack.shape[0]
    _check_mesh(M)
    R = M // 2
    n = M**3
    S = srcpos.shape[0]
    dtype, device = fstack.dtype, fstack.device
    dr, vos = _scalars(cfg, dtype, device, None, None)
    abu = torch.tensor(_ABU, dtype=dtype, device=device)
    sig = torch.tensor(_SIGMAS, dtype=dtype, device=device)
    f = fstack.reshape(n, 5)
    sp = srcpos.to(dtype=torch.long)
    nfl = nflux.to(dtype=dtype)
    s_idx = torch.arange(S, device=device)

    signs = torch.tensor(_octant_signs(), device=device)          # (8, 3)
    vmax = torch.where(signs > 0, R, R - 1)                       # (8, 3)
    owns = signs > 0
    ar = torch.arange(R + 1, device=device)
    # absolute coordinate of octant-frame index a along each axis:
    # (S, 8, 3, R+1)
    coord = torch.remainder(sp[:, None, :, None]
                            + signs[None, :, :, None] * ar, M)
    b = ar[:, None].expand(R + 1, R + 1)
    c = ar[None, :].expand(R + 1, R + 1)
    bf, cf = b.to(dtype), c.to(dtype)

    slab = torch.zeros((S, n, 4), dtype=dtype, device=device)
    ploss = torch.zeros(S, dtype=dtype, device=device)

    # source cell (evolve_point.F90:140-151) seeds plane 0 of every
    # octant and is deposited once
    flat0 = (coord[:, 0, 0, 0] * M + coord[:, 0, 1, 0]) * M + coord[:, 0, 2, 0]
    f0 = f[flat0]
    bc0 = _base_cols(f0, abu)
    cc0 = bc0 * (0.5 * dr)
    phi0 = _cell_rates(cfg, torch.zeros_like(cc0), cc0, vos, nfl, f0[:, 2])
    slab[s_idx, flat0] = torch.stack(
        [phi0.photo_cell_HI / bc0[:, 0], phi0.photo_cell_HeI / bc0[:, 1],
         phi0.photo_cell_HeII / bc0[:, 2], phi0.heat], dim=-1)
    p1 = torch.zeros((S, 8, R + 1, R + 1, 3), dtype=dtype, device=device)
    p1[:, :, 0, 0] = cc0[:, None, :]
    p2 = torch.zeros_like(p1)
    p3 = torch.zeros_like(p1)

    nfl_cells = nfl.view(S, 1, 1, 1, 3)
    vm = vmax.view(8, 3, 1, 1)
    for s in range(1, 3 * R + 1):
        a = s - b - c                                             # (R+1,)^2
        valid = ((a >= 0) & (a <= vm[:, 0]) & (b <= vm[:, 1])
                 & (c <= vm[:, 2]))                               # (8, ...)
        ac = a.clamp(0, R)
        af = ac.to(dtype)

        # dominant axis (z wins ties, then y; column_density.f90:107,
        # 199,275) and the canonical (u, v)
        is_z = (cf >= bf) & (cf >= af)
        is_y = (~is_z) & (bf >= af) & (bf >= cf)
        dom = torch.where(is_z, 2, torch.where(is_y, 1, 0))
        d_dom = torch.where(is_z, cf, torch.where(is_y, bf, af))
        d_u = torch.where(dom == 0, bf, af)
        d_v = torch.where(dom == 2, bf, cf)
        d_dom = torch.clamp(d_dom, min=1.0)

        alam = (d_dom - 0.5) / d_dom
        du = 2.0 * torch.abs(alam * d_u - (d_u - 0.5))
        dv = 2.0 * torch.abs(alam * d_v - (d_v - 0.5))
        s1 = (1.0 - du) * (1.0 - dv)
        s2 = du * (1.0 - dv)
        s3 = (1.0 - du) * dv
        s4 = du * dv

        # corners as shifted planes (octant_sweep.py:188-206)
        c1 = _shift_bc(p3, 1, 1)
        p1s_01, p1s_10 = _shift_bc(p1, 0, 1), _shift_bc(p1, 1, 0)
        p2s_11 = _shift_bc(p2, 1, 1)
        p2s_01, p2s_10 = _shift_bc(p2, 0, 1), _shift_bc(p2, 1, 0)
        dom3 = dom[..., None]
        c4 = torch.where(dom3 == 2, p1s_01, torch.where(dom3 == 1, p1s_10, p1))
        c2 = torch.where(dom3 == 0, p2s_01, p2s_11)
        c3 = torch.where(dom3 == 2, p2s_01, p2s_10)

        w = lambda sg, cc: sg[..., None] / torch.clamp(cc * sig,
                                                       min=MIN_WEIGHT_DENOM)
        w1, w2, w3, w4 = w(s1, c1), w(s2, c2), w(s3, c3), w(s4, c4)
        wsum = w1 + w2 + w3 + w4
        cd_in = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / wsum

        # diagonal boost (column_density.f90:174-184)
        on_diag = (d_dom == 1.0) & ((d_u == 1.0) | (d_v == 1.0))
        full_diag = (d_u == 1.0) & (d_v == 1.0)
        boost = torch.ones_like(d_dom)
        boost[on_diag] = SQRT2
        boost[on_diag & full_diag] = SQRT3
        cd_in = cd_in * boost[..., None]

        path_units = torch.sqrt((d_u * d_u + d_v * d_v) / (d_dom * d_dom)
                                + 1.0)
        path = path_units * dr
        if cfg.coldensh_LLS > 0.0:
            # LLS fog (evolve_point.F90:177-180); no LLS loss here
            cd_in[..., 0] += cfg.coldensh_LLS * path_units

        # the cells of plane s: (S, 8, R+1, R+1)
        flat = ((coord[:, :, 0][:, :, ac] * M + coord[:, :, 1][:, :, b]) * M
                + coord[:, :, 2][:, :, c])
        fc = f[flat]
        bcols = _base_cols(fc, abu)
        cd_out = cd_in + bcols * path[..., None]
        # invalid positions carry zeros: later planes' corner reads see
        # untouched cells as zero columns
        plane = torch.where(valid[..., None], cd_out, 0.0)

        dist2 = af * af + bf * bf + cf * cf
        vol_ratio = 4.0 * const.pi * dist2 * path_units
        phi = _cell_rates(cfg, cd_in, cd_out, vol_ratio * vos, nfl_cells,
                          fc[..., 2])
        live = valid & (cd_in[..., 0] < cfg.max_coldensh)
        fl = live.to(dtype)
        rates = torch.stack(
            [fl * phi.photo_cell_HI / bcols[..., 0],
             fl * phi.photo_cell_HeI / bcols[..., 1],
             fl * phi.photo_cell_HeII / bcols[..., 2],
             fl * phi.heat], dim=-1)

        on_bound = (a == vm[:, 0]) | (b == vm[:, 1]) | (c == vm[:, 2])
        o3 = owns.view(8, 3, 1, 1)
        owned = (((a > 0) | o3[:, 0]) & ((b > 0) | o3[:, 1])
                 & ((c > 0) | o3[:, 2]))
        ploss = ploss + torch.where(live & on_bound & owned,
                                    phi.photo_out / vol_ratio,
                                    0.0).sum(dim=(1, 2, 3))
        dep = valid & owned                                       # (8, ...)
        slab[s_idx[:, None], flat[:, dep]] = rates[:, dep]
        p1, p2, p3 = plane, p1, p2
    return slab, ploss


def octant_sweep_cuda(cfg: SweepConfig, fstack, srcpos, nflux):
    """The octant kernel (``csrc/octant_sweep.cu``); same contract as
    `octant_sweep_plain`.

    Replaces octant_sweep.py:sweep_octant_source_batch (its vmaps over
    sources and octants, the plane scan and the stitch), with
    quadrature.py:_one_source_quad through the shared cell step
    (csrc/short_char.cuh).  Bound on the card by the K-node
    exponentials of the owned cells; a source's planes take 8 x 4 x
    (M/2+1)^2 x 3 values, no column cube.  Each plane launches its
    valid positions only (plane_rows), at the lanes per cell of
    `_plane_lanes`; the ring starts filled with NaN, so a read of a
    position the sweep did not write would show in the outputs.
    """
    _check_kernel_inputs(fstack, srcpos, nflux, cfg)
    M, S = fstack.shape[0], srcpos.shape[0]
    _check_mesh(M)
    R = M // 2
    dtype, device = fstack.dtype, fstack.device
    kt = _kernel_tables(cfg, dtype)
    K, type_ints, route, route_ptrs = _route_args(kt)
    fields = fstack.contiguous()
    sp = srcpos.to(dtype=torch.int32).contiguous()
    nfl = nflux.to(dtype=dtype).contiguous()
    row0, cells, rows = _plane_table(M, device)
    plan, nslots = plane_plan(S, row0, cells)

    lib = cuda_build.load("octant_sweep")
    ring = torch.full((S, 8, 4, R + 1, R + 1, 3), float("nan"), dtype=dtype,
                      device=device)
    slab = torch.zeros((S, M**3, 4), dtype=dtype, device=device)
    partials = torch.zeros((S, nslots), dtype=dtype, device=device)
    name = ("octant_sweep_" + ("heat_" if kt.heat else "")
            + ("f32" if dtype == torch.float32 else "f64"))
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 14
                   + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    err = fn(P(fields), P(sp), P(nfl), P(kt.packed), P(rows), P(ring),
             P(slab), P(partials), plan.ctypes.data_as(ctypes.c_void_p),
             nslots, M, S, K, *type_ints, float(cfg.dr),
             float(cfg.vol / cfg.flux_scale), float(cfg.coldensh_LLS),
             float(cfg.max_coldensh), *route_ptrs,
             cuda_build.stream_of(fields))
    cuda_build.check(err, name)
    # one count a call (a kernel per plane), by route and variant, and
    # the plane launches by lanes per cell
    count(launch_counter("octant_sweep", kt))
    for G, n in zip(*np.unique(plan[plan[:, 2] > 0, 3], return_counts=True)):
        count(f"launches.octant_sweep.lanes{int(G)}", int(n))
    return slab, partials.sum(dim=1)


def _octant_trace(fstack):
    if fstack.is_cuda:
        return octant_sweep_cuda
    if fstack.device.type == "cpu":
        return octant_sweep_plain
    raise ValueError(f"no sweep for device {fstack.device}")


def sweep_octant_source_batch(cfg: SweepConfig, fields: SourceFields,
                              srcpos_batch, nflux_batch) -> RateGrids:
    """Dense-octant trace of a source batch; same contract as
    `sweep_sources_accumulate` (lls_loss is 0).

    Requires an even cubic mesh (trace extents M/2 forward, M/2-1
    backward, evolve_source.F90:103-109).  CUDA tensors go through the
    kernel, CPU tensors through the plain version; sources whose fluxes
    are all zero contribute nothing.  The batch is swept in groups of
    `_source_group` sources, the groups' sums added in order.
    """
    M = cfg.mesh
    fstack = stack_sweep_fields(cfg, fields)
    dtype, device = fstack.dtype, fstack.device
    trace = _octant_trace(fstack)
    rg = torch.zeros((M**3, 4), dtype=dtype, device=device)
    pl = torch.zeros((), dtype=dtype, device=device)
    S = srcpos_batch.shape[0]
    group = _source_group(cfg, S, M, fstack.element_size())
    for g0 in range(0, S, group):
        nf = nflux_batch[g0:g0 + group]
        slab, ploss = trace(cfg, fstack, srcpos_batch[g0:g0 + group], nf)
        live = torch.any(nf > 0.0, dim=1)
        rg = rg + torch.where(live[:, None, None], slab, 0.0).sum(dim=0)
        pl = pl + torch.where(live, ploss, 0.0).sum()
    return RateGrids(phih=rg[:, 0], phihe0=rg[:, 1], phihe1=rg[:, 2],
                     phiheat=rg[:, 3], photon_loss=pl,
                     lls_loss=torch.zeros_like(pl))
