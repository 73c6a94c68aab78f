"""Sweep configuration, field and rate records, what every sweep engine
shares, and the L1-shell engine.

Port of ``c2ray_tpu/sweep/source_sweep.py`` (``do_source`` /
``evolve0D``, evolve_source.F90:66-238, evolve_point.F90:79-319).  The
L1-shell engine traces the general extents (odd meshes, a max_subbox
below M/2 - 1): shells |di|+|dj|+|dk| = 1..n in order, each one batch
(sweep/geometry.py).  `shell_sweep_plain` is JAX's
`_sweep_one_source_stacked` under the source vmap, in PyTorch;
`shell_sweep_cuda` launches the hand-written kernel
``csrc/shell_sweep.cu``, one launch per shell over (source, cell of the
shell).  Both keep a per-source outgoing-column cube in absolute
coordinates and return per-source rate slabs and losses, which
`sweep_sources_accumulate` sums over sources in fixed order.

The shell kernels take the cell size and the LLS column from the
configuration: `sweep_sources_accumulate` puts a step's `dr` and per-cell
`lls_grid` into it (`dataclasses.replace`), so a cosmological step
sweeps at its own cell size and LLS column, as the pyramid engine does.
JAX's shell engine keeps the first step's (a decided deviation, ROADMAP
Queue 3).

Every engine takes either rate route of JAX's `_cell_rates`: quadrature
tables (`QuadTables`, a fixed rule or the "auto" blocks) or the tau
tables (`RadiationTables`, the reference-parity lookup); the kernels
take the route as a template parameter (``csrc/table_rates.cuh``).
"""

import ctypes
import math
from dataclasses import dataclass, field, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from .. import cuda_build
from ..radiation.photo import photoion_rates
from ..radiation.quadrature import (QuadTables, packed_band_blocks,
                                    packed_node_groups, photoion_rates_quad,
                                    rates_heat, uniform_band_rows)
from ..radiation.tables import (RadiationTables, pack_tau_columns,
                                packed_table_route)
from ..utils.clocks import count, span
from .cinterp import cinterp_shell
from .geometry import ShellTable

# evolve_point.F90:91 -- stop rate computation in fully shielded cells
MAX_COLDENSH = 2.0e29

# abundance weights per species column, order (HI, HeI, HeII)
_ABU = (1.0 - const.abu_he, const.abu_he, const.abu_he)

# auto source group: a group's column cube and slab (7 values per cell
# and source) stay under this many bytes
_GROUP_BYTES = 4 * 2**30


@dataclass(frozen=True)
class SweepConfig:
    """Static sweep configuration.  `tables` are quadrature tables
    (`QuadTables`: a fixed rule, or "auto" blocks) or tau tables
    (`RadiationTables`); `track_band_loss` needs quadrature tables."""

    tables: "QuadTables | RadiationTables"
    mesh: int
    dr: float
    isothermal: bool = False
    epsilon: float = 1.0e-20
    max_coldensh: float = MAX_COLDENSH
    # homogeneous LLS opacity column per cell (type 1,
    # c2ray_parameters.f90:72-78); 0 disables
    coldensh_LLS: float = 0.0
    # tables were built divided by this (float32 range guard); the
    # sweep divides the shell volume by it so cell rates come out
    # physical
    flux_scale: float = 1.0
    has_bb: bool = True
    has_pl: bool = False
    has_qso: bool = False
    # shell engine: sources swept together per group (JAX's vmap width,
    # sweep_sources_accumulate's default batch_size); 0 = as the pyramid
    # and octant engines group them (`_source_group`)
    source_batch: int = 0
    # sources swept together per group (0 = auto: the group's column
    # cube and rate slab, S x M^3 x 7 values, under a fixed byte budget)
    source_chunk: int = 0
    # track the escaping-photon rate over the full band axis: the input
    # of the photon-loss redistribution (sweep/photon_losses.py;
    # pyramid engine only)
    track_band_loss: bool = False
    # shell engine: (mesh^3,) LLS column of each cell, in place of
    # coldensh_LLS (the step's, put here by sweep_sources_accumulate)
    lls_grid: Optional[torch.Tensor] = field(default=None, compare=False,
                                             repr=False)
    # the kernels' packed tables (`_kernel_tables`), made at the first
    # launch and kept for the next ones; a configuration made from this
    # one by dataclasses.replace shares them, keyed by the tables' identity
    kernel_cache: dict = field(default_factory=dict, compare=False,
                               repr=False)

    @property
    def vol(self) -> float:
        return self.dr**3


class SourceFields(NamedTuple):
    """Flattened (mesh^3,) grid fields the sweep reads."""

    ndens: torch.Tensor
    h_av0: torch.Tensor
    h_av1: torch.Tensor
    he_av0: torch.Tensor
    he_av1: torch.Tensor


class RateGrids(NamedTuple):
    """Flattened (mesh^3,) accumulated rate grids (evolve_data.F90:40-49)
    and the iteration's photon and LLS losses (0-d tensors)."""

    phih: torch.Tensor
    phihe0: torch.Tensor
    phihe1: torch.Tensor
    phiheat: torch.Tensor
    photon_loss: torch.Tensor
    lls_loss: torch.Tensor
    # (nbands,) escaping-photon rate per band when the sweep ran with
    # track_band_loss, else None
    photon_loss_bands: Optional[torch.Tensor] = None


def zero_rate_grids(mesh: int, dtype, device=None) -> RateGrids:
    z = torch.zeros(mesh**3, dtype=dtype, device=device)
    s = torch.zeros((), dtype=dtype, device=device)
    return RateGrids(phih=z, phihe0=z, phihe1=z, phiheat=z,
                     photon_loss=s, lls_loss=s)


def _cell_rates(cfg: SweepConfig, cd_in, cd_out, vol_ph, nflux, i_state,
                track_bands=False):
    """cd_in/cd_out: (..., 3) species columns; nflux: (..., 3) per
    source type (BB, PL, QSO), broadcast against the cells.  Quadrature
    tables go to photoion_rates_quad, tau tables to photoion_rates
    (JAX's source_sweep.py:118-135); only the quadrature tracks bands."""
    quad = isinstance(cfg.tables, QuadTables)
    if track_bands and not quad:
        raise ValueError("track_band_loss needs the quadrature tables "
                         "(QuadTables)")
    kw = {"track_bands": True} if track_bands else {}
    return (photoion_rates_quad if quad else photoion_rates)(
        cfg.tables,
        cd_in[..., 0], cd_out[..., 0], cd_in[..., 1], cd_out[..., 1],
        cd_in[..., 2], cd_out[..., 2],
        vol_ph, i_state,
        nflux_bb=nflux[..., 0] if cfg.has_bb else None,
        nflux_pl=nflux[..., 1] if cfg.has_pl else None,
        nflux_qso=nflux[..., 2] if cfg.has_qso else None,
        do_heating=not cfg.isothermal,
        **kw,
    )


# ---- what the engines share

def stack_sweep_fields(cfg: SweepConfig, fields: SourceFields):
    """(M, M, M, 5) stacked field cube with the reference's epsilon
    clamps (evolve_point.F90:120-132)."""
    M = cfg.mesh
    eps = cfg.epsilon
    chans = [fields.ndens, torch.clamp(fields.h_av0, min=eps),
             torch.clamp(fields.h_av1, min=eps),
             torch.clamp(fields.he_av0, min=eps),
             torch.clamp(fields.he_av1, min=eps)]
    return torch.stack(chans, dim=-1).reshape(M, M, M, 5)


def _same_device(fstack, srcpos, nflux, cfg):
    for t in (srcpos, nflux, cfg.tables.sigma_HI):
        if t.device != fstack.device:
            raise ValueError(f"sources and tables must be on the fields' "
                             f"device {fstack.device}, not {t.device}")


def _scalars(cfg, dtype, device, dr, vol_over_scale):
    """dr and dr^3/flux_scale as tensors; the volume is computed on the
    host in float64 (the raw cube of a cm-scale dr overflows float32)."""
    if dr is None:
        dr, vol_over_scale = cfg.dr, cfg.vol / cfg.flux_scale
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return as_t(dr), as_t(vol_over_scale)


def _base_cols(fc, abu):
    """Neutral columns per unit length of stacked fields (..., 5):
    stack([h_av0, he_av0, he_av1]) * ndens * abu."""
    return (torch.stack([fc[..., 1], fc[..., 3], fc[..., 4]], dim=-1)
            * fc[..., 0:1] * abu)


def sweep_heats(cfg: SweepConfig) -> bool:
    """Whether the sweep evaluates heating: a heating run over tables
    with heating data for every source type in use (quadrature.rates_heat;
    tau tables likewise, photo.py:photoion_rates)."""
    t = cfg.tables
    if isinstance(t, RadiationTables):
        return not cfg.isothermal and all(
            st.heat_thick is not None
            for st, used in ((t.bb, cfg.has_bb), (t.pl, cfg.has_pl),
                             (t.qso, cfg.has_qso)) if st is not None and used)
    return rates_heat(t, cfg.isothermal, cfg.has_bb, cfg.has_pl,
                      cfg.has_qso)


_BLOCK = 256   # kBlock of the sweep kernels
# the kernels' kK of the two routes besides a fixed quadrature rule
# (csrc/table_rates.cuh: kTableRoute, kBlockRoute)
ROUTE_TABLE = -1
ROUTE_BLOCKS = -2
MAX_BLOCKS = 24   # kMaxBlocks of csrc/band_rates.cuh


class KernelTables(NamedTuple):
    """A sweep kernel's rate tables.  The fixed quadrature rule: packed
    (nbt, row length) band rows, types the (nflux column, band count,
    first band) of each source type, K its node count.  "auto" tables:
    packed the flat rows of packed_node_groups, types its groups, K =
    ROUTE_BLOCKS.  Tau tables: packed their (nb, 17) band rows, types
    the PackedTauTables, K = ROUTE_TABLE."""

    packed: torch.Tensor
    types: object
    K: int
    heat: bool


def _pack_kernel_tables(cfg: SweepConfig, dtype, heat: bool
                        ) -> KernelTables:
    """The kernels' tables on the configuration's route (KernelTables);
    raises for more node groups than the kernels take."""
    flags = (cfg.has_bb, cfg.has_pl, cfg.has_qso)
    if isinstance(cfg.tables, RadiationTables):
        pk = pack_tau_columns(packed_table_route(
            cfg.tables, dtype, cfg.tables.sigma_HI.device, heat, *flags))
        return KernelTables(pk.rows, pk, ROUTE_TABLE, heat)
    flat, blocks = packed_band_blocks(cfg.tables, dtype, heat, *flags)
    if len({b[3] for b in blocks}) == 1:
        return KernelTables(*uniform_band_rows(flat, blocks), heat)
    flat, groups, _ = packed_node_groups(cfg.tables, dtype, heat, *flags)
    if len(groups) > MAX_BLOCKS:
        raise ValueError(f"the sweep kernels take at most {MAX_BLOCKS} node "
                         f"groups, not {len(groups)}")
    return KernelTables(flat, groups, ROUTE_BLOCKS, heat)


def _kernel_tables(cfg: SweepConfig, dtype, track: bool = False
                   ) -> KernelTables:
    """The kernels' tables on the configuration's route (KernelTables),
    packed once and kept in cfg.kernel_cache under the identity of the
    tables, the physics flags and the dtype: a configuration with other
    tables never reads stale rows.  Raises, with the byte count, when
    the band rows, the loss-reduction buffer and (with `track`) the
    per-band staging buffer exceed a block's shared memory, and for band
    tracking off the fixed rule."""
    heat = sweep_heats(cfg)
    key = (id(cfg.tables), cfg.has_bb, cfg.has_pl, cfg.has_qso, heat, dtype)
    hit = cfg.kernel_cache.get(key)
    if hit is None:
        # the entry holds the tables, so their id stays unique
        hit = (cfg.tables, _pack_kernel_tables(cfg, dtype, heat))
        cfg.kernel_cache[key] = hit
    kt = hit[1]
    if track and kt.K == ROUTE_TABLE:
        raise ValueError("track_band_loss needs the quadrature tables "
                         "(QuadTables)")
    if track and kt.K == ROUTE_BLOCKS:
        raise ValueError("the band-tracking sweep kernel takes a fixed "
                         "quadrature rule, not \"auto\" blocks")
    nstage = cfg.tables.sigma_HI.shape[0] * _BLOCK if track else 0
    smem = (kt.packed.numel() + 2 * _BLOCK + nstage) * kt.packed.element_size()
    if smem > cuda_build.SHARED_MEM_LIMIT:
        raise ValueError(f"band tables need {smem} B of shared memory, over "
                         f"the {cuda_build.SHARED_MEM_LIMIT} B a block can "
                         "have")
    return kt


def _type_args(types):
    """The kernels' (column, band count, first band) ints of 3 types."""
    return [a for t in types for a in t] + [0, 0, 0] * (3 - len(types))


def launch_counter(library: str, kt: KernelTables) -> str:
    """The launch counter of `library`'s kernel on the route and variant
    of `kt`: launches.<library>[.table | .auto][.heat]."""
    route = {ROUTE_TABLE: ".table", ROUTE_BLOCKS: ".auto"}.get(kt.K, "")
    return f"launches.{library}{route}" + (".heat" if kt.heat else "")


def _route_args(kt: KernelTables):
    """The kernel arguments of the route: K and the type ints (ntypes
    and _type_args) of a fixed rule, zero on the other routes; the host
    route ints of csrc/table_rates.cuh:parse_route (kept alive by the
    caller; None on a fixed rule); and the trailing pointers: those ints,
    then the tau tables' packed photo and heat columns and a null (the
    hbin slot; all null off the table route).  The fixed rule's arguments are the ones the entries took
    before the routes; the route's come after them, before the
    stream."""
    null = ctypes.c_void_p(None)
    P = cuda_build.ptr
    if kt.K >= 0:
        return (kt.K, [len(kt.types)] + _type_args(kt.types), None,
                [null] * 4)
    if kt.K == ROUTE_BLOCKS:
        ints = [ROUTE_BLOCKS, kt.packed.numel(), len(kt.types)]
        for b in kt.types:
            ints += list(b)
        ptrs = [null] * 3
    else:
        pk = kt.types
        cols = list(pk.cols) + [0] * (3 - len(pk.cols))
        ints = [ROUTE_TABLE, kt.packed.numel(), pk.rows.shape[0], 0,
                len(pk.cols)] + cols + list(pk.live)
        ptrs = [P(pk.photo), null if pk.heat is None else P(pk.heat), null]
    ints = np.ascontiguousarray(ints, dtype=np.int32)
    return (0, [0] * 10, ints,
            [ints.ctypes.data_as(ctypes.c_void_p)] + ptrs)


def _check_kernel_inputs(fstack, srcpos, nflux, cfg):
    """What every sweep kernel requires of its inputs."""
    if not fstack.is_cuda:
        raise ValueError("the sweep kernel takes CUDA tensors")
    _same_device(fstack, srcpos, nflux, cfg)
    M, S = fstack.shape[0], srcpos.shape[0]
    if not 0 < S <= 65535:
        raise ValueError(f"the sweep kernel takes 1..65535 sources, not {S}")
    if fstack.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep kernel takes float32/float64, not "
                        f"{fstack.dtype}")
    if fstack.shape != (M, M, M, 5):
        raise ValueError(f"fields must be (M, M, M, 5), got "
                         f"{tuple(fstack.shape)}")


def _source_group(cfg: SweepConfig, S: int, M: int, itemsize: int) -> int:
    """Sources swept together (JAX's `_source_chunk`): cfg.source_chunk,
    or 0 for as many as keep a group's cd and slab (S x M^3 x 7 values)
    under _GROUP_BYTES."""
    if cfg.source_chunk:
        return max(1, min(int(cfg.source_chunk), S))
    return max(1, min(S, _GROUP_BYTES // (M**3 * 7 * itemsize)))


# ---- the L1-shell engine

def _check_extents(shells: ShellTable, M: int):
    if any(h - l + 1 > M for l, h in zip(shells.lo, shells.hi)):
        raise ValueError(f"a shell table of extents {shells.lo}..{shells.hi} "
                         f"does not fit a {M}^3 mesh")


def shell_sweep_plain(cfg: SweepConfig, shells: ShellTable, fstack, srcpos,
                       nflux):
    """Plain PyTorch version of the shell kernel.

    fstack: (M, M, M, 5) stacked fields; srcpos: (S, 3) int; nflux:
    (S, 3).  The cell size is cfg.dr, the LLS column of each cell
    cfg.lls_grid (mesh^3,) where given, else the homogeneous
    cfg.coldensh_LLS.  Returns (slab (S, M^3, 4) per-source rates in
    absolute coordinates, photon_loss (S,), lls_loss (S,)): JAX's
    `_sweep_one_source_stacked` (source_sweep.py:138-248) for each
    source, with the per-cell LLS column of the pyramid engine's
    `trace_plain`."""
    _same_device(fstack, srcpos, nflux, cfg)
    M = fstack.shape[0]
    _check_extents(shells, M)
    n = M**3
    S = srcpos.shape[0]
    dtype, device = fstack.dtype, fstack.device
    dr, vos = _scalars(cfg, dtype, device, None, None)
    lls_cells = _lls_cells(cfg, n, dtype, device)
    abu = torch.tensor(_ABU, dtype=dtype, device=device)
    f = fstack.reshape(n, 5)
    sp = srcpos.to(dtype=torch.long)
    nfl = nflux.to(dtype=dtype)
    s_idx = torch.arange(S, device=device)

    cd = torch.zeros((S, n, 3), dtype=dtype, device=device)
    slab = torch.zeros((S, n, 4), dtype=dtype, device=device)
    ploss = torch.zeros(S, dtype=dtype, device=device)
    lloss = torch.zeros(S, dtype=dtype, device=device)
    count("sweep.zeroed_bytes", _nbytes(cd, slab, ploss, lloss))

    def flat_of(pos):
        return (pos[..., 0] * M + pos[..., 1]) * M + pos[..., 2]

    # source cell (evolve_point.F90:140-151): vol_ph = cell volume
    flat0 = flat_of(torch.remainder(sp, M))
    f0 = f[flat0]
    bc0 = _base_cols(f0, abu)
    cc0 = bc0 * (0.5 * dr)
    cd[s_idx, flat0] = cc0
    phi0 = _cell_rates(cfg, torch.zeros_like(cc0), cc0, vos, nfl, f0[:, 2])
    slab[s_idx, flat0] = torch.stack(
        [phi0.photo_cell_HI / bc0[:, 0], phi0.photo_cell_HeI / bc0[:, 1],
         phi0.photo_cell_HeII / bc0[:, 2], phi0.heat], dim=-1)

    cells = torch.as_tensor(shells.cells, device=device).to(torch.long)
    bound = torch.as_tensor(shells.cell_boundary, device=device)
    starts = shells.starts
    nfl_cells = nfl[:, None, :]
    for k in range(shells.n_shells):
        offs = cells[starts[k]:starts[k + 1]]                 # (W, 3)
        on_bound = bound[starts[k]:starts[k + 1]]
        cd_in, path_units = cinterp_shell(offs, sp, M, cd)    # (S, W, 3)
        path = path_units * dr
        flat = flat_of(torch.remainder(sp[:, None, :] + offs, M))  # (S, W)
        o = offs.to(dtype)
        dist2 = o[:, 0] ** 2 + o[:, 1] ** 2 + o[:, 2] ** 2
        vol_ratio = 4.0 * const.pi * dist2 * path_units

        # the LLS column of the cell being entered adds to the incoming
        # HI column (evolve_point.F90:177-180), or the homogeneous one
        if lls_cells is not None:
            lls_add = lls_cells[flat] * path_units
        elif cfg.coldensh_LLS > 0.0:
            lls_add = cfg.coldensh_LLS * path_units
        else:
            lls_add = None
        if lls_add is not None:
            cd_in[..., 0] += lls_add

        fc = f[flat]                                          # (S, W, 5)
        bcols = _base_cols(fc, abu)
        # outgoing columns = in + time-averaged cell column
        # (evolve_point.F90:237-244)
        cd_out = cd_in + bcols * path[:, None]
        cd[s_idx[:, None], flat] = cd_out
        phi = _cell_rates(cfg, cd_in, cd_out, vol_ratio * vos, nfl_cells,
                          fc[..., 2])

        # shielded cells get zero rates (evolve_point.F90:250,279-290)
        live = cd_in[..., 0] < cfg.max_coldensh
        fl = live.to(dtype)
        slab[s_idx[:, None], flat] = torch.stack(
            [fl * phi.photo_cell_HI / bcols[..., 0],
             fl * phi.photo_cell_HeI / bcols[..., 1],
             fl * phi.photo_cell_HeII / bcols[..., 2],
             fl * phi.heat], dim=-1)
        # photon loss through the trace boundary
        # (evolve_point.F90:310-315)
        ploss = ploss + torch.where(live & on_bound,
                                    phi.photo_out / vol_ratio, 0.0).sum(-1)
        if lls_add is not None:
            # photons absorbed by the LLS fog (total_LLS_loss,
            # photonstatistics.f90:250-267, evolve_point.F90:277)
            tau_lls = const.sigma_HI_at_ion_freq * lls_add
            lloss = lloss + torch.where(
                live, phi.photo_in / vol_ratio * (-torch.expm1(-tau_lls)),
                0.0).sum(-1)
    return slab, ploss, lloss


def _lls_cells(cfg: SweepConfig, n: int, dtype, device):
    """cfg.lls_grid as (n,) values of the fields' dtype and device, or
    None."""
    if cfg.lls_grid is None:
        return None
    lls = cfg.lls_grid.reshape(-1)
    if lls.shape != (n,) or lls.dtype != dtype or lls.device != device:
        raise ValueError(f"lls_grid must be ({n},) {dtype} on {device}, "
                         f"not {tuple(lls.shape)} {lls.dtype} on "
                         f"{lls.device}")
    return lls.contiguous()


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


_DEVICE_CELLS = {}


def _device_cells(shells: ShellTable, device):
    """The table's packed cells on `device`, copied once per table."""
    key = (shells, str(device))
    if key not in _DEVICE_CELLS:
        _DEVICE_CELLS[key] = torch.as_tensor(shells.packed, device=device)
    return _DEVICE_CELLS[key]


def shell_sweep_cuda(cfg: SweepConfig, shells: ShellTable, fstack, srcpos,
                      nflux):
    """The shell kernel (``csrc/shell_sweep.cu``); same contract as
    `shell_sweep_plain`.

    Replaces source_sweep.py:_sweep_one_source_stacked under the source
    vmap of sweep_sources_accumulate, with cinterp.py:cinterp_shell
    inlined, and quadrature.py:_one_source_quad through the shared cell
    step (csrc/short_char.cuh): its isothermal branch, or with heating
    its heating branch too.  Bound on the card by the K-node
    exponentials, as the pyramid kernel; each cell gathers its corners
    from the source's column cube, and the kernel walks the compact
    table (no thread on padding).  With cfg.lls_grid the kernel reads
    each entered cell's LLS column, as the pyramid kernel does.
    """
    _check_kernel_inputs(fstack, srcpos, nflux, cfg)
    M, S = fstack.shape[0], srcpos.shape[0]
    _check_extents(shells, M)
    dtype, device = fstack.dtype, fstack.device
    lls = _lls_cells(cfg, M**3, dtype, device)
    kt = _kernel_tables(cfg, dtype)
    K, type_ints, route, route_ptrs = _route_args(kt)
    cells = _device_cells(shells, device)
    starts = np.ascontiguousarray(shells.starts, dtype=np.int64)
    fields = fstack.contiguous()
    sp = srcpos.to(dtype=torch.int32).contiguous()
    nfl = nflux.to(dtype=dtype).contiguous()

    lib = cuda_build.load("shell_sweep")
    lib.shell_sweep_slots.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.shell_sweep_slots.restype = ctypes.c_int
    starts_p = starts.ctypes.data_as(ctypes.c_void_p)
    nslots = max(lib.shell_sweep_slots(starts_p, shells.n_shells), 1)
    cd = torch.zeros((S, M**3, 3), dtype=dtype, device=device)
    slab = torch.zeros((S, M**3, 4), dtype=dtype, device=device)
    partials = torch.zeros((S, nslots, 2), dtype=dtype, device=device)
    name = ("shell_sweep_" + ("heat_" if kt.heat else "")
            + ("f32" if dtype == torch.float32 else "f64"))
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                   + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    err = fn(P(fields), P(sp), P(nfl), P(kt.packed),
             ctypes.c_void_p(None) if lls is None else P(lls), P(cells),
             starts_p, P(cd), P(slab), P(partials), M, S, shells.n_shells, K,
             *type_ints, float(cfg.dr),
             float(cfg.vol / cfg.flux_scale), float(cfg.coldensh_LLS),
             float(cfg.max_coldensh), *route_ptrs,
             cuda_build.stream_of(fields))
    cuda_build.check(err, name)
    # one count a call (a kernel per shell), by route and variant
    count(launch_counter("shell_sweep", kt))
    # the source cells' launch, then one a shell
    count("sweep.kernels", 1 + shells.n_shells)
    count("sweep.zeroed_bytes", _nbytes(cd, slab, partials))
    losses = partials.sum(dim=1)
    return slab, losses[:, 0], losses[:, 1]


def _stack_fields(cfg: SweepConfig, fields: SourceFields):
    """(n, 5) field stack with the reference's epsilon clamps on the
    fractions (evolve_point.F90:120-132)."""
    return stack_sweep_fields(cfg, fields).reshape(-1, 5)


def _shell_trace(fstack):
    if fstack.is_cuda:
        return shell_sweep_cuda
    if fstack.device.type == "cpu":
        return shell_sweep_plain
    raise ValueError(f"no sweep for device {fstack.device}")


def sweep_one_source(cfg: SweepConfig, shells: ShellTable,
                     fields: SourceFields, srcpos, nflux,
                     rates_in: RateGrids) -> RateGrids:
    """Trace one source and add its rates into ``rates_in``.

    srcpos: (3,) int (0-based); nflux: (3,) normalised fluxes
    (BB, PL, QSO) of this source (NormFlux*, sourceprops_test.F90:38-48).
    """
    fstack = stack_sweep_fields(cfg, fields)
    slab, ploss, lloss = _shell_trace(fstack)(
        cfg, shells, fstack, srcpos.reshape(1, 3), nflux.reshape(1, 3))
    return RateGrids(
        phih=rates_in.phih + slab[0, :, 0],
        phihe0=rates_in.phihe0 + slab[0, :, 1],
        phihe1=rates_in.phihe1 + slab[0, :, 2],
        phiheat=rates_in.phiheat + slab[0, :, 3],
        photon_loss=rates_in.photon_loss + ploss[0],
        lls_loss=rates_in.lls_loss + lloss[0])


def sweep_sources_accumulate(cfg: SweepConfig, shells: ShellTable,
                             fields: SourceFields,
                             srcpos_batch, nflux_batch,
                             batch_size: Optional[int] = None, dr=None,
                             vol_over_scale=None,
                             lls_grid=None) -> RateGrids:
    """Trace a batch of sources through the shell engine, accumulating
    rates.

    srcpos_batch: (S, 3) int; nflux_batch: (S, 3).  Sources with all
    fluxes zero contribute nothing, and a batch of no sources gives zero
    rates without launching anything.  CUDA tensors go through the
    kernel, CPU tensors through the plain version.  Sources are swept
    `batch_size` at a time (default cfg.source_batch, or with 0 the
    pyramid engine's `_source_group`); each group's sum over its sources
    is added to the total in group order.

    `dr` (the step's cell size) and `lls_grid` (mesh^3,) (each cell's
    LLS column, in place of cfg.coldensh_LLS) go into the configuration
    the traces take.  Their volume factor is then dr^3/flux_scale, the
    `vol_over_scale` evolve3d computes beside `dr`; a `vol_over_scale`
    that differs from it raises ValueError.
    """
    M = cfg.mesh
    with span("c2ray.sweep.stack"):
        fstack = stack_sweep_fields(cfg, fields)
    dtype, device = fstack.dtype, fstack.device
    if dr is not None:
        cfg = replace(cfg, dr=float(dr))
    if vol_over_scale is not None and not math.isclose(
            float(vol_over_scale), cfg.vol / cfg.flux_scale, rel_tol=1e-9):
        raise ValueError(
            f"the shell engine's volume factor is dr^3/flux_scale = "
            f"{cfg.vol / cfg.flux_scale:.9g}, not {float(vol_over_scale):.9g}")
    if lls_grid is not None:
        cfg = replace(cfg, lls_grid=torch.as_tensor(
            lls_grid, dtype=dtype, device=device).reshape(-1))
    trace = _shell_trace(fstack)
    rg = torch.zeros((M**3, 4), dtype=dtype, device=device)
    pl = torch.zeros((), dtype=dtype, device=device)
    ll = torch.zeros((), dtype=dtype, device=device)
    S = srcpos_batch.shape[0]
    group = (batch_size or cfg.source_batch
             or _source_group(cfg, S, M, fstack.element_size()))
    for g0 in range(0, S, max(1, group)):
        sp = srcpos_batch[g0:g0 + group]
        nf = nflux_batch[g0:g0 + group]
        with span("c2ray.sweep.group"):
            slab, ploss, lloss = trace(cfg, shells, fstack, sp, nf)
        count("sweep.groups")
        with span("c2ray.sweep.sum"):
            live = torch.any(nf > 0.0, dim=1)
            rg = rg + torch.where(live[:, None, None], slab, 0.0).sum(dim=0)
            pl = pl + torch.where(live, ploss, 0.0).sum()
            ll = ll + torch.where(live, lloss, 0.0).sum()
        count("sweep.summed_bytes", _nbytes(slab))
    return RateGrids(phih=rg[:, 0], phihe0=rg[:, 1], phihe1=rg[:, 2],
                     phiheat=rg[:, 3], photon_loss=pl, lls_loss=ll)
