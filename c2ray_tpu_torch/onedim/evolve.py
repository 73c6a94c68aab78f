"""1D radial sweep: `evolve1d`, one timestep of the 1D program.

Port of ``c2ray_tpu/onedim/evolve.py`` (``code/files_for_1D/evolve_new.F90``):
a single outward sweep over radius with strict i-1 -> i causality; the
carry is the outgoing column-density triplet, and each shell runs its
fixed point (photo rates -> two doric passes averaged -> thermal, until
converged, evolve_new.F90:239-394).  `evolve1d_plain` is a Python loop
over the shells with each fixed point on 0-d tensors; `evolve1d_cuda`
runs the whole march in one launch of the hand-written kernel
``csrc/evolve1d.cu`` (one warp; the quadrature rate route -- a fixed
rule or the "auto" blocks -- or the tau-table route, isothermal or with
heating).  `evolve1d` takes the kernel for CUDA
tensors and the plain version for CPU tensors.

Reference deviations (documented, both are reference bugs):
- evolve_new.F90:267-268 divides the He rates by ion%he_av(nx) with a
  stale loop index (out-of-bounds read); we use he_av(0)/he_av(1) as the
  3D code does (evolve_point.F90:268-270).
- evolve_new.F90:307 uses ion%he_av(1) where the first doric pass used
  ion%he(1); we use the current fractions in both passes like the 3D
  do_chemistry (evolve_point.F90:556-569).
"""

import ctypes
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from .. import constants as const
from .. import cuda_build
from ..chemistry import (IonFractions, IonState, coldens, coldens_bndry_HeI,
                         coldens_bndry_HeII, coldens_bndry_HI, doric,
                         electrondens, prepare_doric_factors)
from ..cooling import CoolingTables, stacked
from ..radiation.photo import photoion_rates
from ..radiation.quadrature import (QuadTables, packed_band_blocks,
                                    photoion_rates_quad, rates_heat,
                                    uniform_band_rows)
from ..radiation.tables import RadiationTables, packed_table_route
from ..rates import rate_coefficients
from ..sweep.global_pass import MIN_FRACTION_OF_ATOMS, MIN_FRACTIONAL_CHANGE
from ..thermal import thermal
from ..utils.clocks import count

# evolve_new.F90:156
MAX_COLDENSH_1D = 2.0e26
MAX_CELL_ITER = 4000

# "auto" tables in the kernel: the nodes of a row and the lanes a slot
# of rows spans (band_rates.cuh: kRowNodes, kRowLanes)
ROW_NODES = 3
ROW_LANES = 32


class State1D(NamedTuple):
    """Grid state for the 1D problem (material module arrays)."""

    ndens: torch.Tensor   # (mesh,)
    temper: torch.Tensor  # (mesh,)
    xh: torch.Tensor      # (mesh, 2)
    xhe: torch.Tensor     # (mesh, 3)


@dataclass(frozen=True)
class OneDContext:
    """Static configuration + tables for the 1D solver."""

    tables: object  # RadiationTables or QuadTables
    cooling: Optional[CoolingTables]
    dr: float
    vol: torch.Tensor               # (mesh,) shell volumes / flux_scale
    clumping: float = 1.0
    isothermal: bool = True
    gamma_uvb: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    epsilon: float = 1.0e-20
    cosmo_cool_factor: float = 0.0
    boundary_tauHI: float = 0.0
    boundary_tauHeI: float = 0.0
    boundary_tauHeII: float = 0.0
    has_bb: bool = True
    has_pl: bool = False
    has_qso: bool = False
    max_cell_iter: int = MAX_CELL_ITER
    # the radiation tables' flux scale: `vol` is stored DIVIDED by it,
    # on the host in float64 (raw shell volumes ~1e66 cm^3 overflow
    # float32; the scaled tables x scaled volumes cancel exactly)
    flux_scale: float = 1.0
    # the kernel's packed tables, made at the first launch and kept for
    # the next ones (see `_kernel_tables`); a context made from this one
    # by dataclasses.replace (test 4's new dr and vol) shares them
    kernel_cache: dict = field(default_factory=dict, compare=False,
                               repr=False)


def _cell_photorates(ctx: OneDContext, cd_in, cc_cell, vol_ph, i_state):
    """photoion_rates for one cell given incoming columns and cell columns."""
    fn = (photoion_rates_quad if isinstance(ctx.tables, QuadTables)
          else photoion_rates)
    return fn(
        ctx.tables,
        cd_in[0], cd_in[0] + cc_cell[0],
        cd_in[1], cd_in[1] + cc_cell[1],
        cd_in[2], cd_in[2] + cc_cell[2],
        vol_ph, i_state,
        nflux_bb=1.0 if ctx.has_bb else None,
        nflux_pl=1.0 if ctx.has_pl else None,
        nflux_qso=1.0 if ctx.has_qso else None,
        do_heating=not ctx.isothermal,
    )


def _cell_columns(ctx, ions: IonFractions, ndens_p):
    """Column densities of one cell per species (evolve_new.F90:253-255)."""
    return (coldens(ctx.dr, ions.h0, ndens_p, 1.0 - const.abu_he),
            coldens(ctx.dr, ions.he0, ndens_p, const.abu_he),
            coldens(ctx.dr, ions.he1, ndens_p, const.abu_he))


def _conv(new, old):
    return (torch.abs(new - old) / new < MIN_FRACTIONAL_CHANGE) | (
        new < MIN_FRACTION_OF_ATOMS)


def _solve_cell(ctx: OneDContext, dt, cd_in, ndens_p, vol_ph, temper0, ion0):
    """Fixed-point iteration for one cell (evolve_new.F90:237-394).
    Returns (ion, temper1, iterations, thermal sub-step counts: the
    largest of one iteration, the sum)."""
    guvb = ctx.gamma_uvb
    ion, temper1, avg_temper = ion0, temper0, temper0
    nit, nsub, nsub_sum, done = 0, 0, 0, False
    # isothermal: avg_temper stays temper0, so the fits never change
    rates = rate_coefficients(avg_temper)
    while not done and nit < ctx.max_cell_iter:
        prev_avg = ion.avg
        temper2 = temper1

        # ------- photo block (evolve_new.F90:252-274)
        cc_av = _cell_columns(ctx, ion.avg, ndens_p)
        phi = _cell_photorates(ctx, cd_in, cc_av, vol_ph, ion.avg.h1)
        photo_HI = phi.photo_cell_HI / (ion.avg.h0 * ndens_p
                                        * (1.0 - const.abu_he)) + guvb[0]
        photo_HeI = phi.photo_cell_HeI / (ion.avg.he0 * ndens_p
                                          * const.abu_he) + guvb[1]
        photo_HeII = phi.photo_cell_HeII / (ion.avg.he1 * ndens_p
                                            * const.abu_he) + guvb[2]

        de = electrondens(ndens_p, ion.avg)
        if not ctx.isothermal:
            rates = rate_coefficients(avg_temper)

        # ------- doric pass 1 (factors from current fractions)
        fac = prepare_doric_factors(*_cell_columns(ctx, ion.cur, ndens_p))
        ion1 = doric(dt, de, ion, photo_HI, photo_HeI, photo_HeII, fac,
                     rates, ctx.clumping, ctx.epsilon)
        de = electrondens(ndens_p, ion1.avg)

        # ------- doric pass 2, then average (evolve_new.F90:303-333)
        fac2 = prepare_doric_factors(*_cell_columns(ctx, ion1.cur, ndens_p))
        ion2 = doric(dt, de, ion1, photo_HI, photo_HeI, photo_HeII, fac2,
                     rates, ctx.clumping, ctx.epsilon)

        half = lambda a, b: 0.5 * (a + b)
        cur = IonFractions(*(half(a, b) for a, b in zip(ion2.cur, ion1.cur)))
        # the reference averages h_av(0), he_av(0), he_av(1) only
        # (evolve_new.F90:330-332); h_av(1)/he_av(2) keep pass-2 values
        avg = IonFractions(
            h0=half(ion2.avg.h0, ion1.avg.h0),
            h1=ion2.avg.h1,
            he0=half(ion2.avg.he0, ion1.avg.he0),
            he1=half(ion2.avg.he1, ion1.avg.he1),
            he2=ion2.avg.he2,
        )
        ion_new = IonState(cur=cur, avg=avg, old=ion.old)
        de = electrondens(ndens_p, avg)

        # ------- thermal (evolve_new.F90:336-347)
        temper1_new = temper0
        avg_temper_new = avg_temper
        if not ctx.isothermal:
            tr = thermal(dt, temper0, de, ndens_p, ion_new, phi.heat,
                         ctx.cooling, ctx.cosmo_cool_factor)
            temper1_new = tr.end_temper
            avg_temper_new = tr.avg_temper
            nsub = max(nsub, tr.n_substeps)
            nsub_sum += tr.n_substeps

        # ------- convergence (evolve_new.F90:349-370)
        done = bool(_conv(avg.h0, prev_avg.h0)
                    & _conv(avg.he0, prev_avg.he0)
                    & _conv(avg.he1, prev_avg.he1)
                    & _conv(avg.he2, prev_avg.he2)
                    & (torch.abs(temper1_new - temper2) / temper1_new
                       < MIN_FRACTIONAL_CHANGE))
        ion, temper1, avg_temper = ion_new, temper1_new, avg_temper_new
        nit += 1
    return ion, temper1, nit, nsub, nsub_sum


def _boundary_columns(ctx: OneDContext):
    return (coldens_bndry_HI(ctx.boundary_tauHI),
            coldens_bndry_HeI(ctx.boundary_tauHeI),
            coldens_bndry_HeII(ctx.boundary_tauHeII))


def evolve1d_plain(ctx: OneDContext, state: State1D, dt):
    """The radial march as a loop over the shells (the JAX package's
    lax.scan, make_evolve1d:190-236).  Returns (new state, per-shell
    iterations (int32), counters): counters = [summed iterations,
    largest iterations of a shell, largest thermal sub-step count of
    an iteration, summed thermal sub-steps] (int32)."""
    dtype, device = state.ndens.dtype, state.ndens.device
    cd_in = tuple(torch.tensor(b, dtype=dtype, device=device)
                  for b in _boundary_columns(ctx))
    xh_new, xhe_new, temper_new, nits = [], [], [], []
    nsub_max = nsub_sum = 0
    for i in range(state.ndens.shape[0]):
        ndens_p, temper0 = state.ndens[i], state.temper[i]
        xh, xhe = state.xh[i], state.xhe[i]
        f0 = IonFractions(h0=xh[0], h1=xh[1], he0=xhe[0], he1=xhe[1],
                          he2=xhe[2])
        ion0 = IonState(cur=f0, avg=f0, old=f0)

        shielded = bool(cd_in[0] > MAX_COLDENSH_1D)
        ion, temper1, nit, nsub, nsum = _solve_cell(ctx, dt, cd_in, ndens_p,
                                                    ctx.vol[i], temper0, ion0)
        # fully shielded cells are left untouched (evolve_new.F90:395-404)
        final = f0 if shielded else ion.cur
        final_avg = f0 if shielded else ion.avg
        temper1 = temper0 if shielded else temper1

        # outgoing columns add the time-averaged cell column
        # (evolve_new.F90:417-424)
        cc = _cell_columns(ctx, final_avg, ndens_p)
        cd_in = (cd_in[0] + cc[0], cd_in[1] + cc[1], cd_in[2] + cc[2])

        xh_new.append(torch.stack([final.h0, final.h1]))
        xhe_new.append(torch.stack([final.he0, final.he1, final.he2]))
        temper_new.append(temper1)
        nits.append(nit)
        nsub_max = max(nsub_max, nsub)
        nsub_sum += nsum
    new_state = State1D(ndens=state.ndens, temper=torch.stack(temper_new),
                        xh=torch.stack(xh_new), xhe=torch.stack(xhe_new))
    nits_t = torch.tensor(nits, dtype=torch.int32, device=device)
    counters = torch.tensor([sum(nits), max(nits, default=0), nsub_max,
                             nsub_sum],
                            dtype=torch.int32, device=device)
    return new_state, nits_t, counters


class KernelTables1D(NamedTuple):
    """The 1D kernel's table inputs: the band rows (quadrature: the
    packed rows of `packed_band_rows`; "auto" tables: the rows of
    `_row_deal`; tables: (nb, 17) rows of sigmas, masks and the
    f-factors), on the table route the heating columns (nb, 3) int32,
    the photo tables (ntypes, 2, NumTau + 1, nb) and with heating the
    heating tables (ntypes, 2, NumTau + 1, nheat), with heating the
    stacked cooling table; the layout integers of the entry point (nbt,
    K, ntypes, the types' band counts and first bands, nb, nheat; "auto"
    tables, whose entries are their own: the rows' slot count); the
    route of the entry points: "quad", "table" or "auto"."""

    bands: torch.Tensor
    hbin: Optional[torch.Tensor]
    photo: Optional[torch.Tensor]
    heat: Optional[torch.Tensor]
    cool: Optional[torch.Tensor]
    layout: Tuple[int, ...]
    route: str = "quad"


def _table_route(ctx: OneDContext, dtype, device, heat: bool):
    """The table variant's (bands, hbin, photo, heat tables, layout)."""
    tr = packed_table_route(ctx.tables, dtype, device, heat, ctx.has_bb,
                            ctx.has_pl, ctx.has_qso)
    nheat = tr.heat.shape[-1] if heat else 0
    layout = (0, 0, len(tr.cols)) + (0,) * 6 + (tr.rows.shape[0], nheat)
    return tr.rows, tr.hbin, tr.photo, tr.heat, layout


def _row_deal(flat, blocks, heat: bool):
    """"auto" tables as the 1D kernel deals them to its warp's lanes
    (band_rates.cuh: rows_in / rows_out): every live band of every block
    of packed_band_blocks (flat rows, blocks) cut into rows of ROW_NODES
    nodes, the last row of a band padded with nodes of weight 0 (sighat
    and A 0); a row holds its band's values in packed_band_blocks'
    layout at K = ROW_NODES.  Row j lies in slot j // ROW_LANES of lane
    j % ROW_LANES; zero rows fill the last slot.
    Returns (rows, slots, deal): the rows slot-major, value-major,
    lane-fastest (value v of slot s, lane l at (s * values + v) *
    ROW_LANES + l), and per row its (block, band of the block, first
    node, nodes), None for a zero row."""
    M = ROW_NODES
    rows, deal = [], []
    for bi, (_, _, nb, K, row0) in enumerate(blocks):
        width = 17 + 5 * K if heat else 5 + 2 * K
        band = flat[row0:row0 + nb * width].reshape(nb, width)
        # the node arrays of a row: sighat, A, with heating A_heat x 3
        arrays = 5 if heat else 2
        for i in range(nb):
            for k0 in range(0, K, M):
                k1 = min(K, k0 + M)
                pad = band.new_zeros(M - (k1 - k0))
                cols = [band[i, :5]]
                for q in range(arrays):
                    cols += [band[i, 5 + q * K + k0:5 + q * K + k1], pad]
                cols.append(band[i, 5 + arrays * K:])
                rows.append(torch.cat(cols))
                deal.append((bi, i, k0, k1 - k0))
    slots = -(-len(rows) // ROW_LANES)
    table = flat.new_zeros(slots * ROW_LANES, rows[0].numel())
    table[:len(rows)] = torch.stack(rows)
    packed = table.reshape(slots, ROW_LANES, -1).transpose(1, 2).reshape(-1)
    return (packed.contiguous(), slots,
            deal + [None] * (slots * ROW_LANES - len(rows)))


def _row_in_values(heat: bool) -> int:
    """Values of one row's incoming side (band_rates.cuh: kRowInValues):
    tau_in, the thin sum, with heating the three thin heat sums, then
    e_in of each node."""
    return (5 if heat else 2) + ROW_NODES


def _shared_limit(nbytes: int, what: str):
    if nbytes > cuda_build.SHARED_MEM_LIMIT:
        raise ValueError(f"{what} need {nbytes} B of shared memory, over the "
                         f"{cuda_build.SHARED_MEM_LIMIT} B a block can have")


def _pack_kernel_tables(ctx: OneDContext, dtype, device) -> KernelTables1D:
    heat = not ctx.isothermal
    if heat and ctx.cooling is None:
        raise ValueError("a heating 1D run needs cooling tables")
    route = "quad"
    if isinstance(ctx.tables, RadiationTables):
        route = "table"
        bands, hbin, photo, heat_tab, layout = _table_route(ctx, dtype,
                                                            device, heat)
    else:
        flags = (ctx.has_bb, ctx.has_pl, ctx.has_qso)
        if heat and not rates_heat(ctx.tables, False, *flags):
            raise ValueError("a heating 1D run needs quadrature tables with "
                             "heating data (isothermal=False)")
        flat, blocks = packed_band_blocks(ctx.tables, dtype, heat, *flags)
        photo = heat_tab = hbin = None
        if len({b[3] for b in blocks}) > 1:
            # "auto" tables: every band's rows dealt to the warp's lanes
            rows, slots, _ = _row_deal(flat, blocks, heat)
            bands = rows.to(device)
            route = "auto"
            _shared_limit((bands.numel()
                           + slots * ROW_LANES * _row_in_values(heat)
                           + (stacked(ctx.cooling).numel() if heat
                              else 0)) * bands.element_size(),
                          "\"auto\" band tables")
            layout = (slots,)
        else:
            bands, types, K = uniform_band_rows(flat, blocks)
            bands = bands.to(device)
            _shared_limit(bands.numel() * bands.element_size(),
                          "band tables")
            pad = [0] * (3 - len(types))
            layout = ((bands.shape[0], K, len(types))
                      + tuple([t[1] for t in types] + pad)
                      + tuple([t[2] for t in types] + pad) + (0, 0))
    cool = (stacked(ctx.cooling).to(dtype=dtype, device=device).contiguous()
            if heat else None)
    return KernelTables1D(bands, hbin, photo, heat_tab, cool, layout,
                          route)


def _kernel_tables(ctx: OneDContext, dtype, device) -> KernelTables1D:
    """The kernel's table inputs, packed once and kept in
    ctx.kernel_cache under the identity of the tables and cooling tables
    they were made from, the physics flags, the dtype and the device: a
    context with other tables never reads stale rows."""
    key = (id(ctx.tables), id(ctx.cooling), ctx.isothermal, ctx.has_bb,
           ctx.has_pl, ctx.has_qso, dtype, device)
    hit = ctx.kernel_cache.get(key)
    if hit is None:
        # the entry holds the tables, so their ids stay unique
        hit = (ctx.tables, ctx.cooling,
               _pack_kernel_tables(ctx, dtype, device))
        ctx.kernel_cache[key] = hit
    return hit[2]


def evolve1d_cuda(ctx: OneDContext, state: State1D, dt):
    """The 1D kernel (``csrc/evolve1d.cu``); same contract as
    `evolve1d_plain`, with the tensors it returns on the card.

    Replaces onedim/evolve.py:make_evolve1d's scan of _solve_cell, with
    the rates of quadrature.py:photoion_rates_quad or, for
    RadiationTables, of photo.py:photoion_rates.  One launch of one warp
    per timestep: the march is one serial chain, as the JAX scan is, so
    the kernel is bound by the latency of the fixed-point iterations,
    not by the card's throughput; the lanes share the bands of each rate
    evaluation and run the chemistry redundantly on identical values.
    The tables are packed at the first launch and kept (`_kernel_tables`).
    """
    nd = state.ndens
    dtype, device = nd.dtype, nd.device
    if not nd.is_cuda:
        raise ValueError("the 1D kernel takes CUDA tensors")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the 1D kernel takes float32/float64, not {dtype}")
    mesh = nd.shape[0]
    for t, shape in ((nd, (mesh,)), (state.temper, (mesh,)),
                     (state.xh, (mesh, 2)), (state.xhe, (mesh, 3)),
                     (ctx.vol, (mesh,))):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"the 1D state and volumes must be {dtype} on "
                             f"{device}, shapes (mesh,), (mesh, 2), (mesh, 3)")
    heat = not ctx.isothermal
    kt = _kernel_tables(ctx, dtype, device)
    null = ctypes.c_void_p(None)
    P = lambda t: null if t is None else cuda_build.ptr(t)
    ins = [t.contiguous() for t in (nd, state.temper, state.xh, state.xhe,
                                    ctx.vol)]
    xh_out = torch.empty((mesh, 2), dtype=dtype, device=device)
    xhe_out = torch.empty((mesh, 3), dtype=dtype, device=device)
    temper_out = torch.empty(mesh, dtype=dtype, device=device)
    nits = torch.empty(mesh, dtype=torch.int32, device=device)
    counters = torch.zeros(4, dtype=torch.int32, device=device)

    lib = cuda_build.load("evolve1d")
    auto = kt.route == "auto"
    name = (f"evolve1d_{kt.route}_" + ("heat_" if heat else "iso_")
            + ("f32" if dtype == torch.float32 else "f64"))
    # "auto" tables have entries of their own: no tau-table pointers, the
    # rows' slot count
    tabs = ((kt.bands, kt.cool) if auto
            else (kt.bands, kt.hbin, kt.photo, kt.heat, kt.cool))
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * (10 + len(tabs))
                   + [ctypes.c_int] * (2 + len(kt.layout))
                   + [ctypes.c_double] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bnd = _boundary_columns(ctx)
    err = fn(*(P(t) for t in ins), *(P(t) for t in tabs), P(xh_out),
             P(xhe_out), P(temper_out), P(nits), P(counters), mesh,
             *kt.layout,
             int(ctx.max_cell_iter), float(ctx.dr), float(dt),
             float(ctx.clumping), *(float(g) for g in ctx.gamma_uvb),
             float(ctx.epsilon), float(ctx.cosmo_cool_factor),
             *(float(b) for b in bnd), cuda_build.stream_of(nd))
    cuda_build.check(err, name)
    # one count a timestep, by route (a fixed rule, tau tables, "auto"
    # blocks) and variant
    count("launches.evolve1d"
          + {"table": ".table", "auto": ".auto"}.get(kt.route, "")
          + (".heat" if heat else ""))
    new_state = State1D(ndens=state.ndens, temper=temper_out, xh=xh_out,
                        xhe=xhe_out)
    return new_state, nits, counters


def evolve1d(ctx: OneDContext, state: State1D, dt):
    """One timestep of the 1D program: (new state, per-shell iterations,
    counters) -- the JAX package's (state, nits) plus the counters of
    `evolve1d_plain`.  CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    if state.ndens.is_cuda:
        return evolve1d_cuda(ctx, state, dt)
    if state.ndens.device.type == "cpu":
        return evolve1d_plain(ctx, state, dt)
    raise ValueError(f"no 1D timestep for device {state.ndens.device}")
