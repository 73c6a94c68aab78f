"""Global chemistry pass: apply the accumulated rates on every cell.

Port of ``c2ray_tpu/sweep/global_pass.py`` (``global_pass`` ->
``evolve0D_global`` -> ``do_chemistry``, evolve.F90:435-501,
evolve_point.F90:325-646).

Every cell iterates {electron density -> T-dependent rates -> two doric
passes averaged -> thermal} to its own 1% fixed point (cap `max_iter`),
with damped Picard from iteration DAMP_AFTER on; an isothermal config
holds T fixed and runs no thermal sub-cycle.  `chemistry_pass_plain`
runs the JAX package's in-graph lockstep (all cells step together,
converged cells frozen); `chemistry_pass_cuda` runs each cell's fixed
point on a thread until the cell converges, the thread then taking the
next cell (``csrc/chemistry.cu``).  A frozen cell never changes, so the
two agree cell for cell.  The TPU's host loop with compaction buckets
exists only for the TPU and is not ported.
"""

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import torch

from .. import constants as const
from .. import cuda_build
from ..chemistry import (IonFractions, IonState, coldens, doric,
                         electrondens, prepare_doric_factors)
from ..cooling import CoolingTables, stacked
from ..rates import rate_coefficients
from ..state import GridState
from ..thermal import thermal
from ..utils.clocks import count
from .source_sweep import RateGrids

# c2ray_parameters.f90:36,44
MIN_FRACTIONAL_CHANGE = 1.0e-2
MIN_FRACTION_OF_ATOMS = 1.0e-8
MAX_CHEM_ITER = 400

# Damped Picard: past this many fixed-point iterations, successive
# iterates are averaged (x' = (x_new + x_prev)/2).  In float32 a cell
# minority's iterate map enters a >1% limit cycle that would run to the
# iteration cap; damping contracts it to the float64 fixed point.
# Below the threshold the reference's plain iteration is untouched
# (c2ray_tpu/sweep/global_pass.py:38-48).
DAMP_AFTER = 50
DAMP_FACTOR = 0.5

# The chemistry kernel's input rows, in its order (csrc/chemistry.cu:
# Row): GridState fields, then RateGrids fields; t_final and phiheat are
# read by the heating variant only, clumping (a scalar or one value per
# cell) last.
CHEM_ROWS = ("ndens", "h0", "h1", "he0", "he1", "he2", "h_av0", "h_av1",
             "he_av0", "he_av1", "he_av2", "h_int0", "h_int1", "he_int0",
             "he_int1", "he_int2", "t_av", "phih", "phihe0", "phihe1",
             "t_final", "phiheat", "clumping")
_RATE_ROWS = frozenset(("phih", "phihe0", "phihe1", "phiheat"))

# the cooling table the heating kernel reads, (801, 5) species last, per
# cooling tables, dtype and device (the entry holds the tables, so the
# id stays unique)
_COOLING = {}


@dataclass(frozen=True)
class ChemistryConfig:
    isothermal: bool = False
    epsilon: float = 1.0e-20
    isothermal_temperature: float = 1.0e4
    max_iter: int = MAX_CHEM_ITER
    # cooling curves of the thermal sub-cycle (heating configs)
    cooling: Optional[CoolingTables] = None
    # 2 (dz/dt)/(1+z), the adiabatic cosmological cooling factor
    # (cosmology.f90:207-234); a pass may override it per timestep
    cosmo_cool_factor: float = 0.0

    def __post_init__(self):
        if not self.isothermal and self.cooling is None:
            raise ValueError("a heating ChemistryConfig (isothermal=False) "
                             "needs cooling tables")


def _doric_half(cfg: ChemistryConfig, dt, ndens, clumping,
                phi_HI, phi_HeI, phi_HeII, fixed_rates, ion, avg_t):
    """{electron density -> rates -> two doric passes averaged}
    (evolve_point.F90:487-600).  Returns (ion_new, de)."""

    def factors_from(ions: IonFractions):
        # cell columns enter doric only through opacity ratios, so the
        # path length cancels (evolve_point.F90:394-395,556-563)
        cch = coldens(1.0, ions.h0, ndens, 1.0 - const.abu_he)
        cche0 = coldens(1.0, ions.he0, ndens, const.abu_he)
        cche1 = coldens(1.0, ions.he1, ndens, const.abu_he)
        return prepare_doric_factors(cch, cche0, cche1)

    de = electrondens(ndens, ion.avg)
    rates = (fixed_rates if cfg.isothermal
             else rate_coefficients(avg_t))

    ion1 = doric(dt, de, ion, phi_HI, phi_HeI, phi_HeII,
                 factors_from(ion.cur), rates, clumping, cfg.epsilon)
    de = electrondens(ndens, ion1.avg)
    ion2 = doric(dt, de, ion1, phi_HI, phi_HeI, phi_HeII,
                 factors_from(ion1.cur), rates, clumping, cfg.epsilon)

    half = lambda a, b: 0.5 * (a + b)
    cur = IonFractions(*(half(a, b) for a, b in zip(ion2.cur, ion1.cur)))
    # the reference averages h_av(0), he_av(0), he_av(1) only
    # (evolve_point.F90:593-595)
    avg = IonFractions(
        h0=half(ion2.avg.h0, ion1.avg.h0),
        h1=ion2.avg.h1,
        he0=half(ion2.avg.he0, ion1.avg.he0),
        he1=half(ion2.avg.he1, ion1.avg.he1),
        he2=ion2.avg.he2,
    )
    ion_new = IonState(cur=cur, avg=avg, old=ion.old)
    return ion_new, electrondens(ndens, avg)


def _map_ion(fn, *ions: IonState) -> IonState:
    return IonState(*(IonFractions(*(fn(*xs) for xs in zip(*fr)))
                      for fr in zip(*ions)))


def _conv_freeze(cfg: ChemistryConfig, carry, ion_new, temper1_new,
                 avg_t_new):
    """Convergence test + freeze (evolve_point.F90:605-640): converged
    cells keep their values and leave the active set."""
    ion, temper1, avg_t, active = carry
    prev_avg = ion.avg
    temper2 = temper1
    avg = ion_new.avg

    def conv(new, old):
        return (torch.abs((new - old) / new) < MIN_FRACTIONAL_CHANGE) | (
            new < MIN_FRACTION_OF_ATOMS)

    done = (conv(avg.h0, prev_avg.h0)
            & conv(avg.he0, prev_avg.he0)
            & conv(avg.he2, prev_avg.he2)
            & (torch.abs((temper1_new - temper2) / temper1_new)
               < MIN_FRACTIONAL_CHANGE))

    keep = lambda new, old: torch.where(active, new, old)
    ion_out = _map_ion(keep, ion_new, ion)
    temper1 = keep(temper1_new, temper1)
    avg_t = keep(avg_t_new, avg_t)
    return (ion_out, temper1, avg_t, active & ~done)


def _chem_iteration(cfg: ChemistryConfig, dt, ndens, clumping,
                    phi_HI, phi_HeI, phi_HeII, phi_heat, temper0,
                    fixed_rates, cosmo_cool_factor, carry, damp=None):
    """One masked fixed-point iteration (evolve_point.F90:487-640):
    {electron density -> T-dependent rates -> two doric passes averaged
    -> thermal} with converged cells frozen.  carry = (ion, temper1,
    avg_t, active); `damp` blends toward the previous iterate (see
    DAMP_AFTER), 0 or None = plain iteration.

    Returns (carry, n_substeps): the thermal sub-cycle runs on the
    active cells only (the freeze discards the rest, as in the JAX
    package's split trip, global_pass.py:284-287), so n_substeps is the
    largest sub-step count of an active cell."""
    ion, temper1, avg_t, active = carry
    ion_new, de = _doric_half(cfg, dt, ndens, clumping, phi_HI, phi_HeI,
                              phi_HeII, fixed_rates, ion, avg_t)
    blend = lambda new, old: new + damp * (old - new)
    if damp is not None:
        ion_new = _map_ion(blend, ion_new, ion)
        de = electrondens(ndens, ion_new.avg)

    temper1_new = temper0
    avg_t_new = avg_t
    n_sub = 0
    if not cfg.isothermal:
        sub = lambda x: x[active] if x.ndim else x
        tr = thermal(dt, temper0[active], de[active], ndens[active],
                     _map_ion(sub, ion_new), phi_heat[active], cfg.cooling,
                     cosmo_cool_factor)
        temper1_new = temper1.masked_scatter(active, tr.end_temper)
        avg_t_new = avg_t.masked_scatter(active, tr.avg_temper)
        n_sub = tr.n_substeps
        if damp is not None:
            temper1_new = blend(temper1_new, temper1)
            avg_t_new = blend(avg_t_new, avg_t)

    return _conv_freeze(cfg, carry, ion_new, temper1_new, avg_t_new), n_sub


def _chem_setup(cfg: ChemistryConfig, state: GridState):
    """(temper1_0, avg_t_0, fixed_rates): the isothermal temperature and
    its rates, or the state's t_final (evolve_point.F90:479) and t_av."""
    if cfg.isothermal:
        temper1_0 = torch.full_like(state.ndens, cfg.isothermal_temperature)
        return temper1_0, temper1_0, rate_coefficients(temper1_0)
    return state.t_final, state.t_av, None


def _do_chemistry_global(cfg: ChemistryConfig, dt, state: GridState,
                         phi_HI, phi_HeI, phi_HeII, phi_heat,
                         cosmo_cool_factor=None):
    """The in-graph lockstep of the JAX package
    (global_pass.py:637-655): every cell steps until none is active or
    `max_iter` is reached.  Returns (IonState, t_inter, t_av,
    n_iterations, largest thermal sub-step count of a cell)."""
    if cosmo_cool_factor is None:
        cosmo_cool_factor = cfg.cosmo_cool_factor
    ion = state.ion_state(cfg.epsilon)
    ndens = state.ndens
    temper1, avg_t, fixed_rates = _chem_setup(cfg, state)
    temper0 = temper1
    dt = torch.as_tensor(dt, dtype=ndens.dtype, device=ndens.device)
    active = torch.ones_like(ndens, dtype=torch.bool)
    carry = (ion, temper1, avg_t, active)
    nit = max_sub = 0
    while nit < cfg.max_iter and bool(torch.any(carry[3])):
        damp = torch.tensor(DAMP_FACTOR if nit >= DAMP_AFTER else 0.0,
                            dtype=ndens.dtype, device=ndens.device)
        carry, n_sub = _chem_iteration(
            cfg, dt, ndens, state.clumping, phi_HI, phi_HeI, phi_HeII,
            phi_heat, temper0, fixed_rates, cosmo_cool_factor, carry,
            damp=damp)
        max_sub = max(max_sub, n_sub)
        nit += 1
    ion, temper1, avg_t, _ = carry
    return ion, temper1, avg_t, nit, max_sub


def _finalize_pass(state: GridState, ion: IonState, t_inter, t_av
                   ) -> Tuple[GridState, torch.Tensor]:
    """Global convergence count + state write-back
    (evolve_point.F90:399-435)."""
    def big_change(new, old):
        return ((torch.abs(new - old) > MIN_FRACTIONAL_CHANGE)
                & (torch.abs((new - old) / new) > MIN_FRACTIONAL_CHANGE)
                & (new > MIN_FRACTION_OF_ATOMS))

    changed = (big_change(ion.avg.h0, state.h_av0)
               | big_change(ion.avg.he0, state.he_av0)
               | big_change(ion.avg.he2, state.he_av2)
               | ((torch.abs((state.t_av - t_av) / t_av) > 1.0e-1)
                  & (torch.abs(t_av - state.t_av) > 100.0)))
    conv_flag = torch.sum(changed.to(torch.int32))

    new_state = state._replace(
        h_int0=ion.cur.h0, h_int1=ion.cur.h1,
        he_int0=ion.cur.he0, he_int1=ion.cur.he1, he_int2=ion.cur.he2,
        h_av0=ion.avg.h0, h_av1=ion.avg.h1,
        he_av0=ion.avg.he0, he_av1=ion.avg.he1, he_av2=ion.avg.he2,
        t_inter=t_inter, t_av=t_av,
    )
    return new_state, conv_flag


def chemistry_pass_plain(cfg: ChemistryConfig, state: GridState,
                         rates: RateGrids, dt, cosmo_cool_factor=None):
    """Plain PyTorch version of the chemistry kernel.  Returns
    (new state, conv_flag, n_iterations, largest thermal sub-step count
    of a cell in one iteration; 0 when isothermal)."""
    ion, t_inter, t_av, nit, n_sub = _do_chemistry_global(
        cfg, dt, state, rates.phih, rates.phihe0, rates.phihe1,
        rates.phiheat, cosmo_cool_factor)
    new_state, conv_flag = _finalize_pass(state, ion, t_inter, t_av)
    as_t = lambda v: torch.tensor(v, dtype=torch.int32,
                                  device=state.ndens.device)
    return new_state, conv_flag, as_t(nit), as_t(n_sub)


def kernel_rows(state: GridState, rates: RateGrids):
    """The chemistry kernel's input rows (CHEM_ROWS order): the state's
    and the rates' tensors themselves, strided views included."""
    return [getattr(rates if name in _RATE_ROWS else state, name)
            for name in CHEM_ROWS]


def kernel_cooling_table(cfg: ChemistryConfig, dtype, device):
    """The heating kernel's (801, 5) cooling table (cooling.stacked) in
    `dtype` on `device`, built once per cooling tables, dtype and
    device."""
    key = (id(cfg.cooling), dtype, torch.device(device))
    hit = _COOLING.get(key)
    if hit is None:
        hit = _COOLING[key] = (cfg.cooling, stacked(cfg.cooling).to(
            dtype=dtype, device=device).contiguous())
    return hit[1]


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chemistry_pass_cuda(cfg: ChemistryConfig, state: GridState,
                        rates: RateGrids, dt, cosmo_cool_factor=None):
    """The chemistry kernel (``csrc/chemistry.cu``); same contract as
    `chemistry_pass_plain`, with the tensors it returns on the card.

    Replaces global_pass.py:_do_chemistry_global's lockstep of
    _chem_iteration plus _finalize_pass, with thermal.py's sub-cycle
    and cooling.py:coolin inside when heating.  Bound on the card by the
    per-cell arithmetic times the cell's own iteration (and, heating,
    sub-step) count: a thread that finishes its cell takes the next one,
    so a converged cell leaves no lane idle, where the TPU paid for the
    convergence tail per grid or compacted on the host.  The kernel reads
    every input row where it lies (`kernel_rows`: a pointer and a stride
    each); the heating cooling table is built once (`kernel_cooling_table`).
    """
    ndens = state.ndens
    dtype, device = ndens.dtype, ndens.device
    if not ndens.is_cuda:
        raise ValueError("the chemistry kernel takes CUDA tensors")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chemistry kernel takes float32/float64, not {dtype}")
    heat = not cfg.isothermal
    if cosmo_cool_factor is None:
        cosmo_cool_factor = cfg.cosmo_cool_factor
    n = ndens.shape[0]
    rows = kernel_rows(state, rates)
    if not heat:
        # the isothermal kernel reads neither t_final nor phiheat
        rows[20] = rows[21] = ndens
    clumping = rows[22].to(dtype=dtype).reshape(-1)
    if clumping.device != device or clumping.numel() not in (1, n):
        raise ValueError(f"clumping must be a scalar or ({n},) on {device}")
    rows[22] = clumping
    for r in rows[:22]:
        if r.shape != (n,) or r.dtype != dtype or r.device != device:
            raise ValueError("state and rates must be (n,) tensors of one "
                             "dtype on one device")
    strides = [r.stride(0) for r in rows[:22]] + [
        clumping.stride(0) if clumping.numel() == n else 0]
    cool = kernel_cooling_table(cfg, dtype, device) if heat else ndens
    out = torch.empty((12, n), dtype=dtype, device=device)
    # [conv_flag, largest iterations, largest sub-steps, -, the next cell
    # to hand out (64 bits)]
    counters = torch.zeros(6, dtype=torch.int32, device=device)

    lib = cuda_build.load("chemistry")
    name = ("chemistry_heat_" if heat else "chemistry_iso_") + (
        "f32" if dtype == torch.float32 else "f64")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_double] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    ptrs = (ctypes.c_void_p * len(rows))(*(r.data_ptr() for r in rows))
    strd = (ctypes.c_longlong * len(rows))(*strides)
    err = fn(ptrs, strd, P(cool), P(out), P(counters), n, _sm_count(device),
             float(dt), float(cfg.isothermal_temperature),
             float(cosmo_cool_factor), float(cfg.epsilon), int(cfg.max_iter),
             int(DAMP_AFTER), float(DAMP_FACTOR), cuda_build.stream_of(ndens))
    cuda_build.check(err, name)
    count("launches.chemistry.heat" if heat else "launches.chemistry")
    new_state = state._replace(
        h_int0=out[0], h_int1=out[1], he_int0=out[2], he_int1=out[3],
        he_int2=out[4], h_av0=out[5], h_av1=out[6], he_av0=out[7],
        he_av1=out[8], he_av2=out[9], t_inter=out[10], t_av=out[11])
    return new_state, counters[0], counters[1], counters[2]


def global_chemistry_pass(cfg: ChemistryConfig, state: GridState,
                          rates: RateGrids, dt, cosmo_cool_factor=None
                          ) -> Tuple[GridState, torch.Tensor]:
    """evolve0D_global over the whole grid (evolve_point.F90:325-440).

    Returns (new state, conv_flag = number of non-converged cells).
    `cosmo_cool_factor` (None = the config's) is the per-timestep
    adiabatic cooling factor.  CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    if state.ndens.is_cuda:
        pass_fn = chemistry_pass_cuda
    elif state.ndens.device.type == "cpu":
        pass_fn = chemistry_pass_plain
    else:
        raise ValueError(f"no chemistry for device {state.ndens.device}")
    new_state, conv_flag, _, _ = pass_fn(cfg, state, rates, dt,
                                         cosmo_cool_factor)
    return new_state, conv_flag
