"""Thermal evolution of cells: sub-cycled internal-energy integration.

Port of ``c2ray_tpu/thermal.py`` (``code/thermal.f90:22-174`` and the
temperature/pressure helpers of ``code/tped.f90:41-70``).

Each cell integrates its internal energy with an adaptive explicit
sub-cycle (dt_thermal = RELATIVE_DENERGY * u / |rate|, at most
MAX_SUBSTEPS sub-steps).  `thermal_substeps` is the plain version: all
cells advance together in a masked lockstep loop, each taking its own
step until its own cumulative time reaches dt.  The chemistry kernel
(``csrc/chemistry.cu``) runs the same sub-cycle as a per-thread loop:
a cell's value sequence depends only on its own steps, and the cap on
the lockstep index equals the cell's own step count while it is active,
so the two agree cell for cell.
"""

from typing import NamedTuple

import torch

from . import constants as const
from .chemistry import IonState, electrondens
from .cooling import CoolingTables, coolin

# c2ray_parameters.f90:87-89
MINITEMP = 1.0
RELATIVE_DENERGY = 0.1
MAX_SUBSTEPS = 10000


def temper2pressr(temper, ndens, eldens):
    """tped.f90:41-53"""
    return (ndens + eldens) * const.k_B * temper


def pressr2temper(pressr, ndens, eldens):
    """tped.f90:58-70"""
    return pressr / (const.k_B * (ndens + eldens))


class ThermalResult(NamedTuple):
    end_temper: torch.Tensor
    avg_temper: torch.Tensor
    n_substeps: int


class ThermalCtx(NamedTuple):
    """Per-cell constants of the sub-cycle (thermal.f90:62-79)."""
    heating: torch.Tensor
    ndens_atom: torch.Tensor
    ndens_electron: torch.Tensor   # coolin's ne (start-of-step state)
    ne_av: torch.Tensor            # T<->p conversions inside the loop
    ne_end: torch.Tensor           # end-of-step conversion (finalize)
    cosmo_cool_rate: torch.Tensor  # factor * u0 (thermal.f90:74-79)
    T0: torch.Tensor               # entry temperature
    xh0: torch.Tensor              # ion.avg fractions for coolin
    xh1: torch.Tensor
    xhe0: torch.Tensor
    xhe1: torch.Tensor
    xhe2: torch.Tensor


class ThermalCarry(NamedTuple):
    """Evolving per-cell state of the sub-cycle."""
    u: torch.Tensor
    T: torch.Tensor
    avg_sum: torch.Tensor
    cum: torch.Tensor
    active: torch.Tensor


def thermal_init(dt, end_temper, ndens_electron, ndens_atom,
                 ion: IonState, heating, cosmo_cool_factor):
    """Set up the sub-cycle (thermal.f90:62-83).  Returns
    (ThermalCtx, ThermalCarry); every leaf has the shape of
    `end_temper`."""
    T0 = torch.as_tensor(end_temper)
    shape, dtype, device = T0.shape, T0.dtype, T0.device
    bc = lambda x: torch.broadcast_to(
        torch.as_tensor(x, dtype=dtype, device=device), shape)
    heating = bc(heating)
    ndens_atom = bc(ndens_atom)
    ndens_electron = bc(ndens_electron)

    # electron densities used inside the loop are held at the
    # start-of-step ionic state (thermal.f90:68-69, 131-132)
    ne_old = electrondens(ndens_atom, ion.old)
    ne_av = electrondens(ndens_atom, ion.avg)
    ne_end = electrondens(ndens_atom, ion.cur)

    u0 = temper2pressr(T0, ndens_atom, ne_old) / const.gamma1
    # fixed during the sub-cycle, from the initial energy
    # (thermal.f90:74-79)
    cosmo_cool_rate = bc(cosmo_cool_factor) * u0

    active0 = T0 > MINITEMP  # thermal.f90:83
    zero = torch.zeros_like(T0)
    ctx = ThermalCtx(heating=heating, ndens_atom=ndens_atom,
                     ndens_electron=ndens_electron, ne_av=bc(ne_av),
                     ne_end=bc(ne_end), cosmo_cool_rate=cosmo_cool_rate,
                     T0=T0, xh0=bc(ion.avg.h0), xh1=bc(ion.avg.h1),
                     xhe0=bc(ion.avg.he0), xhe1=bc(ion.avg.he1),
                     xhe2=bc(ion.avg.he2))
    # the time done keeps the sub-cycle's clock (thermal_substeps)
    cum = torch.zeros_like(T0, dtype=torch.promote_types(T0.dtype,
                                                         torch.float32))
    carry = ThermalCarry(u=u0, T=T0, avg_sum=zero, cum=cum,
                         active=active0)
    return ctx, carry


def thermal_substeps(cooling_tables: CoolingTables, dt, ctx: ThermalCtx,
                     carry: ThermalCarry, nit0: int = 0,
                     max_substeps: int = MAX_SUBSTEPS):
    """The masked lockstep sub-cycle (thermal.f90:110-155), from lockstep
    index `nit0` until every cell is done or the index reaches
    `max_substeps`.  Returns (carry, index)."""
    # the sub-cycle's clock (dt, the time done) is kept in float32 at
    # least: in a lower precision (the control's bfloat16) the sum of
    # sub-steps stops growing short of dt and the loop never ends.  In
    # float32 and float64 this is the port's arithmetic unchanged.
    clock = torch.promote_types(ctx.T0.dtype, torch.float32)
    dt = torch.as_tensor(dt, dtype=clock, device=ctx.T0.device)
    u_floor = temper2pressr(
        torch.as_tensor(MINITEMP, dtype=ctx.T0.dtype, device=ctx.T0.device),
        ctx.ndens_atom, ctx.ne_av) / const.gamma1
    nit = nit0
    while nit < max_substeps and bool(torch.any(carry.active)):
        u, T, avg_sum, cum, active = carry

        cooling = coolin(cooling_tables, ctx.ndens_atom,
                         ctx.ndens_electron, ctx.xh0, ctx.xh1, ctx.xhe0,
                         ctx.xhe1, ctx.xhe2, T) + ctx.cosmo_cool_rate
        thermal_rate = torch.clamp(torch.abs(cooling - ctx.heating),
                                   min=1e-50)
        dt_thermal = RELATIVE_DENERGY * u / thermal_rate
        dt_ode = torch.minimum(dt_thermal, (dt - cum).to(u.dtype))

        u_new = u + dt_ode * (ctx.heating - cooling)
        avg_new = avg_sum + 0.5 * T * dt_ode
        T_new = pressr2temper(u_new * const.gamma1, ctx.ndens_atom,
                              ctx.ne_av)
        avg_new = avg_new + 0.5 * T_new * dt_ode

        # floor at minitemp (thermal.f90:140-146).  The reference resets
        # internal_energy to the *pressure* at minitemp there (missing
        # the 1/gamma1); the JAX package and the port use u = p/gamma1.
        too_cold = T_new < MINITEMP
        u_new = torch.where(too_cold, u_floor, u_new)
        T_new = torch.where(too_cold, torch.full_like(T_new, MINITEMP),
                            T_new)

        cum_new = cum + dt_ode.to(clock)
        done = (cum_new >= dt) | (torch.abs(cum_new - dt) < 1e-6 * dt)

        # only active cells advance
        carry = ThermalCarry(u=torch.where(active, u_new, u),
                             T=torch.where(active, T_new, T),
                             avg_sum=torch.where(active, avg_new, avg_sum),
                             cum=torch.where(active, cum_new, cum),
                             active=active & ~done)
        nit += 1
    return carry, nit


def thermal_finalize(ctx: ThermalCtx, carry: ThermalCarry, dt):
    """(end_temper, avg_temper) from a finished carry
    (thermal.f90:160-171)."""
    dt = torch.as_tensor(dt, dtype=ctx.T0.dtype, device=ctx.T0.device)
    avg_temper = torch.where(dt > 0.0, carry.avg_sum / dt, ctx.T0)
    end_T = pressr2temper(carry.u * const.gamma1, ctx.ndens_atom,
                          ctx.ne_end)
    # cells that never entered the loop keep their temperature and
    # report avg = initial (thermal.f90:83,160-171)
    active0 = ctx.T0 > MINITEMP
    end_T = torch.where(active0, end_T, ctx.T0)
    avg_temper = torch.where(active0, avg_temper, ctx.T0)
    return end_T, avg_temper


def thermal(dt, end_temper, ndens_electron, ndens_atom, ion: IonState,
            heating, cooling_tables: CoolingTables, cosmo_cool_factor=0.0,
            max_substeps: int = MAX_SUBSTEPS) -> ThermalResult:
    """Sub-cycled thermal update (thermal.f90:22-174), elementwise.

    ``heating`` is the photo-heating rate [erg cm^-3 s^-1] (phi%heat).
    ``cosmo_cool_factor`` is 2 (dz/dt)/(1+z): the adiabatic cosmological
    cooling rate is factor * u evaluated on the initial internal energy
    (thermal.f90:74-79, cosmology.f90:207-234).  `n_substeps` is the
    number of lockstep sub-steps, the largest count of any cell.
    """
    ctx, carry = thermal_init(dt, end_temper, ndens_electron, ndens_atom,
                              ion, heating, cosmo_cool_factor)
    carry, nit = thermal_substeps(cooling_tables, dt, ctx, carry, 0,
                                  max_substeps)
    end_T, avg_temper = thermal_finalize(ctx, carry, dt)
    return ThermalResult(end_temper=end_T, avg_temper=avg_temper,
                         n_substeps=nit)
