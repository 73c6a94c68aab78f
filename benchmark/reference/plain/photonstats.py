"""Photon-conservation accounting.

Port of ``c2ray_tpu/photonstats.py``
(``code/files_for_3D/photonstatistics.f90``): the audit that compares
ionizations + recombinations against the photons emitted every
timestep.  Sums over cells run on the state's device in its dtype; the
volume factors (~1e68 cm^3 per cell at cosmological dr) are applied on
the host in float64, where a float32 multiply would overflow.  A state
cut into slabs over ranks (the domain mode) passes `reduce`, which sums
each function's partial sums over the ranks in one all-reduce.
"""

from typing import NamedTuple

import torch

from . import constants as const
from .chemistry import IonFractions, electrondens
from .rates import RateCoeffs
from .state import GridState


class SpeciesInventory(NamedTuple):
    """Volume-integrated atom counts per species (state_before/after,
    photonstatistics.f90:117-144), host floats."""

    h0: float
    h1: float
    he0: float
    he1: float
    he2: float


def _host_sums(terms, reduce=None):
    """The sums of `terms` over their cells, as host floats; `reduce`
    (e.g. parallel.comm.psum) adds the ranks' sums, all in one call."""
    sums = torch.stack([torch.sum(t) for t in terms])
    if reduce is not None:
        sums = reduce(sums)
    return [float(x) for x in sums.cpu()]


def species_inventory(state: GridState, vol, use_start=True, reduce=None
                      ) -> SpeciesInventory:
    nd = state.ndens
    if use_start:
        f = (state.h0, state.h1, state.he0, state.he1, state.he2)
    else:
        f = (state.h_int0, state.h_int1, state.he_int0, state.he_int1,
             state.he_int2)
    ab_h = float(vol) * (1.0 - const.abu_he)
    ab_he = float(vol) * const.abu_he
    s = _host_sums([nd * x for x in f], reduce)
    return SpeciesInventory(h0=s[0] * ab_h, h1=s[1] * ab_h, he0=s[2] * ab_he,
                            he1=s[3] * ab_he, he2=s[4] * ab_he)


class PhotonBudget(NamedTuple):
    """One timestep's photon budget (report_photonstatistics,
    photonstatistics.f90:272-318)."""

    total_ion: float              # new ionizations (atoms)
    totrec: float                 # recombinations not producing ions
    totcollisions: float          # collisional ionizations
    recomions: float              # He-recombination-driven ionizations
    total_src: float              # photons emitted
    photon_conservation: float    # (ion - coll - recomion)/src
    # photons lost over the trace boundary / in LLSs this step
    # (photonstatistics.f90:278-281)
    total_photon_loss: float = 0.0
    total_lls_loss: float = 0.0


def total_rates(state: GridState, rates: RateCoeffs, vol, dt, reduce=None):
    """Recombination / collisional budgets over the step using the
    time-averaged fractions (total_rates, photonstatistics.f90:150-203)."""
    nd = state.ndens
    avg = IonFractions(state.h_av0, state.h_av1, state.he_av0,
                       state.he_av1, state.he_av2)
    ne = electrondens(nd, avg)
    cl = state.clumping

    voldt = float(vol) * float(dt)
    s = _host_sums([
        nd * (avg.h1 * rates.brech0 * (1.0 - const.abu_he)
              + avg.he1 * rates.breche0 * const.abu_he * 0.04) * ne * cl,
        nd * ne * (avg.h0 * rates.colli_HI + avg.he0 * rates.colli_HeI
                   + avg.he1 * rates.colli_HeII),
        nd * const.abu_he * cl
        * (avg.he2 * 1.121 * rates.breche1 + avg.he1 * rates.breche0 * 0.96)
        * const.abu_he * ne], reduce)
    return s[0] * voldt, s[1] * voldt, s[2] * voldt


def photon_budget(before: SpeciesInventory, state: GridState,
                  rates: RateCoeffs, vol, dt, total_src,
                  photon_loss=0.0, lls_loss=0.0, reduce=None) -> PhotonBudget:
    """Full conservation report for one step.

    ``total_src``: photons emitted = sum(NormFlux)*S_star*dt
    (photonstatistics.f90:282-288).  ``photon_loss`` / ``lls_loss``
    are the last iteration's loss rates in physical photons/s; they
    enter the report as loss*dt (photonstatistics.f90:278-281).
    """
    after = species_inventory(state, vol, use_start=True, reduce=reduce)
    # total_ionizations (photonstatistics.f90:239-247)
    dh0 = before.h0 - after.h0
    dhe0 = before.he0 - after.he0
    dhe2 = after.he2 - before.he2
    total_ion = dh0 + dhe0 + dhe2

    totrec, totcoll, recomions = total_rates(state, rates, vol, dt, reduce)
    photcons = (total_ion - totcoll - recomions) / max(
        float(total_src), 1e-300)
    return PhotonBudget(
        total_ion=total_ion, totrec=totrec, totcollisions=totcoll,
        recomions=recomions, total_src=float(total_src),
        photon_conservation=photcons,
        total_photon_loss=float(photon_loss) * float(dt),
        total_lls_loss=float(lls_loss) * float(dt))


def photcons_violation(budget: PhotonBudget, tolerance=0.15) -> int:
    """photcons_flag (output.F90:522-533): flag a photon-conservation
    problem when more than `tolerance` of the emitted photons are
    unaccounted for AND the deficit is not explained by photons leaving
    the grid (the reference's commented-out logic, active here as in
    the JAX package)."""
    if budget.total_src <= 0.0:
        return 0
    deficit = 1.0 - float(budget.photon_conservation)
    loss_frac = (budget.total_photon_loss + budget.total_lls_loss) \
        / budget.total_src
    if deficit > tolerance and loss_frac < deficit:
        return 1
    return 0
