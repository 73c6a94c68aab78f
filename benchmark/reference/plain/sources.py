"""Source catalogs, luminosity models and low-mass suppression.

Port of ``c2ray_tpu/sources.py`` (numpy host code, the same as the JAX
package's; the driver copies the ionization grid to the host once per
slice for the suppression test): the `sourceprops` module family:

- test catalogs (explicit position + photon-rate lists):
  ``code/files_for_3D/sourceprops_test.F90``
- halo catalogs with suppressible low-mass sources and three UV
  luminosity models: ``code/files_for_3D/sourceprops_cubep3m.F90``
  (also covering the pmfast / LG / gadget / test4 variants, which differ
  only in file naming conventions handled by `c2ray_tpu_torch.nbody`)
- the controlled source-order randomisation `ctrper`
  (``code/ctrper.f90``); with batched sweeps the processing order no
  longer affects load balance, but the utility is kept for parity.

All fluxes are *normalised*: NormFlux = photon rate / S_star of the
corresponding SED component, so a source of NormFlux 1 emits exactly the
table-normalised spectrum (sourceprops_test.F90:110-167).
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from . import constants as const
from .radiation.sed import SEDConfig


class SourceList(NamedTuple):
    """Batched sources: positions (S,3) int32 (0-based) and normalised
    fluxes (S,3) for (BB, PL, QSO)."""

    srcpos: np.ndarray
    nflux: np.ndarray

    @property
    def n_sources(self) -> int:
        return self.srcpos.shape[0]


# ---------------------------------------------------------------------------
# Halo-catalog source model (sourceprops_cubep3m.F90)
# ---------------------------------------------------------------------------


@dataclass
class HaloSourceModel:
    """Halo -> luminosity model (sourceprops_cubep3m.F90:518-709).

    uv_model: "Iliev et al" (Ndot = f M / (m_p dt)), "Fixed N_gamma"
    (per-slice photon budget with cumulative carry-over) or
    "Fixed Ndot_gamma" (per-slice photon rate)
    (sourceprops_cubep3m.F90:740-781).
    """

    M_grid: float                     # grid mass unit [g] (nbody)
    uv_model: str = "Iliev et al"
    # photons/atom for (high-mass, low-mass) sources
    # (c2ray_parameters.f90:94)
    phot_per_atom: Tuple[float, float] = (10.0, 150.0)
    xray_phot_per_atom: float = 0.02  # c2ray_parameters.f90:99
    lifetime: float = 20e6 * const.YEAR  # c2ray_parameters.f90:103
    still_neutral: float = 0.1        # c2ray_parameters.f90:109
    Omega_B: float = 0.044
    Omega0: float = 0.27
    # "Fixed N_gamma" bookkeeping (sourceprops_cubep3m.F90:560-585)
    cumfrac_max: float = 0.15
    uv_array: Optional[np.ndarray] = None  # photons (or rates) per slice
    cumulative_uv: float = 0.0

    def luminosity_from_mass(self, mass_grid_units):
        """NormFlux for an effective mass, in units of S_star
        (sourceprops_cubep3m.F90:621-642); divide by the timestep to
        get the Iliev-et-al rate."""
        return (mass_grid_units * self.M_grid * self.Omega_B
                / (self.Omega0 * const.m_p))


class HaloCatalog(NamedTuple):
    """A halo source catalog for one redshift slice: positions (N,3)
    0-based, high-mass column, suppressible low-mass column, optional
    QSO luminosity column (the `<z>_wsubgrid_sources.dat` content,
    sourceprops_cubep3m.F90:42-64)."""

    pos: np.ndarray
    mass_hmach: np.ndarray
    mass_lmach: np.ndarray
    qso_lum: Optional[np.ndarray] = None


class SuppressionStats(NamedTuple):
    n_total: int
    n_active: int
    n_massive: int
    n_supprble: int
    n_suppressed: int


def apply_suppression_and_luminosities(
        catalog: HaloCatalog, xh1, model: HaloSourceModel,
        sed: SEDConfig, dt, slice_index: int = 0
) -> Tuple[SourceList, SuppressionStats]:
    """Suppression + UV model in one vectorised pass
    (sourceprops_cubep3m.F90:251-413, 518-617).

    ``xh1``: the ionized-H fraction grid, flattened or 3D, used for the
    "still neutral" suppression criterion; low-mass halos only shine
    where xh1 < still_neutral (and only under "Iliev et al").
    Mutates model.cumulative_uv for the "Fixed N_gamma" bookkeeping.
    """
    xh1 = np.asarray(xh1)
    if xh1.ndim == 3:
        cell_x = xh1[catalog.pos[:, 0], catalog.pos[:, 1], catalog.pos[:, 2]]
    else:
        mesh = round(len(xh1) ** (1 / 3))
        flat = ((catalog.pos[:, 0] * mesh + catalog.pos[:, 1]) * mesh
                + catalog.pos[:, 2])
        cell_x = xh1[flat]

    neutral = cell_x < model.still_neutral
    has_hm = catalog.mass_hmach > 0.0
    has_lm = catalog.mass_lmach > 0.0
    has_qso = (catalog.qso_lum is not None) & (
        np.zeros_like(has_hm, dtype=bool) if catalog.qso_lum is None
        else catalog.qso_lum > 0.0)

    iliev = model.uv_model == "Iliev et al"
    # active: massive or QSO always; low-mass only in neutral cells under
    # the Iliev model (sourceprops_cubep3m.F90:354-397)
    active = has_hm | has_qso | (neutral & has_lm & iliev)
    lm_effective = np.where(neutral & iliev, catalog.mass_lmach, 0.0)

    stats = SuppressionStats(
        n_total=len(catalog.pos),
        n_active=int(active.sum()),
        n_massive=int(has_hm.sum()),
        n_supprble=int(has_lm.sum()),
        n_suppressed=int((has_lm & ~(neutral & iliev)).sum()),
    )

    pos = catalog.pos[active]
    m_h = catalog.mass_hmach[active]
    m_l = lm_effective[active]

    if iliev:
        src_mass = (m_h * model.phot_per_atom[0]
                    + m_l * model.phot_per_atom[1])
        nflux_bb = model.luminosity_from_mass(src_mass) / (
            sed.bb.S_star * model.lifetime)
        pl_mass = model.xray_phot_per_atom * (m_h + m_l)
    else:
        src_mass = m_h
        pl_mass = model.xray_phot_per_atom * m_h
        total = max(src_mass.sum(), 1e-300)
        uv = model.uv_array
        if uv is None or slice_index >= len(uv):
            nflux_bb = np.zeros_like(src_mass)
        elif model.uv_model == "Fixed N_gamma":
            cumfrac = min(model.cumfrac_max,
                          model.cumulative_uv / uv[slice_index])
            nflux_bb = ((1.0 + cumfrac) * uv[slice_index] / model.lifetime
                        * src_mass / (total * sed.bb.S_star))
            model.cumulative_uv = max(
                0.0, model.cumulative_uv - cumfrac * uv[slice_index])
        elif model.uv_model == "Fixed Ndot_gamma":
            nflux_bb = uv[slice_index] * src_mass / (total * sed.bb.S_star)
        else:
            raise ValueError(f"unknown UV model {model.uv_model}")

    nflux = np.zeros((len(pos), 3))
    nflux[:, 0] = nflux_bb
    if sed.pl is not None:
        nflux[:, 1] = model.luminosity_from_mass(pl_mass) / (
            sed.pl.S_star * model.lifetime)
    if sed.qso is not None and catalog.qso_lum is not None:
        nflux[:, 2] = qso_luminosity_to_nflux(
            catalog.qso_lum[active], sed)
    return SourceList(srcpos=pos.astype(np.int32), nflux=nflux), stats


def qso_luminosity_to_nflux(lum_2kev, sed: SEDConfig):
    """erg/s at 2 keV -> normalised photon rate
    (QPL_Luminosity_convert, sourceprops_cubep3m.F90:674-709)."""
    qso = sed.qso
    Emin = qso.min_freq / const.ev2fr
    Emax = qso.max_freq / const.ev2fr
    delta_E = (Emax - Emin) * const.ev2erg
    alpha = qso.index - 1.0
    nphot = (-1.0 / delta_E * lum_2kev / (2000.0 ** (-alpha))
             / alpha * (Emax ** (-alpha) - Emin ** (-alpha)))
    return nphot / qso.S_star
