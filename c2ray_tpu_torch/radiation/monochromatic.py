"""Monochromatic (single-frequency) radiation mode.

Port of ``c2ray_tpu/radiation/monochromatic.py``
(``code/radiation_monocromatic.F90``): all photons share one frequency
and the cross sections come from the Verner et al. (1996) analytic fits
evaluated at that frequency (radiation_monocromatic.F90:185-241).  The
result is a `QuadTables` with one band and one node, so the quadrature
route (the plain rates and the 1D kernel's quadrature variant) takes it
unchanged: one node reproduces S * e^-tau attenuation exactly.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import constants as const
from .bands import Bands
from .quadrature import QuadTables, SourceQuad
from .sed import SEDConfig, normalize_seds

_MB = 1.0e-18  # megabarn in cm^2

# Verner et al. (1996) fit parameters for (HI, HeI, HeII)
# (radiation_monocromatic.F90:188-196)
_ETH = (13.6, 24.59, 54.42)
_E0 = (0.4298, 13.61, 1.720)
_SIG0 = tuple(s * _MB for s in (5.475e4, 9.492e2, 1.369e4))
_YA = (3.288e1, 1.469, 3.288e1)
_P = (2.963, 3.188, 2.963)
_YW = (0.0, 2.039, 0.0)
_Y0 = (0.0, 4.434e-1, 0.0)
_Y1 = (0.0, 2.136, 0.0)


def verner_cross_section(energy_ev, species: int) -> float:
    """Photo-ionization cross section [cm^2] at an energy [eV]
    (Verner et al. 1996; radiation_monocromatic.F90:217-222).

    species: 0=HI, 1=HeI, 2=HeII.  Zero below threshold.
    """
    if energy_ev < _ETH[species]:
        return 0.0
    x = energy_ev / _E0[species] - _Y0[species]
    y = np.sqrt(x * x + _Y1[species] ** 2)
    F = (((x - 1.0) ** 2 + _YW[species] ** 2)
         * y ** (0.5 * _P[species] - 5.5)
         * (1.0 + np.sqrt(y / _YA[species])) ** (-_P[species]))
    return _SIG0[species] * F


def build_monochromatic_tables(sed: SEDConfig, energy_ev: float = 13.6, *,
                               isothermal=True, dtype=torch.float64,
                               flux_scale=None, device=None
                               ) -> Tuple[QuadTables, SEDConfig, Bands]:
    """Single-frequency analog of `build_quadrature_tables`.

    All S_star photons carry ``energy_ev``; cross sections are the
    Verner fits at that energy.  Returns the same (tables, sed, bands)
    triple so the 1D machinery is reused unchanged.
    """
    freq = energy_ev * const.ev2fr
    sig = np.array([verner_cross_section(energy_ev, s) for s in range(3)])

    # one band spanning just the chosen frequency
    bands = Bands(
        nbnd1=1, nbnd2=0, nbnd3=0,
        freq_min=np.array([freq]), freq_max=np.array([freq]),
        delta_freq=np.array([0.0]),
        sigma_HI=np.array([sig[0]]), sigma_HeI=np.array([sig[1]]),
        sigma_HeII=np.array([sig[2]]),
        pli_HI=np.array([0.0]), pli_HeI=np.array([0.0]),
        pli_HeII=np.array([0.0]))

    # normalization: total rate is just S_star (photon sense)
    sed = normalize_seds(
        sed, const.ion_freq_HI, const.ion_freq_HeII * 100.0) \
        if sed.bb is not None and sed.bb.S_star == 0.0 else sed
    S_total = sum(s.S_star for s in (sed.bb, sed.pl, sed.qso)
                  if s is not None)
    if flux_scale is None:
        flux_scale = 1.0 if dtype == torch.float64 else max(S_total, 1.0)

    arr = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                    dtype=dtype, device=device)

    def one_source(S_star):
        if S_star is None:
            return None
        heat = None
        if not isothermal:
            heat = [arr(np.array([[S_star / flux_scale * const.hplanck
                                   * max(freq - thr, 0.0)]]))
                    for thr in (const.ion_freq_HI, const.ion_freq_HeI,
                                const.ion_freq_HeII)]
        return SourceQuad(
            band_lo=0, band_hi=0,
            sigma_hat=arr(np.ones((1, 1))),
            A_photo=arr(np.array([[S_star / flux_scale]])),
            A_heat_HI=None if heat is None else heat[0],
            A_heat_HeI=None if heat is None else heat[1],
            A_heat_HeII=None if heat is None else heat[2])

    z1 = arr(np.zeros(1))
    qt = QuadTables(
        bb=one_source(sed.bb.S_star if sed.bb else None),
        pl=one_source(sed.pl.S_star if sed.pl else None),
        qso=one_source(sed.qso.S_star if sed.qso else None),
        sigma_HI=arr(bands.sigma_HI), sigma_HeI=arr(bands.sigma_HeI),
        sigma_HeII=arr(bands.sigma_HeII),
        f1ion_HI=z1, f1ion_HeI=z1, f1ion_HeII=z1,
        f2ion_HI=z1, f2ion_HeI=z1, f2ion_HeII=z1,
        f1heat_HI=z1, f1heat_HeI=z1, f1heat_HeII=z1,
        f2heat_HI=z1, f2heat_HeI=z1, f2heat_HeII=z1,
        mask_HeI=arr((bands.sigma_HeI > 0).astype(float)),
        mask_HeII=arr((bands.sigma_HeII > 0).astype(float)),
    )
    bands = dataclasses.replace(bands, flux_scale=float(flux_scale))
    return qt, sed, bands
