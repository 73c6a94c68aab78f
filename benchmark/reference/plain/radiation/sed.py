"""Source SEDs (blackbody / power-law / quasar power-law) and normalization.

Re-implementation of ``code/radiation_sed_parameters.f90`` and the nominal
values in ``code/sed_parameters.f90``.  The reference gates power-law and
quasar sources behind ``-DPL``/``-DQUASARS`` compile flags; here they are
ordinary optional components of :class:`SEDConfig`.

All integration is host-side numpy (table building happens once).
"""

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from .. import constants as const
from ..romberg import romberg_weights
from .bands import NumFreq


@dataclass(frozen=True)
class BlackBodySED:
    """Blackbody source (radiation_sed_parameters.f90:68-74, 637-679).

    Specify exactly one of ``S_star`` (ionizing photon rate, s^-1) or
    ``L_star_ion`` (ionizing luminosity, erg/s) or ``R_star`` (cm); the
    normalization fixes the others.
    """

    T_eff: float = 5.0e4          # sed_parameters.f90:31
    S_star: float = 1e48          # sed_parameters.f90:33
    L_star_ion: float = 0.0
    R_star: float = const.R_SOLAR
    L_star: float = 0.0

    @property
    def h_over_kT(self) -> float:
        return const.hplanck / (const.k_B * self.T_eff)


@dataclass(frozen=True)
class PowerLawSED:
    """(Quasar) power-law source (radiation_sed_parameters.f90:81-100).

    ``index`` is the photon-number power-law index.  Normalized either to
    ``S_star`` (photon rate) or to ``Edd_efficiency * EddLum`` (energy).
    """

    index: float = 2.5                     # sed_parameters.f90:40
    S_star: float = 1e48                   # sed_parameters.f90:46
    Edd_efficiency: float = 0.0
    EddLum: float = 1.38e38 * 1.0e6        # sed_parameters.f90:42-44
    min_freq: float = 0.3 * 1e3 * const.ev2fr   # sed_parameters.f90:48
    max_freq: float = const.ion_freq_HeII * 100.0
    scaling: float = 1.0
    ionizing_luminosity: float = 0.0


@dataclass(frozen=True)
class SEDConfig:
    """The full source-spectrum configuration (source types B/P/Q/A)."""

    bb: Optional[BlackBodySED] = None
    pl: Optional[PowerLawSED] = None
    qso: Optional[PowerLawSED] = None


def blackbody_photon_density(freq, h_over_kT):
    """Photon-sense blackbody (radiation_sed_parameters.f90:803-823)."""
    x = freq * h_over_kT
    # guard overflow of exp for large x (the reference switches to
    # exp(x/2)^2 which is identical; we just clamp)
    safe = np.minimum(x, 709.0)
    val = const.two_pi_over_c_square * freq * freq / (np.exp(safe) - 1.0)
    return np.where(x <= 709.0, val, const.two_pi_over_c_square * freq**2 * np.exp(-x))


def powerlaw_photon_density(freq, index):
    """Photon-sense power law (radiation_sed_parameters.f90:827-841)."""
    return freq ** (-index)


def _integrate(fn, fmin, fmax, energy_sense: bool):
    """Romberg integral of an SED over [fmin, fmax] with NumFreq+1 points
    (radiation_sed_parameters.f90:746-799)."""
    dx = (fmax - fmin) / NumFreq
    freq = fmin + dx * np.arange(NumFreq + 1)
    vals = fn(freq)
    if energy_sense:
        vals = vals * const.hplanck * freq
    w = romberg_weights(NumFreq)
    return float(np.sum(vals * w) * dx)


def integrate_bb(bb: BlackBodySED, fmin, fmax, sense="S", edges=None):
    """Photon ('S') or energy ('L') integral of the scaled blackbody.

    ``edges``: optional array of interior band edges; when given, the
    integral is accumulated band-by-band exactly as the rate tables are
    (the reference instead uses a single coarse 513-point integral over
    the whole ionizing range, radiation_sed_parameters.f90:746-781, which
    under-resolves the BB peak by ~1%; band-wise integration makes the
    table photon budget match S_star exactly).
    """
    fn = lambda f: blackbody_photon_density(f, bb.h_over_kT)
    if edges is None:
        raw = _integrate(fn, fmin, fmax, energy_sense=(sense == "L"))
    else:
        pts = [fmin] + [e for e in np.atleast_1d(edges)
                        if fmin < e < fmax] + [fmax]
        raw = sum(_integrate(fn, a, b, energy_sense=(sense == "L"))
                  for a, b in zip(pts[:-1], pts[1:]))
    return 4.0 * const.pi * bb.R_star**2 * raw


def integrate_pl(pl: PowerLawSED, fmin, fmax, sense="S"):
    raw = _integrate(
        lambda f: powerlaw_photon_density(f, pl.index),
        fmin, fmax, energy_sense=(sense == "L"))
    return pl.scaling * raw


def normalize_blackbody(bb: BlackBodySED, freq_lo, freq_hi,
                        edges=None) -> BlackBodySED:
    """Scale R_star/L_star so the requested S_star or L_star_ion is met
    (radiation_sed_parameters.f90:637-679).

    ``freq_lo``/``freq_hi``: full ionizing range covered by the bands;
    ``edges``: interior band edges for band-wise integration.
    """
    bb_flux = const.sigma_SB * bb.T_eff**4
    L_star = 4.0 * const.pi * bb.R_star**2 * bb_flux
    bb = replace(bb, L_star=L_star)

    if bb.L_star_ion != 0.0:
        L_unscaled = integrate_bb(bb, freq_lo, freq_hi, "L", edges)
        R_star = np.sqrt(bb.L_star_ion / L_unscaled) * bb.R_star
        bb = replace(bb, R_star=float(R_star),
                     L_star=float(4.0 * const.pi * R_star**2 * bb_flux))
        S_star = integrate_bb(bb, freq_lo, freq_hi, "S", edges)
        return replace(bb, S_star=S_star)

    S_unscaled = integrate_bb(bb, freq_lo, freq_hi, "S", edges)
    if bb.S_star == 0.0:
        bb = replace(bb, S_star=S_unscaled)
    else:
        s = bb.S_star / S_unscaled
        bb = replace(bb, R_star=float(np.sqrt(s) * bb.R_star),
                     L_star=float(s * bb.L_star))
    return replace(bb,
                   L_star_ion=integrate_bb(bb, freq_lo, freq_hi, "L", edges))


def normalize_powerlaw(pl: PowerLawSED) -> PowerLawSED:
    """Normalize to photon rate or Eddington efficiency
    (radiation_sed_parameters.f90:684-709)."""
    if pl.S_star > 0.0:
        S_unscaled = integrate_pl(replace(pl, scaling=1.0),
                                  pl.min_freq, pl.max_freq, "S")
        pl = replace(pl, scaling=pl.S_star / S_unscaled)
        L_ion = integrate_pl(pl, pl.min_freq, pl.max_freq, "L")
        return replace(pl, ionizing_luminosity=L_ion,
                       Edd_efficiency=L_ion / pl.EddLum)
    L_ion = pl.EddLum * pl.Edd_efficiency
    L_unscaled = integrate_pl(replace(pl, scaling=1.0),
                              pl.min_freq, pl.max_freq, "L")
    pl = replace(pl, scaling=L_ion / L_unscaled, ionizing_luminosity=L_ion)
    return replace(pl, S_star=integrate_pl(pl, pl.min_freq, pl.max_freq, "S"))


def normalize_seds(sed: SEDConfig, freq_lo, freq_hi,
                   edges=None) -> SEDConfig:
    """Normalize all configured source components
    (radiation_sed_parameters.f90:473-485)."""
    return SEDConfig(
        bb=(normalize_blackbody(sed.bb, freq_lo, freq_hi, edges)
            if sed.bb else None),
        pl=normalize_powerlaw(sed.pl) if sed.pl else None,
        qso=normalize_powerlaw(sed.qso) if sed.qso else None,
    )


def nominal_quasar() -> PowerLawSED:
    """Nominal quasar SED (sed_parameters.f90:53-67)."""
    return PowerLawSED(index=1.8, S_star=1e48)
