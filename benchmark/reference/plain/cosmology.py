"""Cosmological evolution: time <-> redshift, comoving rescaling, cooling.

Port of ``c2ray_tpu/cosmology.py`` (``code/cosmology.f90`` and the
parameter variants ``code/cosmoparms*.f90``).  Host code in Python
floats: it is the source of the per-step ``cosmo_cool_factor`` that the
thermal sub-cycle takes.  The EdS high-z approximations of the
reference are kept exactly (cosmology.f90:61,94,117,146 are 'Good only
for high-z').
"""

import math
from dataclasses import dataclass

from . import constants as const

_KM = 1e5
_MPC = const.Mpc


@dataclass(frozen=True)
class CosmologyParams:
    """Cosmological parameter set (cosmoparms.f90:28-43)."""

    cosmo_id: str
    h: float
    Omega0: float
    Omega_B: float
    cmbtemp: float = 2.726

    @property
    def H0(self) -> float:
        """Hubble constant in s^-1."""
        return self.h * 100.0 * _KM / _MPC

    @property
    def rho_crit_0(self) -> float:
        return 3.0 * self.H0**2 / (8.0 * const.pi * const.G_grav)


# The parameter variants of the reference (one linked per build,
# cosmoparms_*.f90); default is WMAP3+ (cosmoparms.f90).
COSMOLOGIES = {
    "WMAP3plus": CosmologyParams("WMAP3plus", h=0.7, Omega0=0.27, Omega_B=0.044),
    "WMAP1": CosmologyParams("WMAP1", h=0.71, Omega0=0.27, Omega_B=0.044),
    "WMAP3": CosmologyParams("WMAP3", h=0.73, Omega0=0.238, Omega_B=0.0418),
    "WMAP5": CosmologyParams("WMAP5", h=0.7, Omega0=0.279, Omega_B=0.0462),
    "EoRKP": CosmologyParams("EoRKP", h=0.678, Omega0=0.308, Omega_B=0.0484),
    "TEST4": CosmologyParams("TEST4", h=0.7, Omega0=0.27, Omega_B=0.043),
}

DEFAULT_COSMOLOGY = COSMOLOGIES["WMAP3plus"]


@dataclass(frozen=True)
class CosmoClock:
    """Tracks the (z, t) correspondence from an initial redshift
    (the module state of cosmology.f90: zred_t0, t0, zred)."""

    params: CosmologyParams
    zred_t0: float
    t0: float
    zred: float = 0.0

    @classmethod
    def init(cls, params: CosmologyParams, zred0: float) -> "CosmoClock":
        """cosmology_init (cosmology.f90:49-73): t0 good only for high z."""
        t0 = 2.0 * (1.0 + zred0) ** (-1.5) / (3.0 * params.H0
                                              * math.sqrt(params.Omega0))
        # zred starts at 0 so the first rescale converts comoving -> proper
        return cls(params=params, zred_t0=zred0, t0=float(t0), zred=0.0)

    def time2zred(self, time):
        """cosmology.f90:78-96"""
        return -1.0 + (1.0 + self.zred_t0) * (self.t0 / (self.t0 + time)) ** (2.0 / 3.0)

    def zred2time(self, zred1):
        """cosmology.f90:101-119"""
        return self.t0 * (((1.0 + self.zred_t0) / (1.0 + zred1)) ** 1.5 - 1.0)

    def redshift_evol(self, time):
        """cosmology.f90:125-153: returns (new clock, zfactor, Hz)."""
        zred_prev = self.zred
        zred = float(-1.0 + (1.0 + self.zred_t0)
                     * ((self.t0 + time) / self.t0) ** (-2.0 / 3.0))
        zfactor = (1.0 + zred_prev) / (1.0 + zred)
        Hz = self.params.H0 * (1.0 + zred) ** 1.5 * math.sqrt(
            self.params.Omega0)
        new = CosmoClock(params=self.params, zred_t0=self.zred_t0,
                         t0=self.t0, zred=zred)
        return new, zfactor, Hz

    def cosmo_cool_rate(self, e_int):
        """Adiabatic cosmological cooling rate (cosmology.f90:207-234)."""
        return e_int * self.cosmo_cool_factor()

    def cosmo_cool_factor(self) -> float:
        """2 (dz/dt)/(1+z), the factor multiplying the internal energy in
        cosmo_cool (cosmology.f90:207-234); applied per sub-step in
        thermal (thermal.f90:76-107).  Time dependent, so drivers pass
        it to each timestep."""
        p = self.params
        dzdt = p.H0 * (1.0 + self.zred) * math.sqrt(
            p.Omega0 * (1.0 + self.zred) ** 3 + 1.0 - p.Omega0)
        return 2.0 / (1.0 + self.zred) * dzdt

    def compton_cool_rate(self, temper, eldens):
        """Compton cooling against the CMB (cosmology.f90:239-260)."""
        z1 = 1.0 + self.zred
        return 5.65e-36 * eldens * z1**4 * (temper
                                            - self.params.cmbtemp * z1)


def cosmo_evol_scaling(zfactor):
    """Scale factors for (length, volume, density) under one redshift step
    (cosmo_evol, cosmology.f90:159-202): lengths x zf, volumes x zf^3,
    number densities x zf^-3."""
    zf3 = zfactor**3
    return zfactor, zf3, 1.0 / zf3
