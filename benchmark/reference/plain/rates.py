"""Temperature-dependent recombination and collisional-ionization rates.

Port of ``c2ray_tpu/rates.py`` (``ini_rec_colion_factors`` and friends
in ``code/cgsconstants.f90:140-289``): the whole coefficient set is an
elementwise function of a temperature tensor.  The chemistry kernel
(``csrc/chemistry.cu``) evaluates the same fits per cell.
"""

from typing import NamedTuple

import torch

from . import constants as const


class RateCoeffs(NamedTuple):
    """All T-dependent rate coefficients (same shapes as the input T)."""

    arech0: torch.Tensor    # H+ -> H0 case-A recombination
    brech0: torch.Tensor    # H+ -> H0 case-B recombination
    areche0: torch.Tensor   # He+ -> He0 case-A (incl. dielectronic)
    breche0: torch.Tensor   # He+ -> He0 case-B (incl. dielectronic)
    oreche0: torch.Tensor   # He+ -> He0 recombination to n=1 (A - B)
    areche1: torch.Tensor   # He++ -> He+ case-A
    breche1: torch.Tensor   # He++ -> He+ case-B
    treche1: torch.Tensor   # He++ -> He+ recombination to n=2
    colli_HI: torch.Tensor  # H0 collisional ionization
    colli_HeI: torch.Tensor
    colli_HeII: torch.Tensor
    v: torch.Tensor         # He++ recombination photons in 2-photon decay


def _hui_gnedin_caseA_H(lam):
    # Hui & Gnedin (1997) case-A fit (cgsconstants.f90:172)
    return 1.269e-13 * lam**1.503 / (1.0 + (lam / 0.522) ** 0.470) ** 1.923


def _hui_gnedin_caseB_H(lam):
    # Hui & Gnedin (1997) case-B fit (cgsconstants.f90:173)
    return 2.753e-14 * lam**1.500 / (1.0 + (lam / 2.740) ** 0.407) ** 2.242


def rate_coefficients(temperature: torch.Tensor) -> RateCoeffs:
    """All T-dependent rates (cgsconstants.f90:140-266), elementwise."""
    T = temperature

    # --- hydrogen recombination (cgsconstants.f90:156-175)
    lam_H = 2.0 * (const.temph0 / T)
    arech0 = _hui_gnedin_caseA_H(lam_H)
    brech0 = _hui_gnedin_caseB_H(lam_H)

    # --- He0 recombination incl. dielectronic (cgsconstants.f90:179-213)
    # branch at T < 9e3 K uses the hydrogenic fit
    lam_He0 = 2.0 * (const.temphe[0] / T)
    dielectronic = (
        1.9e-3
        * T ** (-1.5)
        * torch.exp(-4.7e5 / T)
        * (1.0 + 0.3 * torch.exp(-9.4e4 / T))
    )
    areche0_hot = 3.000e-14 * lam_He0**0.654 + dielectronic
    breche0_hot = 1.260e-14 * lam_He0**0.750 + dielectronic
    cold = T < 9.0e3
    areche0 = torch.where(cold, arech0, areche0_hot)
    breche0 = torch.where(cold, brech0, breche0_hot)
    oreche0 = areche0 - breche0

    # --- He+ recombination (cgsconstants.f90:217-238)
    lam_He1 = 2.0 * (const.temphe[1] / T)
    breche1 = (5.5060e-14 * lam_He1**1.5
               / (1.0 + (lam_He1 / 2.740) ** 0.407) ** 2.242)
    areche1 = (2.538e-13 * lam_He1**1.503
               / (1.0 + (lam_He1 / 0.522) ** 0.470) ** 1.923)
    treche1 = 3.4e-13 * (T / 1.0e4) ** (-0.6)
    v = 0.285 * (T / 1.0e4) ** 0.119

    # --- collisional ionization, Cox (1970) fits (cgsconstants.f90:244-266)
    sqrtT = torch.sqrt(T)
    colli_HI = const.colh0 * sqrtT * torch.exp(-const.temph0 / T)
    colli_HeI = const.colhe[0] * sqrtT * torch.exp(-const.temphe[0] / T)
    colli_HeII = const.colhe[1] * sqrtT * torch.exp(-const.temphe[1] / T)

    return RateCoeffs(
        arech0=arech0, brech0=brech0,
        areche0=areche0, breche0=breche0, oreche0=oreche0,
        areche1=areche1, breche1=breche1, treche1=treche1,
        colli_HI=colli_HI, colli_HeI=colli_HeI, colli_HeII=colli_HeII,
        v=v,
    )


def constant_rate_coefficients(dtype=torch.float64, device=None
                               ) -> RateCoeffs:
    """The fixed T = 1e4 K coefficients of the reference's debug variant
    (cgsconstants.f90:270-289), as 0-d tensors."""
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    brech0 = f(2.59182e-13)
    breche0 = f(2.61613e-13)
    breche1 = f(1.54528e-12)
    areche0 = f(4.22471e-13)
    areche1 = f(2.22561e-12)
    arech0 = f(4.29695e-13)
    return RateCoeffs(
        arech0=arech0, brech0=brech0,
        areche0=areche0, breche0=breche0, oreche0=areche0 - breche0,
        areche1=areche1, breche1=breche1, treche1=f(3.46e-13),
        colli_HI=f(8.96396e-16), colli_HeI=f(7.46415e-22),
        colli_HeII=f(2.28059e-37), v=f(0.285),
    )
