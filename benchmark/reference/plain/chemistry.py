"""Per-cell ionization chemistry: the `doric` analytic ODE solver.

Port of ``c2ray_tpu/chemistry.py`` (``code/doric.f90:35-372``,
``code/tped.f90:75-84``) as elementwise PyTorch math.  This is the
plain version of the arithmetic that the chemistry kernel
(``csrc/chemistry.cu``) runs per cell; the two-sector scaling, the
quadratic-root identity and the expm1 time averages are kept exactly,
since float32 needs each of them.
"""

from typing import NamedTuple

import torch

from . import constants as const
from .rates import RateCoeffs


class IonFractions(NamedTuple):
    """Ionization fractions for one epoch (all same-shape tensors)."""

    h0: torch.Tensor   # neutral H fraction
    h1: torch.Tensor   # ionized H fraction
    he0: torch.Tensor  # neutral He
    he1: torch.Tensor  # He+
    he2: torch.Tensor  # He++


class IonState(NamedTuple):
    """Current / time-averaged / start-of-step ionization fractions
    (the reference `ionstates` type, mat_ini_test.F90:70-77)."""

    cur: IonFractions
    avg: IonFractions
    old: IonFractions


def ion_fractions(h1, he1, he2) -> IonFractions:
    """IonFractions from the ionized fractions (tensors or numbers)."""
    h1, he1, he2 = (torch.as_tensor(x) for x in (h1, he1, he2))
    return IonFractions(h0=1.0 - h1, h1=h1, he0=1.0 - he1 - he2, he1=he1,
                        he2=he2)


def electrondens(ndens, ions: IonFractions):
    """Electron density (tped.f90:75-84)."""
    return ndens * (
        ions.h1 * (1.0 - const.abu_he)
        + const.abu_c
        + const.abu_he * (ions.he1 + 2.0 * ions.he2)
    )


def coldens(path, neufrac, ndens, abundance):
    """Column density contribution of one cell (doric.f90:358-372)."""
    return neufrac * ndens * path * abundance


def coldens_bndry_HI(boundary_tauHI=0.0):
    """The HI column of a boundary optical depth at the HI threshold."""
    return boundary_tauHI / const.sigma_HI_at_ion_freq


def coldens_bndry_HeI(boundary_tauHeI=0.0):
    return boundary_tauHeI / const.sigma_HeI_at_ion_freq


def coldens_bndry_HeII(boundary_tauHeII=0.0):
    return boundary_tauHeII / const.sigma_HeII_at_ion_freq


class DoricFactors(NamedTuple):
    yfrac: torch.Tensor
    zfrac: torch.Tensor
    y2afrac: torch.Tensor
    y2bfrac: torch.Tensor


def prepare_doric_factors(NHI, NHeI, NHeII) -> DoricFactors:
    """Optical-depth ratios at the He thresholds / He+ Ly-a
    (doric.f90:317-351).  The columns are normalised by their sum first:
    the raw products underflow float32."""
    tiny = torch.finfo(NHI.dtype).tiny

    def pairnorm(*cols):
        inv = 1.0 / torch.clamp(sum(cols), min=tiny)
        return [c * inv for c in cols]

    nh_a, nhe_a = pairnorm(NHI, NHeI)
    tau_H_heth = nh_a * const.sigma_H_heth
    tau_He_heth = nhe_a * const.sigma_HeI_at_ion_freq
    tau_H_heLya = nh_a * const.sigma_H_heLya
    tau_He_heLya = nhe_a * const.sigma_He_heLya
    nh_b, nhe_b, nhe2_b = pairnorm(NHI, NHeI, NHeII)
    tau_H_he2th = nh_b * const.sigma_H_he2
    tau_He_he2th = nhe_b * const.sigma_He_he2
    tau_He2_he2th = nhe2_b * const.sigma_HeII_at_ion_freq

    denom2 = tau_He2_he2th + tau_He_he2th + tau_H_he2th
    return DoricFactors(
        yfrac=tau_H_heth / (tau_H_heth + tau_He_heth),
        zfrac=tau_H_heLya / (tau_H_heLya + tau_He_heLya),
        y2afrac=tau_He2_he2th / denom2,
        y2bfrac=tau_He_he2th / denom2,
    )


def _clamp_h(h0, h1, epsilon):
    """Epsilon-clamp a (h0, h1) pair, h0 branch first (doric.f90:232-239)."""
    low0 = h0 < epsilon
    h0, h1 = (torch.where(low0, epsilon, h0),
              torch.where(low0, 1.0 - epsilon, h1))
    low1 = h1 < epsilon
    h1, h0 = (torch.where(low1, epsilon, h1),
              torch.where(low1, 1.0 - epsilon, h0))
    return h0, h1


def _clamp_h_avg(h0, h1, epsilon):
    """Same but h1 branch first (doric.f90:291-298)."""
    low1 = h1 < epsilon
    h1, h0 = (torch.where(low1, epsilon, h1),
              torch.where(low1, 1.0 - epsilon, h0))
    low0 = h0 < epsilon
    h0, h1 = (torch.where(low0, epsilon, h0),
              torch.where(low0, 1.0 - epsilon, h1))
    return h0, h1


def _clamp_he(he0, he1, he2, epsilon):
    """Clamp-and-renormalise He triplet only where needed
    (doric.f90:241-258)."""
    any_low = (he0 <= epsilon) | (he1 <= epsilon) | (he2 <= epsilon)
    c0 = torch.clamp(he0, min=epsilon)
    c1 = torch.clamp(he1, min=epsilon)
    c2 = torch.clamp(he2, min=epsilon)
    norm = c0 + c1 + c2
    he0 = torch.where(any_low, c0 / norm, he0)
    he1 = torch.where(any_low, c1 / norm, he1)
    he2 = torch.where(any_low, c2 / norm, he2)
    return he0, he1, he2


def doric(dt, ne, ion: IonState, photo_HI, photo_HeI, photo_HeII,
          factors: DoricFactors, rates: RateCoeffs, clumping=1.0,
          epsilon=1.0e-20) -> IonState:
    """Analytic one-step solution of the coupled H/He ionization ODE
    (doric.f90:35-313): d/dt (x_HII, x_HeII, x_HeIII) = M x + g over
    `dt` by eigen-decomposition, plus the time-averaged fractions.
    Returns a new IonState (``old`` passed through)."""
    pfrac = 0.96  # Osterbrock 1989
    heliumfraction = const.abu_he / (1.0 - const.abu_he)
    ffrac = torch.clamp(10.0 * ion.cur.h0, 0.01, 1.0)
    yfrac, zfrac = factors.yfrac, factors.zfrac
    y2afrac, y2bfrac = factors.y2afrac, factors.y2bfrac
    # Flower & Perinotto (1980)
    wfrac = (1.425 - 0.737) + 0.737 * yfrac
    v = rates.v

    alpha_h_B = clumping * rates.brech0
    alpha_he_1 = clumping * rates.oreche0
    alpha_he_B = clumping * rates.breche0
    alpha_he_A = clumping * rates.areche0
    alpha_he2_B = clumping * rates.breche1
    alpha_he2_A = clumping * rates.areche1
    alpha_he2_2 = clumping * rates.treche1
    alpha_he2_1 = alpha_he2_A - alpha_he2_B

    # floor equivalent to the reference's 1e-200 (doric.f90:109-111),
    # representable at the working precision
    tiny = torch.finfo(photo_HI.dtype).tiny
    aih0 = torch.clamp(photo_HI + ne * rates.colli_HI, min=tiny)
    aihe0 = torch.clamp(photo_HeI + ne * rates.colli_HeI, min=tiny)
    aihe1 = torch.clamp(photo_HeII + ne * rates.colli_HeII, min=tiny)

    # --- two-sector nondimensionalisation (see c2ray_tpu/chemistry.py):
    # He-sector rates scaled by sHe, the H rate by sH; every expression
    # below is built from same-sector O(<=1) products, raw differences
    # of representable rates, or explicit scale ratios.
    sH = aih0 + ne * alpha_h_B                     # = -Lmat
    sHe = aihe0 + aihe1 + ne * (alpha_he_A + alpha_he2_A)
    a0 = aihe0 / sHe
    a1 = aihe1 / sHe
    nes = ne / sHe

    # Matrix elements (doric.f90:124-131); tilde = He-sector scaled
    Lmat = -sH
    Mt = (yfrac * nes * alpha_he_1 + pfrac * nes * alpha_he_B) \
        * heliumfraction
    Nt = (
        (ffrac * zfrac * (1.0 - v) + v * wfrac) * alpha_he2_B
        + alpha_he2_2
        + (1.0 - y2afrac - y2bfrac) * alpha_he2_1
    ) * heliumfraction * nes
    Pt = -a0 - a1 - nes * (alpha_he_A - (1.0 - yfrac) * alpha_he_1)
    Et = -nes * (alpha_he2_A - y2afrac * alpha_he2_1)
    Qt = (
        -a0
        + nes * alpha_he2_B * (ffrac * (1.0 - zfrac) * (1.0 - v)
                               + v * (1.425 - wfrac))
        - Et
        + alpha_he2_1 * y2bfrac * nes
    )

    Bt = Et - Pt
    four_aQ = 4.0 * a1 * Qt
    St = torch.sqrt(Bt * Bt + four_aQ)
    QHEPt = 1.0 / (Qt * a1 - Et * Pt)
    # B -+ S with the quadratic-root product identity for the
    # cancelling branch ((B-S)(B+S) = -4*a1*Qt)
    big = torch.where(Bt >= 0.0, Bt + St, Bt - St)
    small = -four_aQ / torch.where(torch.abs(big) > tiny, big,
                                   torch.full_like(big, tiny))
    BmSt = torch.where(Bt >= 0.0, small, big)
    BpSt = torch.where(Bt >= 0.0, big, small)

    # Eigenvalues (doric.f90:168-170); lambda2/3 back in raw units
    lambda1 = Lmat
    lambda2 = 0.5 * sHe * (Et + Pt - St)
    lambda3 = 0.5 * sHe * (Et + Pt + St)

    # Particular solution (doric.f90:176-178)
    rx = aih0 / sH + (sHe / sH) * ((Mt * Et - Nt * a1) * (a0 * QHEPt))
    ry = a0 * (Et * QHEPt)
    rz = -a0 * (a1 * QHEPt)

    # --- mode coefficients per species, in the analytically cancelled
    # form (the reference's 1/(2*aihe1) eigenvector factors cancel):
    #   h1(t)  = coef1 e^{l1 t} + X2 e^{l2 t} + X3 e^{l3 t} + rx
    #   he1(t) =                  Y2 e^{l2 t} + Y3 e^{l3 t} + ry
    #   he2(t) =                  Z2 e^{l2 t} + Z3 e^{l3 t} + rz
    dy = ry - ion.old.he1
    Tz = rz - ion.old.he2
    twoS = 2.0 * torch.clamp(St, min=tiny)
    Lm2 = Lmat - lambda2
    Lm3 = Lmat - lambda3
    r2 = sHe / torch.where(Lm2 == 0.0, torch.full_like(Lm2, -tiny), Lm2)
    r3 = sHe / torch.where(Lm3 == 0.0, torch.full_like(Lm3, -tiny), Lm3)
    u2 = -2.0 * a1 * Nt + Mt * BpSt
    u3 = -2.0 * a1 * Nt + Mt * BmSt
    w2 = Nt * BmSt + 2.0 * Qt * Mt
    w3 = Nt * BpSt + 2.0 * Qt * Mt
    X2 = (u2 * dy - w2 * Tz) * r2 / twoS
    X3 = (-u3 * dy + w3 * Tz) * r3 / twoS
    Y2 = -(BpSt * dy - 2.0 * Qt * Tz) / twoS
    Y3 = (BmSt * dy - 2.0 * Qt * Tz) / twoS
    Z2 = (2.0 * a1 * dy + BmSt * Tz) / twoS
    Z3 = -(2.0 * a1 * dy + BpSt * Tz) / twoS
    coef1 = ion.old.h1 - rx - X2 - X3

    lam1dt = dt * lambda1
    lam2dt = dt * lambda2
    lam3dt = dt * lambda3
    elam1dt = torch.exp(lam1dt)
    elam2dt = torch.exp(lam2dt)
    elam3dt = torch.exp(lam3dt)

    h1 = coef1 * elam1dt + X2 * elam2dt + X3 * elam3dt + rx
    he1 = Y2 * elam2dt + Y3 * elam3dt + ry
    he2 = Z2 * elam2dt + Z3 * elam3dt + rz
    h0 = 1.0 - h1
    he0 = 1.0 - he1 - he2

    h0, h1 = _clamp_h(h0, h1, epsilon)
    he0, he1, he2 = _clamp_he(he0, he1, he2, epsilon)

    # Time-averaged fractions: (e^x - 1)/x via expm1, which has no
    # cancellation at any x, so only exact zero needs a branch
    # (doric.f90:267-283)
    def em1_over(lamdt):
        safe = torch.where(lamdt == 0.0, torch.ones_like(lamdt), lamdt)
        return torch.where(lamdt == 0.0, torch.ones_like(lamdt),
                           torch.expm1(safe) / safe)

    f1 = em1_over(lam1dt)
    f2 = em1_over(lam2dt)
    f3 = em1_over(lam3dt)

    h1_av = rx + coef1 * f1 + X2 * f2 + X3 * f3
    he1_av = ry + Y2 * f2 + Y3 * f3
    he2_av = rz + Z2 * f2 + Z3 * f3
    h0_av = 1.0 - h1_av
    he0_av = 1.0 - he1_av - he2_av

    h0_av, h1_av = _clamp_h_avg(h0_av, h1_av, epsilon)
    he0_av, he1_av, he2_av = _clamp_he(he0_av, he1_av, he2_av, epsilon)

    return IonState(
        cur=IonFractions(h0=h0, h1=h1, he0=he0, he1=he1, he2=he2),
        avg=IonFractions(h0=h0_av, h1=h1_av, he0=he0_av, he1=he1_av,
                         he2=he2_av),
        old=ion.old,
    )
