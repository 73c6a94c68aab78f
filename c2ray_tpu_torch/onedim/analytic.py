"""Analytic I-front solutions for the 1D test problems.

Port of ``c2ray_tpu/onedim/analytic.py`` (``code/files_for_1D/output.f90:302-433``),
host code in float64:

- test 1: Stroemgren sphere,  r_S (1 - e^{-t/t_rec})^{1/3}
- test 2: 1/r density, LambertW solution
- test 3: 1/r^2 + core, r_core sqrt(1 + 2 t/t_rec,core) (L ~ 0 branch)
- test 4: cosmological front via exponential integrals (Shapiro & Giroux)

scipy provides LambertW and E_n, replacing the reference's hand-rolled
Halley iteration (output.f90:465-524) and Numerical-Recipes expint
(output.f90:530-602).
"""

import numpy as np
from scipy.special import expn, lambertw

from .. import constants as const
from .material import OneDProblem, analytic_parameters_test4


def stromgren_radius(S_star, ndens, clumping=1.0, alphaB=const.bh00):
    return (3.0 * S_star
            / (4.0 * const.pi * ndens**2 * clumping * alphaB)) ** (1.0 / 3.0)


def analytic_front(problem: OneDProblem, S_star: float, time: float,
                   ndens0: float = None, zred: float = None,
                   t0: float = None) -> float:
    """Analytic front radius at ``time`` (output.f90:302-391).

    ``ndens0``: proper density of cell 1 (defaults to the problem value).
    For test 4 pass the current redshift and the EdS t0.
    """
    bh00 = const.bh00
    cl = problem.clumping
    n0 = problem.dens_val if ndens0 is None else ndens0

    if problem.testnum == 1:
        rs = stromgren_radius(S_star, n0, cl)
        return rs * (1.0 - np.exp(-n0 * cl * bh00 * time)) ** (1.0 / 3.0)

    if problem.testnum == 2:
        L = S_star / (4.0 * const.pi * problem.dens_val * problem.r_core)
        K = problem.dens_val * problem.r_core * cl * bh00
        w = lambertw(-np.exp(-K * K * time / L - 1.0)).real
        return L / K * (1.0 + w)

    if problem.testnum == 3:
        dens_core, r_core = problem.dens_val, problem.r_core
        L = (S_star / (4.0 * const.pi * dens_core * r_core**2)
             - 4.0 / 3.0 * dens_core * r_core * cl * bh00)
        t_reccore = 1.0 / (dens_core * cl * bh00)
        if abs(L) / (4.0 / 3.0 * dens_core * r_core * cl * bh00) >= 1e-3:
            raise ValueError(
                "no analytical solution for these test-3 parameters "
                "(output.f90:355-366)")
        front = r_core * np.sqrt(1.0 + 2.0 * time / t_reccore)
        # early phase: still inside the flat core -> Stroemgren growth
        rs = stromgren_radius(S_star, n0, cl)
        t_core = -t_reccore * np.log(1.0 - (r_core / rs) ** 3)
        if time < t_core:
            front = rs * (1.0 - np.exp(-n0 * cl * bh00 * time)) ** (1.0 / 3.0)
        return front

    if problem.testnum == 4:
        t1, t0_t, eta = analytic_parameters_test4(problem)
        if t0 is None:
            t0 = t0_t
        if zred is None:
            raise ValueError("test 4 needs the current redshift")
        rs_comoving = stromgren_radius(S_star, problem.dens_val, cl)
        tratio = t0 / (t0 + time)
        # the reference expint(n, x, y) = E_n(x) * exp(y)
        # (output.f90:530-602)
        term = (expn(2, eta * tratio) * np.exp(tratio * eta) / tratio
                - expn(2, eta) * np.exp(tratio * eta))
        return (rs_comoving
                * (eta / (1.0 + problem.zred00) ** 3 * term) ** (1.0 / 3.0)
                / (1.0 + zred))

    raise ValueError(f"unknown test problem {problem.testnum}")


def numerical_front(x, dr, xh1, xlimit=0.5) -> float:
    """Front position by threshold interpolation (output.f90:399-433)."""
    x = np.asarray(x)
    xh1 = np.asarray(xh1)
    idx = np.nonzero(xh1 < xlimit)[0]
    if len(idx) == 0:
        i1 = len(x) - 2
    elif idx[0] == 0:
        return float(x[0] - 0.5 * dr)
    else:
        i1 = idx[0] - 1
    i2 = i1 + 1
    if xh1[i1] == 0.0 and xh1[i2] == 0.0:
        return float(x[0] - 0.5 * dr)
    return float((xlimit - xh1[i1]) * (x[i1] - x[i2])
                 / (xh1[i1] - xh1[i2]) + x[i1])
