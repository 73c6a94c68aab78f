"""1D test-problem material initialisation.

Port of ``c2ray_tpu/onedim/material.py`` (``code/files_for_1D/mat_ini.F90``),
host code in float64 numpy:

- test 1: constant density (Stroemgren sphere)
- test 2: 1/r density
- test 3: 1/r^2 density with a flat core of radius r_core
- test 4: cosmological constant (comoving) density (Shapiro & Giroux)

Initial ionization fractions come either from a UV background
equilibrium (find_ionfractions_from_uvb, mat_ini.F90:286-321) or are
fully neutral (mat_ini.F90:269-277).
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import constants as const
from ..cosmology import CosmologyParams, DEFAULT_COSMOLOGY
from ..grid import RadialGrid
from ..rates import rate_coefficients


@dataclass(frozen=True)
class OneDProblem:
    """Configuration of a 1D test problem (the mat_ini stdin deck)."""

    testnum: int = 1
    dens_val: float = 1.0e-3          # cm^-3 (core density for tests 2/3)
    r_core: float = 0.0               # cm (tests 2/3)
    clumping: float = 1.0
    temper_val: float = 1.0e4         # K
    isothermal: bool = True
    gamma_uvb: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    zred00: float = 0.0               # initial redshift (test 4)
    cosmology: CosmologyParams = DEFAULT_COSMOLOGY
    epsilon: float = 1.0e-20


def density_profile(problem: OneDProblem, grid: RadialGrid) -> np.ndarray:
    """Density per test problem (mat_ini.F90:206-256)."""
    x = grid.x
    t = problem.testnum
    if t in (1, 4):
        return np.full(grid.mesh, problem.dens_val)
    if t == 2:
        return problem.dens_val * (x / problem.r_core) ** -1.0
    if t == 3:
        n = problem.dens_val * (x / problem.r_core) ** -2.0
        return np.where(x <= problem.r_core, problem.dens_val, n)
    raise ValueError(f"unknown test problem {t}")


def _rates_at(temper: float):
    """The rate fits at one temperature, in float64."""
    return rate_coefficients(torch.tensor(temper, dtype=torch.float64))


def find_ionfractions_from_uvb(problem: OneDProblem, nnd: float):
    """Equilibrium fractions under a UV background
    (mat_ini.F90:286-321): fixed-point iteration on the electron fraction."""
    r = _rates_at(problem.temper_val)
    g1, g2, g3 = problem.gamma_uvb
    rech2 = nnd * problem.clumping * float(r.brech0)
    reche2 = nnd * problem.clumping * float(r.breche0)
    reche3 = nnd * problem.clumping * float(r.breche1)
    fe = 1.0
    for _ in range(1000):
        xh0 = fe * rech2 / (g1 + fe * rech2)
        xhe0 = fe * reche2 / (g2 * (1.0 + g3 / (fe * reche3)) + fe * reche2)
        xhe1 = (1.0 - xhe0) / (1.0 + g3 / (fe * reche3))
        fe_prev = fe
        fe = (const.abu_h * (1.0 - xh0)
              + const.abu_he * (2.0 - (2.0 * xhe0 + xhe1)))
        if abs(fe - fe_prev) / max(fe_prev, 1e-30) < 0.01:
            break
    return xh0, xhe0, xhe1


def init_material(problem: OneDProblem, grid: RadialGrid):
    """ndens, temper, xh (0:1), xhe (0:2) numpy arrays
    (mat_ini.F90:99-284).

    For test 4 the returned density is comoving (the cosmological
    rescaling brings it to proper units, mat_ini.F90:247-253).
    """
    mesh = grid.mesh
    ndens = density_profile(problem, grid)
    temper = np.full(mesh, problem.temper_val)
    eps = problem.epsilon

    if problem.gamma_uvb[0] > 0.0:
        xh = np.zeros((mesh, 2))
        xhe = np.zeros((mesh, 3))
        for i in range(mesh):
            xh0, xhe0, xhe1 = find_ionfractions_from_uvb(problem, ndens[i])
            xh[i] = (xh0, 1.0 - xh0)
            xhe[i] = (xhe0, xhe1, 1.0 - xhe0 - xhe1)
    else:
        xh = np.tile([1.0, 0.0], (mesh, 1))
        xhe = np.tile([1.0 - 2.0 * eps, eps, eps], (mesh, 1))
    return ndens, temper, xh, xhe


def analytic_parameters_test4(problem: OneDProblem):
    """t1, t0_t, eta for the Shapiro-Giroux solution (mat_ini.F90:239-246)."""
    bh00 = const.bh00
    t1 = 1.0 / (bh00 * problem.clumping * problem.dens_val)
    p = problem.cosmology
    t0_t = (2.0 * (1.0 + problem.zred00) ** (-1.5)
            / (3.0 * p.H0 * np.sqrt(p.Omega0)))
    eta = t0_t / t1 * (1.0 + problem.zred00) ** 3
    return t1, t0_t, eta
