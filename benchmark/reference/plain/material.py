"""Material models: density initialisation, sub-grid clumping, LLS.

Port of ``c2ray_tpu/material.py`` (numpy host code, the same as the JAX
package's), re-implementing the `material` module family
(``code/files_for_3D/mat_ini_test.F90`` and the cubep3m / pmfast / LG /
Gadget / test4 variants, which differ in how the density grid is read --
handled by `c2ray_tpu_torch.io.readers`):

- uniform test density: mean baryon density x (1+z)^3
  (mat_ini_test.F90:210-265)
- clumping models 1-5 (mat_ini_test.F90:520-590)
- LLS models 0-2 with the Songaila & Cowie (2010) evolution
  (mat_ini_test.F90:40-62, 594-663)
"""

import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from . import constants as const
from .cosmology import CosmologyParams, DEFAULT_COSMOLOGY


def mean_baryon_density(z, cosmology: CosmologyParams = DEFAULT_COSMOLOGY):
    """Proper mean baryonic number density at z [cm^-3]
    (dens_ini, mat_ini_test.F90:210-265)."""
    rho = cosmology.rho_crit_0 * cosmology.Omega_B
    return rho / (const.mu * const.m_p) * (1.0 + z) ** 3


def uniform_density_grid(mesh: int, z,
                         cosmology: CosmologyParams = DEFAULT_COSMOLOGY):
    return np.full((mesh, mesh, mesh), mean_baryon_density(z, cosmology))


# ---------------------------------------------------------------------------
# Sub-grid clumping (mat_ini_test.F90:520-590)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClumpingModel:
    """type_of_clumping (c2ray_parameters.f90:61-69):
    1 constant; 2/3/4 redshift fits (3.5Mpc PM WMAP1, WMAP3, 1Mpc P3M);
    5 position-dependent grid (supplied by the caller/reader)."""

    type_of_clumping: int = 1
    clumping_factor: float = 1.0
    grid: Optional[np.ndarray] = None  # for type 5

    def at_redshift(self, z):
        """Mean clumping factor (set_clumping, mat_ini_test.F90:520-540).

        Returns a scalar for types 1-4 and the grid for type 5.
        """
        t = self.type_of_clumping
        if t == 1:
            return self.clumping_factor
        if t == 2:
            return 27.466 * math.exp(-0.114 * z + 0.001328 * z * z)
        if t == 3:
            return 26.2917 * math.exp(-0.1822 * z + 0.003505 * z * z)
        if t == 4:
            return 17.57 * math.exp(-0.101 * z + 0.0011 * z * z)
        if t == 5:
            if self.grid is None:
                raise ValueError("type-5 clumping needs a grid "
                                 "(mat_ini_test.F90:544-553)")
            return self.grid
        raise ValueError(f"unknown clumping type {t}")


# ---------------------------------------------------------------------------
# Lyman-limit systems (mat_ini_test.F90:40-62, 594-663)
# ---------------------------------------------------------------------------

# Songaila & Cowie (2010) model parameters (mat_ini_test.F90:52-55)
C_LLS = 2.84
Z_X = 3.5
Y_LLS = 2.04
BETA_LLS = 1.28
OPDEPTH_LL = 2.0                                   # mat_ini_test.F90:40
N_1_LLS = OPDEPTH_LL / const.sigma_HI_at_ion_freq  # mat_ini_test.F90:41


@dataclass(frozen=True)
class LLSModel:
    """type_of_LLS (c2ray_parameters.f90:71-78): 0 none; 1 homogeneous
    optical depth per cell; 2 position-dependent grid."""

    type_of_LLS: int = 0
    grid: Optional[np.ndarray] = None  # column densities, type 2
    n_LLS: float = 0.0                 # state evolved by cosmo steps

    def initialised(self, z, dr, cosmology=DEFAULT_COSMOLOGY) -> "LLSModel":
        """LLS_init (mat_ini_test.F90:594-635): 1/distance between LLSs
        in grid cells, with the beta column-density-distribution
        correction."""
        if self.type_of_LLS != 1:
            return replace(self, n_LLS=0.0)
        n = (C_LLS * (1.0 / (1.0 + Z_X)) ** Y_LLS * dr
             * cosmology.H0 * math.sqrt(cosmology.Omega0) / const.c_light)
        n *= math.gamma(2.0 - BETA_LLS) / (OPDEPTH_LL ** (1.0 - BETA_LLS))
        # the reference initialises this z=0 value and evolves it with
        # cosmo_evol's zfactor**-(y+1.5) rescaling (cosmology.f90:200);
        # `z` is accepted for API symmetry but unused at init
        del z
        return replace(self, n_LLS=n)

    def evolve(self, zfactor) -> "LLSModel":
        """Cosmological evolution of the LLS density
        (cosmo_evol, cosmology.f90:199-201)."""
        return replace(self, n_LLS=self.n_LLS * zfactor ** (-Y_LLS - 1.5))

    def coldensh_per_cell(self):
        """set_LLS (mat_ini_test.F90:640-663)."""
        if self.type_of_LLS == 0:
            return 0.0
        if self.type_of_LLS == 1:
            return N_1_LLS * self.n_LLS
        if self.type_of_LLS == 2:
            if self.grid is None:
                raise ValueError("type-2 LLS needs a grid")
            return self.grid
        raise ValueError(f"unknown LLS type {self.type_of_LLS}")

    def mean_free_path_pMpc(self, dr):
        if self.n_LLS <= 0.0:
            return float("inf")
        return dr / self.n_LLS / const.Mpc


def protect_ionization_fractions(xh1, xhe1, xhe2, epsilon=1.0e-20):
    """Clamp restart-loaded fractions into valid ranges
    (protect_ionization_fractions, mat_ini_test.F90:374-406)."""
    xh1 = np.clip(xh1, epsilon, 1.0 - epsilon)
    xhe1 = np.clip(xhe1, epsilon, 1.0)
    xhe2 = np.clip(xhe2, epsilon, 1.0)
    norm = np.maximum(xhe1 + xhe2, 1.0)
    over = norm > 1.0 - epsilon
    scale = np.where(over, (1.0 - epsilon) / np.maximum(norm, 1e-300), 1.0)
    return xh1, xhe1 * scale, xhe2 * scale


# --- compressed single-value ionization storage -----------------------
# The reference's *_compr module family (mat_ini_cubep3m_compr.F90,
# mat_ini_pmfast_compr.F90, photonstatistics_compr.f90, output_compr.F90)
# fights replicated-memory pressure at >=512^3 meshes by storing the
# H ionization state as ONE float per cell whose sign encodes which of
# {x_HII, x_HI} is held, so the *small* fraction keeps full precision:
#   a >= 0 :  a = x_HII   (ionized fraction small)
#   a <  0 : -a = x_HI    (neutral fraction small)
# decode: neutral_from_compr = (sign(0.5, a) + 0.5) - a
# (mat_ini_cubep3m_compr.F90:454-471).  The codec is kept for
# interoperability with compressed reference dumps and for halving the
# bytes of H-only snapshots.
