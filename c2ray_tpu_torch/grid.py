"""Grids: 1D radial shells and 3D Cartesian cells.

Port of ``c2ray_tpu/grid.py`` (``code/files_for_1D/grid.F90`` and
``code/files_for_3D/grid.F90``).  Host code in float64 numpy, identical
to the JAX package's.
"""

from dataclasses import dataclass

import numpy as np

from . import constants as const


@dataclass(frozen=True)
class RadialGrid:
    """1D spherical grid (files_for_1D/grid.F90:73-121)."""

    r_in: float
    r_out: float
    mesh: int

    @property
    def dr(self) -> float:
        return (self.r_out - self.r_in) / self.mesh

    @property
    def x(self) -> np.ndarray:
        """Cell-centre radii (grid.F90:114)."""
        i = np.arange(1, self.mesh + 1)
        return (i - 0.5) * self.dr + self.r_in

    @property
    def vol(self) -> np.ndarray:
        """Shell volumes (grid.F90:119)."""
        x = self.x
        return (4.0 * const.pi / 3.0
                * ((x + 0.5 * self.dr) ** 3 - (x - 0.5 * self.dr) ** 3))


@dataclass(frozen=True)
class CartesianGrid:
    """3D Cartesian grid (files_for_3D/grid.F90:37-149).

    ``boxsize`` is comoving Mpc/h; cgs cell size dr = box/h/mesh in cm.
    """

    boxsize_mpc_h: float
    mesh: tuple
    h: float = 0.7

    @property
    def boxsize_cm(self) -> float:
        return self.boxsize_mpc_h * const.Mpc / self.h

    @property
    def dr(self) -> float:
        return self.boxsize_cm / self.mesh[0]

    @property
    def vol(self) -> float:
        """Scalar cell volume (grid.F90:142)."""
        return self.dr**3

    @property
    def sim_volume(self) -> float:
        return self.boxsize_cm**3

    def coords(self, axis: int) -> np.ndarray:
        i = np.arange(1, self.mesh[axis] + 1)
        return (i - 0.5) * self.dr
