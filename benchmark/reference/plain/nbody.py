"""N-body simulation interfaces: redshift sequences, unit conversions,
file conventions.

From ``c2ray_tpu/nbody.py`` (numpy host code, the same as the JAX
package's): every member of the `nbody` module family, the test
backends, ``code/cubep3m.F90`` (CubeP3M catalogs + unit system),
PMFAST, LG and GADGET.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import constants as const
from .cosmology import CosmologyParams, DEFAULT_COSMOLOGY


@dataclass(frozen=True)
class NBodyInterface:
    """Common data every backend provides (the nbody module contract)."""

    nbody_type: str
    boxsize: float                  # comoving Mpc/h
    zred_array: np.ndarray          # redshift slice sequence
    cosmology: CosmologyParams = DEFAULT_COSMOLOGY
    # directory conventions (density / clumping / sources / LLS)
    dir_dens: str = ""
    dir_clump: str = ""
    dir_src: str = ""
    dir_LLS: str = ""
    # fine-grid size of the companion N-body run (cubep3m.F90:42)
    n_box: Optional[int] = None
    id_str: str = "unknown"

    @property
    def num_zred(self) -> int:
        return len(self.zred_array)

    @property
    def M_box(self) -> float:
        """Total mass in the box [g] (cubep3m.F90:119)."""
        p = self.cosmology
        return p.rho_crit_0 * p.Omega0 * (self.boxsize * const.Mpc / p.h) ** 3

    @property
    def M_grid(self) -> float:
        """Mean mass per N-body fine-grid cell [g] (cubep3m.F90:120)."""
        n = self.n_box if self.n_box else 1
        return self.M_box / float(n) ** 3

    @property
    def M_particle(self) -> float:
        return 8.0 * self.M_grid

    def density_convert_grid(self, mesh: int) -> float:
        """Conversion from grid-unit density files to comoving cm^-3
        (cubep3m.F90:125)."""
        p = self.cosmology
        n = self.n_box if self.n_box else mesh
        return (p.rho_crit_0 * p.Omega_B / (const.mu * const.m_p)
                * float(mesh) ** 3 / float(n) ** 3)

    def density_convert_particle(self, mesh: int) -> float:
        return 8.0 * self.density_convert_grid(mesh)

    @property
    def lscale(self) -> float:
        """Comoving length unit [cm] (cubep3m.F90:130)."""
        n = self.n_box if self.n_box else 1
        return self.boxsize * const.Mpc / self.cosmology.h / n

    @property
    def tscale(self) -> float:
        """Time unit [s] (cubep3m.F90:132)."""
        p = self.cosmology
        return 2.0 / (3.0 * np.sqrt(p.Omega0) * p.H0)


def _eds_sequence(z_start, timestep, num, cosmology):
    """Redshift slices equally spaced in EdS time (test.F90:90-109)."""
    t0 = (2.0 * (1.0 + z_start) ** (-1.5)
          / (3.0 * cosmology.H0 * np.sqrt(cosmology.Omega0)))
    nz = np.arange(num)
    return -1.0 + (1.0 + z_start) * (t0 / (t0 + nz * timestep)) ** (2.0 / 3.0)


def test_nbody(cosmology=DEFAULT_COSMOLOGY) -> NBodyInterface:
    """Synthetic test backend: 5 slices from z=9 spaced 10 Myr,
    10 Mpc/h box (test.F90:47,90-109)."""
    return NBodyInterface(
        nbody_type="test", boxsize=10.0, cosmology=cosmology,
        zred_array=_eds_sequence(9.0, 1e7 * const.YEAR, 5, cosmology))


def test4_nbody(cosmology=DEFAULT_COSMOLOGY, data_dir="../TEST4/"
                ) -> NBodyInterface:
    """Iliev Test-4 backend: 9 slices from z=8.8492 spaced 0.05 Myr,
    0.5 Mpc/h box (test4.F90:46-51)."""
    return NBodyInterface(
        nbody_type="test4", boxsize=0.5, cosmology=cosmology,
        zred_array=_eds_sequence(8.8492, 0.05e6 * const.YEAR, 9, cosmology),
        dir_dens=data_dir, dir_src=data_dir, id_str="test4 res")


def cubep3m_nbody(redshift_file, boxsize=244.0, n_box=8000,
                  cosmology=DEFAULT_COSMOLOGY, base_dir="../",
                  source_dir="./sources/") -> NBodyInterface:
    """CubeP3M backend (cubep3m.F90:39-143,200-287).

    ``redshift_file``: text file with a count then one redshift per line.
    """
    with open(redshift_file) as f:
        n = int(f.readline().split()[0])
        zred = np.array([float(f.readline().split()[0]) for _ in range(n)])
    # resolution id string (cubep3m.F90:223-287)
    id_str = {8000: "coarsest", 10976: "coarsest"}.get(n_box, "unknown")
    return NBodyInterface(
        nbody_type="cubep3m", boxsize=boxsize, n_box=n_box,
        cosmology=cosmology, zred_array=zred,
        dir_dens=base_dir + "coarser_densities/halos_removed/",
        dir_clump=base_dir + "coarser_densities/halos_included/",
        dir_LLS=base_dir + "halos/",
        dir_src=source_dir, id_str=id_str)


def pmfast_nbody(redshift_file, boxsize=100.0, n_box=3248,
                 cosmology=DEFAULT_COSMOLOGY, base_dir="../"
                 ) -> NBodyInterface:
    """PMFAST backend (pmfast.F90, legacy)."""
    with open(redshift_file) as f:
        n = int(f.readline().split()[0])
        zred = np.array([float(f.readline().split()[0]) for _ in range(n)])
    return NBodyInterface(
        nbody_type="pmfast", boxsize=boxsize, n_box=n_box,
        cosmology=cosmology, zred_array=zred,
        dir_dens=base_dir + "coarser_densities/",
        dir_src=base_dir + "sources/")


def lg_nbody(redshift_file, boxsize, cosmology=DEFAULT_COSMOLOGY,
             base_dir="../", id_str="LG") -> NBodyInterface:
    """LG (constrained Local Group GADGET simulation) backend.

    The reference's `LG.F90` nbody module is absent from the tree (only
    `mat_ini_LG.F90` / `sourceprops_LG.F90` survive), so this is
    reconstructed from the module contract those files import
    (mat_ini_LG.F90:17-18): `nbody_type="LG"`, slice-numbered density
    files `<nz:03d>rho_<id_str>.dat` in "M0Mpc3" mass-density units
    with an unformatted header (read by io.readers.read_lg_density_file),
    and an `id_str` that selects the `dmdens_cic` naming variant
    (mat_ini_LG.F90:185-191).
    """
    with open(redshift_file) as f:
        n = int(f.readline().split()[0])
        zred = np.array([float(f.readline().split()[0]) for _ in range(n)])
    return NBodyInterface(
        nbody_type="LG", boxsize=boxsize, cosmology=cosmology,
        zred_array=zred, dir_dens=base_dir, dir_src=base_dir,
        id_str=id_str)


def gadget_nbody(redshift_file, boxsize, cosmology=DEFAULT_COSMOLOGY,
                 base_dir="../") -> NBodyInterface:
    """GADGET backend skeleton (gadget.F90; the reference marks this
    variant not working, files_for_3D/Makefile:21)."""
    with open(redshift_file) as f:
        n = int(f.readline().split()[0])
        zred = np.array([float(f.readline().split()[0]) for _ in range(n)])
    return NBodyInterface(
        nbody_type="gadget", boxsize=boxsize, cosmology=cosmology,
        zred_array=zred, dir_dens=base_dir, dir_src=base_dir)
