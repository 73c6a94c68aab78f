"""Input readers: density / clumping / LLS cubes from N-body pipelines.

Port of ``c2ray_tpu/io/readers.py`` (numpy): the file-reading halves of the `material` variants:
``mat_ini_cubep3m.F90:223-351`` (per-redshift `<z>n_all.dat` density
cubes with unit conversion), clumping grids (``:460-520``) and LLS grids
(``:667-763``).
"""

import numpy as np

from ..nbody import NBodyInterface
from .fortran_records import read_unformatted_cube


def _zred_str(z) -> str:
    """Fortran f6.3-formatted redshift used in all file names
    (mat_ini_cubep3m.F90:256, output.F90:263)."""
    return f"{z:6.3f}".strip()


def read_density_file(nbody: NBodyInterface, z, mesh: int, zfactor_cube=1.0,
                      markers=True, density_unit="grid",
                      path=None, header=True) -> np.ndarray:
    """Read a `<z>n_all.dat` density cube and convert to proper cm^-3
    (dens_ini, mat_ini_cubep3m.F90:223-351).

    `markers=False, header=False` reads the PMFAST "binary" stream
    flavour (densityformat="binary", densityheader=.false.,
    pmfast.F90:59-63).  Returns the PROPER density at z (the x(1+z)^3
    factor applied).
    """
    if path is None:
        path = f"{nbody.dir_dens}{_zred_str(z)}n_all.dat"
    cube = read_unformatted_cube(path, dtype=np.float32, markers=markers,
                                 mesh=mesh, header=header
                                 ).astype(np.float64)
    if density_unit == "grid":
        convert = nbody.density_convert_grid(mesh)
    elif density_unit == "particle":
        convert = nbody.density_convert_particle(mesh)
    elif density_unit == "M0Mpc3":
        # mass density in M_sun/Mpc^3 h^2 units -> baryon number density
        # (mat_ini_cubep3m.F90:304-305, mat_ini_LG.F90:246-249)
        from .. import constants as const
        p = nbody.cosmology
        convert = (const.M_SOLAR / const.Mpc**3 * p.h**2
                   * p.Omega_B / p.Omega0 / (const.mu * const.m_p))
    else:
        raise ValueError(f"unknown density unit {density_unit}")
    return cube * convert * (1.0 + z) ** 3


def read_halo_catalog(nbody: NBodyInterface, z, path=None,
                      n_extra_cols=0):
    """Read a `<z>_wsubgrid_sources.dat` halo catalog
    (sourceprops_cubep3m.F90:42-64, 340-400).

    Rows: (i, j, k, mass_hmach, mass_lmach[, extra...]), 1-based
    positions.  Returns a `sources.HaloCatalog`.
    """
    from ..sources import HaloCatalog

    if path is None:
        path = f"{nbody.dir_src}{_zred_str(z)}_wsubgrid_sources.dat"
    with open(path) as f:
        n = int(f.readline().split()[0])
        rows = [[float(x) for x in f.readline().split()] for _ in range(n)]
    arr = np.asarray(rows) if rows else np.zeros((0, 5 + n_extra_cols))
    qso = arr[:, 5] if arr.shape[1] > 5 else None
    return HaloCatalog(pos=arr[:, :3].astype(np.int32) - 1,
                       mass_hmach=arr[:, 3], mass_lmach=arr[:, 4],
                       qso_lum=qso)
