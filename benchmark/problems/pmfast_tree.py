"""Seeded inputs in the PMFAST formats that the port's readers take.

The tree is cubep3m_tree's (the seeded density field, halo catalogs,
redshift list and restart cubes; see that module), laid out as
``config.py``'s "pmfast" backend and ``io/readers.py`` read it: under a
base directory, ``redshift_file``, ``coarser_densities/<z>n_all.dat``
and ``sources/<z>_wsubgrid_sources.dat``, and the restart cubes under
the results directory.  Two changes:

- The density unit: PMFAST's grid-unit density counts fine-mesh cells
  of mass, so a cube of mean (n_box / mesh)^3 holds the cosmic mean
  baryon density (``density_convert_grid``: (mesh / n_box)^3 of
  rho_crit Omega_B / (mu m_p) per unit), and each cube of the
  generator, of mean 1, is scaled by that factor.
- What the seed moves: one realisation, drawn from the configuration's
  ``realisation_seed``, seen in an orientation and from an origin drawn
  from the run's seed (one of the cube's 48 rotations and reflections,
  then a periodic shift, of every cube and catalog).  At the cosmic mean
  density C2-Ray's iterations a step follow the fastest ionization
  front, which another realisation moves by 10% or more; every view of
  one realisation is the same periodic volume, so the work of a cycle
  stays put, while the cells the program reads move with the seed and
  the sweeps' interpolations take their axes in another order.
"""

import glob
import os

import numpy as np

from harness import spec
from reference.plain.io.fortran_records import (read_unformatted_cube,
                                                write_unformatted_cube)


def make(cfg: dict, traffic: dict, seed: int, workdir: str, device="cpu",
         mesh=None) -> dict:
    """Write the cell's inputs under `workdir` and return its Run3D
    configuration dictionary (cubep3m_tree.make's contract)."""
    out = spec.generator("cubep3m_tree").make(
        cfg, traffic, int(cfg["realisation_seed"]), workdir, device=device,
        mesh=mesh)
    run = out["run3d"]
    M = int(run["mesh"])
    rng = np.random.default_rng(int(seed))
    view = (rng.permutation(3), rng.integers(0, 2, 3).astype(bool),
            rng.integers(0, M, 3))
    base = os.path.join(workdir, "tree")
    scale = np.float32((float(cfg["nbody"]["n_box"]) / M) ** 3)
    dens_dir = os.path.join(base, *cfg["layout"]["density_dir"])
    for path in sorted(glob.glob(os.path.join(dens_dir, "*n_all.dat"))):
        cube = read_unformatted_cube(path, dtype=np.float32)
        write_unformatted_cube(path, _viewed(cube, view) * scale,
                               dtype=np.float32)
    src_dir = os.path.join(base, *cfg["layout"]["source_dir"])
    for path in sorted(glob.glob(os.path.join(src_dir,
                                              "*_wsubgrid_sources.dat"))):
        _view_catalog(path, view, M)
    for path in sorted(glob.glob(os.path.join(workdir, "results",
                                              "xfrac3d*.bin"))):
        cube = read_unformatted_cube(path, dtype=np.float64)
        write_unformatted_cube(path, _viewed(cube, view),
                               dtype=np.float64)
    run["nbody"] = dict(cfg["nbody"],
                        redshift_file=os.path.join(base, "redshifts.txt"),
                        base_dir=base + os.sep)
    return out


def _viewed(cube, view):
    """`cube` with its axes in the order `perm`, reversed along the axes
    `flip`, then rolled by `shift`: the cell at p moves to `_cell(p)`."""
    perm, flip, shift = view
    c = np.flip(np.transpose(cube, perm), tuple(np.flatnonzero(flip)))
    return np.roll(c, tuple(int(k) for k in shift), axis=(0, 1, 2))


def _cell(p, view, M):
    """Where `_viewed` puts the 0-based cell p (a length-3 array)."""
    perm, flip, shift = view
    q = np.asarray(p)[perm]
    return (np.where(flip, M - 1 - q, q) + shift) % M


def _view_catalog(path, view, M):
    """Rewrite a `<z>_wsubgrid_sources.dat` (a count, then 1-based
    (i, j, k) and the two mass columns) with its cells moved as
    `_viewed` moves them, rows in their order."""
    with open(path) as f:
        lines = f.read().split("\n")
    n = int(lines[0])
    rows = [ln.split() for ln in lines[1:1 + n]]
    with open(path, "w") as f:
        f.write(f"{n}\n")
        for r in rows:
            i, j, k = _cell([int(x) - 1 for x in r[:3]], view, M) + 1
            f.write(f"{i} {j} {k} {r[3]} {r[4]}\n")
