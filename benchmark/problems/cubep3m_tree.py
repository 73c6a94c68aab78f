"""Seeded inputs in the CubeP3M formats that the port's readers take.

One generator for every configuration of the benchmark: it writes, under
a work directory, the redshift list, one density cube per slice
(``<z>n_all.dat``, grid units: mean 1), one halo catalog per slice
(``<z>_wsubgrid_sources.dat``) and, where the cell starts from an
ionized state, the slice-restart cubes (``xfrac3d_<z>.bin``,
``xfrac3dHe1_<z>.bin``, ``xfrac3dHe2_<z>.bin``).  It returns the plain
dictionary that ``c2ray_tpu_torch.config.run3d_config_from_dict``
takes.

What the seed moves and what it does not:

- The density field is a lognormal field with the configuration's
  smoothing and width (its phases come from the seed), with a Gaussian
  overdensity at every halo.
- Halo positions are the highest peaks of the smoothed field, so the
  seed moves them.  The halo counts and masses are fixed: the masses
  are fixed quantiles of a dn/dM ~ M^-2 mass function, largest first,
  assigned to the peaks in order of height.
- The ionized bubbles of a restart fill the workload's share of the
  volume exactly (a quantile threshold of the smoothed halo field), and
  exactly half of the low-mass halos sit in ionized cells, so the
  number of sources that the suppression keeps is fixed too.

The random numbers are drawn with a ``torch.Generator`` on the given
device, in a few whole-grid calls.  This module reads nothing of the
program and writes only under the work directory.
"""

import math
import os

import numpy as np
import torch

from reference.plain.io.fortran_records import write_unformatted_cube
from reference.plain.io.readers import _zred_str
from reference.plain.nbody import _eds_sequence
from reference.plain.cosmology import COSMOLOGIES
from reference.plain import constants as const


def redshifts(cfg: dict, traffic: dict) -> list:
    """The slice redshifts the cell runs: the configuration's sequence
    (EdS-spaced from `z_start` by `slice_yr`) from the workload's
    `z_start`, the cycle's slices plus the end of the last one."""
    seq = cfg["slices"]
    z0 = float(traffic.get("z_start", seq["z_start"]))
    n = int(traffic["num_slices"]) + 1
    cosmo = COSMOLOGIES[cfg["run3d"]["cosmology"]]
    zs = _eds_sequence(z0, float(seq["slice_yr"]) * const.YEAR, n, cosmo)
    if seq.get("rounded", True):
        # a redshift list file holds three decimals (f6.3 file names)
        zs = np.round(zs, 3)
    return [float(z) for z in zs]


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63 - 1))
    return g


def _smooth(field, sigma_cells: float):
    """Periodic Gaussian smoothing (FFT) with width `sigma_cells`."""
    M = field.shape[0]
    k = torch.fft.fftfreq(M, device=field.device, dtype=field.dtype)
    kr = torch.fft.rfftfreq(M, device=field.device, dtype=field.dtype)
    k2 = (k[:, None, None] ** 2 + k[None, :, None] ** 2
          + kr[None, None, :] ** 2) * (2.0 * math.pi) ** 2
    spec = torch.fft.rfftn(field) * torch.exp(-0.5 * k2 * sigma_cells**2)
    return torch.fft.irfftn(spec, s=field.shape)


def _peaks(field, n: int):
    """Flat indices of the n highest local maxima of a periodic field,
    highest first; where it has fewer, the highest other cells follow
    (at the few cells of a test grid)."""
    pad = torch.nn.functional.pad(field[None, None], (1,) * 6,
                                  mode="circular")
    mx = torch.nn.functional.max_pool3d(pad, 3, stride=1)[0, 0]
    flat = field.reshape(-1)
    peak = (field >= mx).reshape(-1)
    # peaks rank above every other cell, each group by height
    key = flat - flat.min() + peak.to(flat.dtype) * (flat.max() - flat.min()
                                                     + 1.0)
    return torch.topk(key, n).indices


def quantile_masses(n: int, m_min: float, m_max: float) -> np.ndarray:
    """n masses at the fixed quantiles (i + 1/2)/n of dn/dM ~ M^-2 on
    [m_min, m_max], largest first."""
    q = (np.arange(n) + 0.5) / n
    inv = 1.0 / m_max + q * (1.0 / m_min - 1.0 / m_max)
    return np.sort(1.0 / inv)[::-1].copy()


def _unravel(flat, M):
    flat = np.asarray(flat, dtype=np.int64)
    return np.stack([flat // (M * M), (flat // M) % M, flat % M], axis=1)


def _write_catalog(path, pos, m_high, m_low):
    """`<z>_wsubgrid_sources.dat`: a count, then (i, j, k) 1-based with
    the high- and low-mass columns in grid-mass units."""
    with open(path, "w") as f:
        f.write(f"{len(pos)}\n")
        for (i, j, k), mh, ml in zip(pos + 1, m_high, m_low):
            f.write("%d %d %d %.6e %.6e\n" % (i, j, k, mh, ml))


def make(cfg: dict, traffic: dict, seed: int, workdir: str, device="cpu",
         mesh=None) -> dict:
    """Write the cell's inputs under `workdir` and return its Run3D
    configuration dictionary.  `mesh` overrides the configuration's
    (the CPU tests run the same generator at a few cells)."""
    run = dict(cfg["run3d"])
    run.update(traffic.get("run3d", {}))
    M = int(mesh or run["mesh"])
    run["mesh"] = M
    dens = cfg["density"]
    halos = cfg["halos"]
    n_high = int(traffic["n_sources"]) - int(traffic.get("n_low_mass", 0))
    n_low = int(traffic.get("n_low_mass", 0))
    zs = redshifts(cfg, traffic)
    dev = torch.device(device)
    g = _generator(seed, dev)

    # density: lognormal with the configuration's width, unit mean
    white = torch.randn((M, M, M), generator=g, device=dev,
                        dtype=torch.float32)
    smooth = _smooth(white, float(dens["smoothing_cells"]))
    smooth = smooth / smooth.std()
    idx = _peaks(smooth, n_high + 4 * n_low)
    pos = _unravel(idx.cpu().numpy(), M)
    field = torch.exp(float(dens["sigma_ln"]) * smooth)
    # a Gaussian overdensity at every massive halo
    blob = torch.zeros((M, M, M), device=dev, dtype=torch.float32)
    blob.view(-1)[idx[:n_high]] = 1.0
    w = float(dens["halo_blob_cells"])
    blob = _smooth(blob, w) * (2.0 * math.pi * w * w) ** 1.5
    field = field / field.mean() + float(dens["halo_overdensity"]) * blob
    field = torch.clamp(field / field.mean(), min=float(dens["floor"]))
    cube = field.cpu().numpy().astype(np.float32)

    # halo masses in grid-mass units of the nbody backend
    m_grid = _grid_mass(cfg, run)
    m_high = quantile_masses(n_high, *halos["high_mass_msun_h"]) \
        / m_grid if n_high else np.zeros(0)
    m_low = quantile_masses(n_low, *halos["low_mass_msun_h"]) \
        / m_grid if n_low else np.zeros(0)

    base = os.path.join(workdir, "tree")
    dens_dir = os.path.join(base, *cfg["layout"]["density_dir"])
    src_dir = os.path.join(base, *cfg["layout"]["source_dir"])
    results = os.path.join(workdir, "results")
    for d in (dens_dir, src_dir, results):
        os.makedirs(d, exist_ok=True)

    # the low-mass halos: candidate peaks below the massive ones; with a
    # restart, half in ionized cells and half in neutral ones
    cand = pos[n_high:]
    ionized = None
    if "restart" in traffic:
        ionized = _bubbles(pos[:n_high], m_high, M, dev,
                           float(traffic["restart"]["filling"]),
                           float(traffic["restart"]["bubble_cells"]))
        inside = ionized[cand[:, 0], cand[:, 1], cand[:, 2]]
        pick = np.concatenate([np.flatnonzero(inside)[:n_low // 2],
                               np.flatnonzero(~inside)[:n_low - n_low // 2]])
        if len(pick) != n_low:
            raise ValueError("not enough low-mass halo candidates in "
                             "ionized and neutral cells")
        low_pos = cand[np.sort(pick)]
    else:
        low_pos = cand[:n_low]
    cat_pos = np.concatenate([pos[:n_high], low_pos]).astype(np.int64)
    cat_high = np.concatenate([m_high, np.zeros(n_low)])
    cat_low = np.concatenate([np.zeros(n_high), m_low])

    written = set()
    for z in zs[:-1]:
        name = _zred_str(z)
        if name in written:
            continue
        written.add(name)
        write_unformatted_cube(os.path.join(dens_dir, f"{name}n_all.dat"),
                               cube, dtype=np.float32)
        _write_catalog(os.path.join(src_dir,
                                    f"{name}_wsubgrid_sources.dat"),
                       cat_pos, cat_high, cat_low)
    zfile = os.path.join(base, "redshifts.txt")
    with open(zfile, "w") as f:
        f.write(f"{len(zs)}\n" + "\n".join(repr(z) for z in zs) + "\n")

    if ionized is not None:
        rs = traffic["restart"]
        name = _zred_str(zs[0])
        xh1 = np.where(ionized, rs["x_ionized"], rs["x_neutral"])
        fields = {"xfrac3d": xh1,
                  "xfrac3dHe1": xh1 * float(rs["he1_of_h1"]),
                  "xfrac3dHe2": xh1 * float(rs["he2_of_h1"])}
        for stem, x in fields.items():
            write_unformatted_cube(os.path.join(results,
                                                f"{stem}_{name}.bin"),
                                   x, dtype=np.float64)

    nbody = dict(cfg["nbody"])
    if nbody["type"] == "cubep3m":
        nbody.update(redshift_file=zfile, base_dir=base + os.sep,
                     source_dir=src_dir + os.sep)
    else:
        nbody.update(data_dir=base + os.sep)
    run.update(nbody=nbody, results_dir=results + os.sep,
               dump_dir=workdir + os.sep)
    return {"run3d": run, "redshifts": zs, "n_sources": len(cat_pos),
            "restart_z": zs[0] if ionized is not None else None}


def _grid_mass(cfg: dict, run: dict) -> float:
    """The nbody backend's grid mass (cubep3m.F90:119-120) in Msun/h:
    the box's mass over n_box^3 fine cells (n_box 1 when unset)."""
    cosmo = COSMOLOGIES[run["cosmology"]]
    n = cfg["nbody"].get("n_box") or 1
    box_cm = cfg["nbody"]["boxsize"] * const.Mpc / cosmo.h
    m_box = cosmo.rho_crit_0 * cosmo.Omega0 * box_cm**3
    return m_box / float(n) ** 3 / (const.M_SOLAR / cosmo.h)


def _bubbles(pos, mass, M, dev, filling, width):
    """Ionized cells: where the halo mass field smoothed over `width`
    cells lies in its top `filling` share (ties broken by position)."""
    dep = torch.zeros((M, M, M), device=dev, dtype=torch.float64)
    flat = torch.as_tensor((pos[:, 0] * M + pos[:, 1]) * M + pos[:, 2],
                           device=dev)
    dep.view(-1).index_add_(0, flat, torch.as_tensor(mass, device=dev))
    sm = _smooth(dep, width).reshape(-1)
    order = torch.argsort(sm, descending=True, stable=True)
    ion = torch.zeros(M**3, dtype=torch.bool, device=dev)
    ion[order[:int(round(filling * M**3))]] = True
    return ion.reshape(M, M, M).cpu().numpy()
