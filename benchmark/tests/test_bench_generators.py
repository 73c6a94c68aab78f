"""The seeded generator: one seed, one set of inputs; another seed moves
positions and phases but not the counts, masses or bubble filling."""

import bench_path  # noqa: F401  (the import path; first)

import hashlib
import os

import numpy as np

from harness import spec

GEN = spec.generator("cubep3m_tree")


def _digest(root):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                data = fh.read()
            h.update(data.replace(str(root).encode(), b""))
    return h.hexdigest()


def _make(tmp_path, tag, cell, seed, **over):
    cfg = spec.config(spec.cell(spec.benchmark(), cell)["config"])
    traffic = dict(spec.traffic(cell), **over)
    d = tmp_path / tag
    d.mkdir()
    out = GEN.make(cfg, traffic, seed, str(d), mesh=24)
    return d, out


def _catalog(d, out):
    from reference.plain.io.readers import _zred_str

    z = _zred_str(out["redshifts"][0])
    for root, _, files in os.walk(d):
        for f in files:
            if f == f"{z}_wsubgrid_sources.dat":
                return np.loadtxt(os.path.join(root, f), skiprows=1)
    raise FileNotFoundError(z)


def test_one_seed_one_set_of_inputs(tmp_path):
    big = 2**31 + 12345
    a, oa = _make(tmp_path, "a", "cubep3m_250.late_isothermal", big,
                  n_sources=8, n_low_mass=2)
    b, ob = _make(tmp_path, "b", "cubep3m_250.late_isothermal", big,
                  n_sources=8, n_low_mass=2)
    assert _digest(a) == _digest(b)
    assert oa["redshifts"] == ob["redshifts"]


def test_another_seed_moves_positions_not_counts_or_masses(tmp_path):
    a, oa = _make(tmp_path, "a", "cubep3m_250.late_isothermal", 1,
                  n_sources=8, n_low_mass=2)
    b, ob = _make(tmp_path, "b", "cubep3m_250.late_isothermal", 2,
                  n_sources=8, n_low_mass=2)
    ca, cb = _catalog(a, oa), _catalog(b, ob)
    assert ca.shape == cb.shape == (8, 5)
    np.testing.assert_array_equal(ca[:, 3:], cb[:, 3:])
    assert not np.array_equal(ca[:, :3], cb[:, :3])


def test_restart_fills_its_share_and_halves_the_low_mass_halos(tmp_path):
    from reference.plain.io.fortran_records import read_unformatted_cube
    from reference.plain.io.readers import _zred_str

    d, out = _make(tmp_path, "a", "cubep3m_250.late_isothermal", 5,
                   n_sources=8, n_low_mass=4)
    rs = spec.traffic("cubep3m_250.late_isothermal")["restart"]
    z = _zred_str(out["restart_z"])
    x = read_unformatted_cube(str(d / "results" / f"xfrac3d_{z}.bin"),
                              dtype=np.float64)
    ionized = x == rs["x_ionized"]
    assert ionized.sum() == round(rs["filling"] * x.size)
    cat = _catalog(d, out)
    low = cat[cat[:, 4] > 0][:, :3].astype(int) - 1
    inside = ionized[low[:, 0], low[:, 1], low[:, 2]]
    assert inside.sum() == 2 and (~inside).sum() == 2
