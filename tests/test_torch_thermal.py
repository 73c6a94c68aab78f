"""Cooling, thermal, grid and cosmology: the port against the JAX package.

float64 throughout.  The cooling tables are built by the same numpy
code in both packages and agree to rtol 1e-14.  `coolin` is one
log10, a truncating cast and a linear interpolation: rtol 1e-13.  The
thermal sub-cycle is an explicit integration whose step sequence
amplifies last-bit differences between XLA's and PyTorch's CPU math
(after 140 sub-steps as much as a 1-ulp change of the input
temperature): temperatures agree to rtol 1e-9 at time steps of up to
1e14 s (measured 9e-11 after 915 sub-steps), and the sub-step count
exactly.  Grid and cosmology are host float64 arithmetic: rtol 1e-14.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import cooling as j_cool
from c2ray_tpu import cosmology as j_cosmo
from c2ray_tpu import grid as j_grid
from c2ray_tpu import thermal as j_thermal
from c2ray_tpu.chemistry import IonFractions as JIF
from c2ray_tpu.chemistry import IonState as JIS
from c2ray_tpu_torch import convert
from c2ray_tpu_torch import cooling as t_cool
from c2ray_tpu_torch import cosmology as t_cosmo
from c2ray_tpu_torch import grid as t_grid
from c2ray_tpu_torch import thermal as t_thermal
from c2ray_tpu_torch.chemistry import IonFractions as TIF
from c2ray_tpu_torch.chemistry import IonState as TIS

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

_NAMES = ("H0-cool.tab", "H1-cool-B.tab", "He0-cool_new.tab",
          "He1-cool_new_nocollion.tab", "He2-cool.tab")


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_cooling_tables_match():
    a = t_cool.setup_cooling_tables(torch.float64)
    b = j_cool.setup_cooling_tables(jnp.float64)
    for name, x, y in zip(a._fields, a, b):
        assert x.shape == (t_cool.TEMPPOINTS,)
        _close(x, y, rtol=1e-14, msg=name)
    assert t_cool.DTEMP_LOG == j_cool.DTEMP_LOG


def test_cooling_tables_from_files_match(tmp_path):
    """Reference-format ASCII tables load alike in both packages."""
    tabs = j_cool.setup_cooling_tables()
    logt = j_cool.MINTEMP_LOG + j_cool.DTEMP_LOG * np.arange(
        j_cool.TEMPPOINTS)
    for name, col in zip(_NAMES, tabs):
        vals = np.log10(np.maximum(np.asarray(col), 1e-50))
        with open(tmp_path / name, "w") as f:
            f.write("1 1 0\n")
            for lt, lv in zip(logt, vals):
                f.write(f"{lt:.6f}  {lv:.6f}\n")
    a = t_cool.setup_cooling_tables_from_files(str(tmp_path))
    b = j_cool.setup_cooling_tables_from_files(str(tmp_path))
    for x, y in zip(a, b):
        _close(x, y, rtol=1e-14)
    with open(tmp_path / "short.tab", "w") as f:
        f.write("1 1 0\n1.0 -20.0\n")
    with pytest.raises(ValueError, match="rows"):
        t_cool.load_ascii_cooling_table(str(tmp_path / "short.tab"))


def _fractions(rng, n):
    h1 = rng.uniform(0.0, 1.0, n)
    he1 = rng.uniform(0.0, 0.6, n)
    he2 = rng.uniform(0.0, 0.4, n)
    return [1.0 - h1, h1, 1.0 - he1 - he2, he1, he2]


def test_coolin_matches_gather_path():
    """In and out of the table: T from 0.5 K to 1e10 K, including the
    end points, where the signed fraction extrapolates."""
    rng = np.random.RandomState(3)
    n = 4000
    T = np.concatenate([10.0 ** rng.uniform(np.log10(0.5), 10.0, n - 6),
                        [0.5, 10.0, 1.0e9, 1.0e10, 3.0, 2.0e9]])
    nd = 10.0 ** rng.uniform(-4, 0, n)
    ne = nd * rng.uniform(0.01, 1.1, n)
    x = _fractions(rng, n)
    tab_j = j_cool.setup_cooling_tables(jnp.float64)
    tab_t = convert.cooling_tables_from_numpy(tab_j)
    a = t_cool.coolin(tab_t, *map(torch.as_tensor, [nd, ne, *x, T]))
    b = j_cool.coolin(tab_j, *map(jnp.asarray, [nd, ne, *x, T]),
                      use_matmul=False)
    _close(a, b, rtol=1e-13)


def _thermal_inputs(seed, n=256):
    rng = np.random.RandomState(seed)
    ions = [_fractions(rng, n) for _ in range(3)]
    nd = 10.0 ** rng.uniform(-4, -1, n)
    ne = nd * rng.uniform(0.01, 1.1, n)
    T0 = 10.0 ** rng.uniform(2.0, 4.5, n)
    T0[:3] = (0.5, 1.0, 1.5)      # at and below MINITEMP: never step
    heat = nd * 10.0 ** rng.uniform(-28, -22, n)
    return ions, nd, ne, T0, heat


@pytest.mark.parametrize("seed,dt,ccf", [(0, 1.0e13, 0.0),
                                         (1, 1.0e14, 0.0),
                                         (2, 3.0e13, 3.0e-17)])
def test_thermal_matches(seed, dt, ccf):
    ions, nd, ne, T0, heat = _thermal_inputs(seed)
    tab_j = j_cool.setup_cooling_tables(jnp.float64)
    tab_t = convert.cooling_tables_from_numpy(tab_j)
    jion = JIS(*(JIF(*map(jnp.asarray, f)) for f in ions))
    tion = TIS(*(TIF(*map(torch.as_tensor, f)) for f in ions))
    ref = j_thermal.thermal(jnp.asarray(dt), jnp.asarray(T0), jnp.asarray(ne),
                            jnp.asarray(nd), jion, jnp.asarray(heat), tab_j,
                            ccf)
    got = t_thermal.thermal(dt, torch.as_tensor(T0), torch.as_tensor(ne),
                            torch.as_tensor(nd), tion, torch.as_tensor(heat),
                            tab_t, ccf)
    assert got.n_substeps == int(ref.n_substeps) > 10
    _close(got.end_temper, ref.end_temper, rtol=1e-9, msg="end_temper")
    _close(got.avg_temper, ref.avg_temper, rtol=1e-9, msg="avg_temper")
    # cells at or below MINITEMP keep their temperature
    np.testing.assert_array_equal(got.end_temper[:2].numpy(), T0[:2])


def test_thermal_cosmological_cooling_cools():
    """Zero photo-heating with a cosmological cooling factor: the gas
    cools, by more than with radiative cooling alone."""
    _, nd, ne, T0, _ = _thermal_inputs(4, n=32)
    fr = TIF(*map(torch.as_tensor, _fractions(np.random.RandomState(4), 32)))
    tab = t_cool.setup_cooling_tables(torch.float64)
    args = (1.0e13, torch.as_tensor(T0), torch.as_tensor(ne),
            torch.as_tensor(nd), TIS(fr, fr, fr),
            torch.zeros(32, dtype=torch.float64), tab)
    plain = t_thermal.thermal(*args, 0.0)
    cosmo = t_thermal.thermal(*args, 3.0e-16)
    warm = torch.as_tensor(T0) > 10.0     # not held at the 1 K floor
    assert bool((cosmo.end_temper < plain.end_temper)[warm].all())
    assert bool((plain.end_temper <= torch.as_tensor(T0)).all())


def test_pressure_temperature_round_trip():
    rng = np.random.RandomState(5)
    T = 10.0 ** rng.uniform(0, 8, 100)
    nd = 10.0 ** rng.uniform(-5, 0, 100)
    ne = nd * rng.uniform(0, 1.2, 100)
    p = t_thermal.temper2pressr(torch.as_tensor(T), torch.as_tensor(nd),
                                torch.as_tensor(ne))
    _close(p, j_thermal.temper2pressr(T, nd, ne), rtol=1e-15)
    _close(t_thermal.pressr2temper(p, torch.as_tensor(nd),
                                   torch.as_tensor(ne)), T, rtol=1e-14)
    assert (t_thermal.MINITEMP, t_thermal.RELATIVE_DENERGY,
            t_thermal.MAX_SUBSTEPS) == (j_thermal.MINITEMP,
                                        j_thermal.RELATIVE_DENERGY,
                                        j_thermal.MAX_SUBSTEPS)


def test_grids_match():
    for a, b in ((t_grid.RadialGrid(0.0, 3.0e22, 64),
                  j_grid.RadialGrid(0.0, 3.0e22, 64)),
                 (t_grid.RadialGrid(1.0e20, 5.0e22, 100),
                  j_grid.RadialGrid(1.0e20, 5.0e22, 100))):
        _close(a.dr, b.dr, rtol=1e-14)
        _close(a.x, b.x, rtol=1e-14)
        _close(a.vol, b.vol, rtol=1e-14)
    a = t_grid.CartesianGrid(100.0, (32, 32, 32), h=0.7)
    b = j_grid.CartesianGrid(100.0, (32, 32, 32), h=0.7)
    for name in ("boxsize_cm", "dr", "vol", "sim_volume"):
        _close(getattr(a, name), getattr(b, name), rtol=1e-14, msg=name)
    _close(a.coords(1), b.coords(1), rtol=1e-14)


@pytest.mark.parametrize("name", sorted(j_cosmo.COSMOLOGIES))
def test_cosmology_matches(name):
    pa, pb = t_cosmo.COSMOLOGIES[name], j_cosmo.COSMOLOGIES[name]
    assert pa == t_cosmo.CosmologyParams(pb.cosmo_id, pb.h, pb.Omega0,
                                         pb.Omega_B, pb.cmbtemp)
    _close(pa.H0, pb.H0, rtol=1e-14)
    _close(pa.rho_crit_0, pb.rho_crit_0, rtol=1e-14)
    ca, cb = t_cosmo.CosmoClock.init(pa, 9.0), j_cosmo.CosmoClock.init(pb, 9.0)
    _close(ca.t0, cb.t0, rtol=1e-14)
    for z in (8.5, 7.0, 6.0):
        _close(ca.zred2time(z), cb.zred2time(z), rtol=1e-14)
        _close(ca.time2zred(ca.zred2time(z)), cb.time2zred(cb.zred2time(z)),
               rtol=1e-14)
    for t in (0.0, 1.0e14, 3.0e15):
        ca, zfa, Hza = ca.redshift_evol(t)
        cb, zfb, Hzb = cb.redshift_evol(t)
        _close((ca.zred, zfa, Hza), (cb.zred, zfb, Hzb), rtol=1e-14)
        _close(ca.cosmo_cool_factor(), cb.cosmo_cool_factor(), rtol=1e-14)
        _close(ca.cosmo_cool_rate(2.0e-13), cb.cosmo_cool_rate(2.0e-13),
               rtol=1e-14)
        _close(ca.compton_cool_rate(1.0e4, 1.0e-3),
               float(cb.compton_cool_rate(1.0e4, 1.0e-3)), rtol=1e-14)
    assert ca.cosmo_cool_factor() > 0.0
    _close(t_cosmo.cosmo_evol_scaling(1.1), j_cosmo.cosmo_evol_scaling(1.1),
           rtol=1e-15)
