"""The 3D timestep: the port's plain path against the JAX package.

16^3 x 2 sources, float64, with the adaptive subbox.  One iteration and
a full `evolve3d` go through both packages from the same state; the
iteration count, conv_flag and subbox radius agree exactly, and the
state fields to rtol 1e-9 with a 1e-11 absolute floor: fractions are
O(1), and near the sources doric's mode sums cancel terms of up to
~1e4, so float64 rounding reaches ~1e-12 in h_int0 = 1 - h_int1.
The mirror-symmetry check of tests/test_sweep3d.py runs on the port
alone.

The heating timestep uses the 16^3 single-source setup of
tests/test_thermal_3d.py (1e5 K blackbody, T0 = 100 K) and the same
tolerances (measured: fields within 1.2e-14 absolute, temperatures
within 1e-13 relative); the port's result must also pass that test's
physics checks.
"""

import jax.numpy as jnp
import numpy as np
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.cooling import setup_cooling_tables
from c2ray_tpu.radiation import BlackBodySED, SEDConfig
from c2ray_tpu.radiation.quadrature import build_quadrature_tables
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.evolve3d import evolve3d as j_evolve3d
from c2ray_tpu.sweep.evolve3d import \
    make_evolve3d_iteration as j_make_iteration
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.radiation import sed as t_sed
from c2ray_tpu_torch.radiation.quadrature import \
    build_quadrature_tables as t_build
from c2ray_tpu_torch.state import initial_grid_state as t_state
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SweepConfig, evolve3d,
                                   make_evolve3d_iteration)

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

M = 16


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                               atol=1e-11, err_msg=name)


def _setup():
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=3e51)),
        isothermal=True, dtype=jnp.float64)
    kw = dict(mesh=M, dr=15.0 * const.kpc / M, isothermal=True,
              flux_scale=bands.flux_scale)
    jcfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, **kw),
        chem=JChemConfig(cooling=None, isothermal=True),
        shells=build_shell_table(M), subbox_start=4)
    tcfg = Evolve3DConfig(
        sweep=SweepConfig(tables=convert.quad_tables_from_numpy(tables), **kw),
        chem=ChemistryConfig(isothermal=True), subbox_start=4)
    rng = np.random.RandomState(7)
    srcpos = rng.randint(0, M, size=(2, 3))
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (2, 1)),
                            np.zeros((2, 2))], axis=1)
    dens = 1e-4 * 10.0 ** rng.uniform(-0.5, 0.5, (M, M, M))
    js = j_state(dens, 0.0, 0.0, 0.0, 1.0e4, dtype=jnp.float64)
    return jcfg, tcfg, js, srcpos, nflux


def test_one_iteration_matches_jax():
    jcfg, tcfg, js, srcpos, nflux = _setup()
    dt = 1.0e14
    ref = j_make_iteration(jcfg)(js, jnp.asarray(srcpos, jnp.int32),
                                 jnp.asarray(nflux), jnp.asarray(dt))
    got = make_evolve3d_iteration(tcfg)(convert.grid_state_from_numpy(js),
                                        torch.as_tensor(srcpos),
                                        torch.as_tensor(nflux), dt)
    assert int(got[1]) == int(ref[1])
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-10)
    for name in got[0]._fields:
        _close(getattr(got[0], name), getattr(ref[0], name), name)


def test_evolve3d_matches_jax():
    jcfg, tcfg, js, srcpos, nflux = _setup()
    dt = 1.0e14
    j_new, j_stats = j_evolve3d(jcfg, js, jnp.asarray(srcpos, jnp.int32),
                                jnp.asarray(nflux), dt)
    t_new, t_stats = evolve3d(tcfg, convert.grid_state_from_numpy(js),
                              torch.as_tensor(srcpos),
                              torch.as_tensor(nflux), dt)
    assert t_stats.n_iterations == j_stats.n_iterations
    assert t_stats.conv_flag == j_stats.conv_flag
    assert t_stats.subbox_radius == j_stats.subbox_radius
    assert j_stats.subbox_radius > jcfg.subbox_start   # the subbox grew
    np.testing.assert_allclose(t_stats.photon_loss, j_stats.photon_loss,
                               rtol=1e-9)
    for name in t_new._fields:
        _close(getattr(t_new, name), getattr(j_new, name), name)


def test_evolve3d_dr_override_matches_jax():
    """`dr` rescales the cell size (the cosmological driver's per-step
    proper length), passed on with its host-f64 dr^3/flux_scale."""
    jcfg, tcfg, js, srcpos, nflux = _setup()
    dt, dr = 1.0e14, 1.3 * jcfg.sweep.dr
    j_new, j_stats = j_evolve3d(jcfg, js, jnp.asarray(srcpos, jnp.int32),
                                jnp.asarray(nflux), dt, dr=dr)
    t_new, t_stats = evolve3d(tcfg, convert.grid_state_from_numpy(js),
                              torch.as_tensor(srcpos),
                              torch.as_tensor(nflux), dt, dr=dr)
    base, _ = evolve3d(tcfg, convert.grid_state_from_numpy(js),
                       torch.as_tensor(srcpos), torch.as_tensor(nflux), dt)
    assert not torch.equal(base.h1, t_new.h1), "dr must change the result"
    assert (t_stats.n_iterations, t_stats.conv_flag,
            t_stats.subbox_radius) == (j_stats.n_iterations,
                                       j_stats.conv_flag,
                                       j_stats.subbox_radius)
    np.testing.assert_allclose(t_stats.photon_loss, j_stats.photon_loss,
                               rtol=1e-9)
    for name in t_new._fields:
        _close(getattr(t_new, name), getattr(j_new, name), name)


def _heating_setup():
    """tests/test_thermal_3d.py:16-34 in both packages."""
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=1.0e5, S_star=1.0e49)),
        isothermal=False, dtype=jnp.float64)
    cooling = setup_cooling_tables(jnp.float64)
    kw = dict(mesh=M, dr=12.0 * const.kpc / M, isothermal=False,
              flux_scale=bands.flux_scale)
    jcfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, **kw),
        chem=JChemConfig(cooling=cooling, isothermal=False),
        shells=build_shell_table(M))
    tcfg = Evolve3DConfig(
        sweep=SweepConfig(tables=convert.quad_tables_from_numpy(tables), **kw),
        chem=ChemistryConfig(
            isothermal=False,
            cooling=convert.cooling_tables_from_numpy(cooling)))
    js = j_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0, 100.0,
                 dtype=jnp.float64)
    return jcfg, tcfg, js, np.array([[M // 2] * 3]), np.array([[1.0, 0.0,
                                                                 0.0]])


def test_heating_iteration_matches_jax():
    """One heating iteration with a cosmological cooling factor."""
    jcfg, tcfg, js, srcpos, nflux = _heating_setup()
    dt, ccf = 5.0e6 * const.YEAR, 1.0e-16
    ref = j_make_iteration(jcfg)(js, jnp.asarray(srcpos, jnp.int32),
                                 jnp.asarray(nflux), jnp.asarray(dt),
                                 cosmo_cool_factor=jnp.asarray(ccf))
    got = make_evolve3d_iteration(tcfg)(convert.grid_state_from_numpy(js),
                                        torch.as_tensor(srcpos),
                                        torch.as_tensor(nflux), dt,
                                        cosmo_cool_factor=ccf)
    assert int(got[1]) == int(ref[1])
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-10)
    assert float(np.max(np.asarray(ref[0].t_av))) > 1.0e4   # it heats
    for name in got[0]._fields:
        _close(getattr(got[0], name), getattr(ref[0], name), name)


def test_heating_evolve3d_matches_jax():
    jcfg, tcfg, js, srcpos, nflux = _heating_setup()
    dt = 5.0e6 * const.YEAR
    j_new, j_stats = j_evolve3d(jcfg, js, jnp.asarray(srcpos, jnp.int32),
                                jnp.asarray(nflux), dt)
    t_new, t_stats = evolve3d(tcfg, convert.grid_state_from_numpy(js),
                              torch.as_tensor(srcpos),
                              torch.as_tensor(nflux), dt)
    assert (t_stats.n_iterations, t_stats.conv_flag,
            t_stats.subbox_radius) == (j_stats.n_iterations,
                                       j_stats.conv_flag,
                                       j_stats.subbox_radius)
    for name in t_new._fields:
        _close(getattr(t_new, name), getattr(j_new, name), name)

    # the physics checks of tests/test_thermal_3d.py, on the port
    T = t_new.t_final.reshape(M, M, M).numpy()
    h1 = t_new.h1.reshape(M, M, M).numpy()
    he2 = t_new.he2.reshape(M, M, M).numpy()
    c = M // 2
    assert 1.5e4 < T[c, c, c] < 6.0e4
    assert h1[c, c, c] > 0.99
    assert he2[c, c, c] > 0.5
    assert T[0, 0, 0] < 5.0 * 100.0
    assert np.all(np.isfinite(T))


def test_multi_source_symmetry():
    """Two equal sources placed symmetrically produce a mirror-symmetric
    ionization field (tests/test_sweep3d.py:93, on the port)."""
    tables, _, bands = t_build(
        t_sed.SEDConfig(bb=t_sed.BlackBodySED(T_eff=1.0e5, S_star=3.0e48)),
        isothermal=True, dtype=torch.float64)
    cfg = Evolve3DConfig(
        sweep=SweepConfig(tables=tables, mesh=M, dr=14.0 * const.kpc / M,
                          isothermal=True, flux_scale=bands.flux_scale),
        chem=ChemistryConfig(isothermal=True, isothermal_temperature=1.0e4))
    state = t_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0, 1.0e4)
    srcpos = torch.tensor([[4, 8, 8], [12, 8, 8]])
    nflux = torch.tensor([[0.5, 0.0, 0.0], [0.5, 0.0, 0.0]],
                         dtype=torch.float64)
    state, _ = evolve3d(cfg, state, srcpos, nflux, 10.0e6 * const.YEAR)
    h1 = state.h1.reshape(M, M, M).numpy()
    # mirror about the x = 8 plane maps source 1 onto source 2:
    # with periodic wrap, x -> (16 - x) mod 16
    mirrored = h1[(16 - np.arange(16)) % 16]
    np.testing.assert_allclose(h1, mirrored, rtol=1e-6, atol=1e-12)
