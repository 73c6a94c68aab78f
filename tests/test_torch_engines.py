"""The sweep engines in the timestep and the driver: the port against the
JAX package, float64 on the CPU.

`evolve3d` with engine="shells" at 17^3 (odd: the shell engine's own
case) and engine="octant" at 16^3, two sources: iteration count and
conv_flag equal, fields within rtol 1e-9 and a 1e-11 absolute floor
(tests/test_torch_evolve3d.py's tolerance).  The engine-selection rules
of JAX evolve3d.py:119-130 and :275; Run3D at an odd mesh (17^3) and
under max_subbox (16^3, radius 5) against JAX's Run3D with the helpers
of tests/test_torch_driver3d.py.  And where the port parts from a fault
of the reference (ROADMAP Queue 3): JAX's octant and shell engines
ignore the iteration's `dr`, `vol_over_scale` and `lls_grid`; the port's
shell engine takes them (a decided deviation), its octant engine keeps
the parity.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.radiation import BlackBodySED, SEDConfig
from c2ray_tpu.radiation.quadrature import build_quadrature_tables
from c2ray_tpu.sources import SourceList as JSourceList
from c2ray_tpu.state import GridState as JGridState
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_table
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.evolve3d import evolve3d as j_evolve3d
from c2ray_tpu.sweep.evolve3d import \
    make_evolve3d_iteration as j_make_iteration
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu_torch import convert, driver
from c2ray_tpu_torch.sources import SourceList
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SweepConfig, build_shell_table, evolve3d,
                                   make_evolve3d_iteration)
from c2ray_tpu_torch.sweep.evolve3d import sweep_engine
from test_torch_driver3d import (SOURCES, _SLICE, _close_state, _runs,
                                 _same_outputs, _same_stats)

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                               atol=1e-11, err_msg=name)


def _setup(M, engine, max_radius=None, lls=0.0):
    """The isothermal setup of tests/test_torch_evolve3d.py at mesh M,
    in both packages, with the given engine and shell table."""
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=3e51)),
        isothermal=True, dtype=jnp.float64)
    kw = dict(mesh=M, dr=15.0 * const.kpc / M, isothermal=True,
              flux_scale=bands.flux_scale, coldensh_LLS=lls)
    jcfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, **kw),
        chem=JChemConfig(cooling=None, isothermal=True),
        shells=j_table(M, max_radius), engine=engine, subbox_start=4)
    tcfg = Evolve3DConfig(
        sweep=SweepConfig(tables=convert.quad_tables_from_numpy(tables), **kw),
        chem=ChemistryConfig(isothermal=True),
        shells=build_shell_table(M, max_radius), engine=engine,
        subbox_start=4)
    rng = np.random.RandomState(7)
    srcpos = rng.randint(0, M, size=(2, 3))
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (2, 1)),
                            np.zeros((2, 2))], axis=1)
    dens = 1e-4 * 10.0 ** rng.uniform(-0.5, 0.5, (M, M, M))
    js = j_state(dens, 0.0, 0.0, 0.0, 1.0e4, dtype=jnp.float64)
    return jcfg, tcfg, js, srcpos, nflux


@pytest.mark.parametrize("engine,M", [("shells", 17), ("octant", 16)])
def test_evolve3d_engine_matches_jax(engine, M):
    jcfg, tcfg, js, srcpos, nflux = _setup(M, engine)
    dt = 1.0e14
    j_new, j_stats = j_evolve3d(jcfg, js, jnp.asarray(srcpos, jnp.int32),
                                jnp.asarray(nflux), dt)
    t_new, t_stats = evolve3d(tcfg, convert.grid_state_from_numpy(js),
                              torch.as_tensor(srcpos),
                              torch.as_tensor(nflux), dt)
    assert t_stats.n_iterations == j_stats.n_iterations >= 2
    assert t_stats.conv_flag == j_stats.conv_flag
    # no adaptive subbox off the pyramid engine
    assert t_stats.subbox_radius == j_stats.subbox_radius == 0
    np.testing.assert_allclose(t_stats.photon_loss, j_stats.photon_loss,
                               rtol=1e-9)
    for name in t_new._fields:
        _close(getattr(t_new, name), getattr(j_new, name), name)
    assert float(t_new.h1.max()) > 0.5


def test_engine_selection():
    """cfg.engine at the full periodic extents, else the shell engine;
    the photon-loss path only on the pyramid engine (JAX raises alike);
    an unknown engine raises."""
    _, tcfg, _, _, _ = _setup(16, "pyramid")
    assert sweep_engine(tcfg) == "pyramid"
    assert sweep_engine(replace(tcfg, shells=None)) == "pyramid"
    assert sweep_engine(replace(tcfg, engine="octant")) == "octant"
    assert sweep_engine(replace(tcfg, engine="shells")) == "shells"
    # a max_subbox table below M/2 - 1, or an odd mesh: shells whatever
    # the configured engine
    for engine in ("pyramid", "octant"):
        assert sweep_engine(replace(tcfg, engine=engine,
                                    shells=build_shell_table(16, 5))) \
            == "shells"
        odd = replace(tcfg, engine=engine, shells=None,
                      sweep=replace(tcfg.sweep, mesh=17))
        assert sweep_engine(odd) == "shells"
    with pytest.raises(ValueError, match="unknown sweep engine"):
        sweep_engine(replace(tcfg, engine="cubes"))
    tracked = replace(tcfg, add_photon_losses=True,
                      sweep=replace(tcfg.sweep, track_band_loss=True))
    make_evolve3d_iteration(tracked)           # the pyramid engine: fine
    jcfg, _, _, _, _ = _setup(16, "pyramid")
    j_tracked = replace(jcfg, add_photon_losses=True,
                        sweep=replace(jcfg.sweep, track_band_loss=True))
    for t_kw, j_kw in ((dict(engine="octant"),) * 2,
                       (dict(engine="shells"),) * 2,
                       (dict(shells=build_shell_table(16, 5)),
                        dict(shells=j_table(16, 5)))):
        with pytest.raises(ValueError, match="pyramid engine"):
            make_evolve3d_iteration(replace(tracked, **t_kw))
        with pytest.raises(ValueError, match="pyramid engine"):
            j_make_iteration(replace(j_tracked, **j_kw))


@pytest.mark.parametrize("engine,M", [("shells", 9), ("octant", 8)])
def test_ignored_dr_and_lls_grid_parity(engine, M):
    """JAX's octant and shell engines trace the configuration's dr and
    homogeneous LLS column: an iteration given another `dr` (with its
    dr^3/flux_scale) and a per-cell `lls_grid` returns exactly what it
    returns without them (evolve3d.py:153-156).  The port's octant
    engine keeps that parity; its shell engine uses them (a decided
    deviation, ROADMAP Queue 3): the iteration equals, to the bit, one
    whose configuration carries that dr and LLS grid, and differs from
    the one without.  The pyramid engine uses them too."""
    jcfg, tcfg, js, srcpos, nflux = _setup(M, engine, lls=1.0e15)
    dt, dr = 1.0e14, 1.7 * tcfg.sweep.dr
    vos = dr**3 / tcfg.sweep.flux_scale
    grid = np.full(M**3, 3.0e16)
    grid[::3] = 0.0
    ts = convert.grid_state_from_numpy(js)
    sp, nf = torch.as_tensor(srcpos), torch.as_tensor(nflux)
    t_it = make_evolve3d_iteration(tcfg)
    base = t_it(ts, sp, nf, dt)
    moved = t_it(ts, sp, nf, dt, dr=dr, vol_over_scale=vos,
                 lls_grid=torch.as_tensor(grid))
    if engine == "octant":
        for a, b in zip(moved[0], base[0]):
            assert torch.equal(a, b)
        assert [float(x) for x in moved[1:4]] == [float(x)
                                                  for x in base[1:4]]
    else:
        carried = make_evolve3d_iteration(replace(tcfg, sweep=replace(
            tcfg.sweep, dr=dr, lls_grid=torch.as_tensor(grid))))(
                ts, sp, nf, dt)
        for a, b in zip(moved[0], carried[0]):
            assert torch.equal(a, b)
        assert [float(x) for x in moved[1:4]] == [float(x)
                                                  for x in carried[1:4]]
        assert not torch.equal(moved[0].h_av1, base[0].h_av1)
        assert float(moved[3]) != float(base[3]) > 0.0
    jsp, jnf = jnp.asarray(srcpos, jnp.int32), jnp.asarray(nflux)
    j_it = j_make_iteration(jcfg)
    j_base = j_it(js, jsp, jnf, jnp.asarray(dt))
    j_moved = j_it(js, jsp, jnf, jnp.asarray(dt), dr=jnp.asarray(dr),
                   vol_over_scale=jnp.asarray(vos),
                   lls_grid=jnp.asarray(grid))
    for a, b in zip(j_moved[0], j_base[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the pyramid engine (even mesh) does use them
    if M % 2 == 0:
        p_it = make_evolve3d_iteration(replace(tcfg, engine="pyramid"))
        p_base = p_it(ts, sp, nf, dt)
        p_moved = p_it(ts, sp, nf, dt, dr=dr, vol_over_scale=vos,
                       lls_grid=torch.as_tensor(grid))
        assert not all(torch.equal(a, b)
                       for a, b in zip(p_moved[0], p_base[0]))


@pytest.mark.parametrize("mesh,max_subbox", [(17, None), (16, 5)])
def test_run3d_shell_engine_matches_jax(tmp_path, monkeypatch, mesh,
                                        max_subbox):
    """One slice of tests/test_torch_driver3d.py's synthetic test backend
    at an odd mesh, and under a max_subbox below mesh/2 - 1: both run
    the shell engine.  Not cosmological, the cell size and LLS column
    stay put and the port's slice equals JAX's.  Cosmological, with the
    type-1 LLS column, each step has its own cell size and column, which
    JAX's shell engine drops (ROADMAP Queue 3): each step of the port
    equals JAX's evolve3d on the step's inputs with that cell size and
    column in JAX's configuration.  At least 16^3: below 4000 cells
    evolve3d's convergence criterion is 0 cells and every step runs 500
    iterations."""
    spec = dict(_SLICE, mesh=mesh, max_subbox=max_subbox, cosmological=False)
    jr, tr = _runs(tmp_path, spec, f"shells{mesh}")
    assert sweep_engine(tr.evolve_cfg) == "shells"
    assert tr.evolve_cfg.shells.lo == jr.evolve_cfg.shells.lo
    jr.init_uniform_material()
    tr.init_uniform_material()
    j_stats = jr.run_slice(0, JSourceList(*SOURCES))
    t_stats = tr.run_slice(0, SourceList(*SOURCES))
    _same_stats(t_stats, j_stats)
    assert all(s.n_iterations >= 2 and s.subbox_radius == 0
               for s in t_stats)
    _close_state(tr.state, jr.state)
    _same_outputs(jr.config.results_dir, tr.config.results_dir)
    h1 = tr.state.h1.reshape((mesh,) * 3).numpy()
    assert h1[8, 8, 8] > 0.9

    spec = dict(_SLICE, mesh=mesh, max_subbox=max_subbox,
                lls={"type_of_LLS": 1}, streams={})
    jr, tr = _runs(tmp_path, spec, f"cosmo{mesh}")
    steps = []
    port_evolve = driver.evolve3d

    def kept(cfg, state, srcpos, nflux, dt, **kw):
        out = port_evolve(cfg, state, srcpos, nflux, dt, **kw)
        steps.append((state, srcpos, nflux, dt, kw, out))
        return out
    monkeypatch.setattr(driver, "evolve3d", kept)
    tr.init_uniform_material()
    tr.run_slice(0, SourceList(*SOURCES))
    assert len(steps) == 2
    drs = [kw["dr"] for _, _, _, _, kw, _ in steps]
    assert drs[0] != drs[1] != tr.evolve_cfg.sweep.dr
    for state, srcpos, nflux, dt, kw, (t_new, t_st) in steps:
        lls = kw["lls_grid"]
        assert lls is not None and float(lls[0]) > 0.0
        assert torch.equal(lls, torch.full_like(lls, float(lls[0])))
        jcfg = replace(jr.evolve_cfg, sweep=replace(
            jr.evolve_cfg.sweep, dr=kw["dr"], coldensh_LLS=float(lls[0])))
        j_new, j_st = j_evolve3d(
            jcfg, JGridState(*(jnp.asarray(x.numpy()) for x in state)),
            jnp.asarray(srcpos.numpy()), jnp.asarray(nflux.numpy()), dt)
        _same_stats([t_st], [j_st])
        assert t_st.lls_loss > 0.0
        _close_state(t_new, j_new)
