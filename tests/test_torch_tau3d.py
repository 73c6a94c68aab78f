"""The 3D tau-table rate route: the port against the JAX package, float64
on the CPU.

`SweepConfig(tables=RadiationTables)` (JAX's source_sweep.py:118-135
dispatch, which the port took for quadrature tables only, so that the
route raised AttributeError): `_cell_rates` on seeded columns, isothermal
and heating; one `make_evolve3d_iteration` on every engine (pyramid and
octant at 16^3, the shell engine at 17^3), isothermal and heating (dt
3e13 s, tests/test_torch_chemistry.py's heating limit): the rate grids
and losses to rtol 1e-10, the state after the chemistry pass to rtol
1e-9 with a 5e-11 floor (the tau route's rates agree to ~1e-13, their
log10 positions rounding apart, and the chemistry's 1% fixed point
carries that into the He fractions near the sources: 1.08e-11 of a
2.5e-4 he_int0, where the quadrature route meets
tests/test_torch_evolve3d.py's 1e-11 floor), conv_flag equal.  The
table positions (truncated row and residual) agree to rtol 1e-12
(a decided deviation that ROADMAP.md records).
`track_band_loss` with tau tables raises, as JAX's pyramid engine does;
and the evolve3d source strength is JAX's Sigma nflux.  The timesteps
are in test_torch_tau3d_step.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.cooling import setup_cooling_tables as j_cooling
from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import PowerLawSED as JPL
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation import build_radiation_tables as j_tau_tables
from c2ray_tpu.radiation.photo import _table_positions as j_positions
from c2ray_tpu.state import begin_timestep as j_begin
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_shells
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.evolve3d import \
    _scaled_source_strength as j_strength
from c2ray_tpu.sweep.evolve3d import \
    make_evolve3d_iteration as j_make_iteration
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu.sweep.source_sweep import _cell_rates as j_cell_rates
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.cooling import setup_cooling_tables
from c2ray_tpu_torch.radiation.photo import _table_positions
from c2ray_tpu_torch.state import begin_timestep
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SourceFields, SweepConfig,
                                   build_shell_table, make_evolve3d_iteration)
from c2ray_tpu_torch.sweep import pyramid_sweep
from c2ray_tpu_torch.sweep.evolve3d import _scaled_source_strength
from c2ray_tpu_torch.sweep.source_sweep import _cell_rates

torch.set_num_threads(1)

SED = JSED(bb=JBB(T_eff=5.0e4, S_star=3e51))


def tau_setup(M, engine, isothermal, sed=SED, has_pl=False):
    """Tau tables, both packages' Evolve3DConfig, the seeded grid and
    sources of tests/test_torch_engines.py:_setup."""
    tables, _, bands = j_tau_tables(sed, isothermal=isothermal)
    kw = dict(mesh=M, dr=15.0 * const.kpc / M, isothermal=isothermal,
              flux_scale=bands.flux_scale, has_pl=has_pl)
    jcfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, **kw),
        chem=JChemConfig(cooling=None if isothermal
                         else j_cooling(dtype=jnp.float64),
                         isothermal=isothermal),
        shells=j_shells(M), engine=engine, subbox_start=4)
    tcfg = Evolve3DConfig(
        sweep=SweepConfig(tables=convert.radiation_tables_from_numpy(tables),
                          **kw),
        chem=ChemistryConfig(cooling=None if isothermal
                             else setup_cooling_tables(torch.float64),
                             isothermal=isothermal),
        shells=build_shell_table(M), engine=engine, subbox_start=4)
    rng = np.random.RandomState(7)
    srcpos = rng.randint(0, M, size=(2, 3))
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (2, 1)),
                            np.zeros((2, 2))], axis=1)
    dens = 1e-4 * 10.0 ** rng.uniform(-0.5, 0.5, (M, M, M))
    js = j_state(dens, 0.0, 0.0, 0.0, 1.0e4, dtype=jnp.float64)
    return jcfg, tcfg, js, srcpos, nflux


def _columns(n=64, seed=5):
    """Seeded in/out columns over tau_HI ~ 1e-8 .. 1e7, some cells thin."""
    rng = np.random.RandomState(seed)
    cd_in = 10.0 ** rng.uniform(10.0, 24.5, (n, 3)) * [1.0, 0.08, 0.008]
    dcol = cd_in * 10.0 ** rng.uniform(-9.0, 0.0, (n, 1))
    cd_in[:4] = 0.0
    return cd_in, cd_in + dcol


@pytest.mark.parametrize("isothermal", [True, False])
def test_cell_rates_with_tau_tables_match_jax(isothermal):
    sed = JSED(bb=JBB(T_eff=5.0e4, S_star=3e51),
               pl=JPL(index=2.5, S_star=1e50))
    jcfg, tcfg, _, _, _ = tau_setup(8, "pyramid", isothermal, sed=sed,
                                    has_pl=True)
    cd_in, cd_out = _columns()
    n = cd_in.shape[0]
    vol = 10.0 ** np.random.RandomState(6).uniform(60.0, 66.0, n)
    i_state = np.linspace(0.0, 1.0, n)
    nflux = np.array([1.3, 0.7, 0.0])
    j = j_cell_rates(jcfg.sweep, jnp.asarray(cd_in), jnp.asarray(cd_out),
                     jnp.asarray(vol), jnp.asarray(nflux),
                     jnp.asarray(i_state))
    t = _cell_rates(tcfg.sweep, torch.as_tensor(cd_in),
                    torch.as_tensor(cd_out), torch.as_tensor(vol),
                    torch.as_tensor(nflux), torch.as_tensor(i_state))
    for name in ("photo_cell_HI", "photo_cell_HeI", "photo_cell_HeII",
                 "heat", "photo_in", "photo_out"):
        b = np.asarray(getattr(j, name))
        np.testing.assert_allclose(getattr(t, name).numpy(), b, rtol=1e-10,
                                   atol=1e-30 * max(np.abs(b).max(), 1e-300),
                                   err_msg=name)
    assert (float(t.heat.abs().max()) > 0.0) == (not isothermal)
    # the table positions of the rates above
    tau = (cd_in[:, :, None] * np.asarray(jcfg.sweep.tables.sigma_HI)).sum(1)
    ji, ji1, jr = j_positions(jnp.asarray(tau))
    ti, ti1, tr = _table_positions(torch.as_tensor(tau))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti1.numpy(), np.asarray(ji1))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12,
                               atol=1e-12)


def _close(port, ref, name, rtol, atol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("engine,M,isothermal", [
    ("pyramid", 16, True), ("pyramid", 16, False),
    ("octant", 16, True), ("octant", 16, False),
    ("shells", 17, True), ("shells", 17, False)])
def test_iteration_with_tau_tables_matches_jax(engine, M, isothermal):
    jcfg, tcfg, js, srcpos, nflux = tau_setup(M, engine, isothermal)
    dt = 1.0e14 if isothermal else 3.0e13
    j_out = j_make_iteration(jcfg, return_rates=True)(
        j_begin(js), jnp.asarray(srcpos, jnp.int32), jnp.asarray(nflux), dt)
    t_out = make_evolve3d_iteration(tcfg, return_rates=True)(
        begin_timestep(convert.grid_state_from_numpy(js)),
        torch.as_tensor(srcpos), torch.as_tensor(nflux), dt)
    j_rates, t_rates = j_out[4], t_out[4]
    for name in ("phih", "phihe0", "phihe1", "phiheat"):
        b = np.asarray(getattr(j_rates, name))
        _close(getattr(t_rates, name), b, name, 1e-10,
               1e-300 + 1e-14 * np.abs(b).max())
    assert (float(t_rates.phiheat.abs().max()) > 0.0) == (not isothermal)
    assert float(t_rates.phih.max()) > 0.0
    _close(float(t_out[2]), float(j_out[2]), "photon_loss", 1e-10, 0.0)
    assert int(t_out[1]) == int(j_out[1])
    for name in t_out[0]._fields:
        _close(getattr(t_out[0], name), getattr(j_out[0], name), name,
               1e-9, 5e-11)


def test_track_band_loss_needs_quadrature_tables():
    jcfg, tcfg, js, srcpos, nflux = tau_setup(8, "pyramid", True)
    state = convert.grid_state_from_numpy(js)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    tracked = dataclasses.replace(tcfg.sweep, track_band_loss=True)
    with pytest.raises(ValueError, match="QuadTables"):
        pyramid_sweep.sweep_pyramid_source_batch(
            tracked, fields, torch.as_tensor(srcpos), torch.as_tensor(nflux))
    with pytest.raises(ValueError, match="QuadTables"):
        pyramid_sweep._kernel_tables(tracked, torch.float32, track=True)
    # JAX's pyramid engine refuses it alike
    from c2ray_tpu.sweep.pyramid_sweep import \
        sweep_pyramid_source_batch as j_sweep
    from c2ray_tpu.sweep.source_sweep import SourceFields as JFields
    j_tracked = dataclasses.replace(jcfg.sweep, track_band_loss=True)
    with pytest.raises(ValueError, match="QuadTables"):
        j_sweep(j_tracked, JFields(js.ndens, js.h_av0, js.h_av1, js.he_av0,
                                   js.he_av1),
                jnp.asarray(srcpos, jnp.int32), jnp.asarray(nflux))


def test_source_strength_of_tau_tables_is_jax():
    jcfg, tcfg, _, _, _ = tau_setup(8, "pyramid", True)
    nflux = np.random.RandomState(2).uniform(0.0, 2.0, (5, 3))
    assert _scaled_source_strength(tcfg.sweep, torch.as_tensor(nflux)) \
        == pytest.approx(float(j_strength(jcfg.sweep, jnp.asarray(nflux))),
                         rel=1e-15)
