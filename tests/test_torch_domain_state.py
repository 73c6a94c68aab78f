"""The domain mode's state between steps, and the tau-table and "auto"
rate routes in both parallel modes: the port against the JAX package,
float64 on the CPU.

- `Run3D(parallel="domain")` on 2 gloo ranks through one slice of two
  steps (the synthetic test backend of tests/test_torch_driver3d.py):
  before and after each step, and after the slice, every field a rank
  holds has mesh^3/2 cells (its x-slab, as JAX's sharded state); the
  gathered state, the steps' stats and the photon budget equal JAX's
  `Run3D(parallel="domain", n_devices=2)` on 2 host devices (state rtol
  1e-9 with a 1e-11 floor, tests/test_torch_driver3d.py's), and so do
  the files (text byte for byte, cubes within those tolerances);
- `make_domain_iteration` (radius 5) and `make_parallel_iteration` on 8
  gloo ranks with tau tables and with "auto" quadrature tables, against
  JAX's on the 8 host devices, with tests/test_torch_domain.py's and
  tests/test_torch_parallel.py's tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as R
from c2ray_tpu import config as j_config
from c2ray_tpu import constants as jconst
from c2ray_tpu import driver as j_driver
from c2ray_tpu.parallel import ParallelConfig as JParallelConfig
from c2ray_tpu.parallel import domain as jdom
from c2ray_tpu.parallel import make_parallel_iteration as j_parallel
from c2ray_tpu.parallel import pad_sources as j_pad
from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation import build_radiation_tables as j_tau_tables
from c2ray_tpu.radiation.quadrature import \
    build_quadrature_tables as j_tables
from c2ray_tpu.sources import SourceList as JSourceList
from c2ray_tpu.state import begin_timestep as j_begin
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_shells
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu_torch.parallel import launch
from test_torch_driver3d import _same_outputs

torch.set_num_threads(1)

M = 16
SPEC = {"mesh": M, "nbody": {"type": "test"},
        "sed": {"bb": {"T_eff": 5.0e4, "S_star": 3e56}},
        "isothermal": True, "steps_per_slice": 2,
        "streams": {"ion_cubes": True, "axis_cut": True}}
KINDS = ("tau", "auto")
RADIUS = 5


@pytest.fixture(scope="module")
def domain_runs(tmp_path_factory):
    """The port's Run3D on 2 gloo ranks and JAX's on 2 host devices."""
    tmp = tmp_path_factory.mktemp("domain")
    port = launch.launch(R.run3d_domain_state_rank, 2,
                         args=(str(tmp / "port"), SPEC), device="cpu",
                         threads=1)
    d = dict(SPEC, results_dir=str(tmp / "jax" / "results") + "/",
             dump_dir=str(tmp / "jax") + "/", parallel="domain", n_devices=2)
    jr = j_driver.Run3D(j_config.run3d_config_from_dict(d))
    jr.init_uniform_material()
    stats = jr.run_slice(0, JSourceList(*R.SPEC_SOURCES))
    return port, jr, stats, tmp


def test_run3d_domain_keeps_slabs_between_steps(domain_runs):
    port = domain_runs[0]
    for held, _, _, _ in port:
        # before and after each of the two steps, and after the slice
        assert held == [[M**3 // 2]] * 5


def test_run3d_domain_matches_jax(domain_runs):
    port, jr, stats, tmp = domain_runs
    _, whole, t_stats, budget = port[0]
    assert len(t_stats) == len(stats) == 2
    for t, j in zip(t_stats, stats):
        assert t[:2] == (j.n_iterations, j.conv_flag)
        assert t[3] == j.subbox_radius
        np.testing.assert_allclose(t[2], j.photon_loss, rtol=1e-9)
    for k, v in whole.items():
        np.testing.assert_allclose(v, np.asarray(getattr(jr.state, k)),
                                   rtol=1e-9, atol=1e-11, err_msg=k)
    np.testing.assert_allclose(budget, tuple(jr.last_budget), rtol=1e-9)
    # every rank gathered the same whole state
    for k, v in whole.items():
        np.testing.assert_array_equal(port[1][1][k], v)
    # rank 0 alone wrote, and its files are JAX's
    _same_outputs(str(tmp / "jax" / "results"), str(tmp / "port" / "results"))


# ---- the tau-table and "auto" routes in both parallel modes

@pytest.fixture(scope="module")
def route_ranks():
    return launch.launch(R.route_iterations_rank, 8, args=(KINDS, RADIUS),
                         device="cpu", threads=1)


def _jax_cfg(kind, engine="pyramid"):
    sed = JSED(bb=JBB(T_eff=1.0e5, S_star=1.0e49))
    if kind == "tau":
        tables, _, bands = j_tau_tables(sed, isothermal=True)
    else:
        tables, _, bands = j_tables(sed, isothermal=True, dtype=jnp.float64,
                                    n_nodes="auto")
    return JEvolveConfig(
        sweep=JSweepConfig(tables=tables, mesh=M, dr=14.0 * jconst.kpc / M,
                           isothermal=True, flux_scale=bands.flux_scale),
        chem=JChemConfig(cooling=None, isothermal=True,
                         isothermal_temperature=1.0e4),
        shells=j_shells(M), engine=engine)


def _mesh():
    return Mesh(np.array(jax.devices()[:8]), ("d",))


@pytest.mark.parametrize("kind", KINDS)
def test_domain_iteration_with_route_matches_jax(route_ranks, kind):
    port, conv, pl, ll = route_ranks[0][kind][0]
    cfg = _jax_cfg(kind)
    state = j_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0, 1.0e4)
    srcpos, nflux = R.random_sources(M, 5)
    sp, nf = jdom.group_sources_by_slab(srcpos, nflux, M, 8)
    it = jdom.make_domain_iteration(JParallelConfig(cfg=cfg, mesh=_mesh()),
                                    RADIUS)
    s8, conv8, pl8, ll8 = it(jdom.shard_state_slabs(j_begin(state), _mesh()),
                             jnp.asarray(sp), jnp.asarray(nf),
                             jnp.float64(R.DT))
    for k in ("h_av0", "h_av1", "he_av0", "he_av1", "h_int0", "h_int1",
              "he_int0", "he_int1", "he_int2", "t_av", "t_inter"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(s8, k)),
                                   rtol=1e-9, atol=1e-11, err_msg=k)
    np.testing.assert_allclose(port["he_av2"], np.asarray(s8.he_av2),
                               rtol=1e-7, atol=1e-14)
    np.testing.assert_allclose(pl, float(pl8), rtol=1e-11)
    assert conv == int(conv8)
    assert float(np.max(port["h_av1"])) > 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_source_iteration_with_route_matches_jax(route_ranks, kind):
    port, conv, pl, ll = route_ranks[0][kind][1]
    cfg = _jax_cfg(kind)
    state = j_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0, 1.0e4)
    srcpos, nflux = R.random_sources(M, 5)
    sp, nf = j_pad(srcpos, nflux, 8)
    it = j_parallel(JParallelConfig(cfg=cfg, mesh=_mesh()))
    s8, conv8, pl8, ll8 = it(j_begin(state), jnp.asarray(sp),
                             jnp.asarray(nf), jnp.float64(R.DT))
    for k in ("h_av1", "h_int1", "he_av1", "h_av0"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(s8, k)),
                                   rtol=1e-5, atol=1e-14, err_msg=k)
    assert conv == int(conv8)
    np.testing.assert_allclose(pl, float(pl8), rtol=1e-6)
