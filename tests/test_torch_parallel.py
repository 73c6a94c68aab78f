"""The port's source-parallel iteration against the JAX package, float64
on the CPU.

`make_parallel_iteration` in 8 gloo ranks (`c2ray_tpu_torch.parallel
.launch`, bodies in `torch_parallel_ranks.py`) against JAX's on the 8
host devices of tests/conftest.py, at 16^3 with 5 random sources, on
the pyramid engine and on the shell engine (a max_subbox table): the
tolerances of tests/test_parallel.py (rtol 1e-5: the all-reduce sums in
another order than JAX's psum, and the chemistry's 1% fixed point
amplifies it), conv_flag equal.  Also `pad_sources`, `Run3D`'s
refusal to run a parallel mode without a process group, and the source
shuffle's seed shared by the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as R
from c2ray_tpu import constants as jconst
from c2ray_tpu.parallel import ParallelConfig as JParallelConfig
from c2ray_tpu.parallel import make_parallel_iteration as j_parallel
from c2ray_tpu.parallel import pad_sources as j_pad
from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation.quadrature import \
    build_quadrature_tables as j_tables
from c2ray_tpu.state import begin_timestep as j_begin
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_shells
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu_torch.parallel import launch, pad_sources

torch.set_num_threads(1)

CASES = ({"engine": "pyramid"}, {"engine": "shells", "max_subbox": 5})


@pytest.fixture(scope="module")
def ranks8():
    return launch.launch(R.parallel_iterations_rank, 8, args=(CASES,),
                         device="cpu", threads=1)


def _jax_iteration(engine="pyramid", max_subbox=None, M=16, n_src=5):
    tables, _, bands = j_tables(JSED(bb=JBB(T_eff=1.0e5, S_star=1.0e49)),
                                isothermal=True, dtype=jnp.float64)
    cfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, mesh=M, dr=14.0 * jconst.kpc / M,
                           isothermal=True, flux_scale=bands.flux_scale),
        chem=JChemConfig(cooling=None, isothermal=True,
                         isothermal_temperature=1.0e4),
        shells=j_shells(M, max_subbox), engine=engine)
    state = j_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0, 1.0e4)
    srcpos, nflux = R.random_sources(M, n_src)
    sp, nf = j_pad(srcpos, nflux, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    it = j_parallel(JParallelConfig(cfg=cfg, mesh=mesh))
    return it(j_begin(state), jnp.asarray(sp), jnp.asarray(nf),
              jnp.float64(R.DT))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_parallel_iteration_matches_jax(ranks8, case):
    port, conv, pl, ll = ranks8[0][case]
    s8, conv8, pl8, ll8 = _jax_iteration(**CASES[case])
    for k in ("h_av1", "h_int1", "he_av1", "h_av0"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(s8, k)),
                                   rtol=1e-5, atol=1e-14, err_msg=k)
    assert conv == int(conv8)
    np.testing.assert_allclose(pl, float(pl8), rtol=1e-6)
    np.testing.assert_allclose(ll, float(ll8), rtol=1e-6)
    # every rank holds the same gathered state
    for r in ranks8[1:]:
        for k, v in port.items():
            np.testing.assert_array_equal(r[case][0][k], v)


@pytest.mark.parametrize("n,D", [(5, 8), (8, 8), (3, 2), (0, 4)])
def test_pad_sources_equals_jax(n, D):
    srcpos, nflux = R.random_sources(16, n, seed=n)
    got = pad_sources(srcpos, nflux, D)
    want = j_pad(srcpos, nflux, D)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape[0] % D == 0


@pytest.mark.parametrize("mode", ["source", "domain"])
def test_run3d_parallel_needs_a_process_group(mode, tmp_path):
    from c2ray_tpu_torch.driver import Run3D, Run3DConfig
    from c2ray_tpu_torch.io.writers import OutputStreams
    from c2ray_tpu_torch.nbody import test_nbody
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig

    cfg = Run3DConfig(mesh=8, nbody=test_nbody(),
                      sed=SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e50)),
                      results_dir=str(tmp_path), dump_dir=str(tmp_path),
                      streams=OutputStreams(), parallel=mode, n_devices=2,
                      device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        Run3D(cfg)
    cfg.parallel = "replicated"
    with pytest.raises(ValueError, match="parallel="):
        Run3D(cfg)


def test_ranks_share_the_source_shuffle_seed():
    """Run3D's randomize_sources under a process group: every rank
    shuffles with rank 0's seed, so the source-parallel blocks and the
    domain groups come from one list."""
    seeds = launch.launch(R.shared_seed_rank, 2, device="cpu", threads=1)
    assert seeds[0] == seeds[1]
