"""The 1D <-> 3D cross-check on the port, against the JAX package.

The problem of tests/test_1d3d_crosscheck.py (the reference's
`test_against3D` idea, files_for_1D/inputs/test_against3D~): uniform
density 1e-3, one 1e5 K blackbody of 2e48 photons/s, isothermal, 1 kpc
cells, 6 x 10 Myr, run through the port's spherically-symmetric 1D
program (`OneDRun`, 4M shells out to M dr) and its 3D timestep
(`evolve3d`, one source at the centre of an M^3 grid), float64 on the
CPU (the plain versions).  The port's two programs meet the JAX test's
criteria: the 3D front from the ionized volume within one cell of the
1D front, and the on-axis 3D ionized fraction within 0.15 of the 1D
profile at 2, 4 and 6 cells.  Both fronts equal the JAX package's on
the same inputs within rtol 1e-10, and so do the final 3D h1 and 1D
ionized fraction, with a 1e-12 absolute floor.

M = 24 as in the JAX test: below 4000 cells (M <= 15) the convergence
criterion min(int(2.5e-4 M^3), n_src) is 0 and evolve3d runs to its
iteration cap in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.grid import RadialGrid as JGrid
from c2ray_tpu.onedim import OneDProblem as JProblem
from c2ray_tpu.onedim import numerical_front as j_front
from c2ray_tpu.onedim.driver import OneDRun as JRun
from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation.quadrature import build_quadrature_tables as j_tables
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_shells
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.evolve3d import evolve3d as j_evolve3d
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu_torch.grid import RadialGrid
from c2ray_tpu_torch.onedim import OneDProblem, numerical_front
from c2ray_tpu_torch.onedim.driver import OneDRun
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
from c2ray_tpu_torch.state import initial_grid_state
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SweepConfig, build_shell_table, evolve3d)

torch.set_num_threads(1)

M = 24
DENS = 1.0e-3
S_STAR = 2.0e48
T_EFF = 1.0e5
DR = 1.0 * const.kpc          # the same cell size in both programs
N_STEPS, DT = 6, 1.0e7 * const.YEAR
PROFILE_CELLS = (2, 4, 6)


def _front_3d(h1):
    """The front radius of the ionized volume (direction-averaged)."""
    return (3.0 * h1.sum() * DR**3 / (4.0 * np.pi)) ** (1.0 / 3.0)


def _result(x, xh1, h1):
    """{front_1d, front_3d, the 1D shell centres and ionized fraction,
    the 3D h1 cube} of one package's two runs."""
    x, xh1 = np.asarray(x), np.asarray(xh1)
    h1 = np.asarray(h1, dtype=np.float64).reshape(M, M, M)
    return {"front_1d": j_front(x, x[1] - x[0], xh1), "x": x, "xh1": xh1,
            "front_3d": _front_3d(h1), "h1": h1}


@pytest.fixture(scope="module")
def port():
    sed = SEDConfig(bb=BlackBodySED(T_eff=T_EFF, S_star=S_STAR))
    problem = OneDProblem(testnum=1, dens_val=DENS, temper_val=1e4,
                          isothermal=True)
    rgrid = RadialGrid(r_in=0.0, r_out=M * DR, mesh=4 * M)
    run1d = OneDRun.setup(problem, rgrid, sed, device="cpu")
    for _ in range(N_STEPS):
        run1d.step(DT)
    xh1 = run1d.state.xh[:, 1].numpy()

    tables, _, bands = build_quadrature_tables(sed, isothermal=True,
                                               dtype=torch.float64)
    cfg = Evolve3DConfig(
        sweep=SweepConfig(tables=tables, mesh=M, dr=DR, isothermal=True,
                          flux_scale=bands.flux_scale),
        chem=ChemistryConfig(isothermal=True, isothermal_temperature=1.0e4),
        shells=build_shell_table(M))
    state = initial_grid_state(np.full((M,) * 3, DENS), 0.0, 0.0, 0.0,
                               1.0e4)
    srcpos = torch.tensor([[M // 2, M // 2, M // 2]])
    nflux = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
    for _ in range(N_STEPS):
        state, _ = evolve3d(cfg, state, srcpos, nflux, DT)
    out = _result(rgrid.x, xh1, state.h1.numpy())
    # the port's own front function gives the JAX one's value
    assert numerical_front(rgrid.x, rgrid.dr, xh1) == out["front_1d"]
    return out


@pytest.fixture(scope="module")
def jax_run():
    """tests/test_1d3d_crosscheck.py's two runs, their results kept."""
    sed = JSED(bb=JBB(T_eff=T_EFF, S_star=S_STAR))
    problem = JProblem(testnum=1, dens_val=DENS, temper_val=1e4,
                       isothermal=True)
    rgrid = JGrid(r_in=0.0, r_out=M * DR, mesh=4 * M)
    run1d = JRun.setup(problem, rgrid, sed)
    for _ in range(N_STEPS):
        run1d.step(DT)

    tables, _, bands = j_tables(sed, isothermal=True, dtype=jnp.float64)
    cfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, mesh=M, dr=DR, isothermal=True,
                           flux_scale=bands.flux_scale),
        chem=JChemConfig(cooling=None, isothermal=True,
                         isothermal_temperature=1.0e4),
        shells=j_shells(M))
    state = j_state(np.full((M,) * 3, DENS), 0.0, 0.0, 0.0, 1.0e4)
    srcpos = jnp.asarray([[M // 2, M // 2, M // 2]], dtype=jnp.int32)
    nflux = jnp.asarray([[1.0, 0.0, 0.0]])
    cache = {}
    for _ in range(N_STEPS):
        state, _ = j_evolve3d(cfg, state, srcpos, nflux, DT,
                              iteration_cache=cache)
    return _result(rgrid.x, run1d.state.xh[:, 1], state.h1)


def test_port_fronts_within_a_cell(port):
    assert abs(port["front_3d"] - port["front_1d"]) < 1.0 * DR, (
        port["front_1d"] / const.kpc, port["front_3d"] / const.kpc)


@pytest.mark.parametrize("k", PROFILE_CELLS)
def test_port_profiles_agree(port, k):
    # the on-axis 3D ionized fraction against the 1D shell nearest k dr
    prof_3d = port["h1"][M // 2, M // 2, M // 2:]
    i1 = int(np.argmin(np.abs(port["x"] - k * DR)))
    assert abs(prof_3d[k] - port["xh1"][i1]) < 0.15, (
        k, prof_3d[k], port["xh1"][i1])


def test_port_fronts_equal_jax(port, jax_run):
    for key in ("front_1d", "front_3d"):
        np.testing.assert_allclose(port[key], jax_run[key], rtol=1e-10,
                                   err_msg=key)


def test_port_h1_equals_jax(port, jax_run):
    # a 1e-12 absolute floor, as in tests/test_torch_onedim.py: the
    # neutral cells' fractions (~1e-7 here) carry the last bits of 1 - h0
    # (~1e-16 absolute), which differ by summation order
    np.testing.assert_allclose(port["h1"], jax_run["h1"], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(port["xh1"], jax_run["xh1"], rtol=1e-10,
                               atol=1e-12)
