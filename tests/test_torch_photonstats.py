"""Photon budget: the port's photonstats against the JAX package's.

One heating timestep at 16^3 runs through the port; the states before and
after it go to both packages, which must report the same budget.  The
sums run over the same float64 cells in another order (XLA's and
PyTorch's reductions), so the entries agree to rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu import photonstats as j_ps
from c2ray_tpu.rates import rate_coefficients as j_rc
from c2ray_tpu.state import GridState as JGridState
from c2ray_tpu_torch import photonstats as t_ps
from c2ray_tpu_torch.cooling import setup_cooling_tables
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
from c2ray_tpu_torch.rates import rate_coefficients as t_rc
from c2ray_tpu_torch.state import initial_grid_state
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SweepConfig, evolve3d)

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

M = 16   # below 4000 cells evolve3d's convergence criterion is 0 cells


def _one_step():
    S_star = 1.0e49
    tables, sed, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=1.0e5, S_star=S_star)),
        isothermal=False, dtype=torch.float64)
    dr = 12.0 * const.kpc / M
    cfg = Evolve3DConfig(
        sweep=SweepConfig(tables=tables, mesh=M, dr=dr, isothermal=False,
                          flux_scale=bands.flux_scale),
        chem=ChemistryConfig(isothermal=False,
                             cooling=setup_cooling_tables(torch.float64)))
    rng = np.random.RandomState(2)
    before = initial_grid_state(1.0e-3 * 10.0 ** rng.uniform(-0.3, 0.3,
                                                             (M, M, M)),
                                0.0, 0.0, 0.0, 100.0)
    nflux = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
    dt = 2.0e6 * const.YEAR
    after, stats = evolve3d(cfg, before, torch.tensor([[M // 2] * 3]), nflux,
                            dt)
    total_src = float(nflux[:, 0].sum()) * sed.bb.S_star * dt
    return before, after, stats, dr**3, dt, total_src, bands.flux_scale


def _to_jax(state):
    return JGridState(*(jnp.asarray(t.numpy()) for t in state))


def test_photon_budget_of_one_step_matches_jax():
    before, after, stats, vol, dt, total_src, fs = _one_step()
    jb, ja = _to_jax(before), _to_jax(after)
    inv_t = t_ps.species_inventory(before, vol)
    inv_j = j_ps.species_inventory(jb, vol)
    np.testing.assert_allclose(np.array(inv_t), np.array(inv_j), rtol=1e-12)
    np.testing.assert_allclose(
        np.array(t_ps.species_inventory(after, vol, use_start=False)),
        np.array(j_ps.species_inventory(ja, vol, use_start=False)),
        rtol=1e-12)

    loss = dict(photon_loss=stats.photon_loss * fs,
                lls_loss=stats.lls_loss * fs)
    got = t_ps.photon_budget(inv_t, after, t_rc(after.t_av), vol, dt,
                             total_src, **loss)
    ref = j_ps.photon_budget(inv_j, ja, j_rc(ja.t_av), vol, dt, total_src,
                             **loss)
    for name in ref._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-12,
                                   err_msg=name)
    # the step ionized and the photons are accounted for
    assert got.total_ion > 0.0
    assert 0.5 < got.photon_conservation < 1.5
    assert t_ps.photcons_violation(got) == j_ps.photcons_violation(ref)


@pytest.mark.parametrize("photcons,loss,flag", [(1.0, 0.0, 0), (0.5, 0.0, 1),
                                                (0.5, 0.6, 0),
                                                (0.9, 0.0, 0)])
def test_photcons_violation_matches(photcons, loss, flag):
    fields = dict(total_ion=0.0, totrec=0.0, totcollisions=0.0,
                  recomions=0.0, total_src=1.0,
                  photon_conservation=photcons, total_photon_loss=loss)
    assert t_ps.photcons_violation(t_ps.PhotonBudget(**fields)) == flag
    assert j_ps.photcons_violation(j_ps.PhotonBudget(**fields)) == flag
