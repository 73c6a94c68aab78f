"""One `evolve3d` timestep on the 3D tau-table route: the port against
the JAX package, float64 on the CPU.

On every engine (pyramid and octant at 16^3, the shell engine at 17^3),
isothermal (dt 1e14 s) and heating (dt 3e13 s), from the seeded grid of
test_torch_tau3d.py: iterations, conv_flag and subbox radius equal, the
photon loss to rtol 1e-9, every field to rtol 1e-9 with a 5e-11 floor
(test_torch_tau3d.py says why the floor is above the quadrature route's
1e-11).  The subbox ladder's escape test divides the loss by the batch's
strength, which for tau tables is JAX's summed NormFlux.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.sweep.evolve3d import evolve3d as j_evolve3d
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.sweep import evolve3d
from test_torch_tau3d import tau_setup

torch.set_num_threads(1)


@pytest.mark.parametrize("engine,M,isothermal", [
    ("pyramid", 16, True), ("pyramid", 16, False),
    ("octant", 16, True), ("octant", 16, False),
    ("shells", 17, True), ("shells", 17, False)])
def test_evolve3d_with_tau_tables_matches_jax(engine, M, isothermal):
    jcfg, tcfg, js, srcpos, nflux = tau_setup(M, engine, isothermal)
    dt = 1.0e14 if isothermal else 3.0e13
    j_new, j_stats = j_evolve3d(jcfg, js, jnp.asarray(srcpos, jnp.int32),
                                jnp.asarray(nflux), dt)
    t_new, t_stats = evolve3d(tcfg, convert.grid_state_from_numpy(js),
                              torch.as_tensor(srcpos),
                              torch.as_tensor(nflux), dt)
    assert t_stats.n_iterations == j_stats.n_iterations >= 2
    assert t_stats.conv_flag == j_stats.conv_flag
    assert t_stats.subbox_radius == j_stats.subbox_radius
    np.testing.assert_allclose(t_stats.photon_loss, j_stats.photon_loss,
                               rtol=1e-9)
    for name in t_new._fields:
        np.testing.assert_allclose(getattr(t_new, name).numpy(),
                                   np.asarray(getattr(j_new, name)),
                                   rtol=1e-9, atol=5e-11, err_msg=name)
    assert float(t_new.h1.max()) > 0.1
