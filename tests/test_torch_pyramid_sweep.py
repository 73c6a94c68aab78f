"""Pyramid sweep: the port's plain version against the JAX package.

16^3 random fields, 3 sources (one on a grid edge), float64.  The
plain version reads the same corners and evaluates the same arithmetic
as JAX's plane-window scan, so rates and losses agree to rtol 1e-10
with an absolute floor of 1e-10 of the largest value (the tolerance of
the JAX package's own pyramid-vs-octant test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.radiation import BlackBodySED, SEDConfig
from c2ray_tpu.radiation.quadrature import build_quadrature_tables
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep.pyramid_sweep import \
    sweep_pyramid_source_batch as j_sweep
from c2ray_tpu.sweep.source_sweep import SourceFields as JFields
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.sweep import pyramid_sweep as tps
from c2ray_tpu_torch.sweep.source_sweep import SourceFields as TFields
from c2ray_tpu_torch.sweep.source_sweep import SweepConfig as TSweepConfig
from c2ray_tpu_torch.utils.clocks import counter

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

M = 16
RTOL = 1e-10


def _case(isothermal, lls):
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48)),
        isothermal=isothermal, dtype=jnp.float64)
    kw = dict(mesh=M, dr=10.0 * const.kpc / M, isothermal=isothermal,
              flux_scale=bands.flux_scale, coldensh_LLS=lls)
    jcfg = JSweepConfig(tables=tables, **kw)
    tcfg = TSweepConfig(tables=convert.quad_tables_from_numpy(tables), **kw)
    rng = np.random.RandomState(5)
    n = M**3
    fields = dict(ndens=10.0 ** rng.uniform(-4, -2, n),
                  h_av0=rng.uniform(0.2, 1.0, n),
                  h_av1=rng.uniform(0.0, 0.8, n),
                  he_av0=rng.uniform(0.2, 1.0, n),
                  he_av1=rng.uniform(0.0, 0.5, n))
    srcpos = rng.randint(0, M, size=(3, 3))
    srcpos[0] = (0, M - 1, 5)
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (3, 1)),
                            np.zeros((3, 2))], axis=1)
    return jcfg, tcfg, fields, srcpos, nflux


def _check(got, ref):
    got = convert.rate_grids_to_numpy(got)
    for name in ("phih", "phihe0", "phihe1", "phiheat", "photon_loss",
                 "lls_loss"):
        a = getattr(got, name)
        b = np.asarray(getattr(ref, name))
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("radius", [None, 4])
@pytest.mark.parametrize("lls", [0.0, 1.0e15])
def test_sweep_matches_jax(radius, lls):
    jcfg, tcfg, fields, srcpos, nflux = _case(True, lls)
    ref = j_sweep(jcfg, JFields(**{k: jnp.asarray(v)
                                   for k, v in fields.items()}),
                  jnp.asarray(srcpos, jnp.int32), jnp.asarray(nflux),
                  radius=radius)
    before = counter("launches.pyramid_sweep")
    got = tps.sweep_pyramid_source_batch(
        tcfg, TFields(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        torch.as_tensor(srcpos), torch.as_tensor(nflux), radius=radius)
    assert counter("launches.pyramid_sweep") == before, \
        "CPU tensors take the plain version"
    _check(got, ref)
    assert float(got.photon_loss) > 0.0
    assert (float(got.lls_loss) > 0.0) == (lls > 0.0)


def test_heating_sweep_matches_jax():
    """The plain version carries the heating branch too."""
    jcfg, tcfg, fields, srcpos, nflux = _case(False, 0.0)
    ref = j_sweep(jcfg, JFields(**{k: jnp.asarray(v)
                                   for k, v in fields.items()}),
                  jnp.asarray(srcpos, jnp.int32), jnp.asarray(nflux))
    got = tps.sweep_pyramid_source_batch(
        tcfg, TFields(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        torch.as_tensor(srcpos), torch.as_tensor(nflux))
    assert float(np.abs(np.asarray(ref.phiheat)).max()) > 0.0
    _check(got, ref)


def test_dead_sources_contribute_nothing():
    _, tcfg, fields, srcpos, nflux = _case(True, 0.0)
    tf = TFields(**{k: torch.as_tensor(v) for k, v in fields.items()})
    nflux_dead = nflux.copy()
    nflux_dead[1] = 0.0
    both = tps.sweep_pyramid_source_batch(
        tcfg, tf, torch.as_tensor(srcpos), torch.as_tensor(nflux_dead))
    keep = [0, 2]
    alone = tps.sweep_pyramid_source_batch(
        tcfg, tf, torch.as_tensor(srcpos[keep]),
        torch.as_tensor(nflux[keep]))
    for a, b in zip(both, alone):
        torch.testing.assert_close(a, b, rtol=1e-14, atol=0.0)
