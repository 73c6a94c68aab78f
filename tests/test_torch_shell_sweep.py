"""L1-shell engine: the port's table, cinterp and plain sweep against the
JAX package.

Random fields at 16^3 (full periodic extents), 17^3 (odd: the shell
engine's own case) and 16^3 under a radius-5 table, 3 sources (one on a
grid edge), float64.  The plain version evaluates JAX's arithmetic per
cell, so rates and losses agree to rtol 1e-10 with 1e-10 of each part's
largest value as the absolute floor (the tolerance of the JAX package's
own pyramid-vs-octant test); the heat is checked on its own scale.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.radiation import BlackBodySED, SEDConfig
from c2ray_tpu.radiation.quadrature import build_quadrature_tables
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_table
from c2ray_tpu.sweep import cinterp_shell as j_cinterp
from c2ray_tpu.sweep import sweep_sources_accumulate as j_accumulate
from c2ray_tpu.sweep.source_sweep import SourceFields as JFields
from c2ray_tpu.sweep.source_sweep import sweep_one_source as j_one_source
from c2ray_tpu.sweep.source_sweep import zero_rate_grids as j_zero
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.sweep import (build_shell_table, cinterp_shell,
                                   source_sweep, sweep_sources_accumulate)
from c2ray_tpu_torch.sweep.source_sweep import SourceFields as TFields
from c2ray_tpu_torch.sweep.source_sweep import SweepConfig as TSweepConfig
from c2ray_tpu_torch.utils.clocks import counter

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

RTOL = 1e-10
RATES = ("phih", "phihe0", "phihe1", "phiheat", "photon_loss", "lls_loss")
CASES = {"even": (16, None), "odd": (17, None), "subbox": (16, 5)}


def _case(M, isothermal=True, lls=0.0, S=3, seed=5):
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48)),
        isothermal=isothermal, dtype=jnp.float64)
    kw = dict(mesh=M, dr=10.0 * const.kpc / M, isothermal=isothermal,
              flux_scale=bands.flux_scale, coldensh_LLS=lls)
    jcfg = JSweepConfig(tables=tables, **kw)
    tcfg = TSweepConfig(tables=convert.quad_tables_from_numpy(tables), **kw)
    rng = np.random.RandomState(seed)
    n = M**3
    fields = dict(ndens=10.0 ** rng.uniform(-4, -2, n),
                  h_av0=rng.uniform(0.2, 1.0, n),
                  h_av1=rng.uniform(0.0, 0.8, n),
                  he_av0=rng.uniform(0.2, 1.0, n),
                  he_av1=rng.uniform(0.0, 0.5, n))
    srcpos = rng.randint(0, M, size=(S, 3))
    srcpos[0] = (0, M - 1, 5)
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (S, 1)),
                            np.zeros((S, 2))], axis=1)
    return jcfg, tcfg, fields, srcpos, nflux


def _jfields(fields):
    return JFields(**{k: jnp.asarray(v) for k, v in fields.items()})


def _tfields(fields):
    return TFields(**{k: torch.as_tensor(v) for k, v in fields.items()})


def _check(got, ref, rtol=RTOL):
    got = convert.rate_grids_to_numpy(got)
    for name in RATES:
        a = getattr(got, name)
        b = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shell_table_matches_jax(case):
    M, radius = CASES[case]
    got, ref = build_shell_table(M, radius), j_table(M, radius)
    assert (got.lo, got.hi) == (ref.lo, ref.hi)
    np.testing.assert_array_equal(got.offsets, ref.offsets)
    np.testing.assert_array_equal(got.mask, ref.mask)
    np.testing.assert_array_equal(got.boundary, ref.boundary)
    assert (got.n_shells, got.width, got.n_cells) == (ref.n_shells, ref.width,
                                                      ref.n_cells)
    # the compact form: the live cells in order, shell by shell
    np.testing.assert_array_equal(got.cells, ref.offsets[ref.mask])
    np.testing.assert_array_equal(np.diff(got.starts), ref.mask.sum(axis=1))
    p = got.packed.astype(np.int64)
    unpacked = np.stack([(p >> (10 * i) & 1023) - 512 for i in range(3)],
                        axis=1)
    np.testing.assert_array_equal(unpacked, got.cells)
    np.testing.assert_array_equal((p >> 30) & 1, ref.boundary[ref.mask])


def test_cinterp_shell_matches_jax():
    """Random columns at 17^3 (odd: the wrap in absolute coordinates):
    the first shells (the diagonal boost), a middle one and the corner
    shell, one source and then three at once."""
    M = 17
    rng = np.random.RandomState(2)
    table = build_shell_table(M)
    srcpos = np.array([[0, 16, 5], [8, 8, 8], [3, 12, 16]])
    cd = 10.0 ** rng.uniform(15.0, 21.0, (3, M**3, 3))
    for k in (0, 1, 2, table.n_shells // 2, table.n_shells - 1):
        offs = table.cells[table.starts[k]:table.starts[k + 1]]
        refs = [j_cinterp(jnp.asarray(offs), jnp.asarray(sp, jnp.int32), M,
                          jnp.asarray(c)) for sp, c in zip(srcpos, cd)]
        got, path = cinterp_shell(torch.as_tensor(offs),
                                  torch.as_tensor(srcpos[1]), M,
                                  torch.as_tensor(cd[1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(refs[1][0]),
                                   rtol=1e-13)
        np.testing.assert_allclose(path.numpy(), np.asarray(refs[1][1]),
                                   rtol=1e-15)
        batched, _ = cinterp_shell(torch.as_tensor(offs),
                                   torch.as_tensor(srcpos), M,
                                   torch.as_tensor(cd))
        for s, ref in enumerate(refs):
            np.testing.assert_allclose(batched[s].numpy(), np.asarray(ref[0]),
                                       rtol=1e-13)


@pytest.mark.parametrize("lls", [0.0, 1.0e15])
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_sources_accumulate_matches_jax(case, heating, lls):
    M, radius = CASES[case]
    jcfg, tcfg, fields, srcpos, nflux = _case(M, not heating, lls)
    ref = j_accumulate(jcfg, j_table(M, radius), _jfields(fields),
                       jnp.asarray(srcpos, jnp.int32), jnp.asarray(nflux))
    counts = lambda: (counter("launches.shell_sweep"),
                      counter("launches.shell_sweep.heat"))
    before = counts()
    got = sweep_sources_accumulate(tcfg, build_shell_table(M, radius),
                                   _tfields(fields), torch.as_tensor(srcpos),
                                   torch.as_tensor(nflux))
    assert counts() == before, \
        "CPU tensors take the plain version"
    _check(got, ref)
    assert float(got.photon_loss) > 0.0
    assert (float(got.lls_loss) > 0.0) == (lls > 0.0)
    assert (float(got.phiheat.abs().max()) > 0.0) == heating


def test_sweep_one_source_matches_jax():
    jcfg, tcfg, fields, srcpos, nflux = _case(17, True, 1.0e15)
    rng = np.random.RandomState(4)
    rates_in = [rng.uniform(0.0, 1e-12, 17**3) for _ in range(4)]
    j_in = j_zero(17, jnp.float64)._replace(
        **{k: jnp.asarray(v) for k, v in zip(RATES, rates_in)})
    ref = j_one_source(jcfg, j_table(17), _jfields(fields),
                       jnp.asarray(srcpos[0], jnp.int32),
                       jnp.asarray(nflux[0]), j_in)
    t_in = source_sweep.zero_rate_grids(17, torch.float64)._replace(
        **{k: torch.as_tensor(v) for k, v in zip(RATES, rates_in)})
    got = source_sweep.sweep_one_source(tcfg, build_shell_table(17),
                                        _tfields(fields),
                                        torch.as_tensor(srcpos[0]),
                                        torch.as_tensor(nflux[0]), t_in)
    _check(got, ref)


def test_dead_and_absent_sources_contribute_nothing():
    _, tcfg, fields, srcpos, nflux = _case(17)
    table = build_shell_table(17)
    tf = _tfields(fields)
    dead = nflux.copy()
    dead[1] = 0.0
    both = sweep_sources_accumulate(tcfg, table, tf, torch.as_tensor(srcpos),
                                    torch.as_tensor(dead))
    keep = [0, 2]
    alone = sweep_sources_accumulate(tcfg, table, tf,
                                     torch.as_tensor(srcpos[keep]),
                                     torch.as_tensor(nflux[keep]))
    for a, b in zip(both, alone):
        torch.testing.assert_close(a, b, rtol=1e-14, atol=0.0)
    empty = sweep_sources_accumulate(tcfg, table, tf,
                                     torch.as_tensor(srcpos[:0]),
                                     torch.as_tensor(nflux[:0]))
    assert empty.phih.shape == (17**3,)
    assert all(float(t.abs().max()) == 0.0
               for t in empty if t is not None)


def test_grouped_matches_ungrouped():
    """Groups of 2 (batch_size, and SweepConfig.source_batch) against
    one group of 5: the same sums in another order."""
    _, tcfg, fields, srcpos, nflux = _case(16, False, 1.0e15, S=5)
    table = build_shell_table(16, 5)
    args = (table, _tfields(fields), torch.as_tensor(srcpos),
            torch.as_tensor(nflux))
    one = sweep_sources_accumulate(tcfg, *args)
    for grouped in (sweep_sources_accumulate(tcfg, *args, batch_size=2),
                    sweep_sources_accumulate(replace(tcfg, source_batch=2),
                                             *args)):
        for a, b, w in zip(grouped, one, one._fields):
            if b is None:
                continue
            torch.testing.assert_close(a, b, rtol=1e-12,
                                       atol=1e-12 * float(b.abs().max()),
                                       msg=w)

