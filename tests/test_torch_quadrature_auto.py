"""The "auto" quadrature and the small functions of rates.py and
chemistry.py: the port against the JAX package, float64 on the CPU.

- `build_quadrature_tables(n_nodes="auto")`: the blocks (band ranges and
  node counts) equal JAX's, and their arrays to rtol 1e-12, for a
  blackbody, a power law and a QSO spectrum, isothermal and heating;
  the bench's 5e4 K blackbody gives 1 band at K = 12, 26 at K = 3 and 6
  at K = 6;
- `photoion_rates_quad` over the blocks equals JAX's to rtol 1e-10 and
  meets tests/test_quadrature_pin.py's criteria against the fixed 8-node
  and the dense 32-node rules;
- the kernels' block layout (`packed_band_blocks`, the sweep's block
  route) and the 1D kernel's refusal of blocks of several K;
- one `evolve3d` timestep with auto tables on the pyramid engine at
  16^3 against JAX (tests/test_torch_evolve3d.py's tolerances);
- `rates.constant_rate_coefficients`, `chemistry.ion_fractions` and
  `coldens_bndry_HI/HeI/HeII` equal JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import chemistry as j_chem
from c2ray_tpu import constants as const
from c2ray_tpu import rates as j_rates
from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import PowerLawSED as JPL
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation.quadrature import \
    build_quadrature_tables as j_tables
from c2ray_tpu.radiation.quadrature import \
    photoion_rates_quad as j_rates_quad
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_shells
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.evolve3d import \
    _scaled_source_strength as j_strength
from c2ray_tpu.sweep.evolve3d import evolve3d as j_evolve3d
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu_torch import chemistry, convert, rates
from c2ray_tpu_torch.radiation import (BlackBodySED, PowerLawSED,
                                       SEDConfig)
from c2ray_tpu_torch.radiation.quadrature import (AUTO_NODE_TOL,
                                                  SourceQuad,
                                                  build_quadrature_tables,
                                                  packed_band_blocks,
                                                  photoion_rates_quad,
                                                  source_blocks)
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SweepConfig, build_shell_table, evolve3d)
from c2ray_tpu_torch.sweep.evolve3d import _scaled_source_strength
from c2ray_tpu_torch.sweep.source_sweep import (ROUTE_BLOCKS,
                                                _kernel_tables)

torch.set_num_threads(1)

# tests/test_quadrature_pin.py's spectra
J_SED_ALL = JSED(bb=JBB(T_eff=5.0e4, S_star=1.0e48),
                 pl=JPL(index=2.5, S_star=3.0e46),
                 qso=JPL(index=1.8, S_star=1.0e46))
SED_ALL = SEDConfig(bb=BlackBodySED(T_eff=5.0e4, S_star=1.0e48),
                    pl=PowerLawSED(index=2.5, S_star=3.0e46),
                    qso=PowerLawSED(index=1.8, S_star=1.0e46))


@pytest.mark.parametrize("isothermal", [True, False])
def test_auto_blocks_equal_jax(isothermal):
    jt, _, jb = j_tables(J_SED_ALL, isothermal=isothermal, n_nodes="auto",
                         dtype=jnp.float64)
    tt, _, tb = build_quadrature_tables(SED_ALL, isothermal=isothermal,
                                        n_nodes="auto", dtype=torch.float64)
    assert tb.flux_scale == jb.flux_scale
    for name in ("bb", "pl", "qso"):
        jblocks, tblocks = getattr(jt, name), getattr(tt, name)
        assert isinstance(tblocks, tuple) and len(tblocks) == len(jblocks)
        for j, t in zip(jblocks, tblocks):
            assert (t.band_lo, t.band_hi) == (j.band_lo, j.band_hi)
            for f in SourceQuad._fields[2:]:
                a, b = getattr(t, f), getattr(j, f)
                assert (a is None) == (b is None) == (isothermal and
                                                      f.startswith("A_heat"))
                if a is not None:
                    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                               rtol=1e-12, err_msg=f)


def test_auto_blocks_of_the_bench_blackbody():
    """bench.py's 5e4 K blackbody: 1 band at K = 12, 26 at K = 3, 6 at
    K = 6 (126 node terms a cell against the 6-node rule's 33 x 6 =
    198)."""
    for iso in (True, False):
        tt, _, _ = build_quadrature_tables(
            SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=3e51)),
            isothermal=iso, n_nodes="auto", dtype=torch.float32)
        shape = [(b.band_lo, b.band_hi, b.sigma_hat.shape[1])
                 for b in tt.bb]
        assert shape == [(0, 0, 12), (1, 26, 3), (27, 32, 6)]
        # node terms a cell (one exponential each of tau_in, tau_out)
        assert sum(b.sigma_hat.numel() for b in tt.bb) == 126
    assert AUTO_NODE_TOL == 1e-6


def _columns(n=40):
    """tests/test_quadrature_pin.py:_columns."""
    cd_in = np.logspace(10.0, 24.5, n)
    dcol = 0.03 * cd_in + 1.0e10
    return (cd_in, cd_in + dcol, 0.08 * cd_in, 0.08 * (cd_in + dcol),
            0.008 * cd_in, 0.008 * (cd_in + dcol), np.zeros(n))


def _port_rates(qt, cols, heating):
    ci, co, hi_, ho, hhi, hho, z = (torch.as_tensor(c) for c in cols)
    one = torch.ones_like(ci)
    return photoion_rates_quad(qt, ci, co, hi_, ho, hhi, hho, one, z + 0.5,
                               nflux_bb=one, nflux_pl=one, nflux_qso=one,
                               do_heating=heating)


FIELDS = ("photo_cell_HI", "photo_cell_HeI", "photo_cell_HeII", "photo_in",
          "photo_out", "heat")


@pytest.mark.parametrize("isothermal", [True, False])
def test_auto_rates_match_jax_and_the_pin(isothermal):
    heating = not isothermal
    cols = _columns()
    jt, _, _ = j_tables(J_SED_ALL, isothermal=isothermal, n_nodes="auto",
                        flux_scale=1.0, dtype=jnp.float64)
    tt, _, _ = build_quadrature_tables(SED_ALL, isothermal=isothermal,
                                       n_nodes="auto", flux_scale=1.0,
                                       dtype=torch.float64)
    one = jnp.ones(cols[0].shape[0])
    j = j_rates_quad(jt, *(jnp.asarray(c) for c in cols[:6]), one,
                     jnp.asarray(cols[6]) + 0.5, nflux_bb=one, nflux_pl=one,
                     nflux_qso=one, do_heating=heating)
    t = _port_rates(tt, cols, heating)
    for name in FIELDS:
        b = np.asarray(getattr(j, name))
        np.testing.assert_allclose(getattr(t, name).numpy(), b, rtol=1e-10,
                                   atol=1e-14 * np.abs(b).max(),
                                   err_msg=name)
    # test_quadrature_pin.py's criteria, on the port's rates
    t8, _, _ = build_quadrature_tables(SED_ALL, isothermal=isothermal,
                                       n_nodes=8, flux_scale=1.0,
                                       dtype=torch.float64)
    r8 = _port_rates(t8, cols, heating)
    for name in FIELDS[:5] + (("heat",) if heating else ()):
        a = getattr(t, name).numpy()
        b = getattr(r8, name).numpy()
        scale = np.abs(b).max()
        mask = np.abs(b) > 1e-10 * scale
        assert (np.abs(a - b)[mask] / np.abs(b)[mask]).max() < 2e-5, name
    if heating:
        t32, _, _ = build_quadrature_tables(SED_ALL, isothermal=False,
                                            n_nodes=32, flux_scale=1.0,
                                            dtype=torch.float64)
        a = t.heat.numpy()
        b = _port_rates(t32, cols, True).heat.numpy()
        mask = np.abs(b) > 1e-10 * np.abs(b).max()
        assert (np.abs(a - b)[mask] / np.abs(b)[mask]).max() < 5e-5


def test_block_layout_of_the_kernels():
    """packed_band_blocks: per block (column, first band, bands, K,
    first row), the rows of each block at its K; the sweep's kernel
    tables take the block route; the 1D kernel refuses several K."""
    tt, _, bands = build_quadrature_tables(SED_ALL, isothermal=False,
                                           n_nodes="auto",
                                           dtype=torch.float64)
    flat, blocks = packed_band_blocks(tt, torch.float64, True, True, True,
                                      True)
    off = 0
    for (col, lo, nb, K, row0), (sq, want_col) in zip(
            blocks, [(b, c) for c, q in enumerate((tt.bb, tt.pl, tt.qso))
                     for b in source_blocks(q)]):
        assert (col, lo, nb, K, row0) == (want_col, sq.band_lo,
                                          sq.band_hi - sq.band_lo + 1,
                                          sq.sigma_hat.shape[1], off)
        rows = flat[off:off + nb * (17 + 5 * K)].reshape(nb, -1)
        assert torch.equal(rows[:, 5:5 + K], sq.sigma_hat)
        assert torch.equal(rows[:, 5 + K:5 + 2 * K], sq.A_photo)
        assert torch.equal(rows[:, 5 + 4 * K:5 + 5 * K], sq.A_heat_HeII)
        assert torch.equal(rows[:, 0], tt.sigma_HI[lo:lo + nb])
        off += rows.numel()
    assert off == flat.numel()
    cfg = SweepConfig(tables=tt, mesh=8, dr=1e21, isothermal=False,
                      flux_scale=bands.flux_scale, has_pl=True, has_qso=True)
    kt = _kernel_tables(cfg, torch.float32)
    assert kt.K == ROUTE_BLOCKS and kt.types == blocks and kt.heat
    assert kt.packed.dtype == torch.float32 and kt.packed.numel() == off
    with pytest.raises(ValueError, match="fixed"):
        _kernel_tables(cfg, torch.float32, track=True)

    from c2ray_tpu_torch.onedim import evolve as onedim_evolve
    ctx = onedim_evolve.OneDContext(tables=tt, cooling=None, dr=1e20,
                                    vol=torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="one node count"):
        onedim_evolve._pack_kernel_tables(ctx, torch.float64, "cpu")


def test_evolve3d_with_auto_tables_matches_jax():
    M = 16
    jt, _, jbands = j_tables(JSED(bb=JBB(T_eff=5e4, S_star=3e51)),
                             isothermal=True, n_nodes="auto",
                             dtype=jnp.float64)
    kw = dict(mesh=M, dr=15.0 * const.kpc / M, isothermal=True,
              flux_scale=jbands.flux_scale)
    jcfg = JEvolveConfig(sweep=JSweepConfig(tables=jt, **kw),
                         chem=JChemConfig(cooling=None, isothermal=True),
                         shells=j_shells(M), subbox_start=4)
    tcfg = Evolve3DConfig(
        sweep=SweepConfig(tables=convert.quad_tables_from_numpy(jt), **kw),
        chem=ChemistryConfig(isothermal=True), shells=build_shell_table(M),
        subbox_start=4)
    rng = np.random.RandomState(7)
    srcpos = rng.randint(0, M, size=(2, 3))
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (2, 1)),
                            np.zeros((2, 2))], axis=1)
    dens = 1e-4 * 10.0 ** rng.uniform(-0.5, 0.5, (M, M, M))
    js = j_state(dens, 0.0, 0.0, 0.0, 1.0e4, dtype=jnp.float64)
    assert _scaled_source_strength(tcfg.sweep, torch.as_tensor(nflux)) \
        == pytest.approx(float(j_strength(jcfg.sweep, jnp.asarray(nflux))),
                         rel=1e-14)
    j_new, j_stats = j_evolve3d(jcfg, js, jnp.asarray(srcpos, jnp.int32),
                                jnp.asarray(nflux), 1.0e14)
    t_new, t_stats = evolve3d(tcfg, convert.grid_state_from_numpy(js),
                              torch.as_tensor(srcpos),
                              torch.as_tensor(nflux), 1.0e14)
    assert (t_stats.n_iterations, t_stats.conv_flag, t_stats.subbox_radius) \
        == (j_stats.n_iterations, j_stats.conv_flag, j_stats.subbox_radius)
    np.testing.assert_allclose(t_stats.photon_loss, j_stats.photon_loss,
                               rtol=1e-9)
    for name in t_new._fields:
        np.testing.assert_allclose(getattr(t_new, name).numpy(),
                                   np.asarray(getattr(j_new, name)),
                                   rtol=1e-9, atol=1e-11, err_msg=name)
    assert float(t_new.h1.max()) > 0.5


# ---- the small functions

def test_constant_rate_coefficients_equal_jax():
    t = rates.constant_rate_coefficients()
    j = j_rates.constant_rate_coefficients()
    for name in t._fields:
        assert float(getattr(t, name)) == float(getattr(j, name)), name
        assert getattr(t, name).dtype == torch.float64
    assert rates.constant_rate_coefficients(torch.float32).v.dtype \
        == torch.float32


def test_ion_fractions_and_boundary_columns_equal_jax():
    rng = np.random.RandomState(3)
    h1, he1 = rng.uniform(0, 1, 16), rng.uniform(0, 0.5, 16)
    he2 = rng.uniform(0, 0.5, 16)
    t = chemistry.ion_fractions(torch.as_tensor(h1), torch.as_tensor(he1),
                                torch.as_tensor(he2))
    j = j_chem.ion_fractions(h1, he1, he2)
    for name in t._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    for tau in (0.0, 0.3, 7.5):
        assert chemistry.coldens_bndry_HI(tau) == j_chem.coldens_bndry_HI(tau)
        assert chemistry.coldens_bndry_HeI(tau) \
            == j_chem.coldens_bndry_HeI(tau)
        assert chemistry.coldens_bndry_HeII(tau) \
            == j_chem.coldens_bndry_HeII(tau)
    assert chemistry.coldens_bndry_HI() == 0.0
