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
- the kernels' block layout (`packed_band_blocks`, the 1D kernel's
  row deal) and the sweep kernels' node groups (`packed_node_groups`:
  every node once, the lanes' node counts within the largest K) with the
  plain version of their order (`node_group_rates`, here) against JAX's
  `photoion_rates_quad` to rtol 1e-12;
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
from c2ray_tpu_torch import constants as t_const
from c2ray_tpu_torch.radiation import (BlackBodySED, PowerLawSED,
                                       SEDConfig)
from c2ray_tpu_torch.radiation.quadrature import (AUTO_NODE_TOL,
                                                  GROUP_MAX_NODES,
                                                  SourceQuad,
                                                  build_quadrature_tables,
                                                  packed_band_blocks,
                                                  packed_node_groups,
                                                  photoion_rates_quad,
                                                  source_blocks)
from c2ray_tpu_torch.radiation.photo import (TAU_HEAT_LIMIT,
                                             TAU_PHOTO_LIMIT, _AR2, _BR1,
                                             _BR2, _CR1, _CR2, _DR1)
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
    tables take the block route; the 1D kernel takes the blocks as its
    row deal."""
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
    gflat, groups, _ = packed_node_groups(tt, torch.float32, True, True,
                                          True, True)
    assert kt.K == ROUTE_BLOCKS and kt.types == groups and kt.heat
    assert kt.packed.dtype == torch.float32
    assert torch.equal(kt.packed, gflat)
    with pytest.raises(ValueError, match="fixed"):
        _kernel_tables(cfg, torch.float32, track=True)

    # the 1D kernel takes the blocks dealt as rows of ROW_NODES nodes
    from c2ray_tpu_torch.onedim import evolve as onedim_evolve
    ctx = onedim_evolve.OneDContext(tables=tt, cooling=None, dr=1e20,
                                    vol=torch.ones(4, dtype=torch.float64),
                                    has_pl=True, has_qso=True)
    k1 = onedim_evolve._pack_kernel_tables(ctx, torch.float64, "cpu")
    flat_iso, blocks_iso = packed_band_blocks(tt, torch.float64, False, True,
                                              True, True)
    rows, slots, _ = onedim_evolve._row_deal(flat_iso, blocks_iso, False)
    assert torch.equal(k1.bands, rows) and k1.hbin is None
    assert k1.route == "auto" and k1.layout == (slots,)
    n_rows = sum(b[2] * -(-b[3] // onedim_evolve.ROW_NODES) for b in blocks)
    assert slots == -(-n_rows // 32)
    assert k1.bands.numel() == slots * 32 * (5 + 2 * onedim_evolve.ROW_NODES)


# the spectra of the node-group tests: the bench's blackbody, a 1e5 K
# one (blocks of K = 12, 3, 4, 3, 5, 8, 8) and the three source types
_GROUP_SEDS = {
    "bench": (JSED(bb=JBB(T_eff=5e4, S_star=3e51)),
              SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=3e51))),
    "bb1e5": (JSED(bb=JBB(T_eff=1e5, S_star=5e48)),
              SEDConfig(bb=BlackBodySED(T_eff=1e5, S_star=5e48))),
    "all": (J_SED_ALL, SED_ALL),
}


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("spectrum", sorted(_GROUP_SEDS))
def test_node_groups_deal_every_node_once(spectrum, lanes):
    """packed_node_groups: every node of every live band of every block
    in exactly one row of at most GROUP_MAX_NODES nodes, with the band's
    sigmas, masks, node data and f-factors; one group per source type and
    K, by descending K; and the rows dealt to a cell's lanes in turn
    (block_rates) leave the lanes' node counts within the largest K of
    each other.  The bench's blackbody: 8 rows of 6 nodes and 26 of 3, 63
    and 63 node terms at two lanes (one block at a time dealt 69 and
    57)."""
    tt, _, _ = build_quadrature_tables(_GROUP_SEDS[spectrum][1],
                                       isothermal=False, n_nodes="auto",
                                       dtype=torch.float64)
    three = spectrum == "all"
    flags = (True, three, three)
    flat, groups, entries = packed_node_groups(tt, torch.float64, True,
                                               *flags)
    _, blocks = packed_band_blocks(tt, torch.float64, True, *flags)
    want = {(col, lo + i, k) for col, lo, nb, K, _ in blocks
            for i in range(nb) for k in range(K)}
    seen = []
    sq_of = {(col, b): blk for (blk, col) in
             [(blk, c) for c, q in enumerate((tt.bb, tt.pl, tt.qso))
              if q is not None and flags[c] for blk in source_blocks(q)]
             for b in range(blk.band_lo, blk.band_hi + 1)}
    assert [g[3] for g in groups] == sorted((g[3] for g in groups),
                                            reverse=True)
    assert len({(g[0], g[3]) for g in groups}) == len(groups)
    for (col, _, n, K, row0), members in zip(groups, entries):
        assert 0 < K <= GROUP_MAX_NODES and len(members) == n
        for e, (band, k0) in enumerate(members):
            seen += [(col, band, k0 + k) for k in range(K)]
            row = flat[row0 + e * (17 + 5 * K):row0 + (e + 1) * (17 + 5 * K)]
            blk = sq_of[col, band]
            i = band - blk.band_lo
            assert row[0] == tt.sigma_HI[band] and row[4] == tt.mask_HeII[band]
            assert torch.equal(row[5:5 + K], blk.sigma_hat[i, k0:k0 + K])
            assert torch.equal(row[5 + K:5 + 2 * K], blk.A_photo[i, k0:k0 + K])
            assert torch.equal(row[5 + 4 * K:5 + 5 * K],
                               blk.A_heat_HeII[i, k0:k0 + K])
            assert row[-1] == tt.f2heat_HeII[band]
    assert row0 + n * (17 + 5 * K) == flat.numel()
    assert sorted(seen) == sorted(want) and len(seen) == len(want)
    # the lanes' node counts as block_rates deals the rows
    terms, first = [0] * lanes, 0
    for _, _, n, K, _ in groups:
        for e in range(n):
            terms[(first + e) % lanes] += K
        first = (first + n) % lanes
    assert sum(terms) == len(want)
    assert max(terms) - min(terms) <= max(g[3] for g in groups)
    if spectrum == "bench":
        assert [(g[2], g[3]) for g in groups] == [(8, 6), (26, 3)]
        assert lanes != 2 or terms == [63, 63]


def _butterfly(vals):
    """group_sum of csrc/band_rates.cuh over a list of lanes' values: the
    fixed xor butterfly, lane 0's result."""
    off = len(vals) // 2
    while off:
        vals = [v + vals[i ^ off] for i, v in enumerate(vals)]
        off //= 2
    return vals[0]


def node_group_rates(flat, groups, heat: bool, nflux, cd_in, cd_out, vol,
                     i_state, lanes: int = 1):
    """The plain version of the sweep kernels' block route as it orders
    the work (csrc/band_rates.cuh: block_rates and band_terms): the rows
    of packed_node_groups dealt to `lanes` lanes in turn, each lane's
    sums in its rows' order (node sums in node order, the heat by Kahan
    summation, 1/vol once), each lane's outputs formed, the lanes' added
    by the kernels' xor butterfly.  nflux (..., 3) per source type;
    cd_in, cd_out (..., 3) species columns; vol and i_state (...).
    Returns (photo_cell_HI, photo_cell_HeI, photo_cell_HeII, photo_in,
    photo_out, heat); the heat is zero without `heat`."""
    dtype = cd_in.dtype
    tiny = torch.finfo(dtype).tiny
    inv_vol = 1.0 / vol
    x = i_state
    y1 = [_CR1[i] * (1.0 - x ** _BR1[i]) ** _DR1[i] for i in range(3)]
    y2 = [_CR2[i] * x ** _AR2[i] * (1.0 - x ** _BR2[i])
          * (1.0 - x ** _BR2[i]) for i in range(3)]
    z = torch.zeros_like(vol)
    acc = [[z] * 5 for _ in range(lanes)]
    hacc = [[z] * 3 for _ in range(lanes)]
    hcomp = [z] * lanes
    first = 0
    for col, _, n, K, row0 in groups:
        stride = 17 + 5 * K if heat else 5 + 2 * K
        nfl = nflux[..., col]
        nv = nfl * inv_vol
        for e in range(n):
            ln = (first + e) % lanes
            rb = flat[row0 + e * stride:row0 + (e + 1) * stride]
            s3 = rb[0:3]
            tau_in = (cd_in[..., 0] * s3[0] + cd_in[..., 1] * s3[1]
                      + cd_in[..., 2] * s3[2])
            tau_out = (cd_out[..., 0] * s3[0] + cd_out[..., 1] * s3[1]
                       + cd_out[..., 2] * s3[2])
            tc = [s3[c] * (cd_out[..., c] - cd_in[..., c]) for c in range(3)]
            inv = 1.0 / torch.clamp(tc[0] + tc[1] + tc[2], min=tiny)
            dtau = tau_out - tau_in
            thick = dtau.abs() > TAU_PHOTO_LIMIT
            hthick = dtau.abs() > TAU_HEAT_LIMIT
            sh, A = rb[5:5 + K], rb[5 + K:5 + 2 * K]
            g_in = g_thick = g_thin = z
            h_thick, h_thin = [z] * 3, [z] * 3
            for k in range(K):
                e_in = torch.exp(-torch.clamp(tau_in * sh[k], max=80.0))
                e_d = e_in - torch.exp(-torch.clamp(tau_out * sh[k],
                                                    max=80.0))
                g_in = g_in + A[k] * e_in
                g_thick = g_thick + A[k] * e_d
                g_thin = g_thin + A[k] * sh[k] * e_in
                if heat:
                    for sp in range(3):
                        Ah = rb[5 + (2 + sp) * K + k]
                        h_thick[sp] = h_thick[sp] + Ah * e_d
                        h_thin[sp] = h_thin[sp] + Ah * sh[k] * e_in
            phi_in = nfl * g_in
            phi_all = torch.where(thick, nfl * g_thick, nfl * dtau * g_thin)
            pv = phi_all * inv_vol
            a = acc[ln]
            acc[ln] = [a[0] + tc[0] * inv * pv,
                       a[1] + rb[3] * (tc[1] * inv) * pv,
                       a[2] + rb[4] * (tc[2] * inv) * pv,
                       a[3] + phi_in, a[4] + (phi_in - phi_all)]
            if heat:
                mk = (1.0, rb[3], rb[4])
                ph = [mk[sp] * torch.where(
                    hthick, tc[sp] * inv * h_thick[sp] * nv,
                    tc[sp] * h_thin[sp] * nv) for sp in range(3)]
                f = rb[5 + 5 * K:17 + 5 * K]
                fra = [f[3 * j] * ph[0] + f[3 * j + 1] * ph[1]
                       + f[3 * j + 2] * ph[2] for j in range(4)]
                term = ph[0] + ph[1] + ph[2] - y1[2] * fra[2] \
                    + y2[2] * fra[3]
                yk = term - hcomp[ln]
                t = hacc[ln][0] + yk
                hcomp[ln] = (t - hacc[ln][0]) - yk
                h = hacc[ln]
                hacc[ln] = [t, h[1] + (y1[0] * fra[0] - y2[0] * fra[1]),
                            h[2] + (y1[1] * fra[0] - y2[1] * fra[1])]
        first = (first + n) % lanes
    outs = []
    for ln in range(lanes):
        a, h = acc[ln], hacc[ln]
        o = list(a) + [h[0]]
        if heat:
            o[0] = a[0] + h[1] / (t_const.ion_freq_HI * t_const.hplanck)
            o[1] = a[1] + h[2] / (t_const.ion_freq_HeI * t_const.hplanck)
        outs.append(o)
    return tuple(_butterfly([o[q] for o in outs]) for q in range(6))


@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("isothermal", [True, False])
@pytest.mark.parametrize("spectrum", sorted(_GROUP_SEDS))
def test_node_group_rates_match_jax(spectrum, isothermal, lanes):
    """The plain version of the kernels' block route as it orders the
    work (node_group_rates: rows dealt to lanes, each lane's sums, 1/vol
    once, the lanes added by the xor butterfly) against JAX's
    photoion_rates_quad on the same "auto" tables, float64: rtol 1e-12
    of each output's largest value, at seeded columns that cross the
    thin and thick regimes, volumes and ionized fractions, each source
    type's flux its own."""
    heating = not isothermal
    jsed, tsed = _GROUP_SEDS[spectrum]
    jt, _, _ = j_tables(jsed, isothermal=isothermal, n_nodes="auto",
                        dtype=jnp.float64)
    tt = convert.quad_tables_from_numpy(jt)
    three = spectrum == "all"
    flat, groups, _ = packed_node_groups(tt, torch.float64, heating, True,
                                         three, three)
    rng = np.random.RandomState(3)
    n = 256
    cin = 10.0 ** rng.uniform(12.0, 20.0, (n, 3))
    cout = cin + 10.0 ** rng.uniform(8.0, 19.0, (n, 3))
    cout[:32] = cin[:32] * (1.0 + 1e-12)
    vol = 10.0 ** rng.uniform(-3.0, 3.0, n)
    x = rng.uniform(0.0, 1.0, n)
    nfl = rng.uniform(0.5, 2.0, (n, 3))
    cols = (cin[:, 0], cout[:, 0], cin[:, 1], cout[:, 1], cin[:, 2],
            cout[:, 2])
    j = j_rates_quad(jt, *(jnp.asarray(c) for c in cols), jnp.asarray(vol),
                     jnp.asarray(x), nflux_bb=jnp.asarray(nfl[:, 0]),
                     nflux_pl=jnp.asarray(nfl[:, 1]) if three else None,
                     nflux_qso=jnp.asarray(nfl[:, 2]) if three else None,
                     do_heating=heating)
    T = torch.as_tensor
    out = node_group_rates(flat, groups, heating, T(nfl), T(cin), T(cout),
                           T(vol), T(x), lanes)
    for name, a in zip(FIELDS[:5] + ("heat",), out):
        b = np.asarray(getattr(j, name))
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)


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
