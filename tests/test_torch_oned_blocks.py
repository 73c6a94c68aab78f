"""The 1D kernel's "auto" route: its row deal, against the JAX package.

The 1D kernel (csrc/evolve1d.cu, band_rates.cuh: rows_in / rows_out)
takes "auto" quadrature tables as rows of ROW_NODES nodes dealt to the
32 lanes of its warp (onedim/evolve.py:_row_deal).  Here, on the CPU in
float64:

- the deal holds every node of every live band of every block once, each
  row with its band's values and zero nodes after its last one, zero
  rows filling the last slot, in the kernel's slot-major,
  value-major, lane-fastest layout; the incoming side's offsets fill the
  shared memory that `_shared_limit` is asked for;
- `row_deal_rates`, the plain version of the kernel's order (each lane's
  rows in slot order, one output formation a lane, the lanes added by
  the xor butterfly), within rtol 1e-12 of JAX's float64
  `photoion_rates_quad` on the same "auto" tables (every flux 1, as in
  the 1D program), isothermal and heating, at seeded columns across the
  thin and thick regimes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import PowerLawSED as JPL
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation.quadrature import \
    build_quadrature_tables as j_tables
from c2ray_tpu.radiation.quadrature import \
    photoion_rates_quad as j_rates_quad
from c2ray_tpu_torch import constants as t_const
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.onedim import evolve as ev1
from c2ray_tpu_torch.radiation import BlackBodySED, PowerLawSED, SEDConfig
from c2ray_tpu_torch.radiation.photo import (TAU_HEAT_LIMIT,
                                             TAU_PHOTO_LIMIT, _AR2, _BR1,
                                             _BR2, _CR1, _CR2, _DR1)
from c2ray_tpu_torch.radiation.quadrature import (build_quadrature_tables,
                                                  packed_band_blocks,
                                                  source_blocks)

torch.set_num_threads(1)

# test 1's 1e5 K blackbody (blocks of K = 12, 3, 4, 3, 5, 8, 8), the
# bench's 5e4 K one and the three source types
_SEDS = {
    "bb1e5": (JSED(bb=JBB(T_eff=1e5, S_star=5e48)),
              SEDConfig(bb=BlackBodySED(T_eff=1e5, S_star=5e48))),
    "bench": (JSED(bb=JBB(T_eff=5e4, S_star=3e51)),
              SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=3e51))),
    "all": (JSED(bb=JBB(T_eff=5.0e4, S_star=1.0e48),
                 pl=JPL(index=2.5, S_star=3.0e46),
                 qso=JPL(index=1.8, S_star=1.0e46)),
            SEDConfig(bb=BlackBodySED(T_eff=5.0e4, S_star=1.0e48),
                      pl=PowerLawSED(index=2.5, S_star=3.0e46),
                      qso=PowerLawSED(index=1.8, S_star=1.0e46))),
}


def _flags(spectrum):
    three = spectrum == "all"
    return (True, three, three)


def _row_values(heat):
    return 17 + 5 * ev1.ROW_NODES if heat else 5 + 2 * ev1.ROW_NODES


@pytest.mark.parametrize("heat", [False, True])
@pytest.mark.parametrize("spectrum", sorted(_SEDS))
def test_row_deal_covers_every_node_once(spectrum, heat):
    """_row_deal: every (block, band, node) of packed_band_blocks in
    exactly one row, at the row's own node slot, with the band's sigmas,
    masks, f-factors and node data; nodes past a band's last are zeros,
    and so are the rows past the last one; the slot count is the least
    that holds the rows; value v of row j lies at (j // 32 *
    values + v) * 32 + j % 32.  Test 1's blackbody: 156 nodes in 59 rows,
    2 slots."""
    tt, _, _ = build_quadrature_tables(_SEDS[spectrum][1],
                                       isothermal=not heat, n_nodes="auto",
                                       dtype=torch.float64)
    flags = _flags(spectrum)
    flat, blocks = packed_band_blocks(tt, torch.float64, heat, *flags)
    rows, slots, deal = ev1._row_deal(flat, blocks, heat)
    M, W, nv = ev1.ROW_NODES, ev1.ROW_LANES, _row_values(heat)
    real = [d for d in deal if d is not None]
    assert deal[:len(real)] == real and len(deal) == slots * W
    assert (slots - 1) * W < len(real) <= slots * W
    assert rows.shape == (slots * nv * W,)
    table = rows.reshape(slots, nv, W).permute(0, 2, 1).reshape(slots * W, nv)
    assert not table[len(real):].any()
    sq = [blk for c, q in enumerate((tt.bb, tt.pl, tt.qso))
          if q is not None and flags[c] for blk in source_blocks(q)]
    assert len(sq) == len(blocks)
    seen = []
    for row, (bi, i, k0, n) in zip(table, real):
        assert 0 < n <= M
        blk = sq[bi]
        b = blk.band_lo + i
        seen += [(bi, i, k0 + k) for k in range(n)]
        assert row[0] == tt.sigma_HI[b] and row[2] == tt.sigma_HeII[b]
        assert row[4] == tt.mask_HeII[b]
        arrays = [blk.sigma_hat, blk.A_photo]
        if heat:
            arrays += [blk.A_heat_HI, blk.A_heat_HeI, blk.A_heat_HeII]
            assert row[-1] == tt.f2heat_HeII[b]
        for q, arr in enumerate(arrays):
            nodes = row[5 + q * M:5 + (q + 1) * M]
            assert torch.equal(nodes[:n], arr[i, k0:k0 + n])
            assert not nodes[n:].any()
    want = [(bi, i, k) for bi, (_, _, nb, K, _) in enumerate(blocks)
            for i in range(nb) for k in range(K)]
    assert sorted(seen) == want
    if spectrum == "bb1e5":
        assert [(b[3], b[2]) for b in blocks] == [
            (12, 1), (3, 4), (4, 6), (3, 16), (5, 4), (8, 2), (8, 3)]
        assert (len(want), len(real), slots) == (156, 59, 2)


@pytest.mark.parametrize("heat", [False, True])
def test_row_deal_shared_memory(heat):
    """The kernel's shared memory on "auto" tables: the rows, then the
    incoming side of every row (rows_in: value v of slot s, lane l at
    (s * in_values + v) * 32 + l past the rows), then with heating the
    cooling table; the offsets fill exactly the count that
    _pack_kernel_tables asks _shared_limit for, and a limit one byte
    short refuses the tables."""
    from c2ray_tpu_torch.cooling import setup_cooling_tables, stacked

    tt, _, _ = build_quadrature_tables(_SEDS["bb1e5"][1],
                                       isothermal=not heat, n_nodes="auto",
                                       dtype=torch.float64)
    ctx = ev1.OneDContext(
        tables=tt, isothermal=not heat, dr=1e20,
        cooling=setup_cooling_tables(torch.float64) if heat else None,
        vol=torch.ones(4, dtype=torch.float64))
    kt = ev1._pack_kernel_tables(ctx, torch.float32, "cpu")
    slots = kt.layout[0]
    assert kt.route == "auto" and kt.layout == (slots,)
    W, nin = ev1.ROW_LANES, ev1._row_in_values(heat)
    nrow = kt.bands.numel()
    assert nrow == slots * W * _row_values(heat)
    offsets = sorted(nrow + (s * nin + v) * W + lane for s in range(slots)
                     for lane in range(W) for v in range(nin))
    assert offsets == list(range(nrow, nrow + slots * W * nin))
    cool = stacked(ctx.cooling).numel() if heat else 0
    need = 4 * (offsets[-1] + 1 + cool)
    import c2ray_tpu_torch.cuda_build as cb
    limit = cb.SHARED_MEM_LIMIT
    try:
        cb.SHARED_MEM_LIMIT = need
        ev1._pack_kernel_tables(ctx, torch.float32, "cpu")
        cb.SHARED_MEM_LIMIT = need - 1
        with pytest.raises(ValueError, match=f"need {need} B of shared"):
            ev1._pack_kernel_tables(ctx, torch.float32, "cpu")
    finally:
        cb.SHARED_MEM_LIMIT = limit


def _butterfly(vals):
    """group_sum<32> of csrc/band_rates.cuh over the lanes' values: the
    fixed xor butterfly, lane 0's result."""
    off = len(vals) // 2
    while off:
        vals = [v + vals[i ^ off] for i, v in enumerate(vals)]
        off //= 2
    return vals[0]


def row_deal_rates(rows, slots, heat: bool, cd_in, cd_out, vol, i_state):
    """The plain version of the 1D kernel's "auto" route as it orders the
    work (band_rates.cuh: row_in, row_out, rows_out; every flux 1): each
    lane's rows in slot order, a row's node sums in node order, both
    regimes' sums and a select, 1/vol once, the heat by Kahan
    summation; each lane's outputs formed once, the 32 lanes added by the
    kernel's xor butterfly.  rows, slots: _row_deal's; cd_in, cd_out (n,
    3) species columns; vol and i_state (n,).  Returns (photo_cell_HI,
    photo_cell_HeI, photo_cell_HeII, heat); the heat is zero without
    `heat`."""
    M, W = ev1.ROW_NODES, ev1.ROW_LANES
    tab = rows.reshape(slots, _row_values(heat), W)
    tiny = torch.finfo(cd_in.dtype).tiny
    inv_vol = 1.0 / vol
    x = i_state
    y1 = [_CR1[i] * (1.0 - x ** _BR1[i]) ** _DR1[i] for i in range(3)]
    y2 = [_CR2[i] * x ** _AR2[i] * (1.0 - x ** _BR2[i])
          * (1.0 - x ** _BR2[i]) for i in range(3)]
    z = torch.zeros_like(vol)
    outs = []
    for lane in range(W):
        acc, hacc, hcomp = [z] * 3, [z] * 3, z
        for s in range(slots):
            rb = tab[s, :, lane]
            sh = rb[5:5 + M]
            A = rb[5 + M:5 + 2 * M]
            Ah = [rb[5 + (2 + sp) * M:5 + (3 + sp) * M] for sp in range(3)]
            # row_in
            tau_in = (cd_in[:, 0] * rb[0] + cd_in[:, 1] * rb[1]
                      + cd_in[:, 2] * rb[2])
            e_in = [torch.exp(-torch.clamp(tau_in * sh[k], max=80.0))
                    for k in range(M)]
            g_thin, h_thin = z, [z] * 3
            for k in range(M):
                g_thin = g_thin + A[k] * sh[k] * e_in[k]
                if heat:
                    h_thin = [h_thin[sp] + Ah[sp][k] * sh[k] * e_in[k]
                              for sp in range(3)]
            # row_out
            tau_out = (cd_out[:, 0] * rb[0] + cd_out[:, 1] * rb[1]
                       + cd_out[:, 2] * rb[2])
            tc = [rb[c] * (cd_out[:, c] - cd_in[:, c]) for c in range(3)]
            inv = 1.0 / torch.clamp(tc[0] + tc[1] + tc[2], min=tiny)
            dtau = tau_out - tau_in
            thick = dtau.abs() > TAU_PHOTO_LIMIT
            hthick = dtau.abs() > TAU_HEAT_LIMIT
            g_d, h_d = z, [z] * 3
            for k in range(M):
                e_d = e_in[k] - torch.exp(-torch.clamp(tau_out * sh[k],
                                                       max=80.0))
                g_d = g_d + A[k] * e_d
                if heat:
                    h_d = [h_d[sp] + Ah[sp][k] * e_d for sp in range(3)]
            g_x = torch.where(thick, g_d, g_thin)
            pv = torch.where(thick, g_x, dtau * g_x) * inv_vol
            acc = [acc[0] + tc[0] * inv * pv,
                   acc[1] + rb[3] * (tc[1] * inv) * pv,
                   acc[2] + rb[4] * (tc[2] * inv) * pv]
            if heat:
                mk = (1.0, rb[3], rb[4])
                ph = [mk[sp] * torch.where(
                    hthick, tc[sp] * inv * h_d[sp] * inv_vol,
                    tc[sp] * h_thin[sp] * inv_vol) for sp in range(3)]
                f = rb[5 + 5 * M:17 + 5 * M]
                fra = [f[3 * j] * ph[0] + f[3 * j + 1] * ph[1]
                       + f[3 * j + 2] * ph[2] for j in range(4)]
                term = ph[0] + ph[1] + ph[2] - y1[2] * fra[2] \
                    + y2[2] * fra[3]
                yk = term - hcomp
                t = hacc[0] + yk
                hcomp = (t - hacc[0]) - yk
                hacc = [t, hacc[1] + (y1[0] * fra[0] - y2[0] * fra[1]),
                        hacc[2] + (y1[1] * fra[0] - y2[1] * fra[1])]
        o = list(acc) + [hacc[0]]
        if heat:
            o[0] = acc[0] + hacc[1] / (t_const.ion_freq_HI * t_const.hplanck)
            o[1] = acc[1] + hacc[2] / (t_const.ion_freq_HeI
                                       * t_const.hplanck)
        outs.append(o)
    return tuple(_butterfly([o[q] for o in outs]) for q in range(4))


@pytest.mark.parametrize("isothermal", [True, False])
@pytest.mark.parametrize("spectrum", sorted(_SEDS))
def test_row_deal_rates_match_jax(spectrum, isothermal):
    """row_deal_rates (the kernel's order of the row deal) against JAX's
    photoion_rates_quad on the same "auto" tables, float64, every flux 1:
    photo_cell_{HI,HeI,HeII} and the heat within rtol 1e-12 of each
    output's largest value, at seeded columns that cross the thin and
    thick regimes (the first 32 cells thin), volumes and ionized
    fractions."""
    heat = not isothermal
    jsed, _ = _SEDS[spectrum]
    jt, _, _ = j_tables(jsed, isothermal=isothermal, n_nodes="auto",
                        dtype=jnp.float64)
    tt = convert.quad_tables_from_numpy(jt)
    flags = _flags(spectrum)
    flat, blocks = packed_band_blocks(tt, torch.float64, heat, *flags)
    rows, slots, _ = ev1._row_deal(flat, blocks, heat)
    rng = np.random.RandomState(5)
    n = 256
    cin = 10.0 ** rng.uniform(12.0, 20.0, (n, 3))
    cout = cin + 10.0 ** rng.uniform(8.0, 19.0, (n, 3))
    cout[:32] = cin[:32] * (1.0 + 1e-12)
    vol = 10.0 ** rng.uniform(-3.0, 3.0, n)
    x = rng.uniform(0.0, 1.0, n)
    one = jnp.ones(n)
    cols = (cin[:, 0], cout[:, 0], cin[:, 1], cout[:, 1], cin[:, 2],
            cout[:, 2])
    j = j_rates_quad(jt, *(jnp.asarray(c) for c in cols), jnp.asarray(vol),
                     jnp.asarray(x), nflux_bb=one,
                     nflux_pl=one if flags[1] else None,
                     nflux_qso=one if flags[2] else None, do_heating=heat)
    T = torch.as_tensor
    out = row_deal_rates(rows, slots, heat, T(cin), T(cout), T(vol), T(x))
    names = ("photo_cell_HI", "photo_cell_HeI", "photo_cell_HeII", "heat")
    for name, a in zip(names[:4 if heat else 3], out):
        b = np.asarray(getattr(j, name))
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)
