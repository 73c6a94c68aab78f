"""The tau tables packed band-major for the 3D sweep kernels
(radiation/tables.py: pack_tau_columns, PackedTauTables): the packed
reads' plain twin (read_tau_column: v + d r of a row's record) against
the JAX package's photo.py:_read and the port's, at seeded random table
positions, for the photo and heating tables (thick and thin) of every
source type (a blackbody, a power law and a QSO spectrum), float64 and
float32, to the bit; the layout (live bands, the heating columns
resolved per species, the last row's difference zero) and the packing
made once per table set; every route's kernel tables kept on the sweep
configuration.

Where float32 values are subnormal, XLA on the CPU flushes them to zero
and the kernels (and torch) keep them; the float32 comparison with JAX
covers the reads whose operands, difference, product and result are
normal numbers or zeros, and the comparison with the port's `_read`
covers every read.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import PowerLawSED as JPL
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation import build_radiation_tables as j_tau_tables
from c2ray_tpu.radiation.photo import _read as j_read
from c2ray_tpu.radiation.photo import _table_positions as j_positions
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.radiation.bands import NumTau
from c2ray_tpu_torch.radiation.photo import _read
from c2ray_tpu_torch.radiation.tables import (pack_tau_columns,
                                              packed_table_route,
                                              read_tau_column)
from c2ray_tpu_torch.sweep import SweepConfig
from c2ray_tpu_torch.sweep import source_sweep

torch.set_num_threads(1)

J_SED_ALL = JSED(bb=JBB(T_eff=5.0e4, S_star=1.0e48),
                 pl=JPL(index=2.5, S_star=3.0e46),
                 qso=JPL(index=1.8, S_star=1.0e46))
TYPES = ("bb", "pl", "qso")
DTYPES = {"float64": (torch.float64, jnp.float64, np.float64),
          "float32": (torch.float32, jnp.float32, np.float32)}
_CACHE = {}


def _tables(dtype_name):
    """(JAX tables, port tables, TableRoute, PackedTauTables) of the
    three source types with heating, in the dtype."""
    if dtype_name not in _CACHE:
        tdt, jdt, _ = DTYPES[dtype_name]
        jt, _, _ = j_tau_tables(J_SED_ALL, isothermal=False, dtype=jdt)
        tt = convert.radiation_tables_from_numpy(jt, dtype=tdt)
        tr = packed_table_route(tt, tdt, "cpu", True, True, True, True)
        _CACHE[dtype_name] = (jt, tt, tr, pack_tau_columns(tr))
    return _CACHE[dtype_name]


def _positions(dtype_name, n=4096, seed=11):
    """JAX's table positions of seeded taus over the whole grid (and
    past both ends)."""
    _, jdt, _ = DTYPES[dtype_name]
    tau = 10.0 ** np.random.RandomState(seed).uniform(-22.0, 5.0, n)
    tau[:4] = (0.0, 1e-30, 1e4, 1e6)
    ip, ip1, r = j_positions(jnp.asarray(tau, dtype=jdt))
    return ip, ip1, r


def _normal(a, tiny):
    return (np.abs(a) >= tiny) | (a == 0)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["photo", "heat"])
@pytest.mark.parametrize("stype", TYPES)
def test_packed_reads_equal_jax_read(dtype_name, kind, stype):
    """read_tau_column on every live band's column (every species'
    heating column) equals JAX's _read of the unpacked table, thick and
    thin, to the bit, and the port's _read everywhere."""
    jt, tt, tr, pk = _tables(dtype_name)
    _, _, npdt = DTYPES[dtype_name]
    tiny = np.finfo(npdt).tiny
    t = TYPES.index(stype)
    jst, st = getattr(jt, stype), getattr(tt, stype)
    ip, ip1, r = _positions(dtype_name)
    ipt = torch.as_tensor(np.array(ip)).long()
    ip1t = torch.as_tensor(np.array(ip1)).long()
    rt = torch.as_tensor(np.array(r))
    b0, b1 = tr.live
    assert b1 - b0 == pk.photo.shape[1] > 0
    hbin = (tt.hbin_HI, tt.hbin_HeI, tt.hbin_HeII)
    checked = 0
    for b in range(b0, b1):
        if kind == "photo":
            cases = [(pk.photo[t, b - b0], thin, b,
                      jst.photo_thin if thin else jst.photo_thick,
                      st.photo_thin if thin else st.photo_thick)
                     for thin in (False, True)]
        else:
            cases = [(pk.heat[t, b - b0, sp], thin, int(hbin[sp][b]),
                      jst.heat_thin if thin else jst.heat_thick,
                      st.heat_thin if thin else st.heat_thick)
                     for sp in range(3) for thin in (False, True)]
        for column, thin, col, jtab, ttab in cases:
            mine = read_tau_column(column, ipt, rt, thin=thin).numpy()
            cols = jnp.full(ip.shape, col)
            ref = np.asarray(j_read(jtab, cols, ip, ip1, r))
            port = _read(ttab, torch.full(ipt.shape, col), ipt, ip1t,
                         rt).numpy()
            np.testing.assert_array_equal(mine, port)
            lo = np.asarray(jtab)[np.array(ip), col]
            hi = np.asarray(jtab)[np.array(ip1), col]
            d = hi - lo
            ok = (_normal(lo, tiny) & _normal(hi, tiny) & _normal(d, tiny)
                  & _normal(d * np.array(r), tiny) & _normal(ref, tiny))
            if npdt == np.float64:
                assert ok.all()
            np.testing.assert_array_equal(mine[ok], ref[ok])
            checked += int(ok.sum())
    assert checked > 1000


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_pack_layout(dtype_name):
    """PackedTauTables: the live bands' columns in band-major records
    [v, next - v] of the thick and the thin table (the last row's next
    is itself), the heat columns per species at hbin, rows, cols and
    live as the TableRoute's."""
    _, tt, tr, pk = _tables(dtype_name)
    b0, b1 = tr.live
    nt = len(tr.cols)
    assert pk.photo.shape == (nt, b1 - b0, NumTau + 1, 4)
    assert pk.heat.shape == (nt, b1 - b0, 3, NumTau + 1, 4)
    assert pk.photo.is_contiguous() and pk.heat.is_contiguous()
    assert pk.rows is tr.rows and pk.cols == tr.cols and pk.live == tr.live
    for t in range(nt):
        for thin in (0, 1):
            tab = tr.photo[t, thin, :, b0:b1].T            # (nl, rows)
            assert torch.equal(pk.photo[t, :, :, 2 * thin], tab)
            nxt = torch.cat([tab[:, 1:], tab[:, -1:]], dim=1)
            assert torch.equal(pk.photo[t, :, :, 2 * thin + 1], nxt - tab)
            assert not pk.photo[t, :, -1, 2 * thin + 1].any()
            for sp in range(3):
                cols = tr.hbin[b0:b1, sp].long()
                htab = tr.heat[t, thin][:, cols].T
                assert torch.equal(pk.heat[t, :, sp, :, 2 * thin], htab)


def test_kernel_tables_pack_the_tau_tables_once():
    """The sweep kernels' tables on the tau route: PackedTauTables, made
    at the first call for a table set, dtype and device and kept; other
    tables or another dtype get their own."""
    _, tt, _, _ = _tables("float64")
    cfg = SweepConfig(tables=tt, mesh=8, dr=1e21, isothermal=False,
                      has_pl=True, has_qso=True)
    kt = source_sweep._kernel_tables(cfg, torch.float32)
    assert kt.K == source_sweep.ROUTE_TABLE and kt.heat
    assert kt.types.photo.dtype == torch.float32
    assert source_sweep._kernel_tables(cfg, torch.float32).types is kt.types
    k64 = source_sweep._kernel_tables(cfg, torch.float64)
    assert k64.types is not kt.types
    assert k64.types.photo.dtype == torch.float64
    iso = SweepConfig(tables=tt, mesh=8, dr=1e21, isothermal=True,
                      has_pl=True, has_qso=True)
    assert source_sweep._kernel_tables(iso, torch.float64).types.heat is None
    _, route, ptrs = source_sweep._route_args(kt)[1:]
    assert list(route[:2]) == [source_sweep.ROUTE_TABLE, kt.packed.numel()]
    assert list(route[-2:]) == list(kt.types.live)
    assert ptrs[1].value == kt.types.photo.data_ptr()
    assert ptrs[2].value == kt.types.heat.data_ptr() and ptrs[3].value is None


@pytest.mark.parametrize("route", ["fixed", "auto", "tau"])
def test_kernel_tables_are_kept_on_the_configuration(route):
    """Every route's sweep-kernel tables are packed at the first call
    and kept in the configuration's kernel_cache: a second call and a
    configuration made from this one by dataclasses.replace get the same
    tables, another dtype or other tables get their own, and the entry
    holds the tables it was made from."""
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables

    def tables(which):
        if route == "tau":
            return _tables(which)[1]
        sed = SEDConfig(bb=BlackBodySED(
            T_eff=5e4 if which == "float64" else 1e5, S_star=1e48))
        return build_quadrature_tables(
            sed, isothermal=False, dtype=torch.float64,
            n_nodes=6 if route == "fixed" else "auto")[0]

    cfg = SweepConfig(tables=tables("float64"), mesh=8, dr=1e21,
                      isothermal=False)
    kt = source_sweep._kernel_tables(cfg, torch.float32)
    assert kt.K == {"fixed": 6, "auto": source_sweep.ROUTE_BLOCKS,
                    "tau": source_sweep.ROUTE_TABLE}[route] and kt.heat
    assert source_sweep._kernel_tables(cfg, torch.float32) is kt
    moved = dataclasses.replace(cfg, mesh=16, dr=2e21)
    assert source_sweep._kernel_tables(moved, torch.float32) is kt
    assert source_sweep._kernel_tables(cfg, torch.float64) is not kt
    other = dataclasses.replace(cfg, tables=tables("float32"))
    ko = source_sweep._kernel_tables(other, torch.float32)
    assert ko is not kt and ko.types is not kt.types
    assert len(cfg.kernel_cache) == 3
    assert all(hit[0] is t for hit, t in zip(
        cfg.kernel_cache.values(), (cfg.tables, cfg.tables, other.tables)))
