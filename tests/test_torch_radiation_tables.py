"""The port's tau tables, tau-table rates and monochromatic tables equal
the JAX package's.

The tables are integrated in float64 numpy by both packages from the
same code path and cast once, so they agree to float64 rounding (rtol
1e-14; the float32 casts of equal float64 values are equal).  The
tau-table rates (`photoion_rates`) are the same elementwise arithmetic
and gathers in XLA and PyTorch: rtol 1e-12 on seeded random columns
over tau in [1e-8, 1e7], with an absolute floor of 1e-12 of each
field's largest value (the thick branch's in - out difference of two
table reads near TAU_PHOTO_LIMIT keeps fewer digits than its operands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.radiation import bands as j_bands
from c2ray_tpu.radiation import monochromatic as j_mono
from c2ray_tpu.radiation import photo as j_photo
from c2ray_tpu.radiation import sed as j_sed
from c2ray_tpu.radiation import tables as j_tables
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.radiation import bands as t_bands
from c2ray_tpu_torch.radiation import monochromatic as t_mono
from c2ray_tpu_torch.radiation import photo as t_photo
from c2ray_tpu_torch.radiation import sed as t_sed
from c2ray_tpu_torch.radiation import tables as t_tables

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

RTOL = 1e-14


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=0.0)


def _sed(mod, source):
    return {
        "bb": mod.SEDConfig(bb=mod.BlackBodySED(T_eff=1e5, S_star=5e48)),
        "pl": mod.SEDConfig(pl=mod.PowerLawSED(index=2.5, S_star=1e48)),
        "qso": mod.SEDConfig(bb=mod.BlackBodySED(T_eff=3e4, S_star=1e49),
                             qso=mod.PowerLawSED(index=1.8, S_star=0.0,
                                                 Edd_efficiency=0.1)),
    }[source]


def _assert_tables_equal(ta, tb, rtol=RTOL):
    for name in tb._fields:
        va, vb = getattr(ta, name), getattr(tb, name)
        if name in ("bb", "pl", "qso"):
            assert (va is None) == (vb is None), name
            if va is None:
                continue
            for f in vb._fields:
                xa, xb = getattr(va, f), getattr(vb, f)
                assert (xa is None) == (xb is None), (name, f)
                if xa is not None:
                    _close(xa, xb, rtol)
        else:
            _close(va, vb, rtol)


def _build_both(source, isothermal, t_dtype, j_dtype):
    a = t_tables.build_radiation_tables(_sed(t_sed, source),
                                        t_bands.make_bands(),
                                        isothermal=isothermal, dtype=t_dtype)
    b = j_tables.build_radiation_tables(_sed(j_sed, source),
                                        j_bands.make_bands(),
                                        isothermal=isothermal, dtype=j_dtype)
    return a, b


@pytest.mark.parametrize("isothermal", [True, False])
@pytest.mark.parametrize("source", ["bb", "pl", "qso"])
def test_radiation_tables_match(source, isothermal):
    (ta, sa, ba), (tb, sb, bb) = _build_both(source, isothermal,
                                             torch.float64, jnp.float64)
    assert ba.flux_scale == bb.flux_scale == 1.0
    _assert_tables_equal(ta, tb)
    assert ta.hbin_HI.dtype == torch.int64
    if isothermal:
        assert all(t is None or t.heat_thick is None for t in (ta.bb, ta.pl,
                                                               ta.qso))


@pytest.mark.parametrize("source,isothermal", [("bb", True), ("qso", False)])
def test_float32_radiation_tables_match(source, isothermal):
    (ta, sa, ba), (tb, sb, bb) = _build_both(source, isothermal,
                                             torch.float32, jnp.float32)
    total = sum(s.S_star for s in (sa.bb, sa.pl, sa.qso) if s is not None)
    assert ba.flux_scale == bb.flux_scale == pytest.approx(total, rel=1e-15)
    assert ta.sigma_HI.dtype == torch.float32
    _assert_tables_equal(ta, tb)


def test_tau_grid_matches():
    _close(t_tables._tau_grid(), j_tables._tau_grid())
    assert (t_tables.minlogtau, t_tables.dlogtau) == (j_tables.minlogtau,
                                                      j_tables.dlogtau)


@pytest.mark.parametrize("energy", [13.6, 30.0, 60.0])
def test_verner_cross_sections_match(energy):
    for s in range(3):
        assert (t_mono.verner_cross_section(energy, s)
                == j_mono.verner_cross_section(energy, s))


@pytest.mark.parametrize("isothermal", [True, False])
@pytest.mark.parametrize("energy,dtype", [(13.6, "float64"),
                                          (30.0, "float64"),
                                          (60.0, "float32")])
def test_monochromatic_tables_match(energy, dtype, isothermal):
    qa, sa, ba = t_mono.build_monochromatic_tables(
        _sed(t_sed, "bb"), energy, isothermal=isothermal,
        dtype=getattr(torch, dtype))
    qb, sb, bb = j_mono.build_monochromatic_tables(
        _sed(j_sed, "bb"), energy, isothermal=isothermal,
        dtype=getattr(jnp, dtype))
    assert ba.flux_scale == bb.flux_scale
    assert ba.nbands == bb.nbands == 1
    for name in qb._fields:
        va, vb = getattr(qa, name), getattr(qb, name)
        if name in ("bb", "pl", "qso"):
            assert (va is None) == (vb is None)
            if va is None:
                continue
            assert (va.band_lo, va.band_hi) == (vb.band_lo, vb.band_hi)
            assert va.sigma_hat.shape == (1, 1)
            for f in vb._fields[2:]:
                xa, xb = getattr(va, f), getattr(vb, f)
                assert (xa is None) == (xb is None), f
                if xa is not None:
                    _close(xa, xb)
        else:
            _close(va, vb)


def _random_columns(n, seed):
    """In/out columns whose optical depths at the HI threshold span
    [1e-8, 1e7], He columns ~ the He abundance, shell volumes ~1e60 cm^3
    and ionized fractions in (0, 1)."""
    rng = np.random.RandomState(seed)
    tau_in = 10.0 ** rng.uniform(-8.0, 7.0, n)
    cin_HI = tau_in / 6.346e-18
    cc_HI = cin_HI * 10.0 ** rng.uniform(-3.0, 1.0, n)
    he = lambda c: c * 0.08 * rng.uniform(0.0, 1.0, n)
    cin_HeI, cin_HeII = he(cin_HI), he(cin_HI)
    cols = (cin_HI, cin_HI + cc_HI, cin_HeI, cin_HeI + he(cc_HI),
            cin_HeII, cin_HeII + he(cc_HI))
    vol = 10.0 ** rng.uniform(59.0, 61.0, n)
    return cols, vol, rng.uniform(0.0, 1.0, n)


@pytest.mark.parametrize("isothermal", [True, False])
def test_photoion_rates_match(isothermal):
    tb, _, _ = j_tables.build_radiation_tables(
        _sed(j_sed, "qso"), j_bands.make_bands(), isothermal=isothermal)
    ta = convert.radiation_tables_from_numpy(tb)
    cols, vol, x = _random_columns(400, seed=3)
    kw = dict(nflux_bb=1.0, nflux_qso=0.7, do_heating=not isothermal)
    want = j_photo.photoion_rates(tb, *(jnp.asarray(c) for c in cols),
                                  jnp.asarray(vol), jnp.asarray(x), **kw)
    got = t_photo.photoion_rates(ta, *(torch.as_tensor(c) for c in cols),
                                 torch.as_tensor(vol), torch.as_tensor(x),
                                 **kw)
    for name in ("photo_cell_HI", "photo_cell_HeI", "photo_cell_HeII",
                 "heat", "photo_in", "photo_out"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)
    if not isothermal:
        assert np.abs(got.heat.numpy()).max() > 0.0


def test_table_positions_match():
    tau = np.concatenate([[0.0, 1e-30, 1e-20, 1e4, 1e6],
                          10.0 ** np.random.RandomState(4).uniform(
                              -21.0, 5.0, 200)])
    a = t_photo._table_positions(torch.as_tensor(tau))
    b = j_photo._table_positions(jnp.asarray(tau))
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
    np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
    # the residual is odpos - ipos with odpos up to 2000: a few ulp of
    # odpos (log10 and the division by dlogtau round differently in XLA
    # and PyTorch) absolute
    np.testing.assert_allclose(a[2].numpy(), np.asarray(b[2]), rtol=0.0,
                               atol=1e-12)
