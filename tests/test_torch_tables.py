"""The port's host-side tables equal the JAX package's.

Bands, SED normalisation, Romberg weights and the quadrature tables are
built in float64 numpy by both packages from the same code path, so
they must agree to float64 rounding: rtol 1e-14.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import romberg as j_romberg
from c2ray_tpu.radiation import bands as j_bands
from c2ray_tpu.radiation import sed as j_sed
from c2ray_tpu.radiation import tables as j_tables
from c2ray_tpu.radiation.quadrature import \
    build_quadrature_tables as j_build
from c2ray_tpu_torch import romberg as t_romberg
from c2ray_tpu_torch.radiation import bands as t_bands
from c2ray_tpu_torch.radiation import sed as t_sed
from c2ray_tpu_torch.radiation import tables as t_tables
from c2ray_tpu_torch.radiation.quadrature import \
    build_quadrature_tables as t_build

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

RTOL = 1e-14


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("split", [(26, 20), (10, 11), (1, 1)])
def test_bands_match(split):
    a, b = t_bands.make_bands(*split), j_bands.make_bands(*split)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            _close(va, vb)
        else:
            assert va == vb, f.name


def test_romberg_weights_match():
    for n in (1, 2, 16, 512):
        _close(t_romberg.romberg_weights(n), j_romberg.romberg_weights(n))


def _seds(mod):
    return [
        mod.SEDConfig(bb=mod.BlackBodySED(T_eff=5e4, S_star=3e51)),
        mod.SEDConfig(bb=mod.BlackBodySED(T_eff=1e5, L_star_ion=1e38)),
        mod.SEDConfig(pl=mod.PowerLawSED(index=2.5, S_star=1e48)),
        mod.SEDConfig(bb=mod.BlackBodySED(T_eff=3e4, S_star=1e49),
                      qso=mod.PowerLawSED(index=1.8, S_star=0.0,
                                          Edd_efficiency=0.1)),
    ]


@pytest.mark.parametrize("i", range(4))
def test_sed_normalisation_matches(i):
    bands = j_bands.make_bands()
    a = t_sed.normalize_seds(_seds(t_sed)[i], bands.freq_min[0],
                             bands.freq_max[-1], edges=bands.freq_max[:-1])
    b = j_sed.normalize_seds(_seds(j_sed)[i], bands.freq_min[0],
                             bands.freq_max[-1], edges=bands.freq_max[:-1])
    for name in ("bb", "pl", "qso"):
        sa, sb = getattr(a, name), getattr(b, name)
        assert (sa is None) == (sb is None)
        if sa is None:
            continue
        for f in dataclasses.fields(sa):
            _close(getattr(sa, f.name), getattr(sb, f.name))


def test_band_limits_match():
    bands = j_bands.make_bands()
    for T in (1e4, 3e4, 5e4, 1e5, 3e5):
        h_over_kT = j_sed.BlackBodySED(T_eff=T).h_over_kT
        assert (t_tables._bb_band_limits(bands, h_over_kT)
                == j_tables._bb_band_limits(bands, h_over_kT))
    pl = j_sed.PowerLawSED()
    assert (t_tables._pl_band_limits(bands, pl.min_freq, pl.max_freq)
            == j_tables._pl_band_limits(bands, pl.min_freq, pl.max_freq))


@pytest.mark.parametrize("isothermal", [True, False])
@pytest.mark.parametrize("i,n_nodes", [(0, 6), (2, 8), (3, 6)])
def test_quadrature_tables_match(i, n_nodes, isothermal):
    qa, sa, ba = t_build(_seds(t_sed)[i], isothermal=isothermal,
                         dtype=torch.float64, n_nodes=n_nodes)
    qb, sb, bb = j_build(_seds(j_sed)[i], isothermal=isothermal,
                         dtype=jnp.float64, n_nodes=n_nodes)
    assert ba.flux_scale == bb.flux_scale
    for name in qb._fields:
        va, vb = getattr(qa, name), getattr(qb, name)
        if name in ("bb", "pl", "qso"):
            assert (va is None) == (vb is None)
            if va is None:
                continue
            assert (va.band_lo, va.band_hi) == (vb.band_lo, vb.band_hi)
            for f in vb._fields[2:]:
                xa, xb = getattr(va, f), getattr(vb, f)
                assert (xa is None) == (xb is None), f
                if xa is not None:
                    _close(xa, xb)
        else:
            _close(va, vb)


def test_float32_tables_use_the_flux_scale():
    sed = t_sed.SEDConfig(bb=t_sed.BlackBodySED(T_eff=5e4, S_star=3e51))
    q32, s32, b32 = t_build(sed, isothermal=True, dtype=torch.float32)
    q64, _, b64 = t_build(sed, isothermal=True, dtype=torch.float64)
    assert b64.flux_scale == 1.0
    assert b32.flux_scale == pytest.approx(s32.bb.S_star, rel=1e-12)
    assert q32.bb.A_photo.dtype == torch.float32
    np.testing.assert_allclose(
        q32.bb.A_photo.double().numpy() * b32.flux_scale,
        q64.bb.A_photo.numpy(), rtol=1e-6)
