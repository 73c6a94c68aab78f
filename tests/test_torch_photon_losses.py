"""The band-tracked and per-cell-LLS sweep, and the photon-loss
redistribution: the port's plain versions against the JAX package.

16^3 x 3 sources, float64, the setup of tests/test_photon_losses.py.
Tolerances: rates and losses rtol 1e-10 with 1e-10 of each part's
largest value as the absolute floor (the sweep's float64 rounding, as
in tests/test_torch_pyramid_sweep.py); the redistribution rtol 1e-12
(two contractions of 3 and 47 terms, summed in another order).  The
float32 redistribution with fully ionized cells is the decided
deviation from JAX: the port scales the cross sections by their largest
value, so its float32 result is finite where JAX's is inf.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.radiation import BlackBodySED, SEDConfig
from c2ray_tpu.radiation.quadrature import build_quadrature_tables
from c2ray_tpu.state import begin_timestep as j_begin
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.evolve3d import \
    make_evolve3d_iteration as j_make_iteration
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu.sweep.photon_losses import \
    distribute_photon_losses as j_distribute
from c2ray_tpu.sweep.pyramid_sweep import \
    sweep_pyramid_source_batch as j_sweep
from c2ray_tpu.sweep.source_sweep import SourceFields as JFields
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SourceFields, SweepConfig,
                                   make_evolve3d_iteration, photon_losses,
                                   pyramid_sweep)
from c2ray_tpu_torch.utils.clocks import counter

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

M = 16


def _setup(track=True):
    """Both packages' sweep configs, fields and sources (the port's as
    tensors); a random partly ionized state, so every species absorbs."""
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5.0e4, S_star=1.0e50)),
        isothermal=True, dtype=jnp.float64)
    kw = dict(mesh=M, dr=20.0 * const.kpc / M, isothermal=True,
              flux_scale=bands.flux_scale, track_band_loss=track)
    jcfg = JSweepConfig(tables=tables, **kw)
    tcfg = SweepConfig(tables=convert.quad_tables_from_numpy(tables), **kw)
    rng = np.random.RandomState(21)
    n = M**3
    h1 = rng.uniform(0.0, 0.9, n)
    he1 = rng.uniform(0.0, 0.5, n)
    he2 = rng.uniform(0.0, 0.3, n) * (1.0 - he1)
    dens = 1.0e-4 * 10.0 ** rng.uniform(-0.5, 0.5, n)
    js = j_begin(j_state(dens, h1, he1, he2, 1.0e4))
    ts = convert.grid_state_from_numpy(js)
    srcpos = rng.randint(0, M, (3, 3))
    nflux = np.column_stack([rng.uniform(0.5, 2.0, 3), np.zeros((3, 2))])
    return jcfg, tcfg, js, ts, srcpos, nflux


def _jfields(s):
    return JFields(ndens=s.ndens, h_av0=s.h_av0, h_av1=s.h_av1,
                   he_av0=s.he_av0, he_av1=s.he_av1)


def _tfields(s):
    return SourceFields(ndens=s.ndens, h_av0=s.h_av0, h_av1=s.h_av1,
                        he_av0=s.he_av0, he_av1=s.he_av1)


def _close(a, b, name, rtol=1e-10):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * np.abs(b).max(), err_msg=name)


def _sweeps(jcfg, tcfg, js, ts, srcpos, nflux, radius, lls=None):
    ref = j_sweep(jcfg, _jfields(js), jnp.asarray(srcpos, jnp.int32),
                  jnp.asarray(nflux), radius=radius,
                  lls_grid=None if lls is None else jnp.asarray(lls))
    got = pyramid_sweep.sweep_pyramid_source_batch(
        tcfg, _tfields(ts), torch.as_tensor(srcpos), torch.as_tensor(nflux),
        radius=radius, lls_grid=None if lls is None else torch.as_tensor(lls))
    return ref, got


@pytest.mark.parametrize("radius", [4, None])
def test_band_tracked_sweep_matches_jax(radius):
    jcfg, tcfg, js, ts, srcpos, nflux = _setup()
    ref, got = _sweeps(jcfg, tcfg, js, ts, srcpos, nflux, radius)
    for name in ("phih", "phihe0", "phihe1", "photon_loss",
                 "photon_loss_bands"):
        _close(getattr(got, name), getattr(ref, name), name)
    plb = got.photon_loss_bands
    assert plb.shape == (tcfg.tables.sigma_HI.shape[0],)
    assert float(plb.sum()) > 0.0 and bool((plb >= 0.0).all())
    # the bands add up to the scalar escape
    np.testing.assert_allclose(float(plb.sum()), float(got.photon_loss),
                               rtol=1e-10)


def test_lls_grid_sweep_matches_jax():
    """A random type-2 LLS grid (up to tau_LLS ~ 2 per cell) through the
    per-cell LLS channel: rates and both losses."""
    jcfg, tcfg, js, ts, srcpos, nflux = _setup(track=False)
    rng = np.random.RandomState(3)
    lls = rng.uniform(0.0, 2.0, M**3) / const.sigma_HI_at_ion_freq
    ref, got = _sweeps(jcfg, tcfg, js, ts, srcpos, nflux, None, lls)
    assert float(got.lls_loss) > 0.0
    assert got.photon_loss_bands is None
    for name in ("phih", "phihe0", "phihe1", "photon_loss", "lls_loss"):
        _close(getattr(got, name), getattr(ref, name), name)
    # the grid is not the homogeneous column: the rates differ from it
    hom = pyramid_sweep.sweep_pyramid_source_batch(
        dataclasses.replace(tcfg, coldensh_LLS=float(lls.mean())),
        _tfields(ts), torch.as_tensor(srcpos), torch.as_tensor(nflux))
    assert not torch.allclose(hom.phih, got.phih, rtol=1e-3, atol=0.0)


def test_distribute_matches_jax_and_closes_the_budget():
    jcfg, tcfg, js, ts, srcpos, nflux = _setup()
    ref, got = _sweeps(jcfg, tcfg, js, ts, srcpos, nflux, 4)
    vos = tcfg.vol / tcfg.flux_scale
    j_out = j_distribute(jcfg.tables, ref, _jfields(js), jnp.asarray(vos))
    before = [getattr(got, n).clone() for n in ("phih", "phihe0", "phihe1")]
    t_out = photon_losses.distribute_photon_losses(tcfg.tables, got,
                                                   _tfields(ts), vos)
    for name in ("phih", "phihe0", "phihe1"):
        _close(getattr(t_out, name), getattr(j_out, name), name, rtol=1e-12)
    # the budget closes: every escaped photon is absorbed again
    # (tests/test_photon_losses.py:69-95)
    N = photon_losses.neutral_densities(_tfields(ts))
    dphi = torch.stack([getattr(t_out, n) - b for n, b in
                        zip(("phih", "phihe0", "phihe1"), before)], dim=-1)
    assert bool((dphi >= 0.0).all())
    absorbed = float((dphi * N).sum()) * vos
    np.testing.assert_allclose(absorbed, float(got.photon_loss_bands.sum()),
                               rtol=1e-10)


def test_distribute_float32_fully_ionized():
    """Fully ionized cells (neutral fractions 1e-20): N falls to the
    1e-30 floor, N sigma below float32's range.  JAX's float32 result is
    inf there; the port's, with sigma scaled, is finite and within 1e-5
    of the float64 result.  The losses and the cell volume are taken in
    flux units of the total loss (as float32 tables are scaled), which
    leaves the added rates unchanged."""
    from c2ray_tpu.sweep.source_sweep import RateGrids as JRates

    jcfg, tcfg, js, ts, srcpos, nflux = _setup()
    _, got = _sweeps(jcfg, tcfg, js, ts, srcpos, nflux, 4)
    scale = float(got.photon_loss_bands.sum())
    plb = got.photon_loss_bands.numpy() / scale
    vos = tcfg.vol / tcfg.flux_scale / scale
    frac = np.full(M**3, 1e-20)
    ndens = np.array(js.ndens)
    out = {}
    for dtype in (torch.float64, torch.float32):
        t = lambda a: torch.as_tensor(a, dtype=dtype)
        tables = type(tcfg.tables)(*(
            x.to(dtype) if isinstance(x, torch.Tensor) else x
            for x in tcfg.tables))
        z = lambda: torch.zeros(M**3, dtype=dtype)
        rates = got._replace(phih=z(), phihe0=z(), phihe1=z(),
                             photon_loss_bands=t(plb))
        fields = SourceFields(t(ndens), t(frac), t(1.0 - frac), t(frac),
                              t(frac))
        out[dtype] = photon_losses.distribute_photon_losses(tables, rates,
                                                            fields, vos)
    for name in ("phih", "phihe0", "phihe1"):
        a = getattr(out[torch.float32], name).double()
        assert bool(torch.isfinite(a).all()), name
        _close(a, getattr(out[torch.float64], name), name, rtol=1e-5)
    # the decided deviation: JAX's float32 contraction overflows
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    zj = jnp.zeros(M**3, jnp.float32)
    ref32 = j_distribute(
        jcfg.tables, JRates(zj, zj, zj, zj, f32(0.0), f32(0.0), f32(plb)),
        JFields(f32(ndens), f32(frac), f32(1.0 - frac), f32(frac), f32(frac)),
        f32(vos))
    assert not np.isfinite(np.asarray(ref32.phih)).all()


def _evolve_configs(track=True, add=True):
    jcfg, tcfg, js, ts, srcpos, nflux = _setup(track)
    je = JEvolveConfig(sweep=jcfg, chem=JChemConfig(cooling=None,
                                                    isothermal=True),
                       shells=build_shell_table(M), add_photon_losses=add,
                       use_subbox=False)
    te = Evolve3DConfig(sweep=tcfg, chem=ChemistryConfig(isothermal=True),
                        add_photon_losses=add, use_subbox=False)
    return je, te, js, ts, srcpos, nflux


def test_add_photon_losses_iteration_matches_jax():
    je, te, js, ts, srcpos, nflux = _evolve_configs()
    dt = 1.0e13
    ref = j_make_iteration(je, radius=4)(js, jnp.asarray(srcpos, jnp.int32),
                                         jnp.asarray(nflux),
                                         jnp.asarray(dt))
    got = make_evolve3d_iteration(te, radius=4)(
        ts, torch.as_tensor(srcpos), torch.as_tensor(nflux), dt)
    assert int(got[1]) == int(ref[1])
    assert float(got[2]) > 0.0   # the reported loss stays the raw escape
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-10)
    plain = make_evolve3d_iteration(
        dataclasses.replace(te, add_photon_losses=False), radius=4)(
        ts, torch.as_tensor(srcpos), torch.as_tensor(nflux), dt)
    assert bool((got[0].h_av1 >= plain[0].h_av1).all())
    assert not torch.equal(got[0].h_av1, plain[0].h_av1)
    for name in got[0]._fields:
        np.testing.assert_allclose(
            getattr(got[0], name).numpy(), np.asarray(getattr(ref[0], name)),
            rtol=1e-9, atol=1e-11, err_msg=name)


def test_add_photon_losses_needs_band_tracking():
    _, te, *_ = _evolve_configs(track=False)
    with pytest.raises(ValueError, match="track_band_loss"):
        make_evolve3d_iteration(te, radius=4)


def test_source_groups_match_one_group():
    """S = 5 swept in groups of 2 (2 + 2 + 1) against one group: the
    sums run in another order, so float64 agrees to rounding."""
    _, tcfg, _, ts, _, _ = _setup()
    rng = np.random.RandomState(5)
    srcpos = torch.as_tensor(rng.randint(0, M, (5, 3)))
    nflux = torch.as_tensor(np.column_stack([rng.uniform(0.5, 2.0, 5),
                                             np.zeros((5, 2))]))
    nflux[3, 0] = 0.0   # a dark source contributes nothing
    lls = torch.as_tensor(rng.uniform(0.0, 1.0, M**3)
                          / const.sigma_HI_at_ion_freq)
    out = {}
    for chunk in (0, 2):
        cfg = dataclasses.replace(tcfg, source_chunk=chunk)
        assert pyramid_sweep._source_group(cfg, 5, M, 8) == (chunk or 5)
        out[chunk] = pyramid_sweep.sweep_pyramid_source_batch(
            cfg, _tfields(ts), srcpos, nflux, radius=6, lls_grid=lls)
    for name in out[0]._fields:
        _close(getattr(out[2], name), getattr(out[0], name), name,
               rtol=1e-12)


def test_no_sources_give_zero_rates():
    """A batch of 0 sources (a catalog suppressed to nothing) gives zero
    rate grids and losses, as JAX's vmap over 0 sources does."""
    _, tcfg, _, ts, _, _ = _setup()
    rates = pyramid_sweep.sweep_pyramid_source_batch(
        tcfg, _tfields(ts), torch.zeros((0, 3), dtype=torch.long),
        torch.zeros((0, 3), dtype=torch.float64))
    for name, t in zip(rates._fields, rates):
        assert not bool(t.any()), name
    assert rates.phih.shape == (M**3,)
    assert rates.photon_loss_bands.shape == (tcfg.tables.sigma_HI.shape[0],)


def test_photon_loss_kernel_refuses_cpu_tensors():
    jcfg, tcfg, js, ts, srcpos, nflux = _setup()
    _, got = _sweeps(jcfg, tcfg, js, ts, srcpos, nflux, 4)
    before = counter("launches.photon_losses")
    with pytest.raises(ValueError, match="CUDA"):
        photon_losses.distribute_photon_losses_cuda(
            tcfg.tables, got, _tfields(ts), tcfg.vol / tcfg.flux_scale)
    with pytest.raises(ValueError, match="track_band_loss"):
        photon_losses.distribute_photon_losses(
            tcfg.tables, got._replace(photon_loss_bands=None), _tfields(ts),
            1.0)
    assert counter("launches.photon_losses") == before
