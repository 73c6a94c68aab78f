"""The port's packaging and its kernels; this file imports no JAX.

CPU: importing the port leaves JAX unloaded, CPU tensors never reach a
kernel (the launch counters stay at 0), and `chip_smoke.py` refuses to
run without a GPU.  Card (marker `gpu`, skipped without CUDA): each
kernel against its plain version on the same inputs.  On a GPU machine
without JAX, run the card tests with

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from c2ray_tpu_torch import constants as const
from c2ray_tpu_torch import cuda_build
from c2ray_tpu_torch.cooling import setup_cooling_tables
from c2ray_tpu_torch.grid import RadialGrid
from c2ray_tpu_torch.onedim import OneDProblem
from c2ray_tpu_torch.onedim import evolve as onedim_evolve
from c2ray_tpu_torch.onedim.driver import OneDRun
from c2ray_tpu_torch.radiation.monochromatic import \
    build_monochromatic_tables
from c2ray_tpu_torch.radiation import BlackBodySED, PowerLawSED, SEDConfig
from c2ray_tpu_torch.radiation.bands import F_FACTORS
from c2ray_tpu_torch.radiation.quadrature import (build_quadrature_tables,
                                                  packed_band_rows)
from c2ray_tpu_torch.state import initial_grid_state
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SourceFields, SweepConfig,
                                   build_shell_table, evolve3d, global_pass,
                                   octant_sweep, pyramid_sweep, source_sweep)

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = ("import sys, pkgutil, importlib, c2ray_tpu_torch\n"
            "for m in pkgutil.walk_packages(c2ray_tpu_torch.__path__,\n"
            "                               'c2ray_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax'\n"
            "             or k.startswith(('jax.', 'c2ray_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _config(M, dtype, device, S_star=3e51, heating=False):
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=S_star)),
        isothermal=not heating, dtype=dtype, device=device)
    sweep = SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                        isothermal=not heating, flux_scale=bands.flux_scale)
    chem = (ChemistryConfig(isothermal=False,
                            cooling=setup_cooling_tables(dtype, device))
            if heating else ChemistryConfig(isothermal=True))
    return Evolve3DConfig(sweep=sweep, chem=chem, subbox_start=2)


def _sources(M, S, dtype, device, seed=7):
    rng = np.random.RandomState(seed)
    srcpos = rng.randint(0, M, size=(S, 3))
    srcpos[0] = (0, M - 1, M // 3)
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (S, 1)),
                            np.zeros((S, 2))], axis=1)
    return (torch.as_tensor(srcpos, device=device),
            torch.as_tensor(nflux, dtype=dtype, device=device))


def _random_state(M, dtype, device, seed=5):
    rng = np.random.RandomState(seed)
    n = M**3
    h1 = rng.uniform(0.0, 0.8, n)
    he1 = rng.uniform(0.0, 0.5, n)
    he2 = rng.uniform(0.0, 0.3, n) * (1.0 - he1)
    return initial_grid_state(10.0 ** rng.uniform(-4, -2, n), h1, he1, he2,
                              1.0e4, dtype=dtype, device=device)


def _assert_traces_close(k, p, tol):
    """Two traces agree within `tol` relative, with `tol` of each part's
    largest value as its absolute floor: the rates (1/s), the heat
    (erg cm^-3 s^-1, ~1e-15 of the rates) and the two losses each on
    their own scale."""
    k_slab, p_slab = k[0], p[0]
    for a, b, what in ((k_slab[..., :3], p_slab[..., :3], "rates"),
                       (k_slab[..., 3], p_slab[..., 3], "heat"),
                       (k[1], p[1], "photon_loss"), (k[2], p[2], "lls_loss")):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()),
                                   msg=what)


def test_plain_path_launches_no_kernel():
    M = 8
    cfg = _config(M, torch.float64, "cpu")
    srcpos, nflux = _sources(M, 2, torch.float64, "cpu")
    state = initial_grid_state(np.full((M,) * 3, 1e-4), 0.0, 0.0, 0.0, 1e4)
    before = (pyramid_sweep.launches, global_pass.launches)
    new, stats = evolve3d(cfg, state, srcpos, nflux, 1.0e14)
    assert (pyramid_sweep.launches, global_pass.launches) == before
    assert stats.n_iterations >= 2
    assert bool(torch.isfinite(new.h1).all())


def test_wrappers_refuse_other_devices():
    M = 4
    cfg = _config(M, torch.float64, "cpu")
    z = torch.zeros(M**3, device="meta", dtype=torch.float64)
    srcpos, nflux = _sources(M, 1, torch.float64, "meta")
    with pytest.raises(ValueError):
        pyramid_sweep.sweep_pyramid_source_batch(
            cfg.sweep, SourceFields(z, z, z, z, z), srcpos, nflux)


def test_kernel_wrappers_refuse_cpu_tensors():
    M = 4
    cfg = _config(M, torch.float64, "cpu")
    state = _random_state(M, torch.float64, "cpu")
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    fstack = pyramid_sweep.stack_sweep_fields(cfg.sweep, fields)
    srcpos, nflux = _sources(M, 1, torch.float64, "cpu")
    rates = pyramid_sweep.sweep_pyramid_source_batch(cfg.sweep, fields,
                                                     srcpos, nflux)
    before = (pyramid_sweep.launches, global_pass.launches)
    with pytest.raises(ValueError, match="CUDA"):
        pyramid_sweep.trace_cuda(cfg.sweep, fstack, srcpos, nflux, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        global_pass.chemistry_pass_cuda(cfg.chem, state, rates, 1.0e14)
    assert (pyramid_sweep.launches, global_pass.launches) == before


def test_heating_wrappers_refuse_cpu_tensors():
    M = 4
    cfg = _config(M, torch.float64, "cpu", heating=True)
    state = _random_state(M, torch.float64, "cpu")
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    fstack = pyramid_sweep.stack_sweep_fields(cfg.sweep, fields)
    srcpos, nflux = _sources(M, 1, torch.float64, "cpu")
    rates = pyramid_sweep.sweep_pyramid_source_batch(cfg.sweep, fields,
                                                     srcpos, nflux)
    counts = lambda: (pyramid_sweep.launches_heat, global_pass.launches_heat)
    before = counts()
    with pytest.raises(ValueError, match="CUDA"):
        pyramid_sweep.trace_cuda(cfg.sweep, fstack, srcpos, nflux, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        global_pass.chemistry_pass_cuda(cfg.chem, state, rates, 1.0e14)
    assert counts() == before


@pytest.mark.parametrize("heat", [False, True])
def test_packed_tables_layout(heat):
    """Each row of the sweep kernel's band table holds, in order, the
    values csrc/pyramid_sweep.cu reads: sigma (3), masks (2), sighat (K),
    A (K), and with heating A_heat per species (3K) and the 12
    f-factors; rows run over the live bands of each source type."""
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48),
                  pl=PowerLawSED(index=2.5, S_star=1e47)),
        isothermal=not heat, dtype=torch.float64)
    cfg = SweepConfig(tables=tables, mesh=8, dr=1.0e21,
                      isothermal=not heat, flux_scale=bands.flux_scale,
                      has_pl=True)
    assert pyramid_sweep.sweep_heats(cfg) == heat
    packed, types, K = packed_band_rows(tables, torch.float64, heat,
                                        has_pl=True)
    assert K == tables.bb.sigma_hat.shape[1]
    assert packed.shape[1] == (17 + 5 * K if heat else 5 + 2 * K)
    assert [t[0] for t in types] == [0, 1]
    row = 0
    for sq, (col, nb, lo) in zip((tables.bb, tables.pl), types):
        assert nb == sq.band_hi - sq.band_lo + 1 and lo == sq.band_lo
        for j in range(nb):
            b = sq.band_lo + j
            r = packed[row]
            expect = [tables.sigma_HI[b], tables.sigma_HeI[b],
                      tables.sigma_HeII[b], tables.mask_HeI[b],
                      tables.mask_HeII[b]]
            assert torch.equal(r[:5], torch.stack(expect))
            assert torch.equal(r[5:5 + K], sq.sigma_hat[j])
            assert torch.equal(r[5 + K:5 + 2 * K], sq.A_photo[j])
            if heat:
                for s, A in enumerate((sq.A_heat_HI, sq.A_heat_HeI,
                                       sq.A_heat_HeII)):
                    lo = 5 + (2 + s) * K
                    assert torch.equal(r[lo:lo + K], A[j])
                f = torch.stack([getattr(tables, n)[b]
                                 for n in F_FACTORS])
                assert torch.equal(r[5 + 5 * K:], f)
            row += 1
    assert row == packed.shape[0]


def _three_type_config(M, dtype, device, n_nodes=6):
    """Blackbody, power-law and QSO sources with heating tables (the
    power laws over all 47 bands, from the HI threshold up): in f64 at
    K = 6 the 127 band rows exceed the default 48 KB of shared memory."""
    lo = const.ion_freq_HI
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48),
                  pl=PowerLawSED(index=2.5, S_star=1e47, min_freq=lo),
                  qso=PowerLawSED(index=1.8, S_star=1e47, min_freq=lo)),
        isothermal=False, dtype=dtype, device=device, n_nodes=n_nodes)
    return SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                       isothermal=False, flux_scale=bands.flux_scale,
                       has_pl=True, has_qso=True)


def test_sweep_shared_memory_limit():
    """Tables over the default 48 KB pass (the kernels opt in to the
    card's larger dynamic shared memory); over the opt-in limit the
    wrapper raises with the byte count."""
    packed, _, K, heat = pyramid_sweep._kernel_tables(
        _three_type_config(8, torch.float64, "cpu"), torch.float64)
    smem = (packed.numel() + 2 * 256) * 8
    assert heat and K == 6 and packed.shape == (127, 17 + 5 * K)
    assert 48 * 1024 < smem <= cuda_build.SHARED_MEM_LIMIT
    with pytest.raises(ValueError, match=r"need \d+ B of shared memory"):
        pyramid_sweep._kernel_tables(
            _three_type_config(8, torch.float64, "cpu", n_nodes=48),
            torch.float64)


def test_heating_sweep_without_heating_tables_has_no_heat():
    """A heating config over isothermal tables gives zero heat in the
    plain version, so the kernel wrapper takes the isothermal variant."""
    cfg = _config(4, torch.float64, "cpu")
    hot = dataclasses.replace(cfg.sweep, isothermal=False)
    assert not pyramid_sweep.sweep_heats(hot)
    state = _random_state(4, torch.float64, "cpu")
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    srcpos, nflux = _sources(4, 1, torch.float64, "cpu")
    rates = pyramid_sweep.sweep_pyramid_source_batch(hot, fields, srcpos,
                                                     nflux)
    assert float(rates.phiheat.abs().max()) == 0.0


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("radius", [None, 4])
def test_sweep_kernel_matches_plain(cuda_device, dtype, radius, heating):
    M = 16
    cfg = _config(M, dtype, cuda_device, S_star=1e48, heating=heating)
    state = _random_state(M, dtype, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    fstack = pyramid_sweep.stack_sweep_fields(cfg.sweep, fields)
    srcpos, nflux = _sources(M, 3, dtype, cuda_device)
    Rf, Rb = pyramid_sweep.trace_extents(M, radius)
    counts = lambda: (pyramid_sweep.launches, pyramid_sweep.launches_heat)
    before = counts()
    k = pyramid_sweep.trace_cuda(cfg.sweep, fstack, srcpos, nflux, Rf, Rb)
    assert counts() == (before[0] + (not heating), before[1] + heating)
    p = pyramid_sweep.trace_plain(cfg.sweep, fstack, srcpos, nflux, Rf, Rb)
    # float64: rounding only.  float32: columns summed over up to M/2
    # layers with and without FMA contraction, amplified by tau <= 80
    # in e^-tau; measured kernel-vs-plain at 32^3 stays below 1e-6 of
    # the largest value
    if heating:
        assert float(p[0][..., 3].abs().max()) > 0.0
    _assert_traces_close(k, p, 1e-10 if dtype == torch.float64 else 1e-4)


@pytest.mark.gpu
def test_sweep_kernel_with_large_tables_matches_plain(cuda_device):
    """Three source types in f64 with heating: the band tables need more
    than the default 48 KB of shared memory."""
    M = 8
    cfg = _three_type_config(M, torch.float64, cuda_device)
    state = _random_state(M, torch.float64, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    fstack = pyramid_sweep.stack_sweep_fields(cfg, fields)
    srcpos, _ = _sources(M, 2, torch.float64, cuda_device)
    nflux = torch.tensor([[1.0, 0.5, 0.2], [0.7, 0.3, 1.0]],
                         dtype=torch.float64, device=cuda_device)
    Rf, Rb = pyramid_sweep.trace_extents(M)
    k = pyramid_sweep.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb)
    p = pyramid_sweep.trace_plain(cfg, fstack, srcpos, nflux, Rf, Rb)
    assert float(p[0][..., 3].abs().max()) > 0.0
    _assert_traces_close(k, p, 1e-10)


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _traces(cfg, state, srcpos, nflux, radius, **kw):
    """(kernel, plain) traces of one sweep variant."""
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    fstack = pyramid_sweep.stack_sweep_fields(cfg, fields)
    Rf, Rb = pyramid_sweep.trace_extents(cfg.mesh, radius)
    return (pyramid_sweep.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb, **kw),
            pyramid_sweep.trace_plain(cfg, fstack, srcpos, nflux, Rf, Rb,
                                      **kw))


def _parts(trace):
    """rates, heat, photon loss, LLS loss and (tracked) band loss."""
    slab = trace[0]
    out = [slab[..., :3], slab[..., 3], trace[1], trace[2]]
    return out + ([trace[3]] if trace[3] is not None else [])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["lls", "track"])
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lls_and_track_sweep_kernels_match_plain(cuda_device, dtype, heating,
                                                  variant):
    """The per-cell LLS and band-tracking variants against the plain
    version: float64 within rtol 1e-10 of each part's largest value;
    float32 within twice the plain float32 version's error against the
    float64 plain result (plus 1e-6 of the largest value)."""
    M = 16
    rng = np.random.RandomState(3)
    lls64 = torch.as_tensor(10.0 ** rng.uniform(14.0, 17.0, M**3),
                            device=cuda_device)
    counter = "launches_lls" if variant == "lls" else "launches_track"
    parts = {}
    for dt in (torch.float64, dtype):
        cfg = _config(M, dt, cuda_device, S_star=1e48, heating=heating)
        kw = (dict(lls=lls64.to(dt)) if variant == "lls"
              else dict(track=True))
        state = _random_state(M, dt, cuda_device)
        srcpos, nflux = _sources(M, 3, dt, cuda_device)
        before = getattr(pyramid_sweep, counter)
        k, p = _traces(cfg.sweep, state, srcpos, nflux, 4, **kw)
        assert getattr(pyramid_sweep, counter) == before + 1
        parts[dt] = (_parts(k), _parts(p))
    (k64, p64), (k, p) = parts[torch.float64], parts[dtype]
    assert len(k64) == (5 if variant == "track" else 4)
    if variant == "lls":
        assert float(p64[3].abs().max()) > 0.0
    if heating:
        assert float(p64[1].abs().max()) > 0.0
    for a, b, ref in zip(k, p, p64):
        if dtype == torch.float64:
            torch.testing.assert_close(a, b, rtol=1e-10,
                                       atol=1e-10 * float(b.abs().max()))
        else:
            ek, ep = _rel_err(a.double(), ref), _rel_err(b.double(), ref)
            assert ek <= 2.0 * ep + 1e-6, (ek, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("ionized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_photon_loss_kernel_matches_plain(cuda_device, dtype, ionized):
    """The photon-loss kernel against the plain version on a tracked
    sweep's band escape, also on fully ionized cells (neutral fractions
    1e-20): float64 within rtol 1e-12, float32 within 1e-5 (47 positive
    terms summed in another order) and finite."""
    from c2ray_tpu_torch.sweep import photon_losses

    M = 16
    cfg = _config(M, dtype, cuda_device, S_star=1e48)
    sweep = dataclasses.replace(cfg.sweep, track_band_loss=True)
    state = _random_state(M, dtype, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    srcpos, nflux = _sources(M, 3, dtype, cuda_device)
    rates = pyramid_sweep.sweep_pyramid_source_batch(sweep, fields, srcpos,
                                                     nflux, radius=4)
    if ionized:
        tiny = torch.full_like(fields.h_av0, 1.0e-20)
        fields = fields._replace(h_av0=tiny, he_av0=tiny, he_av1=tiny)
    vos = sweep.vol / sweep.flux_scale

    def added(fn):
        z = lambda t: torch.zeros_like(t)
        out = fn(sweep.tables, rates._replace(
            phih=z(rates.phih), phihe0=z(rates.phihe0),
            phihe1=z(rates.phihe1)), fields, vos)
        return torch.stack([out.phih, out.phihe0, out.phihe1])

    before = photon_losses.launches
    k = added(photon_losses.distribute_photon_losses_cuda)
    assert photon_losses.launches == before + 1
    p = added(photon_losses.distribute_photon_losses_plain)
    assert bool(torch.isfinite(k).all()) and float(p.abs().max()) > 0.0
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(k, p, rtol=tol, atol=tol * float(p.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chemistry_kernel_matches_plain(cuda_device, dtype, heating):
    M = 16
    cfg = _config(M, dtype, cuda_device, heating=heating)
    state = _random_state(M, dtype, cuda_device, seed=6)
    srcpos, nflux = _sources(M, 3, dtype, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    rates = pyramid_sweep.sweep_pyramid_source_batch(cfg.sweep, fields,
                                                     srcpos, nflux)
    # heating: a step short enough that the f64 fixed point converges
    # well before the damped regime (tests/test_torch_chemistry.py)
    dt = 1.0e13 if heating else 1.0e14
    counts = lambda: (global_pass.launches, global_pass.launches_heat)
    before = counts()
    k = global_pass.chemistry_pass_cuda(cfg.chem, state, rates, dt)
    assert counts() == (before[0] + (not heating), before[1] + heating)
    p = global_pass.chemistry_pass_plain(cfg.chem, state, rates, dt)
    if dtype == torch.float64:
        assert (int(k[1]), int(k[2])) == (int(p[1]), int(p[2]))
    assert (int(k[3]) > 0) == heating
    # float32: a cell whose 1% convergence test flips stops one
    # fixed-point iteration apart; fractions are O(1), temperatures
    # compared relatively
    tol = 1e-10 if dtype == torch.float64 else 2e-2
    for a, b, name in zip(k[0], p[0], state._fields):
        atol = 0.0 if name.startswith("t_") else tol
        torch.testing.assert_close(a, b, rtol=tol, atol=atol, msg=name)


# the 1D variants of chip_smoke.py's phase 11: (test problem,
# isothermal, quadrature route, monochromatic tables, dt in Myr), on
# the problems of tests/test_onedim.py
_ONED = {
    "quadrature": (1, True, True, False, 10.0),
    "quadrature_heating": (1, False, True, False, 1.0),
    "table": (1, True, False, False, 10.0),
    "table_heating": (1, False, False, False, 1.0),
    "monochromatic": (1, True, True, True, 10.0),
    "test4": (4, True, True, False, 5.0),
}


def _oned_run(variant, mesh, dtype, device):
    testnum, iso, quad, mono, dt = _ONED[variant]
    if testnum == 4:
        problem = OneDProblem(testnum=4, dens_val=1.87e-7, temper_val=1e4,
                              zred00=9.0)
        r_out, S_star = 700.0, 3.0e50
    else:
        problem = OneDProblem(testnum=1, dens_val=1e-3, temper_val=1e4,
                              isothermal=iso)
        r_out, S_star = 10.0, 5.0e48
    sed = SEDConfig(bb=BlackBodySED(T_eff=1e5, S_star=S_star))
    run = OneDRun.setup(problem, RadialGrid(0.0, r_out * const.kpc, mesh),
                        sed, dtype=dtype, use_quadrature=quad,
                        device=device)
    if mono:
        # 13.6 eV: one band, K = 1, a zero HeI mask
        qt, _, bands = build_monochromatic_tables(
            sed, 13.6, isothermal=iso, dtype=dtype, device=device)
        run.ctx = dataclasses.replace(
            run.ctx, tables=qt, flux_scale=bands.flux_scale,
            vol=torch.as_tensor(run.grid.vol / bands.flux_scale,
                                dtype=dtype, device=device))
    return run, dt * 1e6 * const.YEAR


def _oned_counts():
    return (onedim_evolve.launches, onedim_evolve.launches_heat,
            onedim_evolve.launches_table, onedim_evolve.launches_table_heat)


def test_1d_plain_path_launches_no_kernel():
    before = _oned_counts()
    run, dt = _oned_run("table_heating", 8, torch.float64, "cpu")
    nits = run.step(dt)
    assert _oned_counts() == before
    assert int(nits.min()) >= 1 and int(run.last_counters[2]) > 0


def test_1d_kernel_wrapper_refuses_cpu_tensors():
    run, dt = _oned_run("quadrature", 8, torch.float64, "cpu")
    before = _oned_counts()
    with pytest.raises(ValueError, match="CUDA"):
        onedim_evolve.evolve1d_cuda(run.ctx, run.state, dt)
    assert _oned_counts() == before


def test_1d_kernel_tables_are_packed_once():
    """The kernel's table inputs are packed once and kept on the
    context: test 4's per-step context (new dr and volumes) reuses them,
    a context made with other tables gets its own, never stale rows."""
    cpu = torch.device("cpu")
    run, _ = _oned_run("test4", 8, torch.float64, "cpu")
    kt = onedim_evolve._kernel_tables(run.ctx, torch.float64, cpu)
    nbt, K, ntypes = kt.layout[:3]
    assert kt.bands.shape == (nbt, 5 + 2 * K) and ntypes == 1
    assert kt.hbin is None and kt.photo is None and kt.cool is None
    moved = dataclasses.replace(run.ctx, dr=2.0 * run.ctx.dr,
                                vol=2.0 * run.ctx.vol)
    assert onedim_evolve._kernel_tables(moved, torch.float64, cpu) is kt
    mono, _ = _oned_run("monochromatic", 8, torch.float64, "cpu")
    swapped = dataclasses.replace(run.ctx, tables=mono.ctx.tables)
    km = onedim_evolve._kernel_tables(swapped, torch.float64, cpu)
    assert km.layout[:3] == (1, 1, 1) and km.bands.shape == (1, 7)
    heat, _ = _oned_run("table_heating", 8, torch.float64, "cpu")
    kh = onedim_evolve._kernel_tables(heat.ctx, torch.float32, cpu)
    nb = heat.ctx.tables.sigma_HI.shape[0]
    assert kh.bands.shape == (nb, 17) and kh.hbin.shape == (nb, 3)
    assert kh.photo.shape == (1, 2, 2001, nb)
    assert kh.heat.shape == (1, 2, 2001, kh.layout[-1])
    assert kh.cool.shape == (801, 5) and kh.cool.dtype == torch.float32


def _oned_errors(state, ref):
    """Largest |difference| of the fractions and relative one of the
    temperatures from the float64 reference state."""
    frac = max(float((getattr(state, f).double().cpu()
                      - getattr(ref, f)).abs().max()) for f in ("xh", "xhe"))
    temp = float(((state.temper.double().cpu() - ref.temper).abs()
                  / ref.temper).max())
    return frac, temp


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("variant", sorted(_ONED))
def test_evolve1d_kernel_matches_plain(cuda_device, variant, dtype):
    """Two timesteps at mesh 64 through the kernel and the plain version
    (on the CPU).  float64: rtol 1e-10 (fractions with a 1e-12 floor)
    and every shell's iteration count equal.  float32: the kernel's error
    against the plain float64 run within twice the plain float32 run's
    plus 1e-5 (the lanes add the bands in another order, and FMA
    contraction rounds the columns differently)."""
    mesh = 64
    kern, dt = _oned_run(variant, mesh, dtype, cuda_device)
    plain, _ = _oned_run(variant, mesh, dtype, "cpu")
    ref, _ = (_oned_run(variant, mesh, torch.float64, "cpu")
              if dtype == torch.float32 else (plain, None))
    for _ in range(2):
        before = _oned_counts()
        nk = kern.step(dt)
        torch.cuda.synchronize()
        assert sum(_oned_counts()) == sum(before) + 1
        n_plain = plain.step(dt)
        if ref is not plain:
            ref.step(dt)
        assert int(kern.last_counters[0]) == int(nk.sum())
        if dtype == torch.float64:
            assert torch.equal(nk.cpu(), n_plain)
            for f in ("xh", "xhe", "temper"):
                torch.testing.assert_close(
                    getattr(kern.state, f).cpu(), getattr(plain.state, f),
                    rtol=1e-10, atol=0.0 if f == "temper" else 1e-12,
                    msg=f)
        else:
            frac_k, temp_k = _oned_errors(kern.state, ref.state)
            frac_p, temp_p = _oned_errors(plain.state, ref.state)
            assert frac_k <= 2.0 * frac_p + 1e-5, (frac_k, frac_p)
            assert temp_k <= 2.0 * temp_p + 1e-5, (temp_k, temp_p)


# ---- the L1-shell and skewed-octant sweep kernels

_SHELL_CASES = {"even": (16, None), "odd": (17, None), "subbox": (16, 5)}


def _engine_counts():
    return (source_sweep.launches, source_sweep.launches_heat,
            octant_sweep.launches, octant_sweep.launches_heat)


def test_shell_and_octant_plain_paths_launch_no_kernel():
    """CPU tensors take the plain versions; the kernel wrappers refuse
    them."""
    before = _engine_counts()
    for engine, M in (("shells", 9), ("octant", 8)):
        cfg = dataclasses.replace(_config(M, torch.float64, "cpu"),
                                  engine=engine, max_iterations=2)
        srcpos, nflux = _sources(M, 2, torch.float64, "cpu")
        state = initial_grid_state(np.full((M,) * 3, 1e-4), 0.0, 0.0, 0.0,
                                   1e4)
        new, stats = evolve3d(cfg, state, srcpos, nflux, 1.0e14)
        assert stats.n_iterations >= 2 and stats.subbox_radius == 0
        assert bool(torch.isfinite(new.h1).all())
    assert _engine_counts() == before
    M = 8
    cfg = _config(M, torch.float64, "cpu")
    state = _random_state(M, torch.float64, "cpu")
    fstack = pyramid_sweep.stack_sweep_fields(cfg.sweep, SourceFields(
        state.ndens, state.h_av0, state.h_av1, state.he_av0, state.he_av1))
    srcpos, nflux = _sources(M, 1, torch.float64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        source_sweep.shell_sweep_cuda(cfg.sweep, build_shell_table(M),
                                       fstack, srcpos, nflux)
    with pytest.raises(ValueError, match="CUDA"):
        octant_sweep.octant_sweep_cuda(cfg.sweep, fstack, srcpos, nflux)
    assert _engine_counts() == before


def _engine_traces(engine, cfg, table, state, srcpos, nflux):
    """(kernel, plain) traces of the shell or octant engine as
    (slab, photon loss, LLS loss)."""
    fstack = pyramid_sweep.stack_sweep_fields(cfg, SourceFields(
        state.ndens, state.h_av0, state.h_av1, state.he_av0, state.he_av1))
    if engine == "shells":
        return tuple(fn(cfg, table, fstack, srcpos, nflux)
                     for fn in (source_sweep.shell_sweep_cuda,
                                source_sweep.shell_sweep_plain))
    out = []
    for fn in (octant_sweep.octant_sweep_cuda,
               octant_sweep.octant_sweep_plain):
        slab, ploss = fn(cfg, fstack, srcpos, nflux)
        out.append((slab, ploss, torch.zeros_like(ploss)))
    return tuple(out)


@pytest.mark.gpu
@pytest.mark.parametrize("lls", [0.0, 1.0e15])
@pytest.mark.parametrize("case", ["even", "odd", "subbox", "octant"])
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_shell_and_octant_kernels_match_plain(cuda_device, dtype, heating,
                                              case, lls):
    """The shell kernel at 16^3 (full extents), 17^3 (odd) and 16^3
    under a radius-5 table, and the octant kernel at 16^3, against their
    plain versions on the same inputs: float64 within rtol 1e-10 of
    each part's largest value; float32 within twice the plain float32
    version's error against the float64 plain result, plus 1e-5."""
    engine = "octant" if case == "octant" else "shells"
    M, radius = _SHELL_CASES.get(case, (16, None))
    table = build_shell_table(M, radius)
    parts = {}
    for dt in (torch.float64, dtype):
        cfg = dataclasses.replace(
            _config(M, dt, cuda_device, S_star=1e48, heating=heating).sweep,
            coldensh_LLS=lls)
        state = _random_state(M, dt, cuda_device)
        srcpos, nflux = _sources(M, 3, dt, cuda_device)
        before = _engine_counts()
        k, p = _engine_traces(engine, cfg, table, state, srcpos, nflux)
        i = (0 if engine == "shells" else 2) + heating
        assert _engine_counts()[i] == before[i] + 1
        assert sum(_engine_counts()) == sum(before) + 1
        parts[dt] = (_parts(k + (None,)), _parts(p + (None,)))
    (k64, p64), (k, p) = parts[torch.float64], parts[dtype]
    if heating:
        assert float(p64[1].abs().max()) > 0.0
    assert (float(p64[3].abs().max()) > 0.0) == (lls > 0.0
                                                 and engine == "shells")
    for a, b, ref in zip(k, p, p64):
        if dtype == torch.float64:
            torch.testing.assert_close(a, b, rtol=1e-10,
                                       atol=1e-10 * float(b.abs().max()))
        else:
            ek, ep = _rel_err(a.double(), ref), _rel_err(b.double(), ref)
            assert ek <= 2.0 * ep + 1e-5, (ek, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("heating", [False, True])
def test_three_engine_kernels_agree(cuda_device, heating):
    """At full extents the shell, octant and pyramid kernels compute one
    function: float64 rates, heat and photon loss within rtol 1e-10
    (the JAX package's own pyramid-vs-octant tolerance)."""
    M = 16
    cfg = _config(M, torch.float64, cuda_device, S_star=1e48,
                  heating=heating).sweep
    state = _random_state(M, torch.float64, cuda_device)
    fstack = pyramid_sweep.stack_sweep_fields(cfg, SourceFields(
        state.ndens, state.h_av0, state.h_av1, state.he_av0, state.he_av1))
    srcpos, nflux = _sources(M, 3, torch.float64, cuda_device)
    Rf, Rb = pyramid_sweep.trace_extents(M)
    pyr = pyramid_sweep.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb)
    shell = source_sweep.shell_sweep_cuda(cfg, build_shell_table(M), fstack,
                                           srcpos, nflux)
    octant = octant_sweep.octant_sweep_cuda(cfg, fstack, srcpos, nflux)
    for other in (shell, octant):
        for a, b in ((other[0][..., :3], pyr[0][..., :3]),
                     (other[0][..., 3], pyr[0][..., 3]), (other[1], pyr[1])):
            torch.testing.assert_close(a, b, rtol=1e-10,
                                       atol=1e-10 * float(b.abs().max()))


# ---- the domain decomposition's halo kernels (csrc/domain_halo.cu)

def _halo_case(M, D, radius, dtype, device, C, seed=4):
    """A rank's inputs at a slab shape: its field slabs (a fifth of the
    fractions 0, below epsilon), received halos, a rate slab, three
    windows and cubes, and the received fold chunks."""
    from c2ray_tpu_torch.parallel import domain

    S = M // D
    Mw, _, H = domain._window_geometry(M, radius)
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    u = lambda *shape: t(rng.uniform(size=shape))
    n = S * M * M
    fields = [t(rng.uniform(1e-4, 1e-2, n))]
    fields += [t(np.where(rng.uniform(size=n) < 0.2, 0.0,
                          rng.uniform(size=n))) for _ in range(4)]
    fields += [t(rng.uniform(0.0, 1e18, n)) for _ in range(C - 5)]
    rc = u(S + 2 * H, M + 2 * H, M + 2 * H, 4)
    starts = [tuple(int(rng.randint(0, e - Mw + 1)) for e in rc.shape[:3])
              for _ in range(3)]
    chunks, b0 = [], 0
    for _, lo, hi, at in domain._fold_messages(S, H):
        chunks.append((b0, at, hi - lo))
        b0 += hi - lo
    return dict(S=S, H=H, fields=fields, left=u(H, M, M, C),
                right=u(H, M, M, C), rc=rc, starts=starts,
                cubes=[u(Mw, Mw, Mw, 4) for _ in starts], recv=u(b0, M, M, 4),
                chunks=chunks)


def test_halo_plain_paths_launch_no_kernel():
    from c2ray_tpu_torch.parallel import halo

    c = _halo_case(8, 2, 2, torch.float64, "cpu", 5)
    S, H = c["S"], c["H"]
    before = (halo.launches_pack, halo.launches_accumulate,
              halo.launches_fold)
    pf = halo.halo_pack(c["fields"], 8, 1e-20, c["left"], c["right"], H)
    halo.window_accumulate(c["rc"], c["cubes"][0], c["starts"][0])
    r4 = halo.fold_halo(c["rc"], 8, (H, H + S), c["recv"], c["chunks"])
    assert pf.shape == (S + 2 * H, 8 + 2 * H, 8 + 2 * H, 5)
    assert r4.shape == (4, S * 64)
    assert (halo.launches_pack, halo.launches_accumulate,
            halo.launches_fold) == before


@pytest.mark.gpu
@pytest.mark.parametrize("C", [5, 6])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(32, 8, 5), (128, 1, 64)])
def test_halo_kernels_match_plain(cuda_device, shape, dtype, C):
    """Each halo kernel equals its plain version to the bit (copies, a
    max and adds in the plain version's order), at the slab shapes of 8
    ranks at 32^3 radius 5 (S = 4, H = 6) and of one rank at 128^3, full
    radius (S = 128, H = 64)."""
    from c2ray_tpu_torch.parallel import halo

    M, D, radius = shape
    c = _halo_case(M, D, radius, dtype, cuda_device, C)
    S, H = c["S"], c["H"]
    before = (halo.launches_pack, halo.launches_accumulate,
              halo.launches_fold)
    for planes in (None, (max(0, S - H), S), (0, min(H, S))):
        args = (c["fields"], M, 1e-20) + ((c["left"], c["right"], H)
                                          if planes is None else
                                          (None, None, 0, planes))
        assert torch.equal(halo.halo_pack_cuda(*args),
                           halo.halo_pack_plain(*args))
    rk, rp = c["rc"].clone(), c["rc"].clone()
    for st, cube in zip(c["starts"], c["cubes"]):
        halo.window_accumulate_cuda(rk, cube, st)
        halo.window_accumulate_plain(rp, cube, st)
    assert torch.equal(rk, rp)
    fold = (c["rc"], M, (H, H + S), c["recv"], c["chunks"])
    assert torch.equal(halo.fold_halo_cuda(*fold), halo.fold_halo_plain(*fold))
    for planes in ((0, H), (S + H, S + 2 * H)):
        sent = (c["rc"], M, planes, None, (), False)
        assert torch.equal(halo.fold_halo_cuda(*sent),
                           halo.fold_halo_plain(*sent))
    torch.cuda.synchronize()
    assert (halo.launches_pack - before[0], halo.launches_accumulate
            - before[1], halo.launches_fold - before[2]) == (3, 3, 3)
