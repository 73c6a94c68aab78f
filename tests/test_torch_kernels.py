"""The port's packaging and its kernels; this file imports no JAX.

CPU: importing the port leaves JAX unloaded, CPU tensors never reach a
kernel (the launch counters stay at 0), and `chip_smoke.py` refuses to
run without a GPU.  Card (marker `gpu`, skipped without CUDA): each
kernel against its plain version on the same inputs.  On a GPU machine
without JAX, run the card tests with

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""

import collections
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
from c2ray_tpu_torch.utils.clocks import counter
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
            "sys.path.insert(0, 'tools')\n"
            "for t in ('table_write_torch', 'bench_scaling_torch'):\n"
            "    importlib.import_module(t)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax'\n"
            "             or k.startswith(('jax.', 'c2ray_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _launches(*names):
    """The launch counters launches.<name> of the program's store."""
    return tuple(counter("launches." + n) for n in names)


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
    names = ("pyramid_sweep", "group_accumulate", "chemistry")
    before = _launches(*names)
    new, stats = evolve3d(cfg, state, srcpos, nflux, 1.0e14)
    assert _launches(*names) == before
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
    before = _launches("pyramid_sweep", "chemistry")
    with pytest.raises(ValueError, match="CUDA"):
        pyramid_sweep.trace_cuda(cfg.sweep, fstack, srcpos, nflux, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        global_pass.chemistry_pass_cuda(cfg.chem, state, rates, 1.0e14)
    assert _launches("pyramid_sweep", "chemistry") == before


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
    counts = lambda: _launches("pyramid_sweep.heat", "chemistry.heat")
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


def _three_type_config(M, dtype, device, n_nodes=6, heating=True):
    """Blackbody, power-law and QSO sources with heating tables (the
    power laws over all 47 bands, from the HI threshold up): in f64 at
    K = 6 the 127 band rows exceed the default 48 KB of shared memory."""
    lo = const.ion_freq_HI
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48),
                  pl=PowerLawSED(index=2.5, S_star=1e47, min_freq=lo),
                  qso=PowerLawSED(index=1.8, S_star=1e47, min_freq=lo)),
        isothermal=not heating, dtype=dtype, device=device, n_nodes=n_nodes)
    return SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                       isothermal=not heating, flux_scale=bands.flux_scale,
                       has_pl=True, has_qso=True)


def _few_bands_config(M, dtype, device, n_nodes, heating):
    """A blackbody over 33 bands (no multiple of a cell's lane group) and
    a power law over 1 (fewer than the lanes of a cell)."""
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48),
                  pl=PowerLawSED(index=2.5, S_star=1e47,
                                 min_freq=60.0 * const.ion_freq_HeII,
                                 max_freq=65.0 * const.ion_freq_HeII)),
        isothermal=not heating, dtype=dtype, device=device, n_nodes=n_nodes)
    assert tables.bb.band_hi - tables.bb.band_lo + 1 == 33
    assert tables.pl.band_hi - tables.pl.band_lo + 1 == 1
    return SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                       isothermal=not heating, flux_scale=bands.flux_scale,
                       has_pl=True)


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


# Two band loops as `cuobjdump -sass` prints them (the encodings cut).
# Unrolled, K = 2: a type loop around a band loop with 2K = 4 MUFU.EX2,
# and the unreachable branch-to-self after EXIT.  Branching, K = 1: a
# thick path (2 MUFU.EX2, one FFMA.SAT) and a thin one (1), and a
# division's slow path through a call.
_SASS_UNROLLED = """
        Function : _Z4bandPf
        /*0000*/                   S2R R0, SR_TID.X ;  /* 0x0000000000007919 */
        /*0010*/                   MOV R1, RZ ;
        /*0020*/                   FMUL R2, R1, R1 ;
        /*0030*/                   MUFU.EX2 R3, R2 ;
        /*0040*/                   MUFU.EX2 R4, R2 ;
        /*0050*/                   FFMA R5, R3, R4, R5 ;
        /*0060*/                   MUFU.RCP R6, R5 ;
        /*0070*/                   MUFU.EX2 R7, R2 ;
        /*0080*/                   MUFU.EX2 R8, R2 ;
        /*0090*/                   ISETP.GE.AND P0, PT, R1, 0x4, PT ;
        /*00a0*/              @!P0 BRA 0x20 ;
        /*00b0*/                   IADD3 R1, R1, 0x1, RZ ;
        /*00c0*/                   ISETP.GE.AND P1, PT, R1, 0x3, PT ;
        /*00d0*/              @!P1 BRA 0x10 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0;
"""
_SASS_BRANCHING = """
        Function : _Z6branchPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   FMUL R2, R1, R1 ;
        /*0020*/                   MUFU.RCP R6, R5 ;
        /*0030*/                   FCHK P2, R5, R6 ;
        /*0040*/               @P2 BRA 0x100 ;
        /*0050*/                   FSETP.GT.AND P0, PT, R2, 1, PT ;
        /*0060*/              @!P0 BRA 0xc0 ;
        /*0070*/                   MUFU.EX2 R3, R2 ;
        /*0080*/                   MUFU.EX2 R4, R2 ;
        /*0090*/                   FFMA.SAT R7, R3, R4, R5 ;
        /*00a0*/                   FFMA R5, R7, R8, R5 ;
        /*00b0*/                   BRA 0xd0 ;
        /*00c0*/                   MUFU.EX2 R3, R2 ;
        /*00d0*/                   ISETP.GE.AND P1, PT, R1, 0x4, PT ;
        /*00e0*/              @!P1 BRA 0x10 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   MOV R9, R5 ;
        /*0110*/                   CALL.REL.NOINC 0x130 ;
        /*0120*/                   BRA 0x50 ;
        /*0130*/                   FADD R5, R5, 1 ;
        /*0140*/                   RET.REL.NODEC R20 0x0 ;
"""


@pytest.mark.parametrize("listing, n_ex2, mix", [
    (_SASS_UNROLLED, 4, dict(ex2=4, fp32=2, rcp=1, expf_reduction=0,
                             total=9)),
    # header 4 + the test 2 + the thick path 5 + the loop test 2
    (_SASS_BRANCHING, 2, dict(ex2=2, fp32=2 + 1 + 2, rcp=1,
                              expf_reduction=1, total=4 + 2 + 5 + 2)),
])
def test_sass_band_mix_counts_one_band(listing, n_ex2, mix):
    """chip_smoke.py's counter of the sweep kernels' band loop: one pass
    through the innermost loop holding n_ex2 MUFU.EX2, on the path with
    the most of them and the fewest instructions (the thick band, the
    division's fast path)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.sass_band_mix(listing, n_ex2) == mix


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
    counts = lambda: _launches("pyramid_sweep", "pyramid_sweep.heat")
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
    name = "launches.pyramid_sweep." + variant
    parts = {}
    for dt in (torch.float64, dtype):
        cfg = _config(M, dt, cuda_device, S_star=1e48, heating=heating)
        kw = (dict(lls=lls64.to(dt)) if variant == "lls"
              else dict(track=True))
        state = _random_state(M, dt, cuda_device)
        srcpos, nflux = _sources(M, 3, dt, cuda_device)
        before = counter(name)
        k, p = _traces(cfg.sweep, state, srcpos, nflux, 4, **kw)
        assert counter(name) == before + 1
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

    before = counter("launches.photon_losses")
    k = added(photon_losses.distribute_photon_losses_cuda)
    assert counter("launches.photon_losses") == before + 1
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
    counts = lambda: _launches("chemistry", "chemistry.heat")
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


def _bands_of(tables, nb):
    """The photon-loss inputs of the first nb bands of `tables` (all
    of them at nb = 47)."""
    import types

    keys = ("sigma_HI", "sigma_HeI", "mask_HeI", "sigma_HeII", "mask_HeII")
    if nb == tables.sigma_HI.shape[0]:
        return tables
    return types.SimpleNamespace(**{k: torch.cat(
        [getattr(tables, k)] * 2)[:nb] for k in keys})


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["whole", "strided"])
@pytest.mark.parametrize("nb", [47, 5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_photon_loss_kernel_band_counts_and_row_layouts(cuda_device, dtype,
                                                        nb, layout):
    """The redesigned photon-loss kernel (band table in the constant
    bank, unrolled in groups of 8) at the bench's 47 bands and at 5, on
    the sweep's (n, 4) rate rows (one 16-byte load and store a cell in
    float32) and on three separate rows (strided read-modify-writes),
    against the plain version: float64 within rtol 1e-12, float32 within
    1e-5 (47 positive terms in another order, a reciprocal within an
    ulp); the table packed on the card equals band_table's, phiheat
    keeps its bits, and two calls are equal to the bit."""
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
    tables = _bands_of(sweep.tables, nb)
    plb = rates.photon_loss_bands[:nb]
    vos = sweep.vol / sweep.flux_scale
    n = M**3

    def fresh():
        if layout == "whole":
            slab = torch.zeros((n, 4), dtype=dtype, device=cuda_device)
            slab[:, 3] = rates.phiheat
            g = [slab[:, k] for k in range(4)]
        else:
            rows = torch.zeros((3, n), dtype=dtype, device=cuda_device)
            g = [rows[0], rows[1], rows[2], rates.phiheat.clone()]
        return rates._replace(phih=g[0], phihe0=g[1], phihe1=g[2],
                              phiheat=g[3], photon_loss_bands=plb)

    added = lambda r: torch.stack([r.phih, r.phihe0, r.phihe1])
    before = counter("launches.photon_losses")
    r1 = photon_losses.distribute_photon_losses_cuda(tables, fresh(), fields,
                                                     vos)
    r2 = fresh()
    tab = photon_losses._launch(tables, r2, fields, vos,
                                photon_losses.DENSITY_FLOOR)
    assert counter("launches.photon_losses") == before + 2
    # the table the entry packs on the card is band_table's, to the bit
    assert torch.equal(tab, photon_losses.band_table(tables, plb, n, vos,
                                                     dtype))
    p = added(photon_losses.distribute_photon_losses_plain(
        tables, fresh(), fields, vos))
    k = added(r1)
    assert bool(torch.isfinite(k).all()) and float(p.abs().max()) > 0.0
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(k, p, rtol=tol, atol=tol * float(p.abs().max()))
    assert torch.equal(k, added(r2))
    assert torch.equal(r1.phiheat, rates.phiheat)


@pytest.mark.gpu
def test_photon_loss_kernel_refuses_more_bands_than_its_capacity(
        cuda_device):
    """49 bands do not fit the kernel's constant bank: ValueError, no
    launch."""
    from c2ray_tpu_torch.sweep import photon_losses

    M = 8
    cfg = _config(M, torch.float32, cuda_device, S_star=1e48)
    state = _random_state(M, torch.float32, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    nb = photon_losses.MAX_BANDS + 1
    z = torch.zeros(M**3, dtype=torch.float32, device=cuda_device)
    rates = source_sweep.RateGrids(
        z, z.clone(), z.clone(), z.clone(), z.sum(), z.sum(),
        torch.ones(nb, dtype=torch.float32, device=cuda_device))
    before = counter("launches.photon_losses")
    with pytest.raises(ValueError, match="at most"):
        photon_losses.distribute_photon_losses_cuda(
            _bands_of(cfg.sweep.tables, nb), rates, fields, 1.0)
    assert counter("launches.photon_losses") == before


def _front_pass(M, dtype, device, heating, clump, n_cells, seed=11):
    """(config, state, rates, dt) of a chemistry pass across ionization
    fronts: a neutral grid (densities 0.5-1.5e-3, T 1e4 K; clumping 1 or
    1-3 per cell, with clump "strided" a view of every other element of a
    row twice as long) after one plain pass under three sources, then a
    sweep of that state; the first n_cells cells only."""
    cfg = _config(M, dtype, device, S_star=3e50, heating=heating)
    rng = np.random.RandomState(seed)
    n = M**3
    clumping = 1.0 if clump == "uniform" else rng.uniform(1.0, 3.0, n)
    state = initial_grid_state(1e-3 * rng.uniform(0.5, 1.5, n), 1e-4, 1e-4,
                               0.0, 1.0e4, clumping=clumping, dtype=dtype,
                               device=device)
    srcpos, nflux = _sources(M, 3, dtype, device, seed=seed)
    dt = 1.0e13 if heating else 1.0e14

    def rates_of(s):
        return pyramid_sweep.sweep_pyramid_source_batch(
            cfg.sweep, SourceFields(s.ndens, s.h_av0, s.h_av1, s.he_av0,
                                    s.he_av1), srcpos, nflux)

    state = global_pass.chemistry_pass_plain(cfg.chem, state,
                                             rates_of(state), dt)[0]
    rates = rates_of(state)
    cut = lambda t: t[:n_cells] if t.ndim and t.shape[0] == n else t
    state = type(state)(*(cut(t) for t in state))
    if clump == "strided":
        wide = torch.zeros((n_cells, 2), dtype=dtype, device=device)
        wide[:, 0] = state.clumping
        state = state._replace(clumping=wide[:, 0])
    return (cfg, state,
            type(rates)(*(None if t is None else cut(t) for t in rates)), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("ccf", [0.0, 1.0e-16])
@pytest.mark.parametrize("clump", ["uniform", "cells", "strided"])
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chemistry_kernel_across_ionization_fronts(cuda_device, dtype,
                                                   heating, clump, ccf):
    """The redesigned chemistry kernel (a persistent grid whose lanes
    take the next cell when theirs converges) on a pass across
    ionization fronts, where cells of one warp take different numbers of
    iterations and sub-steps, on 4093 cells (no multiple of a block or a
    warp), the rates strided views of the sweep's slab, a per-cell
    clumping contiguous or a strided view: float64 within
    rtol 1e-10 of the plain version with conv_flag, the largest
    iteration count and the largest sub-step count equal; float32 within
    2e-2 (a cell whose 1% test flips stops one iteration apart); two
    calls equal to the bit."""
    cfg, state, rates, dt = _front_pass(16, dtype, cuda_device, heating,
                                        clump, 4093)
    assert rates.phih.stride(0) == 4
    assert state.clumping.numel() == (1 if clump == "uniform" else 4093)
    if clump != "uniform":
        assert state.clumping.stride(0) == (2 if clump == "strided" else 1)
    k = global_pass.chemistry_pass_cuda(cfg.chem, state, rates, dt, ccf)
    k2 = global_pass.chemistry_pass_cuda(cfg.chem, state, rates, dt, ccf)
    p = global_pass.chemistry_pass_plain(cfg.chem, state, rates, dt, ccf)
    assert [int(x) for x in k[1:]] == [int(x) for x in k2[1:]]
    for a, b in zip(k[0], k2[0]):
        assert torch.equal(a, b)
    assert int(p[2]) >= 2 and (int(p[3]) >= 2) == heating
    if dtype == torch.float64:
        assert [int(x) for x in k[1:]] == [int(x) for x in p[1:]]
    tol = 1e-10 if dtype == torch.float64 else 2e-2
    for a, b, name in zip(k[0], p[0], state._fields):
        atol = 0.0 if name.startswith("t_") else tol
        torch.testing.assert_close(a, b, rtol=tol, atol=atol, msg=name)


# the 1D variants of chip_smoke.py's phase 11: (test problem,
# isothermal, quadrature route, monochromatic tables, dt in Myr), on
# the problems of tests/test_onedim.py; the "cold" heating runs start
# at _ONED_COLD_T0 instead of 1e4 K, so that shells heat through
# rate_coefficients' 9000 K switch (test_1d_cold_heating_cases_*)
_ONED = {
    "quadrature": (1, True, True, False, 10.0),
    "quadrature_heating": (1, False, True, False, 1.0),
    "quadrature_heating_cold": (1, False, True, False, 1.0),
    "table": (1, True, False, False, 10.0),
    "table_heating": (1, False, False, False, 1.0),
    "table_heating_cold": (1, False, False, False, 1.0),
    "monochromatic": (1, True, True, True, 10.0),
    "test4": (4, True, True, False, 5.0),
    "auto": (1, True, True, False, 10.0),
    "auto_heating": (1, False, True, False, 1.0),
}
_ONED_COLD_T0 = 100.0


def _oned_run(variant, mesh, dtype, device):
    testnum, iso, quad, mono, dt = _ONED[variant]
    if testnum == 4:
        problem = OneDProblem(testnum=4, dens_val=1.87e-7, temper_val=1e4,
                              zred00=9.0)
        r_out, S_star = 700.0, 3.0e50
    else:
        t0 = _ONED_COLD_T0 if variant.endswith("_cold") else 1e4
        problem = OneDProblem(testnum=1, dens_val=1e-3, temper_val=t0,
                              isothermal=iso)
        r_out, S_star = 10.0, 5.0e48
    sed = SEDConfig(bb=BlackBodySED(T_eff=1e5, S_star=S_star))
    run = OneDRun.setup(problem, RadialGrid(0.0, r_out * const.kpc, mesh),
                        sed, dtype=dtype, use_quadrature=quad,
                        device=device)
    if mono or variant.startswith("auto"):
        # mono: 13.6 eV, one band, K = 1, a zero HeI mask; "auto": the
        # 1e5 K blackbody's 7 blocks of K = 12, 3, 4, 3, 5, 8, 8
        qt, _, bands = (build_monochromatic_tables(
            sed, 13.6, isothermal=iso, dtype=dtype, device=device) if mono
            else build_quadrature_tables(sed, isothermal=iso, dtype=dtype,
                                         device=device, n_nodes="auto"))
        run.ctx = dataclasses.replace(
            run.ctx, tables=qt, flux_scale=bands.flux_scale,
            vol=torch.as_tensor(run.grid.vol / bands.flux_scale,
                                dtype=dtype, device=device))
    return run, dt * 1e6 * const.YEAR


def _oned_counts():
    return _launches("evolve1d", "evolve1d.heat", "evolve1d.table",
                     "evolve1d.table.heat", "evolve1d.auto",
                     "evolve1d.auto.heat")


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


def test_1d_cold_heating_cases_cross_the_switches():
    """The cold heating cases (T0 = 100 K) reach the branches that the
    kernel's fixed point reorders: within one shell's iterations the
    rate fits see temperatures below and above rate_coefficients' 9000 K
    switch, and bands cross TAU_PHOTO_LIMIT and TAU_HEAT_LIMIT between
    iterations (the plain version, one step at mesh 64, recorded)."""
    from c2ray_tpu_torch.radiation.photo import (TAU_HEAT_LIMIT,
                                                 TAU_PHOTO_LIMIT)

    for variant in ("quadrature_heating_cold", "table_heating_cold"):
        run, dt = _oned_run(variant, 64, torch.float64, "cpu")
        tb = run.ctx.tables
        sig = torch.stack([tb.sigma_HI, tb.sigma_HeI, tb.sigma_HeII], -1)
        calls, temps = [], collections.defaultdict(list)
        photorates, fits = (onedim_evolve._cell_photorates,
                            onedim_evolve.rate_coefficients)
        last = [None]     # the shell of the iteration under way

        def record_rates(ctx, cd_in, cc, vol, h1):
            cin = torch.stack(list(cd_in))
            calls.append((tuple(cin.tolist()),
                          (cin + torch.stack(list(cc))) @ sig.T
                          - cin @ sig.T))
            last[0] = calls[-1][0]
            return photorates(ctx, cd_in, cc, vol, h1)

        def record_fits(t):
            # a shell calls the fits once before its loop (at its first
            # iteration's temperature), then once in each iteration,
            # after the photo rates: those are recorded under the shell
            if last[0] is not None:
                temps[last[0]].append(float(t))
                last[0] = None
            return fits(t)

        onedim_evolve._cell_photorates = record_rates
        onedim_evolve.rate_coefficients = record_fits
        try:
            run.step(dt)
        finally:
            onedim_evolve._cell_photorates = photorates
            onedim_evolve.rate_coefficients = fits
        flips = {TAU_PHOTO_LIMIT: 0, TAU_HEAT_LIMIT: 0}
        for (cin, dtau), (cin1, dtau1) in zip(calls, calls[1:]):
            if cin == cin1:       # the same shell's next iteration
                for lim in flips:
                    flips[lim] += int(((dtau.abs() > lim)
                                       != (dtau1.abs() > lim)).sum())
        assert min(flips.values()) > 0, (variant, flips)
        # a shell whose iterations straddle 9000 K
        assert any(min(ts) < 9.0e3 < max(ts) for ts in temps.values()), \
            variant
        assert float(run.state.temper.max()) > 9.0e3 > _ONED_COLD_T0


def test_oned_split_stamps_fit_the_kernel():
    """tools/profile_torch_iteration.py --oned times the parts of the 1D
    march in a copy of csrc/evolve1d.cu with clock64() stamps: each
    stamp finds its one place in the kernel as it stands, the stamps
    run in the order of an iteration, and the copy is the kernel plus
    the stamps; a kernel without a stamp's place raises."""
    import re

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_torch_iteration as pti

    src = (cuda_build.CSRC / "evolve1d.cu").read_text()
    out = pti.stamp_evolve1d(src)
    body = out[out.index("SPLIT_INIT();"):out.index("SPLIT_STORE();")]
    assert re.findall(r"SPLIT\((\w+)\);", body) == [
        "kSplitShell", "kSplitIn", "kSplitFits", "kSplitOut",
        "kSplitReduce", "kSplitDoric", "kSplitThermal", "kSplitConv"]
    assert out.index("SPLIT_STORE();") < out.index("a.counters[0] = it_sum")
    bare = re.sub(r"\n *SPLIT(_INIT|_STORE)?\(\w*\);", "",
                  out.replace(pti._SPLIT_DEFS, "")
                  .replace(pti._SPLIT_ENTRY, ""))
    assert bare == src
    with pytest.raises(RuntimeError, match="places for a stamp"):
        pti.stamp_evolve1d(src.replace("++nit;", "nit += 1;"))


def test_oned_block_stamps_fit_band_rates():
    """--oned --auto also stamps each pass of the "auto" route in a copy
    of csrc/band_rates.cuh: the row deal's design ("rows") fits this
    tree, each stamp in its one place, begin before end, outgoing and
    incoming; the copy is the header plus the stamps; a header that no
    design fits raises."""
    import re

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_torch_iteration as pti

    src = (cuda_build.CSRC / "band_rates.cuh").read_text()
    out, design = pti.stamp_band_rates(src)
    assert design == "rows"
    assert re.findall(r"BLOCK_SPLIT_(BEGIN|END)\((.*?)\);", out) == [
        ("BEGIN", ""), ("END", "kSplitBlocks + s"), ("BEGIN", ""),
        ("END", "s")]
    bare = re.sub(r"\n *BLOCK_SPLIT_(BEGIN|END)\(.*?\);", "",
                  out.replace(pti._BLOCK_SPLIT_DEFS, ""))
    assert bare == src
    with pytest.raises(RuntimeError, match="no design"):
        pti.stamp_band_rates(src.replace("row_in<", "row_in_<"))


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
    """Two timesteps at mesh 64 (the "auto" tables, whose rows the
    kernel deals to its lanes in another order than the plain version's
    blocks: mesh 128) through the kernel and the plain version (on the
    CPU).  float64: rtol 1e-10 (fractions with a 1e-12 floor) and every
    shell's iteration count equal.  float32: the kernel's error against
    the plain float64 run within twice the plain float32 run's plus 1e-5
    (the lanes add the bands in another order, and FMA contraction
    rounds the columns differently)."""
    mesh = 128 if variant.startswith("auto") else 64
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


@pytest.mark.gpu
def test_div_flat_equals_ieee_division(cuda_device):
    """The 1D kernel's branch-free float division (common.cuh:div_flat)
    gives the bits of `/` on the card: random bit patterns over every
    exponent (normal, subnormal), and zeros, infinities, NaNs and the
    extremes against each other; a NaN only has to be a NaN."""
    import ctypes

    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**32, size=(2, 1 << 21), dtype=np.uint64)
    ab = bits.astype(np.uint32).view(np.float32)
    # quotients near the midpoint of two floats: a = fl(m b), m the
    # midpoint above a random float of [1, 2), b of [1, 2) with few bits
    m = (1.0 + rng.integers(0, 2**23, 1 << 20) / 2.0**23
         + 2.0**-24)
    bm = 1.0 + rng.integers(0, 2**8, 1 << 20) / 2.0**8
    near = np.stack([(m * bm).astype(np.float32),
                     bm.astype(np.float32)])
    ab = np.concatenate([ab, near], axis=1)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                     np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                     np.finfo(np.float32).smallest_subnormal, 3.0, 1e-30,
                     1e30, 7.1e-7], dtype=np.float32)
    ea, eb = np.meshgrid(edge, np.concatenate([edge, -edge]))
    a = np.concatenate([ab[0], ea.ravel()])
    b = np.concatenate([ab[1], eb.ravel()])
    ta, tb = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    qf, qi = torch.empty_like(ta), torch.empty_like(ta)
    fn = cuda_build.load("evolve1d").evolve1d_div_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_build.check(fn(*(cuda_build.ptr(t) for t in (ta, tb, qf, qi)),
                        a.size, cuda_build.stream_of(ta)), "div_check")
    qf, qi = qf.cpu().numpy(), qi.cpu().numpy()
    nan = np.isnan(qi)
    assert np.array_equal(np.isnan(qf), nan)
    assert np.array_equal(qf[~nan].view(np.uint32), qi[~nan].view(np.uint32))


# ---- the L1-shell and skewed-octant sweep kernels

_SHELL_CASES = {"even": (16, None), "odd": (17, None), "subbox": (16, 5)}


def _engine_counts():
    return _launches("shell_sweep", "shell_sweep.heat", "octant_sweep",
                     "octant_sweep.heat")


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


# the octant kernel's launch cases, (mesh, sources): 16^3 (R = 8) and
# 18^3 (R = 9, odd) at 3 sources, and 64^3 at 16 sources, whose planes
# run every lane count of octant_sweep.PLANE_LANES
_OCTANT_CASES = {"16": (16, 3), "18": (18, 3), "lanes": (64, 16)}


@pytest.mark.gpu
@pytest.mark.parametrize("lls", [0.0, 1.0e15])
@pytest.mark.parametrize("case", sorted(_OCTANT_CASES))
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_octant_kernel_matches_plain_at_every_lane_count(cuda_device, dtype,
                                                         heating, case, lls):
    """The octant kernel (valid positions only, lanes per cell chosen per
    plane, the plane ring filled with NaN) against its plain version:
    float64 within rtol 1e-10 of each part's largest value; float32
    within 1e-4 with 1e-4 of each part's largest value as the floor,
    the rates, the heat and the photon loss each on its own scale; two
    calls equal to the bit; each plane launched at the lanes of its
    plan, and at 64^3 x 16 every lane count."""
    M, S = _OCTANT_CASES[case]
    cfg = dataclasses.replace(
        _config(M, dtype, cuda_device, S_star=1e48, heating=heating).sweep,
        coldensh_LLS=lls)
    state = _random_state(M, dtype, cuda_device)
    fstack = pyramid_sweep.stack_sweep_fields(cfg, SourceFields(
        state.ndens, state.h_av0, state.h_av1, state.he_av0, state.he_av1))
    srcpos, nflux = _sources(M, S, dtype, cuda_device)
    lanes = lambda: {G: counter(f"launches.octant_sweep.lanes{G}")
                     for G in octant_sweep.PLANE_LANES}
    before = lanes()
    k = octant_sweep.octant_sweep_cuda(cfg, fstack, srcpos, nflux)
    ran = {G: n - before[G] for G, n in lanes().items()}
    again = octant_sweep.octant_sweep_cuda(cfg, fstack, srcpos, nflux)
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    row0, rows, cells = octant_sweep.plane_rows(M)
    plan, _ = octant_sweep.plane_plan(S, row0, cells)
    assert ran == {G: int((plan[:, 3] == G).sum())
                   for G in octant_sweep.PLANE_LANES}
    if case == "lanes":
        assert all(n > 0 for n in ran.values()), ran
    p = octant_sweep.octant_sweep_plain(cfg, fstack, srcpos, nflux)
    parts = lambda out: (out[0][..., :3], out[0][..., 3], out[1])
    assert float(p[0][..., :3].abs().max()) > 0.0
    assert float(p[1].abs().max()) > 0.0
    if heating:
        assert float(p[0][..., 3].abs().max()) > 0.0
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for a, b in zip(parts(k), parts(p)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()))


# the redesigned sweep kernels' cases: (tables, K, heating, dtype); K = 6
# and 8 run unrolled instantiations, 48 the runtime-K one (its heating
# rows in float64 exceed a block's shared memory)
_REDESIGN_CASES = (
    [("few bands", K, heating, dtype) for K in (6, 8)
     for heating in (False, True)
     for dtype in (torch.float64, torch.float32)]
    + [("three types", 48, False, torch.float64),
       ("three types", 48, False, torch.float32),
       ("three types", 48, True, torch.float32)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", _REDESIGN_CASES,
                         ids=lambda c: f"{c[0]}-K{c[1]}-"
                         f"{'heat' if c[2] else 'iso'}-{str(c[3])[6:]}")
@pytest.mark.parametrize("engine", ["pyramid", "shells"])
def test_redesigned_sweep_kernels_match_plain(cuda_device, engine, case):
    """The pyramid stage kernel and the shell kernel (a lane group per
    cell, the node loop unrolled for K = 6 and 8) against their plain
    versions: float64 within rtol 1e-10 of each
    part's largest value; float32 within 1e-4 with 1e-4 of each part's
    largest value as the floor, and its heat's error against the float64
    plain result at most twice the plain float32 version's plus 1e-7;
    two calls equal to the bit."""
    tables, K, heating, dtype = case
    M = 16
    table = build_shell_table(M)
    Rf, Rb = pyramid_sweep.trace_extents(M)

    def inputs(dt):
        cfg = (_few_bands_config(M, dt, cuda_device, K, heating)
               if tables == "few bands"
               else _three_type_config(M, dt, cuda_device, K, heating))
        state = _random_state(M, dt, cuda_device)
        fstack = pyramid_sweep.stack_sweep_fields(cfg, SourceFields(
            state.ndens, state.h_av0, state.h_av1, state.he_av0,
            state.he_av1))
        srcpos, _ = _sources(M, 3, dt, cuda_device)
        nflux = torch.tensor([[1.0, 0.5, 0.2], [0.7, 0.0, 0.4],
                              [0.0, 1.3, 0.0]], dtype=dt, device=cuda_device)
        return cfg, fstack, srcpos, nflux

    def traces(fn, cfg, fstack, srcpos, nflux):
        if engine == "pyramid":
            out = fn(cfg, fstack, srcpos, nflux, Rf, Rb)
        else:
            out = fn(cfg, table, fstack, srcpos, nflux)
        return out[:3]

    kern, plain = ((pyramid_sweep.trace_cuda, pyramid_sweep.trace_plain)
                   if engine == "pyramid" else
                   (source_sweep.shell_sweep_cuda,
                    source_sweep.shell_sweep_plain))
    args = inputs(dtype)
    k, again = traces(kern, *args), traces(kern, *args)
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    k, p = _parts(k + (None,)), _parts(traces(plain, *args) + (None,))
    # the plain version in float64 (the 48-node heating rows in float64
    # exceed a block's shared memory, so no float64 kernel there)
    p64 = _parts(traces(plain, *inputs(torch.float64)) + (None,))
    assert float(p64[0].abs().max()) > 0.0
    if heating:
        assert float(p64[1].abs().max()) > 0.0
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()))
    if heating and dtype == torch.float32:
        ek = _rel_err(k[1].double(), p64[1])
        ep = _rel_err(p[1].double(), p64[1])
        assert ek <= 2.0 * ep + 1e-7, (ek, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweep_kernel_after_a_larger_opt_in(cuda_device, dtype):
    """A tracked sweep opts each kernel in to the shared memory it takes
    only above the default 48 KB, never below it: a later sweep whose band
    rows outgrow the tracked sweep's tables (within 48 KB) still
    launches."""
    M = 8
    Rf, Rb = pyramid_sweep.trace_extents(M)
    state = _random_state(M, dtype, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    srcpos, _ = _sources(M, 2, dtype, cuda_device)
    nflux = torch.tensor([[1.0, 0.5, 0.0], [0.7, 0.2, 0.0]], dtype=dtype,
                         device=cuda_device)
    small = _config(M, dtype, cuda_device, S_star=1e48).sweep
    pyramid_sweep.trace_cuda(small,
                             pyramid_sweep.stack_sweep_fields(small, fields),
                             srcpos, nflux, Rf, Rb, track=True)
    big = _few_bands_config(M, dtype, cuda_device, 6, False)
    fstack = pyramid_sweep.stack_sweep_fields(big, fields)
    k = pyramid_sweep.trace_cuda(big, fstack, srcpos, nflux, Rf, Rb)
    p = pyramid_sweep.trace_plain(big, fstack, srcpos, nflux, Rf, Rb)
    _assert_traces_close(k, p, 1e-10 if dtype == torch.float64 else 1e-4)


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
    before = _launches("domain_halo.pack", "domain_halo.accumulate",
                       "domain_halo.fold")
    pf = halo.halo_pack(c["fields"], 8, 1e-20, c["left"], c["right"], H)
    halo.window_accumulate(c["rc"], c["cubes"][0], c["starts"][0])
    r4 = halo.fold_halo(c["rc"], 8, (H, H + S), c["recv"], c["chunks"])
    assert pf.shape == (S + 2 * H, 8 + 2 * H, 8 + 2 * H, 5)
    assert r4.shape == (4, S * 64)
    assert _launches("domain_halo.pack", "domain_halo.accumulate",
                     "domain_halo.fold") == before


@pytest.mark.gpu
@pytest.mark.parametrize("C", [5, 6])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(32, 8, 5), (128, 1, 64), (18, 1, 1)])
def test_halo_kernels_match_plain(cuda_device, shape, dtype, C):
    """Each halo kernel equals its plain version to the bit (copies, a
    max and adds in the plain version's order), at the slab shapes of 8
    ranks at 32^3 radius 5 (S = 4, H = 6), of one rank at 128^3, full
    radius (S = 128, H = 64), and of one rank at 18^3, radius 1 (H = 2:
    in float32 with 5 channels a pack row holds 22 x 5 values, 440
    bytes, so every other row starts off a 16-byte boundary)."""
    from c2ray_tpu_torch.parallel import halo

    M, D, radius = shape
    c = _halo_case(M, D, radius, dtype, cuda_device, C)
    S, H = c["S"], c["H"]
    before = _launches("domain_halo.pack", "domain_halo.accumulate",
                       "domain_halo.fold")
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
    after = _launches("domain_halo.pack", "domain_halo.accumulate",
                      "domain_halo.fold")
    assert tuple(a - b for a, b in zip(after, before)) == (3, 3, 3)


# ---- the tau-table and "auto" rate routes of the three sweep kernels

def _route_config(M, dtype, device, route, heating):
    """A 5e4 K blackbody's tau tables ("tau") or "auto" quadrature blocks
    ("auto": 1 band at K = 12, 26 at K = 3, 6 at K = 6)."""
    from c2ray_tpu_torch.radiation.tables import build_radiation_tables

    sed = SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48))
    if route == "tau":
        tables, _, bands = build_radiation_tables(
            sed, isothermal=not heating, dtype=dtype, device=device)
    else:
        tables, _, bands = build_quadrature_tables(
            sed, isothermal=not heating, dtype=dtype, device=device,
            n_nodes="auto")
    return SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                       isothermal=not heating, flux_scale=bands.flux_scale)


# (engine, mesh, trace radius or shell-table radius, per-cell LLS grid)
_ROUTE_CASES = {"pyramid": ("pyramid", 16, None, False),
                "pyramid_radius4_lls": ("pyramid", 16, 4, True),
                "shells_odd": ("shells", 17, None, False),
                "shells_subbox": ("shells", 16, 5, False),
                "octant": ("octant", 16, None, False)}


def _route_traces(case, cfg, state, srcpos, nflux):
    engine, M, radius, lls = _ROUTE_CASES[case]
    if engine == "pyramid":
        grid = (torch.as_tensor(10.0 ** np.random.RandomState(8).uniform(
            14.0, 17.0, M**3), dtype=state.ndens.dtype,
            device=state.ndens.device) if lls else None)
        return _traces(cfg, state, srcpos, nflux, radius, lls=grid)
    k, p = _engine_traces(engine, cfg, build_shell_table(M, radius), state,
                          srcpos, nflux)
    return k + (None,), p + (None,)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
@pytest.mark.parametrize("route", ["tau", "auto"])
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_route_sweep_kernels_match_plain(cuda_device, dtype, heating, route,
                                         case):
    """The tau-table and "auto" routes of the pyramid (full extents, and
    radius 4 with a per-cell LLS grid), shell (17^3, and under a radius-5
    table) and octant kernels against their plain versions, 3 sources:
    float64 within rtol 1e-10 of each part's largest value, float32
    within twice the plain float32 version's error against float64 plus
    1e-5; each call counts one launch of its route's variant."""
    engine = _ROUTE_CASES[case][0]
    M = _ROUTE_CASES[case][1]
    library = {"pyramid": "pyramid_sweep", "shells": "shell_sweep",
               "octant": "octant_sweep"}[engine]
    name = (f"launches.{library}" + (".table" if route == "tau" else ".auto")
            + (".heat" if heating else ""))
    parts = {}
    for dt in (torch.float64, dtype):
        cfg = _route_config(M, dt, cuda_device, route, heating)
        state = _random_state(M, dt, cuda_device)
        srcpos, nflux = _sources(M, 3, dt, cuda_device)
        before = counter(name)
        k, p = _route_traces(case, cfg, state, srcpos, nflux)
        assert counter(name) == before + 1
        parts[dt] = (_parts(k), _parts(p))
    (k64, p64), (k, p) = parts[torch.float64], parts[dtype]
    assert float(p64[0].abs().max()) > 0.0
    if heating:
        assert float(p64[1].abs().max()) > 0.0
    for a, b, ref in zip(k, p, p64):
        if dtype == torch.float64:
            torch.testing.assert_close(a, b, rtol=1e-10,
                                       atol=1e-10 * float(b.abs().max()))
        else:
            ek, ep = _rel_err(a.double(), ref), _rel_err(b.double(), ref)
            assert ek <= 2.0 * ep + 1e-5, (ek, ep)


# other "auto" and tau tables: (spectrum, route) -- a 1e5 K blackbody's
# "auto" blocks (node groups of K = 6, 5, 4, 3, 2: the runtime-K rows),
# and a blackbody, power law and QSO spectrum on both routes (a group and
# a table column per source type)
_ROUTE_TABLE_CASES = {"bb1e5_auto": ("bb1e5", "auto"),
                      "three_types_auto": ("all", "auto"),
                      "three_types_tau": ("all", "tau")}


def _route_config_of(M, dtype, device, spectrum, route, heating):
    from c2ray_tpu_torch.radiation.tables import build_radiation_tables

    sed = (SEDConfig(bb=BlackBodySED(T_eff=1e5, S_star=1e48))
           if spectrum == "bb1e5" else
           SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48),
                     pl=PowerLawSED(index=2.5, S_star=3e46),
                     qso=PowerLawSED(index=1.8, S_star=1e46)))
    build = build_radiation_tables if route == "tau" else (
        lambda *a, **k: build_quadrature_tables(*a, **k, n_nodes="auto"))
    tables, _, bands = build(sed, isothermal=not heating, dtype=dtype,
                             device=device)
    three = spectrum == "all"
    return SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                       isothermal=not heating, flux_scale=bands.flux_scale,
                       has_pl=three, has_qso=three)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["pyramid", "shells", "octant"])
@pytest.mark.parametrize("tables", sorted(_ROUTE_TABLE_CASES))
@pytest.mark.parametrize("heating", [False, True])
def test_route_kernels_with_other_tables(cuda_device, heating, tables,
                                         engine):
    """The redesigned routes on other tables, every engine at 16^3 (the
    shell engine 17^3), 3 sources with fluxes in every column: float64
    within rtol 1e-10 of each part's largest value against the plain
    version."""
    spectrum, route = _ROUTE_TABLE_CASES[tables]
    case = {"pyramid": "pyramid", "shells": "shells_odd",
            "octant": "octant"}[engine]
    M = _ROUTE_CASES[case][1]
    cfg = _route_config_of(M, torch.float64, cuda_device, spectrum, route,
                           heating)
    state = _random_state(M, torch.float64, cuda_device)
    srcpos, nflux = _sources(M, 3, torch.float64, cuda_device)
    nflux = nflux[:, :1] * torch.tensor([1.0, 0.5, 0.25], dtype=nflux.dtype,
                                        device=nflux.device)
    k, p = _route_traces(case, cfg, state, srcpos, nflux)
    for a, b in zip(_parts(k), _parts(p)):
        torch.testing.assert_close(a, b, rtol=1e-10,
                                   atol=1e-10 * float(b.abs().max()))


def _parent_dir():
    """The commit before the rate routes unpacked under build/parent (a
    `git archive`), or a skip."""
    parent = os.path.join(ROOT, "build", "parent")
    if not os.path.isdir(os.path.join(parent, "c2ray_tpu_torch", "csrc")):
        pytest.skip("needs the parent commit unpacked under build/parent")
    return parent


@pytest.mark.gpu
def test_fixed_rule_sweeps_time_as_the_parent(cuda_device):
    """The route switch leaves the fixed quadrature rule's sweep kernels
    as fast as they were: at 128^3 x 8 float32 on phase 16's state, the
    pyramid, shell and octant sweeps, isothermal and heating, within 1%
    of the parent build's in turns (parent, this, this, parent).  Their
    SASS moved: each kernel's Params carries the route tables, which the
    route redesigns changed."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_torch_iteration as pti

    times = pti.fixed_rule_against_parent(_parent_dir())
    assert len(times) == 6
    for key, ms in times.items():
        ratio = sum(ms["this"]) / sum(ms["parent"])
        assert abs(ratio - 1.0) <= 0.01, (key, ms)


@pytest.mark.gpu
def test_unrouted_sources_sass_equals_the_parent(cuda_device):
    """The sources outside the route switch compile as they did: with
    the parent commit unpacked under build/parent, every function of the
    parent's halo source has the same SASS here, and every one of its 1D
    source's either has or, where one moved (the "auto" block route's
    branches in the march move the scheduling of some fixed-rule
    kernels), the 1D kernel's three main-path variants run within 1% of
    the parent build's in turns (chip_smoke.phase_oned_in_turns, one
    test-1 step at mesh 2000 after a first one)."""
    _parent_dir()
    sys.path.insert(0, ROOT)
    import chip_smoke

    _, same, plibs = chip_smoke.parent_libraries()
    assert same["domain_halo"][0] == same["domain_halo"][1], same
    dt = 10.0 * chip_smoke.MYR
    main = {}
    for name, iso, quad in chip_smoke.ONED_MAIN:
        run = chip_smoke.oned_run(1, 2000, torch.float32, cuda_device, iso,
                                  quad)
        run.step(dt)
        main[name] = {"run": run, "dt": dt}
    times = chip_smoke.phase_oned_in_turns(main, plibs, same)
    for name, t in (times or {}).items():
        assert abs(chip_smoke.turns_ratio(t) - 1.0) <= 0.01, (name, t)
