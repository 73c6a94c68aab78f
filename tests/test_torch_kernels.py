"""The port's packaging and its kernels; this file imports no JAX.

CPU: importing the port leaves JAX unloaded, CPU tensors never reach a
kernel (the launch counters stay at 0), and `chip_smoke.py` refuses to
run without a GPU.  Card (marker `gpu`, skipped without CUDA): each
kernel against its plain version on the same inputs.  On a GPU machine
without JAX, run the card tests with

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from c2ray_tpu_torch import constants as const
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
from c2ray_tpu_torch.state import initial_grid_state
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SourceFields, SweepConfig, evolve3d,
                                   global_pass, pyramid_sweep)

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


def _config(M, dtype, device, S_star=3e51):
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=S_star)),
        isothermal=True, dtype=dtype, device=device)
    sweep = SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                        isothermal=True, flux_scale=bands.flux_scale)
    return Evolve3DConfig(sweep=sweep,
                          chem=ChemistryConfig(isothermal=True),
                          subbox_start=2)


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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("radius", [None, 4])
def test_sweep_kernel_matches_plain(cuda_device, dtype, radius):
    M = 16
    cfg = _config(M, dtype, cuda_device, S_star=1e48)
    state = _random_state(M, dtype, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    fstack = pyramid_sweep.stack_sweep_fields(cfg.sweep, fields)
    srcpos, nflux = _sources(M, 3, dtype, cuda_device)
    Rf, Rb = pyramid_sweep.trace_extents(M, radius)
    before = pyramid_sweep.launches
    k = pyramid_sweep.trace_cuda(cfg.sweep, fstack, srcpos, nflux, Rf, Rb)
    assert pyramid_sweep.launches == before + 1
    p = pyramid_sweep.trace_plain(cfg.sweep, fstack, srcpos, nflux, Rf, Rb)
    # float64: rounding only.  float32: columns summed over up to M/2
    # layers with and without FMA contraction, amplified by tau <= 80
    # in e^-tau; measured kernel-vs-plain at 32^3 stays below 1e-6 of
    # the largest value
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chemistry_kernel_matches_plain(cuda_device, dtype):
    M = 16
    cfg = _config(M, dtype, cuda_device)
    state = _random_state(M, dtype, cuda_device, seed=6)
    srcpos, nflux = _sources(M, 3, dtype, cuda_device)
    fields = SourceFields(state.ndens, state.h_av0, state.h_av1,
                          state.he_av0, state.he_av1)
    rates = pyramid_sweep.sweep_pyramid_source_batch(cfg.sweep, fields,
                                                     srcpos, nflux)
    before = global_pass.launches
    k = global_pass.chemistry_pass_cuda(cfg.chem, state, rates, 1.0e14)
    assert global_pass.launches == before + 1
    p = global_pass.chemistry_pass_plain(cfg.chem, state, rates, 1.0e14)
    if dtype == torch.float64:
        assert (int(k[1]), int(k[2])) == (int(p[1]), int(p[2]))
    # float32: a cell whose 1% convergence test flips stops one
    # fixed-point iteration apart; fractions are O(1)
    tol = 1e-10 if dtype == torch.float64 else 2e-2
    for a, b in zip(k[0], p[0]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
