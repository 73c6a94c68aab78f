"""Drive the PyTorch + CUDA port of the 3D timestep on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: require CUDA, print the card's name and power limit;
2. build: compile the kernels of ``c2ray_tpu_torch/csrc`` with nvcc,
   one nvcc per source, all started together;
3. kernel vs plain at 32^3 x 3 sources (one at a grid edge), radius
   None and 8, float64 and float32: the sweep's per-source rates and
   losses, and one chemistry pass -- isothermal, then with heating
   (the heating chemistry pass with cosmo_cool_factor 0 and 1e-16);
4. isothermal main path: the bench configuration of ``bench.py`` (5e4 K
   blackbody, S_star 3e51, 50 kpc box, n = 1e-4, dt = 1e14 s, 128^3 x 8
   sources from RandomState(7)) in float32: one warm-up iteration, 4
   timed iterations of `make_evolve3d_iteration`, the sweep and
   chemistry walls of 4 more, then one full `evolve3d` timestep; both
   isothermal kernels must have been launched by it;
5. heating main path: the same configuration with heating (the
   heating stage of ``bench.py``, T0 = 1e4 K): the same timings, the
   largest chemistry iteration and thermal sub-step counts, then one
   `evolve3d` timestep and its photon budget; both heating kernels must
   have been launched by it;
6. physics: the isothermal Stroemgren sphere (M = 20, 4 x 10 Myr) in
   float32 against the analytic front; and the heating problem of
   ``tools/tpu_heating_check.py`` (1e5 K blackbody, S_star 5e48, n =
   1e-3, T0 = 100 K, 16 kpc box, M = 32, 6 x 0.5 Myr) in float32 on the
   card against the port's plain versions in float64 on the CPU.

Then each kernel's time and its plain version's at its main path's
shapes, and their agreement there within the stated float32
tolerances.  The Run3D slice adds:

7. kernel vs plain at 32^3 x 3 sources, float64 and float32,
   isothermal and heating: the sweep with a per-cell LLS grid and with
   band tracking (rates, heat, photon / LLS loss, band loss); the
   photon-loss kernel, also on fully ionized cells; grouped vs
   ungrouped sweeps, and a batch of no sources;
8. photon-loss main path: the bench configuration with
   `track_band_loss` and `add_photon_losses`, timed as in 4; the
   redistributed photons equal the tracked escape; then the band-
   tracking sweep's and the photon-loss kernel's times;
9. driver physics: `Run3D` on the configuration of
   ``tools/tpu_run3d_check.py`` (32^3, heating, T0 = 100 K, two
   sources) in float32 on the card against the port's plain float64
   on the CPU, which runs in a process of its own from the start of
   the script;
10. driver at full width: `Run3D.run()` at 128^3, heating, float32, on
   a seeded synthetic CubeP3M tree (3 redshifts from z = 9, density
   cubes with noise and blobs, 64-halo catalogs with suppression,
   clumping and LLS type 1), 2 slices x 2 steps; then the per-cell LLS
   sweep's time at the shapes of its last step.

The 1D slice adds, before phase 9's wait for its CPU reference:

11. 1D kernel vs plain at mesh 128 over 2 steps, float64 and float32
   (the plain version on the CPU): the quadrature and tau-table routes,
   isothermal and heating, the monochromatic tables and test 4;
12. 1D main path at full width: test 1 (Stroemgren, n = 1e-3, T = 1e4
   K, 1e5 K blackbody of 5e48 photons/s, 10 kpc) at mesh 10000 in
   float32 through `OneDRun`, 12 x 10 Myr, isothermal and heating on
   the quadrature route and isothermal on the tau tables: step walls,
   iterations, the front against the analytic one and the photon
   budget;
13. 1D physics: the four problems of ``tools/tpu_1d_check.py`` in
   float32 on the card with its tolerances, and the test-1 front at
   mesh 128, 512 and 10000;
14. 1D kernel vs plain at full width, after phase 10: phase 12's three
   variants in float64, one 10 Myr step of test 1 at mesh 10000 from
   the initial state, the kernel on the card against the plain version
   on the CPU, which runs in a process of its own per variant from the
   end of phase 8; the heating temperatures within ten times the
   spread that a few ulps of the volumes give the plain version (the
   problem is ill-conditioned next to the source), measured alike.

Then the 1D kernels' times at mesh 10000 after the others'.

The shell and octant slice adds, after phase 8:

15. shell and octant kernels vs plain: the shell kernel at 32^3 (full
   extents), 33^3 (odd) and 32^3 under build_shell_table(32, 8), the
   octant kernel at 32^3, 3 sources (one at a grid edge), float64 and
   float32, isothermal and heating, without and with a homogeneous LLS
   column; then the shell, octant and pyramid kernels against each
   other at 32^3 in float64 (rtol 1e-10);
16. the bench configuration of phase 4 (128^3 x 8, float32) on
   engine="shells" and engine="octant", isothermal and heating, timed
   as in 4 and 5, each new kernel variant launched;
17. after phase 9, the Run3D physics check of phase 9 at mesh 33 (odd:
   the shell engine) in float32 on the card against the port's plain
   float64 on the CPU (run after phase 9's in the same child process);
   after phase 10, `Run3D.run()` at 203^3 (the radiative-transfer grid
   of Iliev et al. 2006, MNRAS 369, 1625), heating, float32, on phase
   10's synthetic tree with 64 halos, 1 slice x 2 steps, on the shell
   engine (which, as in the JAX package, takes no LLS grid: its LLS
   loss is 0).

Then the shell and octant kernels' times at 128^3 x 8, last.

The multi-GPU slice adds, after phase 16 (the card has one H100, so
the parallel paths run at world size 1; their exchange between ranks
is held against the JAX package by the CPU tests in gloo processes):

18. the three halo kernels (``csrc/domain_halo.cu``: halo_pack,
   window_accumulate, fold_halo) against their plain versions on the
   card, float64 and float32, with 5 and 6 channels, at the slab shapes
   of 8 ranks at 32^3 radius 5 (S = 4, H = 6) and of one rank at 128^3,
   full radius (S = 128, H = 64): equal to the bit;
19. NCCL at world size 1 (a process group met through a FileStore under
   build/chip_smoke/): the collectives, a CPU tensor refused, and the
   time of an all-reduce of the four rate grids and of an all-gather
   of the 12 chemistry fields at 128^3;
20. the bench configuration of phases 4 and 5 through
   make_domain_iteration (full radius) and make_parallel_iteration
   beside make_evolve3d_iteration, timed in turns, their first
   iterations held to the single-device one (rates rtol 1e-4 with a
   1e-4-of-max floor, state 2e-2), then one timestep of each of
   evolve3d, domain_evolve3d and parallel_evolve3d;
21. after phase 10, `Run3D(parallel="domain", n_devices=1).run()` on
   phase 10's configuration: its mean ionized fraction within 1% of
   phase 10's, the same output files.

Then the halo kernels' times at 128^3, world size 1, full radius.

Each entry of the `kernels` line carries its bound: the larger of the
bytes the function must move over the card's memory rate and its
operations over their peak rate (`bound`; for the 1D kernels the
largest of that, the latency of the iterations' dependent chains and
one warp's instruction issue, `oned_bound`).
The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import heapq
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def synced(fn, *args):
    """(result, wall seconds) of fn(*args) between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean device time in ms of fn() over reps calls (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the
# tensor cores; the special-function units (exp, reciprocal) give 16
# results per SM and clock at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), x 132 SMs x
# 1.98 GHz.  The main path runs float32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_PER_S = 16 * 132 * 1.98e9


def bound(nbytes, flops, sfu):
    """(bound_ms, bound_by) of a float32 kernel: the larger of the bytes
    over the memory rate and the operations over their peak rate (the
    float32 pipes and the special-function units run side by side, so
    the slower of the two)."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOPS_PER_S, sfu / SFU_PER_S)
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def sweep_bound(sweep_cfg, S, Rf, Rb, lls=False, track=False):
    """Bound of one float32 sweep of S sources over (Rf + Rb + 1)^3
    cells each.  Bytes: the 5 field channels (and the LLS grid) read
    once, the (S, M^3, 4) rate slab written once.  Operations: at each
    of the K nodes of each live band, cell and source, 2 exponentials
    (e_in, e_out) on the special-function units and 10 flops of the
    photo sums (25 with the heating sums) on the float32 pipes; an
    expm1 per cell with LLS, an add per band and cell with tracking."""
    from c2ray_tpu_torch.radiation.quadrature import packed_band_rows
    from c2ray_tpu_torch.sweep.source_sweep import sweep_heats

    heat = sweep_heats(sweep_cfg)
    packed, _, K = packed_band_rows(sweep_cfg.tables, torch.float32, heat,
                                    sweep_cfg.has_bb, sweep_cfg.has_pl,
                                    sweep_cfg.has_qso)
    M, nlive = sweep_cfg.mesh, packed.shape[0]
    cells = S * (Rf + Rb + 1) ** 3
    nodes = cells * nlive * K
    nbytes = 4 * (M**3 * (6 if lls else 5) + S * M**3 * 4)
    flops = nodes * (25 if heat else 10) + (cells * nlive if track else 0)
    return bound(nbytes, flops, 2 * nodes + (cells if lls else 0))


# one fixed-point iteration of one cell (csrc/chemistry.cu, lower
# estimates): two doric solves, each a square root, 3 exponentials and
# 3 expm1, and about 200 flops; the bound counts one iteration per
# cell, the least any cell does
CHEM_SFU_PER_ITERATION = 14
CHEM_FLOPS_PER_ITERATION = 200


def chemistry_bound(n, heat):
    """Bound of one float32 chemistry pass over n cells: 20 state and
    rate rows read (22 with heating), 12 rows written; one iteration
    per cell."""
    return bound(4 * n * ((22 if heat else 20) + 12),
                 n * CHEM_FLOPS_PER_ITERATION, n * CHEM_SFU_PER_ITERATION)


def photon_losses_bound(n, nb):
    """Bound of one float32 photon-loss redistribution over n cells and
    nb bands: 4 field rows read, 3 rate rows read and written; per cell
    and band the 3-term denominator (5 flops), its reciprocal (one
    special-function result) and 3 multiply-adds (6 flops)."""
    return bound(4 * n * 10, n * nb * 11, n * nb)


# the bench configuration's source and box (bench.py:70-136): S_star,
# blackbody T_eff in K, box in kpc
BENCH_SOURCE = (3e51, 5e4, 50.0)


def setup(mesh, S_star, T_eff, box, dtype, dev, heating=False):
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.cooling import setup_cooling_tables
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
    from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                       SweepConfig)

    tables, sed, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=T_eff, S_star=S_star)),
        isothermal=not heating, dtype=dtype, device=dev)
    sweep = SweepConfig(tables=tables, mesh=mesh, dr=box * const.kpc / mesh,
                        isothermal=not heating, flux_scale=bands.flux_scale)
    if heating:
        chem = ChemistryConfig(isothermal=False,
                               cooling=setup_cooling_tables(dtype, dev))
    else:
        chem = ChemistryConfig(isothermal=True, isothermal_temperature=1.0e4)
    return Evolve3DConfig(sweep=sweep, chem=chem), sed


def random_case(M, S, dtype, dev, seed):
    """Random fields and sources (source 0 on a grid edge)."""
    from c2ray_tpu_torch.state import initial_grid_state

    rng = np.random.RandomState(seed)
    n = M**3
    h1 = rng.uniform(0.0, 0.8, n)
    he1 = rng.uniform(0.0, 0.5, n)
    he2 = rng.uniform(0.0, 0.3, n) * (1.0 - he1)
    state = initial_grid_state(10.0 ** rng.uniform(-4, -2, n), h1, he1, he2,
                               1.0e4, dtype=dtype, device=dev)
    srcpos = rng.randint(0, M, size=(S, 3))
    srcpos[0] = (0, M - 1, M // 3)
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (S, 1)),
                            np.zeros((S, 2))], axis=1)
    return (state, torch.as_tensor(srcpos, device=dev),
            torch.as_tensor(nflux, dtype=dtype, device=dev))


def fields_of(state):
    from c2ray_tpu_torch.sweep import SourceFields

    return SourceFields(ndens=state.ndens, h_av0=state.h_av0,
                        h_av1=state.h_av1, he_av0=state.he_av0,
                        he_av1=state.he_av1)


def rel_err(a, b):
    """max |a - b| / max |b| over all elements (0 when b is all 0)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


SWEEP_PARTS = ("rates", "heat", "photon_loss", "lls_loss", "band_loss")


def _sweep_parts(out, unit):
    """(rates, heat, photon_loss, lls_loss[, band_loss]) of a trace;
    losses are in the tables' flux units, brought to float64 physical
    by `unit`; the band loss when the trace tracked bands."""
    slab, ploss, lls = out[:3]
    parts = (slab[..., :3], slab[..., 3], ploss.double() * unit,
             lls.double() * unit)
    if len(out) > 3 and out[3] is not None:
        parts += (out[3].double() * unit,)
    return parts


def compare_sweep(cfg64, cfg32, M, dev, radius, lls, lls_grid=None,
                  track=False):
    """Sweep kernel vs plain at float64 (tight) and float32 (against
    the float64 plain result, as accurate as the float32 plain
    version), the heating column on its own; with `lls_grid` (numpy,
    M^3) the per-cell LLS variant, with `track` the band-tracking one.
    Returns the worst float32 relative error of the kernel."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    out = {}
    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        cfg = dataclasses.replace(cfg.sweep, coldensh_LLS=lls)
        state, srcpos, nflux = random_case(M, 3, dtype, dev, seed=5)
        fstack = ps.stack_sweep_fields(cfg, fields_of(state))
        Rf, Rb = ps.trace_extents(M, radius)
        unit = cfg.flux_scale / cfg64.sweep.flux_scale
        kw = dict(track=track, lls=None if lls_grid is None else
                  torch.as_tensor(lls_grid, dtype=dtype, device=dev))
        out[name] = (
            _sweep_parts(ps.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb,
                                       **kw), unit),
            _sweep_parts(ps.trace_plain(cfg, fstack, srcpos, nflux, Rf, Rb,
                                        **kw), unit))
    (k64, p64), (k32, p32) = out["f64"], out["f32"]
    if len(k64) != (5 if track else 4):
        raise AssertionError("the kernel's band loss is missing")
    label = (f"radius={radius} lls={lls:g}"
             + (" lls grid" if lls_grid is not None else "")
             + (" track" if track else ""))
    # float64: the JAX package's own pyramid-vs-octant tolerance
    for a, b, w in zip(k64, p64, SWEEP_PARTS):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * scale,
                                   msg=f"f64 sweep {w} {label}")
    worst = 0.0
    for a64, a, b, ref, w in zip(k64, k32, p32, p64, SWEEP_PARTS):
        ek = rel_err(a.double(), ref)
        ep = rel_err(b.double(), ref)
        log(f"  sweep {label} {w}: f64 kernel-plain "
            f"{rel_err(a64, ref):.3e}; vs f64 plain: f32 kernel {ek:.3e}, "
            f"f32 plain {ep:.3e}")
        # float32: the kernel's error against float64 within twice the
        # plain version's (float32 rounding of columns accumulated over
        # up to M/2 layers, amplified by tau in e^-tau and by the
        # E_in - E_out cancellation just above TAU_PHOTO_LIMIT), plus a
        # floor of 1e-6; for the heat 1e-7, below the 2.2e-7 of the
        # largest heat that a band sum without compensation costs here
        floor = 1e-7 if w == "heat" else 1e-6
        if not ek <= 2.0 * ep + floor:
            raise AssertionError(f"f32 sweep {w}: kernel error {ek:.3e} "
                                 f"vs plain {ep:.3e}")
        worst = max(worst, ek)
    return worst


def compare_chemistry(cfg64, cfg32, M, dev, dt=1.0e14, ccf=None):
    """One chemistry pass, kernel vs plain, on the plain sweep's rates.
    Fractions are compared absolutely, temperatures relatively."""
    from c2ray_tpu_torch.sweep import RateGrids
    from c2ray_tpu_torch.sweep import global_pass as gp
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    names = ("h_int0", "h_int1", "he_int0", "he_int1", "he_int2", "h_av0",
             "h_av1", "he_av0", "he_av1", "he_av2", "t_inter", "t_av")
    label = "heating chemistry" if not cfg64.chem.isothermal else "chemistry"
    res = {}
    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        state, srcpos, nflux = random_case(M, 3, dtype, dev, seed=6)
        fstack = ps.stack_sweep_fields(cfg.sweep, fields_of(state))
        Rf, Rb = ps.trace_extents(M)
        slab, pl, ll, _ = ps.trace_plain(cfg.sweep, fstack, srcpos, nflux,
                                         Rf, Rb)
        rg = slab.sum(dim=0)
        rates = RateGrids(rg[:, 0], rg[:, 1], rg[:, 2], rg[:, 3], pl.sum(),
                          ll.sum())
        res[name] = (gp.chemistry_pass_cuda(cfg.chem, state, rates, dt, ccf),
                     gp.chemistry_pass_plain(cfg.chem, state, rates, dt,
                                             ccf))
    (k64, p64), (k32, p32) = res["f64"], res["f32"]
    for nm, k, p in (("f64", k64, p64), ("f32", k32, p32)):
        log(f"  {label} {nm} dt={dt:g} ccf={ccf}: conv_flag "
            f"{int(k[1])}/{int(p[1])}, iterations {int(k[2])}/{int(p[2])}, "
            f"thermal sub-steps {int(k[3])}/{int(p[3])} (kernel/plain)")
    if (int(k64[1]), int(k64[2])) != (int(p64[1]), int(p64[2])):
        raise AssertionError(f"f64 {label} conv_flag / iterations differ")
    worst = 0.0
    for nm in names:
        a64, b64 = getattr(k64[0], nm), getattr(p64[0], nm)
        temp = nm.startswith("t_")
        # fractions in [0, 1]: 1e-12 absolute, 1e-10 relative;
        # temperatures 1e-10 relative
        torch.testing.assert_close(a64, b64, rtol=1e-10,
                                   atol=0.0 if temp else 1e-12,
                                   msg=f"f64 {label} {nm}")
        scale = b64.abs() if temp else 1.0
        ek = float(((getattr(k32[0], nm).double() - b64).abs()
                     / scale).max())
        ep = float(((getattr(p32[0], nm).double() - b64).abs()
                     / scale).max())
        # float32: within twice the plain float32 error against float64
        # plus 1e-6 (a cell whose 1% convergence test flips in float32
        # stops one fixed-point iteration earlier or later)
        if not ek <= 2.0 * ep + 1e-6:
            raise AssertionError(f"f32 {label} {nm}: kernel error "
                                 f"{ek:.3e} vs plain {ep:.3e}")
        worst = max(worst, ek)
    log(f"  {label} worst error vs f64 (fractions absolute, temperatures "
        f"relative): f32 kernel {worst:.3e}")
    return worst


def phase_compare(dev, M=32, heating=False):
    """Phase 3: kernel vs plain at M^3 x 3 sources, isothermal or with
    heating."""
    cfg64, _ = setup(M, 1e48, 5e4, 10.0, torch.float64, dev, heating)
    cfg32, _ = setup(M, 1e48, 5e4, 10.0, torch.float32, dev, heating)
    sweep_err32 = max(compare_sweep(cfg64, cfg32, M, dev, None, 0.0),
                      compare_sweep(cfg64, cfg32, M, dev, 8, 1.0e15))
    if heating:
        # a step short enough that the float64 fixed point converges
        # well before the damped regime, where the thermal sub-cycle
        # amplifies rounding differences (tests/test_torch_chemistry.py)
        chem_err32 = max(compare_chemistry(cfg64, cfg32, M, dev, 1.0e13, 0.0),
                         compare_chemistry(cfg64, cfg32, M, dev, 1.0e13,
                                           1.0e-16))
    else:
        chem_err32 = compare_chemistry(cfg64, cfg32, M, dev)
    log(f"kernel vs plain{' (heating)' if heating else ''}: ok")
    return sweep_err32, chem_err32


def _zero_ion_rates(rates):
    """`rates` with zero photo-ionization grids, so a redistribution
    into them leaves exactly what it added."""
    z = lambda t: torch.zeros_like(t)
    return rates._replace(phih=z(rates.phih), phihe0=z(rates.phihe0),
                          phihe1=z(rates.phihe1))


def _added(rates):
    return torch.stack([rates.phih, rates.phihe0, rates.phihe1], dim=-1)


def compare_photon_losses(cfg64, cfg32, M, dev):
    """The photon-loss kernel vs plain on the band escape of a float64
    sweep (radius 8), on random fields and on fully ionized ones (all
    neutral fractions 1e-20: JAX's unscaled float32 contraction gives
    inf there).  float64 within rtol 1e-12; float32 within twice the
    plain float32 error against float64 plus 1e-6, and finite.  Returns
    the worst float32 relative error of the kernel."""
    from c2ray_tpu_torch.sweep import RateGrids
    from c2ray_tpu_torch.sweep import photon_losses as pl
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    sweep64 = dataclasses.replace(cfg64.sweep, track_band_loss=True)
    state, srcpos, nflux = random_case(M, 3, torch.float64, dev, seed=9)
    plb = ps.sweep_pyramid_source_batch(sweep64, fields_of(state), srcpos,
                                        nflux, radius=8).photon_loss_bands
    worst = 0.0
    for case in ("random", "ionized"):
        res = {}
        for name, cfg, dtype in (("f64", cfg64, torch.float64),
                                 ("f32", cfg32, torch.float32)):
            st = random_case(M, 3, dtype, dev, seed=9)[0]
            f = fields_of(st)
            if case == "ionized":
                tiny = torch.full_like(f.h_av0, 1.0e-20)
                f = f._replace(h_av0=tiny, he_av0=tiny, he_av1=tiny)
            # the escape in this dtype's flux units (the float32 tables
            # are scaled by the source strength, the float64 ones not)
            fs = cfg.sweep.flux_scale
            z = torch.zeros(M**3, dtype=dtype, device=dev)
            rates = RateGrids(z, z, z, z, z.sum(), z.sum(),
                              (plb * (sweep64.flux_scale / fs)).to(dtype))
            vos = cfg.sweep.vol / fs
            res[name] = [_added(fn(cfg.sweep.tables, _zero_ion_rates(rates),
                                   f, vos))
                         for fn in (pl.distribute_photon_losses_cuda,
                                    pl.distribute_photon_losses_plain)]
        (k64, p64), (k32, p32) = res["f64"], res["f32"]
        torch.testing.assert_close(k64, p64, rtol=1e-12, atol=0.0,
                                   msg=f"f64 photon losses ({case})")
        ek, ep = rel_err(k32.double(), p64), rel_err(p32.double(), p64)
        log(f"  photon losses ({case}): f64 kernel-plain "
            f"{rel_err(k64, p64):.3e}; vs f64 plain: f32 kernel {ek:.3e}, "
            f"f32 plain {ep:.3e}")
        if not (bool(torch.isfinite(k32).all()) and ek <= 2.0 * ep + 1e-6):
            raise AssertionError(f"f32 photon losses ({case}): kernel error "
                                 f"{ek:.3e} vs plain {ep:.3e}")
        worst = max(worst, ek)
    return worst


def compare_groups(cfg64, cfg32, M, dev, S=5):
    """A tracked sweep of S sources in groups of 2 vs in one group,
    through the kernels (the groups' sums add in another order: float64
    within rtol 1e-12, float32 within the kernel-vs-plain rule, 1e-4
    with 1e-4 of the largest value as the floor); and a batch of no
    sources gives zero rates without a launch."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        sweep = dataclasses.replace(cfg.sweep, track_band_loss=True)
        state, srcpos, nflux = random_case(M, S, dtype, dev, seed=10)
        f = fields_of(state)
        one = ps.sweep_pyramid_source_batch(sweep, f, srcpos, nflux,
                                            radius=8)
        grouped = ps.sweep_pyramid_source_batch(
            dataclasses.replace(sweep, source_chunk=2), f, srcpos, nflux,
            radius=8)
        tol = 1e-12 if dtype == torch.float64 else 1e-4
        worst = 0.0
        for a, b, w in zip(grouped, one, one._fields):
            torch.testing.assert_close(a, b, rtol=tol,
                                       atol=tol * float(b.abs().max()),
                                       msg=f"{name} grouped sweep {w}")
            worst = max(worst, rel_err(a, b))
        log(f"  grouped (2) vs one group, {S} sources {name}: largest "
            f"difference {worst:.3e} of each part's largest value")
        before = launch_counts()
        empty = ps.sweep_pyramid_source_batch(sweep, f, srcpos[:0],
                                              nflux[:0])
        if launch_counts() != before or any(
                float(t.abs().max()) != 0.0 for t in empty):
            raise AssertionError("a batch of no sources launched or gave "
                                 "non-zero rates")


def phase_compare_slice(dev, M=32, heating=False):
    """Phase 7: the per-cell LLS and band-tracking sweep variants, the
    photon-loss kernel and source groups, kernel vs plain at M^3 x 3
    sources.  Returns the worst float32 errors (LLS sweep, tracked
    sweep, photon losses)."""
    cfg64, _ = setup(M, 1e48, 5e4, 10.0, torch.float64, dev, heating)
    cfg32, _ = setup(M, 1e48, 5e4, 10.0, torch.float32, dev, heating)
    # a position-dependent (type 2) LLS grid: 1e14-1e17 cm^-2 per cell,
    # tau_LLS 6e-4 to 0.6
    grid = 10.0 ** np.random.RandomState(8).uniform(14.0, 17.0, M**3)
    lls_err = max(compare_sweep(cfg64, cfg32, M, dev, r, 0.0, lls_grid=grid)
                  for r in (None, 8))
    track_err = max(compare_sweep(cfg64, cfg32, M, dev, r, 0.0, track=True)
                    for r in (None, 8))
    pl_err = compare_photon_losses(cfg64, cfg32, M, dev)
    compare_groups(cfg64, cfg32, M, dev)
    log(f"LLS / band-tracking / photon-loss kernels vs plain"
        f"{' (heating)' if heating else ''}: ok")
    return lls_err, track_err, pl_err


def launch_counts():
    from c2ray_tpu_torch.onedim import evolve as ev1
    from c2ray_tpu_torch.parallel import halo
    from c2ray_tpu_torch.sweep import (global_pass, octant_sweep,
                                       photon_losses, pyramid_sweep,
                                       source_sweep)

    return {"pyramid_sweep": pyramid_sweep.launches,
            "pyramid_sweep_heat": pyramid_sweep.launches_heat,
            "pyramid_sweep_lls": pyramid_sweep.launches_lls,
            "pyramid_sweep_track": pyramid_sweep.launches_track,
            "chemistry": global_pass.launches,
            "chemistry_heat": global_pass.launches_heat,
            "photon_losses": photon_losses.launches,
            "evolve1d": ev1.launches,
            "evolve1d_heat": ev1.launches_heat,
            "evolve1d_table": ev1.launches_table,
            "evolve1d_table_heat": ev1.launches_table_heat,
            "shell_sweep": source_sweep.launches,
            "shell_sweep_heat": source_sweep.launches_heat,
            "octant_sweep": octant_sweep.launches,
            "octant_sweep_heat": octant_sweep.launches_heat,
            "halo_pack": halo.launches_pack,
            "window_accumulate": halo.launches_accumulate,
            "fold_halo": halo.launches_fold}


def reset_launch_counts():
    from c2ray_tpu_torch.onedim import evolve as ev1
    from c2ray_tpu_torch.parallel import halo
    from c2ray_tpu_torch.sweep import (global_pass, octant_sweep,
                                       photon_losses, pyramid_sweep,
                                       source_sweep)

    pyramid_sweep.launches = pyramid_sweep.launches_heat = 0
    pyramid_sweep.launches_lls = pyramid_sweep.launches_track = 0
    global_pass.launches = global_pass.launches_heat = 0
    photon_losses.launches = 0
    ev1.launches = ev1.launches_heat = 0
    ev1.launches_table = ev1.launches_table_heat = 0
    source_sweep.launches = source_sweep.launches_heat = 0
    octant_sweep.launches = octant_sweep.launches_heat = 0
    halo.launches_pack = halo.launches_accumulate = halo.launches_fold = 0


def check_launches(name, counts, mine):
    """Every kernel in `mine` launched by the run, no other."""
    log(f"  launches: {counts}")
    for k, c in counts.items():
        if (c <= 0) if k in mine else (c != 0):
            raise AssertionError(f"{name} launched {k} {c} times")


def engine_sweep(engine):
    """The sweep of a source batch that `engine` runs: (sweep config,
    fields, srcpos, nflux) -> RateGrids."""
    from c2ray_tpu_torch.sweep import (build_shell_table,
                                       sweep_octant_source_batch,
                                       sweep_pyramid_source_batch,
                                       sweep_sources_accumulate)

    if engine == "shells":
        return lambda c, *a: sweep_sources_accumulate(
            c, build_shell_table(c.mesh), *a)
    return {"pyramid": sweep_pyramid_source_batch,
            "octant": sweep_octant_source_batch}[engine]


ENGINE_KERNEL = {"shells": "shell_sweep", "octant": "octant_sweep"}


def phase_main(dev, heating=False, mesh=128, n_src=8, n_iter=4,
               photon_losses=False, engine="pyramid"):
    """Phases 4, 5, 8 and 16: the bench configuration in float32 through
    the public entry points, isothermal or with heating, or (phase 8)
    with band tracking and the photon-loss redistribution, on the
    pyramid engine or (phase 16) the shell or octant engine; returns
    what the kernel timings need and the launch counts of this run (the
    engine's sweep kernel only, for phase 16)."""
    from c2ray_tpu_torch import photonstats
    from c2ray_tpu_torch.rates import rate_coefficients
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import (evolve3d, global_pass,
                                       make_evolve3d_iteration,
                                       photon_losses as pls)

    name = ("photon-loss main path" if photon_losses else
            "heating main path" if heating else "main path")
    if engine != "pyramid":
        name = f"{engine} engine {name}"
    cfg, sed = setup(mesh, *BENCH_SOURCE, torch.float32, dev, heating)
    cfg = dataclasses.replace(cfg, engine=engine)
    sweep = engine_sweep(engine)
    if photon_losses:
        cfg = dataclasses.replace(
            cfg, add_photon_losses=True,
            sweep=dataclasses.replace(cfg.sweep, track_band_loss=True))
    vos = cfg.sweep.vol / cfg.sweep.flux_scale
    rng = np.random.RandomState(7)
    srcpos = torch.as_tensor(rng.randint(0, mesh, size=(n_src, 3)),
                             device=dev)
    nflux = torch.as_tensor(np.concatenate(
        [rng.uniform(0.5, 2.0, (n_src, 1)), np.zeros((n_src, 2))], axis=1),
        dtype=torch.float32, device=dev)
    state0 = initial_grid_state(np.full((mesh,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                                1.0e4, dtype=torch.float32, device=dev)
    dt = 1.0e14
    iteration = make_evolve3d_iteration(cfg)

    reset_launch_counts()
    (s, conv, ploss, _), warm = synced(iteration, state0, srcpos, nflux, dt)
    log(f"{name}: warm-up iteration {warm:.3f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        s, conv, ploss, _ = iteration(s, srcpos, nflux, dt)
    torch.cuda.synchronize()
    spi = (time.perf_counter() - t0) / n_iter
    rate = mesh**3 * n_src / spi
    # per-phase walls of n_iter more iterations, with the chemistry
    # kernel's iteration and thermal sub-step counters
    sweep_w, chem_w, chem_it, chem_sub, pl_w = [], [], [], [], []
    st = s
    for _ in range(n_iter):
        rates, w = synced(sweep, cfg.sweep, fields_of(st), srcpos, nflux)
        sweep_w.append(w)
        if photon_losses:
            rates, w = synced(pls.distribute_photon_losses, cfg.sweep.tables,
                              rates, fields_of(st), vos)
            pl_w.append(w)
        (st, _, nit, nsub), w = synced(global_pass.chemistry_pass_cuda,
                                       cfg.chem, st, rates, dt)
        chem_w.append(w)
        chem_it.append(int(nit))
        chem_sub.append(int(nsub))
    vol = cfg.sweep.dr**3
    before = photonstats.species_inventory(state0, vol)
    (s_evo, stats), evo_w = synced(evolve3d, cfg, state0, srcpos, nflux, dt)
    counts = launch_counts()

    xion = float(s.h_av1.double().mean())
    log(f"{name} {mesh}^3 x {n_src} float32: {rate:.6e} "
        f"cell-source-updates/s, {spi:.6f} s/iteration")
    log(f"  sweep wall per iteration: {np.mean(sweep_w):.6f} s "
        f"({', '.join(f'{w:.4f}' for w in sweep_w)})")
    if photon_losses:
        log(f"  photon-loss redistribution wall per iteration: "
            f"{np.mean(pl_w):.6f} s ({', '.join(f'{w:.5f}' for w in pl_w)})")
    log(f"  chemistry wall per iteration: {np.mean(chem_w):.6f} s "
        f"({', '.join(f'{w:.4f}' for w in chem_w)}); largest chemistry "
        f"iterations {chem_it}, thermal sub-steps {chem_sub}")
    log(f"  last timed iteration: conv_flag {int(conv)}, photon_loss "
        f"{float(ploss):.6e}, mean ionized fraction {xion:.6e}")
    if heating:
        t_av = s.t_av.double()
        log(f"  t_av after {n_iter} iterations: mean {float(t_av.mean()):.6e}"
            f" K, max {float(t_av.max()):.6e} K")
    log(f"  evolve3d timestep: {evo_w:.3f} s, {stats}")
    if heating:
        total_src = float(nflux[:, 0].double().sum()) * sed.bb.S_star * dt
        fs = cfg.sweep.flux_scale
        budget = photonstats.photon_budget(
            before, s_evo, rate_coefficients(s_evo.t_av), vol, dt,
            total_src, photon_loss=stats.photon_loss * fs,
            lls_loss=stats.lls_loss * fs)
        log(f"  photon budget of the timestep: {budget}")
        if not all(math.isfinite(float(v)) for v in budget):
            raise AssertionError("heating timestep's photon budget is not "
                                 "finite")
    if photon_losses:
        check_redistribution(cfg, s, srcpos, nflux, vos)
        mine = ("pyramid_sweep_track", "photon_losses",
                "chemistry_heat" if heating else "chemistry")
    else:
        sfx = "_heat" if heating else ""
        mine = (ENGINE_KERNEL.get(engine, "pyramid_sweep") + sfx,
                "chemistry" + sfx)
    check_launches(name, counts, mine)
    for t in (*s, *s_evo):
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} produced non-finite state")
    if not (math.isfinite(xion) and math.isfinite(float(ploss))
            and math.isfinite(stats.photon_loss)):
        raise AssertionError(f"{name} produced non-finite diagnostics")
    if s.h1.shape != (mesh**3,) or s_evo.h1.shape != (mesh**3,):
        raise AssertionError(f"{name} state has the wrong shape")
    if engine != "pyramid":
        return cfg, s, srcpos, nflux, dt, {mine[0]: counts[mine[0]]}
    # the photon-loss path's chemistry launches are not the isothermal
    # path's: keep them apart
    return cfg, s, srcpos, nflux, dt, {
        (k + "@photon_losses" if photon_losses and k.startswith("chemistry")
         else k): counts[k] for k in mine}


def phase_physics(dev, M=20):
    """Phase 6a: isothermal Stroemgren sphere in float32."""
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import evolve3d

    cfg, sed = setup(M, 1.0e49, 1.0e5, 14.0, torch.float32, dev)
    ndens = 1.0e-3
    st = initial_grid_state(np.full((M,) * 3, ndens), 0.0, 0.0, 0.0, 1.0e4,
                            dtype=torch.float32, device=dev)
    src = torch.tensor([[M // 2] * 3], device=dev)
    nfl = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float32, device=dev)
    dts = 10.0e6 * const.YEAR
    for _ in range(4):
        st, _ = evolve3d(cfg, st, src, nfl, dts)
    r_num = (3.0 * float(st.h1.double().sum()) * cfg.sweep.dr**3
             / (4.0 * const.pi)) ** (1.0 / 3.0)
    # analytic Stroemgren front (c2ray_tpu/onedim/analytic.py, test 1)
    alpha_b = const.bh00
    r_s = (3.0 * sed.bb.S_star / (4.0 * const.pi * ndens**2 * alpha_b)
           ) ** (1.0 / 3.0)
    r_ana = r_s * (1.0 - math.exp(-ndens * alpha_b * 4 * dts)) ** (1.0 / 3.0)
    front_err = abs(r_num - r_ana) / r_ana
    log(f"Stroemgren M={M} float32: r_num {r_num:.6e} cm, r_ana "
        f"{r_ana:.6e} cm, relative error {front_err:.4f}")
    if not front_err < 0.05:
        raise AssertionError("Stroemgren front off by more than 5%")


def heating_profile(M, dtype, dev, n_steps=6):
    """The heating problem of tools/tpu_heating_check.py on `dev`:
    shell-averaged x_HII and T profiles around the source after
    n_steps x 0.5 Myr, radii in cell units."""
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import evolve3d

    cfg, _ = setup(M, 5.0e48, 1.0e5, 16.0, dtype, dev, heating=True)
    st = initial_grid_state(np.full((M,) * 3, 1.0e-3), 0.0, 0.0, 0.0, 100.0,
                            dtype=dtype, device=dev)
    src = torch.tensor([[M // 2] * 3], device=dev)
    nfl = torch.tensor([[1.0, 0.0, 0.0]], dtype=dtype, device=dev)
    for _ in range(n_steps):
        st, stats = evolve3d(cfg, st, src, nfl, 5.0e5 * const.YEAR)
    x = st.h1.double().cpu().numpy().reshape(M, M, M)
    T = st.t_final.double().cpu().numpy().reshape(M, M, M)
    ii = np.arange(M) - M // 2
    r = np.sqrt(ii[:, None, None] ** 2 + ii[None, :, None] ** 2
                + ii[None, None, :] ** 2)
    nbins = M // 2
    shell = np.clip(r.astype(np.int64), 0, nbins - 1).ravel()
    cnt = np.bincount(shell, minlength=nbins)
    prof = lambda v: np.bincount(shell, weights=v.ravel(),
                                 minlength=nbins) / cnt
    return np.arange(nbins) + 0.5, prof(x), prof(T), stats


def front_radius(r, x_prof):
    """x_HII = 0.5 crossing by linear interpolation
    (tools/tpu_heating_check.py:front_radius)."""
    below = np.where(x_prof < 0.5)[0]
    if len(below) == 0 or below[0] == 0:
        return float("nan")
    i = below[0]
    x0, x1 = x_prof[i - 1], x_prof[i]
    return r[i - 1] + (0.5 - x0) / (x1 - x0) * (r[i] - r[i - 1])


def phase_heating_physics(dev, M=32):
    """Phase 6b: the heating problem in float32 through the kernels,
    against the port's plain versions in float64 on the CPU; the
    criteria of tools/tpu_heating_check.py."""
    t0 = time.perf_counter()
    r, x_dev, t_dev, st_dev = heating_profile(M, torch.float32, dev)
    t1 = time.perf_counter()
    _, x_ref, t_ref, st_ref = heating_profile(M, torch.float64,
                                              torch.device("cpu"))
    t2 = time.perf_counter()
    rf_dev, rf_ref = front_radius(r, x_dev), front_radius(r, x_ref)
    front_err = abs(rf_dev - rf_ref) / rf_ref
    inside = r < 0.8 * rf_ref
    t_err = float(np.max(np.abs(t_dev[inside] - t_ref[inside])
                         / t_ref[inside]))
    outside = r > 1.5 * rf_ref
    t_out_dev = float(np.max(t_dev[outside]))
    t_out_ref = float(np.max(t_ref[outside]))
    log(f"heating physics M={M}: card f32 {t1 - t0:.1f} s ({st_dev}), "
        f"CPU f64 plain {t2 - t1:.1f} s ({st_ref})")
    log(f"  front radius {rf_dev:.4f} vs f64 {rf_ref:.4f} cells (error "
        f"{front_err:.4%}, limit 5%)")
    log(f"  T inside 0.8 r_front: max relative error {t_err:.4%} (limit "
        f"10%); centre T {t_dev[0]:.1f} K vs f64 {t_ref[0]:.1f} K")
    log(f"  T outside 1.5 r_front: max {t_out_dev:.1f} K vs f64 "
        f"{t_out_ref:.1f} K (limit {2.0 * max(t_out_ref, 200.0):.1f} K)")
    if not (front_err < 0.05 and t_err < 0.10
            and t_out_dev < 2.0 * max(t_out_ref, 200.0)):
        raise AssertionError("heating physics check failed")


def heat_against_f64(cfg, s, srcpos, nflux, heats32):
    """Largest difference of each float32 heat slab in `heats32` from
    the plain version's in float64 on the same (exactly widened)
    inputs, as a share of the largest float64 heat."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    mesh = cfg.sweep.mesh
    cfg64, _ = setup(mesh, *BENCH_SOURCE, torch.float64, srcpos.device,
                     heating=True)
    f64 = fields_of(s)
    f64 = type(f64)(*(t.double() for t in f64))
    Rf, Rb = ps.trace_extents(mesh)
    ref = ps.trace_plain(cfg64.sweep, ps.stack_sweep_fields(cfg64.sweep, f64),
                         srcpos, nflux.double(), Rf, Rb)[0][..., 3]
    return tuple(rel_err(h.double(), ref) for h in heats32)


def phase_kernel_times(cfg, s, srcpos, nflux, dt):
    """Each kernel's device time beside its plain version's, at the
    main path's shapes, and their largest differences: rates (1/s) and
    fractions absolute, temperatures relative."""
    from c2ray_tpu_torch.sweep import global_pass, pyramid_sweep

    heat = not cfg.sweep.isothermal
    mesh = cfg.sweep.mesh
    fstack = pyramid_sweep.stack_sweep_fields(cfg.sweep, fields_of(s))
    Rf, Rb = pyramid_sweep.trace_extents(mesh)
    args = (cfg.sweep, fstack, srcpos, nflux, Rf, Rb)
    sweep_ms = event_ms(lambda: pyramid_sweep.trace_cuda(*args), 3)
    sweep_plain_ms = event_ms(lambda: pyramid_sweep.trace_plain(*args), 1)
    k = pyramid_sweep.trace_cuda(*args)
    p = pyramid_sweep.trace_plain(*args)
    sweep_abs = float((k[0][..., :3] - p[0][..., :3]).abs().max())
    heat_rel = rel_err(k[0][..., 3], p[0][..., 3])
    rates = pyramid_sweep.sweep_pyramid_source_batch(cfg.sweep, fields_of(s),
                                                     srcpos, nflux)
    chem_args = (cfg.chem, s, rates, dt)
    chem_ms = event_ms(lambda: global_pass.chemistry_pass_cuda(*chem_args), 3)
    chem_plain_ms = event_ms(
        lambda: global_pass.chemistry_pass_plain(*chem_args), 1)
    kc = global_pass.chemistry_pass_cuda(*chem_args)
    pc = global_pass.chemistry_pass_plain(*chem_args)
    chem_abs = max(float((getattr(kc[0], n) - getattr(pc[0], n)).abs().max())
                   for n in s._fields[6:16])
    temp_rel = max(float(((getattr(kc[0], n) - getattr(pc[0], n)).abs()
                          / getattr(pc[0], n).abs()).max())
                   for n in ("t_inter", "t_av"))
    v = "heating " if heat else ""
    log(f"{v}sweep at {mesh}^3 x {srcpos.shape[0]}: kernel {sweep_ms:.3f} "
        f"ms, plain {sweep_plain_ms:.3f} ms, max |kernel - plain| "
        f"{sweep_abs:.3e} (f32 rates, 1/s), heat {heat_rel:.3e} of its "
        f"largest value")
    if heat:
        heat_ek, heat_ep = heat_against_f64(cfg, s, srcpos, nflux,
                                            (k[0][..., 3], p[0][..., 3]))
        log(f"  heat vs the plain version in f64 at {mesh}^3: f32 kernel "
            f"{heat_ek:.3e}, f32 plain {heat_ep:.3e} of the largest value")
    log(f"{v}chemistry at {mesh}^3: kernel {chem_ms:.3f} ms, plain "
        f"{chem_plain_ms:.3f} ms, max |kernel - plain| {chem_abs:.3e} "
        f"(f32 fractions), temperatures {temp_rel:.3e} relative; "
        f"iterations {int(kc[2])}/{int(pc[2])}, thermal sub-steps "
        f"{int(kc[3])}/{int(pc[3])}")
    # float32 kernel vs float32 plain, the tolerances of
    # tests/test_torch_kernels.py: sweep 1e-4 relative, with 1e-4 of the
    # largest value as the absolute floor (columns summed over up to M/2
    # layers with and without FMA contraction, amplified by tau in
    # e^-tau), each part on its own scale -- the heat (erg cm^-3 s^-1)
    # is ~1e-15 of the rates (1/s); chemistry 2e-2 (a cell whose 1%
    # convergence test flips stops one fixed-point iteration apart;
    # fractions are O(1), temperatures compared relatively)
    for a, b, what in zip(_sweep_parts(k, 1.0), _sweep_parts(p, 1.0),
                          ("rates", "heat", "photon_loss", "lls_loss")):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()),
                                   msg=f"{v}sweep {what} at {mesh}^3")
    for a, b, nm in zip(kc[0], pc[0], s._fields):
        torch.testing.assert_close(a, b, rtol=2e-2,
                                   atol=0.0 if nm.startswith("t_") else 2e-2,
                                   msg=f"{v}chemistry {nm} at {mesh}^3")
    # the heat against float64: the rule of the 32^3 compare
    if heat and not heat_ek <= 2.0 * heat_ep + 1e-7:
        raise AssertionError(f"heating sweep heat at {mesh}^3: kernel error "
                             f"{heat_ek:.3e} vs plain {heat_ep:.3e}")
    return ((sweep_ms, sweep_plain_ms, sweep_abs, heat_rel),
            (chem_ms, chem_plain_ms, chem_abs, temp_rel))


def check_redistribution(cfg, s, srcpos, nflux, vos):
    """Phase 8's budget: a tracked sweep of the main path's state, its
    band escape summing to its photon loss, redistributed by the kernel
    into zero grids: the photons the grid absorbs (sum over cells and
    species of dphi N V) equal the tracked escape within rtol 1e-4
    (float32 sums over 2M cells and 47 bands)."""
    from c2ray_tpu_torch.sweep import photon_losses as pls
    from c2ray_tpu_torch.sweep import pyramid_sweep

    f = fields_of(s)
    rates = pyramid_sweep.sweep_pyramid_source_batch(cfg.sweep, f, srcpos,
                                                     nflux)
    lost = float(rates.photon_loss_bands.double().sum())
    added = _added(pls.distribute_photon_losses_cuda(
        cfg.sweep.tables, _zero_ion_rates(rates), f, vos))
    absorbed = float((added.double()
                      * pls.neutral_densities(f).double()).sum()) * vos
    log(f"  redistributed photons {absorbed:.6e} vs tracked escape "
        f"{lost:.6e} vs photon_loss {float(rates.photon_loss):.6e} "
        f"(flux units)")
    if not (lost > 0.0 and math.isclose(absorbed, lost, rel_tol=1e-4)
            and math.isclose(lost, float(rates.photon_loss), rel_tol=1e-4)):
        raise AssertionError("the photon-loss redistribution does not "
                             "close the budget")


def _timed_plain(fn, groups):
    """(outputs of fn(g) for each g in groups, their total wall in ms)
    between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(g) for g in groups]
    torch.cuda.synchronize()
    return outs, 1e3 * (time.perf_counter() - t0)


def sweep_times(sweep_cfg, fstack, srcpos, nflux, Rf, Rb, dr=None,
                vos=None, lls=None, track=False, plain_group=8):
    """A sweep variant's kernel time (CUDA events, mean of 3 after a
    warm-up) and its plain version's (one pass, in groups of
    `plain_group` sources to bound its intermediates), and their largest
    difference; each part within the float32 tolerance of phase 3's
    main-path check, 1e-4 with 1e-4 of its largest value as the floor.
    Returns (ms, plain_ms, max |kernel - plain| of the rates (1/s))."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    args = (sweep_cfg, fstack)
    kw = dict(dr=dr, vol_over_scale=vos, lls=lls, track=track)
    ms = event_ms(lambda: ps.trace_cuda(*args, srcpos, nflux, Rf, Rb, **kw),
                  3)
    k = ps.trace_cuda(*args, srcpos, nflux, Rf, Rb, **kw)
    S = srcpos.shape[0]
    outs, plain_ms = _timed_plain(
        lambda g: ps.trace_plain(*args, srcpos[g:g + plain_group],
                                 nflux[g:g + plain_group], Rf, Rb, **kw),
        range(0, S, plain_group))
    p = tuple(None if outs[0][i] is None else torch.cat([o[i] for o in outs])
              for i in range(4))
    for a, b, w in zip(_sweep_parts(k, 1.0), _sweep_parts(p, 1.0),
                       SWEEP_PARTS):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()),
                                   msg=f"sweep {w} at {sweep_cfg.mesh}^3")
    return ms, plain_ms, float((k[0][..., :3] - p[0][..., :3]).abs().max())


def phase_track_times(cfg, s, srcpos, nflux):
    """The band-tracking sweep and the photon-loss kernel at phase 8's
    shapes: kernel, plain version and (photon losses) the two-matmul
    composition of the JAX function, `torch.reciprocal(N @ sig) @ W`;
    the kernel's added rates within rtol 1e-5 of the plain version's (47
    positive terms summed in another order)."""
    from c2ray_tpu_torch.sweep import photon_losses as pls
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    mesh, S = cfg.sweep.mesh, srcpos.shape[0]
    fstack = ps.stack_sweep_fields(cfg.sweep, fields_of(s))
    Rf, Rb = ps.trace_extents(mesh)
    sw = sweep_times(cfg.sweep, fstack, srcpos, nflux, Rf, Rb, track=True)
    sw_bound = sweep_bound(cfg.sweep, S, Rf, Rb, track=True)
    log(f"band-tracking sweep at {mesh}^3 x {S}: kernel {sw[0]:.3f} ms, "
        f"plain {sw[1]:.3f} ms, bound {sw_bound[0]:.3f} ms "
        f"({sw_bound[1]}), max |kernel - plain| {sw[2]:.3e} (f32 rates)")

    f = fields_of(s)
    tables = cfg.sweep.tables
    vos = cfg.sweep.vol / cfg.sweep.flux_scale
    rates = ps.sweep_pyramid_source_batch(cfg.sweep, f, srcpos, nflux)
    k = _added(pls.distribute_photon_losses_cuda(
        tables, _zero_ion_rates(rates), f, vos))
    p = _added(pls.distribute_photon_losses_plain(
        tables, _zero_ion_rates(rates), f, vos))
    torch.testing.assert_close(k, p, rtol=1e-5,
                               atol=1e-5 * float(p.abs().max()),
                               msg=f"photon losses at {mesh}^3")
    pl_abs = float((k - p).abs().max())
    ms = event_ms(lambda: pls.distribute_photon_losses_cuda(
        tables, rates, f, vos), 20)
    plain_ms = event_ms(lambda: pls.distribute_photon_losses_plain(
        tables, rates, f, vos), 20)
    N = pls.neutral_densities(f)
    sig, W = pls.scaled_sigma_and_weights(tables, rates.photon_loss_bands,
                                          mesh**3, vos, torch.float32)
    library_ms = event_ms(lambda: torch.reciprocal(N @ sig) @ W, 20)
    nb = tables.sigma_HI.shape[0]
    pl_bound = photon_losses_bound(mesh**3, nb)
    log(f"photon losses at {mesh}^3 x {nb} bands: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, two matmuls {library_ms:.4f} ms, bound "
        f"{pl_bound[0]:.4f} ms ({pl_bound[1]}), max |kernel - plain| "
        f"{pl_abs:.3e} (f32 rates)")
    return (sw, sw_bound), ((ms, plain_ms, pl_abs), pl_bound, library_ms)


def driver_physics(dtype, device, workdir, mesh=32):
    """The run of tools/tpu_run3d_check.py through the port's Run3D: the
    test backend (10 Mpc/h, z = 9), heating from T0 = 100 K, a 5e4 K
    blackbody of nominal 3e49 photons/s, two sources at NormFlux 3e5
    and 1.5e5, one slice of 2 steps.  Returns its diagnostics."""
    from c2ray_tpu_torch.driver import Run3D, Run3DConfig
    from c2ray_tpu_torch.nbody import test_nbody
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.sources import SourceList

    results = os.path.join(workdir, "results")
    r = Run3D(Run3DConfig(
        mesh=mesh, nbody=test_nbody(),
        sed=SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=3e49)),
        isothermal=False, initial_temperature=1.0e2, steps_per_slice=2,
        results_dir=results, dump_dir=workdir, dtype=dtype, device=device))
    r.init_uniform_material()
    c = mesh // 2
    t0 = time.perf_counter()
    stats = r.run_slice(0, SourceList(
        srcpos=np.array([[c, c, c], [c // 2, c, c]], dtype=np.int32),
        nflux=np.array([[3.0e5, 0.0, 0.0], [1.5e5, 0.0, 0.0]])))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xh1 = r.state.h1.double().cpu().numpy().reshape((mesh,) * 3)
    T = r.state.t_final.double().cpu().numpy().reshape((mesh,) * 3)
    return {"wall_s": wall, "ion_frac": float((xh1 > 0.5).mean()),
            "xh1_centre": float(xh1[c, c, c]), "xh1_corner": float(xh1[0, 0, 0]),
            "T_centre": float(T[c, c, c]), "T_corner": float(T[0, 0, 0]),
            "finite": bool(np.isfinite(xh1).all() and np.isfinite(T).all()),
            "steps": [tuple(st) for st in stats],
            "outputs": sorted(os.listdir(results))}


# the meshes of the driver physics check: phase 9 (pyramid engine) and
# phase 17 (odd: the shell engine)
DRIVER_PHYSICS_MESHES = (32, 33)


def cpu_reference(jobs):
    """The float64 plain runs of phases 9 and 17 on the CPU, one after
    the other in a process of their own: `jobs` is [out_path, mesh, ...];
    each writes its diagnostics as JSON to its out_path."""
    torch.set_num_threads(4)
    for out_path, mesh in zip(jobs[::2], jobs[1::2]):
        with tempfile.TemporaryDirectory(dir=os.path.dirname(out_path)) as tmp:
            res = driver_physics(torch.float64, "cpu", tmp, mesh=int(mesh))
        with open(out_path + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(out_path + ".tmp", out_path)


def start_cpu_reference(workdir):
    """Start the CPU references of phases 9 and 17 in a child process
    that sees no GPU; returns (process, {mesh: result path}, log path)."""
    outs = {m: os.path.join(workdir, f"driver_physics_{m}_f64.json")
            for m in DRIVER_PHYSICS_MESHES}
    logp = os.path.join(workdir, "driver_physics_f64.log")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    jobs = [a for m, out in outs.items() for a in (out, str(m))]
    with open(logp, "w") as lf:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--cpu-reference", *jobs], env=env,
                                stdout=lf, stderr=subprocess.STDOUT)
    return proc, outs, logp


def phase_driver_physics(dev, workdir, ref, mesh=32):
    """Phases 9 and 17: the Run3D physics check in float32 on the card
    against the port's plain float64 on the CPU (the reference process
    started with the script): ionized volume fraction 0.15-0.35 and
    within 0.02 of float64, centre x_HII > 0.8 and T 5e3-6e4 K, corner
    x_HII < 0.1 and T < 1e3 K, the output files written (the criteria
    of tools/tpu_run3d_check.py, calibrated there on a CPU float64 run:
    ionized fraction 0.241; at 33^3, on the shell engine, the plain
    float64 run gives 0.244456).  Returns the launch counts of the card
    run."""
    reset_launch_counts()
    got = driver_physics(torch.float32, dev,
                         os.path.join(workdir, f"driver_physics_{mesh}_f32"),
                         mesh=mesh)
    counts = launch_counts()
    proc, outs, logp = ref
    out = outs[mesh]
    t0 = time.perf_counter()
    while not os.path.exists(out) and proc.poll() is None:
        if time.perf_counter() - t0 > 1000:
            raise AssertionError("the CPU float64 reference timed out")
        time.sleep(0.5)
    waited = time.perf_counter() - t0
    if not os.path.exists(out):
        with open(logp) as f:
            log(f.read())
        raise AssertionError(f"the CPU float64 reference failed (exit "
                             f"{proc.poll()})")
    with open(out) as f:
        want = json.load(f)
    log(f"driver physics {mesh}^3: card f32 {got['wall_s']:.1f} s, CPU f64 "
        f"plain {want['wall_s']:.1f} s (waited {waited:.1f} s for it)")
    for k in ("ion_frac", "xh1_centre", "xh1_corner", "T_centre",
              "T_corner"):
        log(f"  {k}: f32 card {got[k]:.6g}, f64 CPU {want[k]:.6g}")
    log(f"  steps f32: {got['steps']}")
    log(f"  steps f64: {want['steps']}")
    log(f"  outputs: {got['outputs']}")
    ok = (got["finite"] and 0.15 < got["ion_frac"] < 0.35
          and abs(got["ion_frac"] - want["ion_frac"]) < 0.02
          and got["xh1_centre"] > 0.8 and got["xh1_corner"] < 0.1
          and 5.0e3 < got["T_centre"] < 6.0e4 and got["T_corner"] < 1.0e3
          and len(got["outputs"]) >= 2)
    if not ok:
        raise AssertionError("driver physics check failed")
    if mesh % 2:
        check_launches(f"driver physics {mesh}^3", counts,
                       ("shell_sweep_heat", "chemistry_heat"))
    return counts


def synth_cubep3m_tree(base, mesh, zreds, n_halos=64, seed=12):
    """A seeded CubeP3M-format input tree under `base`: the redshift
    list, one density cube per redshift in grid units (mean 1 with 20%
    noise and 8 overdense Gaussian blobs) and one halo catalog per
    redshift: 48 massive halos (200-1000 grid masses, half of them at
    the blobs) and 16 suppressible low-mass ones (5-20 grid masses), each
    one cell from a massive halo, so slice 1 suppresses those that
    slice 0 ionized.  Halo masses grow 10% per slice."""
    from c2ray_tpu_torch.io.fortran_records import write_unformatted_cube
    from c2ray_tpu_torch.io.readers import _zred_str

    rng = np.random.RandomState(seed)
    dens_dir = os.path.join(base, "coarser_densities", "halos_removed")
    src_dir = os.path.join(base, "sources")
    os.makedirs(dens_dir)
    os.makedirs(src_dir)
    zfile = os.path.join(base, "redshifts.txt")
    with open(zfile, "w") as f:
        f.write(f"{len(zreds)}\n" + "\n".join(f"{z:.3f}" for z in zreds))
    blobs = rng.randint(0, mesh, size=(8, 3))
    n_big = n_halos * 3 // 4
    big = np.concatenate([blobs[rng.randint(0, 8, n_big // 2)],
                          rng.randint(0, mesh, size=(n_big - n_big // 2, 3))])
    small = (big[rng.randint(0, n_big, n_halos - n_big)]
             + rng.choice([-1, 1], size=(n_halos - n_big, 3))) % mesh
    m_big = rng.uniform(200.0, 1000.0, n_big)
    m_small = rng.uniform(5.0, 20.0, n_halos - n_big)
    ax = np.arange(mesh)
    for i, z in enumerate(zreds):
        cube = 1.0 + 0.2 * rng.standard_normal((mesh,) * 3)
        for b in blobs:
            d = [np.minimum(np.abs(ax - c), mesh - np.abs(ax - c)) for c in b]
            r2 = (d[0][:, None, None] ** 2 + d[1][None, :, None] ** 2
                  + d[2][None, None, :] ** 2)
            cube += 3.0 * np.exp(-r2 / (2.0 * 3.0**2))
        write_unformatted_cube(
            os.path.join(dens_dir, f"{_zred_str(z)}n_all.dat"),
            np.maximum(cube, 0.1).astype(np.float32), dtype=np.float32)
        grow = 1.1 ** i
        rows = ([(*(p + 1), m * grow, 0.0) for p, m in zip(big, m_big)]
                + [(*(p + 1), 0.0, m * grow) for p, m in zip(small, m_small)])
        with open(os.path.join(src_dir, f"{_zred_str(z)}_wsubgrid_sources.dat"),
                  "w") as f:
            f.write(f"{len(rows)}\n")
            for row in rows:
                f.write("%d %d %d %.6e %.6e\n" % row)
    return zfile, base + os.sep


def driver_config(dev, workdir, mesh, zreds, results, **extra):
    """Phase 10's Run3D configuration, through the config loader a run
    file would use, on the synthetic tree under `workdir` (made by the
    first call), writing to `results`; `extra`: more Run3DConfig keys."""
    from c2ray_tpu_torch.config import run3d_config_from_dict

    tree = os.path.join(workdir, f"nbody{mesh}")
    if os.path.isdir(tree):
        zfile, base = os.path.join(tree, "redshifts.txt"), tree + os.sep
    else:
        zfile, base = synth_cubep3m_tree(tree, mesh, list(zreds))
    return run3d_config_from_dict({
        "mesh": mesh, "cosmology": "WMAP3plus",
        "nbody": {"type": "cubep3m", "redshift_file": zfile,
                  "boxsize": 10.0, "n_box": mesh, "base_dir": base,
                  "source_dir": os.path.join(base, "sources") + os.sep},
        "sed": {"bb": {"T_eff": 5.0e4, "S_star": 1.0e48}},
        "isothermal": False, "initial_temperature": 100.0,
        "steps_per_slice": 2, "density_input": "files",
        "source_input": "catalog",
        "halo_model": {"uv_model": "Iliev et al"},
        "clumping": {"type_of_clumping": 1, "clumping_factor": 1.0},
        "lls": {"type_of_LLS": 1},
        "streams": {"axis_cut": True, "ion_cubes": True,
                    "temper_rate_cubes": True, "midplane_cuts": True,
                    "density_cuts": True},
        "results_dir": results, "dump_dir": workdir,
        "dtype": "float32", "device": str(dev), **extra})


def phase_driver_full(dev, workdir, mesh=128, zreds=(9.0, 8.95, 8.9),
                      mine=("pyramid_sweep_lls", "chemistry_heat")):
    """Phases 10 and 17: Run3D.run() at full width, heating, float32, on
    a synthetic CubeP3M tree, through the config loader a run file would
    use: 2 slices at 128^3 (the pyramid engine with the per-cell LLS
    sweep), 1 slice at 203^3 (the RT grid of Iliev et al. 2006, odd: the
    shell engine, which takes no LLS grid).  Cuts from a production run:
    64 halos instead of a full catalog, 1-2 slices (the script's time
    limit); the seeded tree stands in for N-body outputs the repository
    does not hold.  The kernels in `mine` must have been launched, no
    other."""
    from c2ray_tpu_torch import driver as drv
    from c2ray_tpu_torch.sweep.evolve3d import sweep_engine

    results = os.path.join(workdir, f"run3d_results{mesh}")
    cfg = driver_config(dev, workdir, mesh, zreds, results)
    r = drv.Run3D(cfg)

    # per-step walls and each slice's sources, read around the calls
    # Run3D.run() makes
    steps, used = [], []
    evolve, run_slice = drv.evolve3d, r.run_slice

    def timed_evolve(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evolve(*a, **k)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, out[1]))
        return out

    def recorded_slice(nz, sources, **k):
        used.append(sources)
        out = run_slice(nz, sources, **k)
        b = r.last_budget
        log(f"  slice {nz}: {r.last_suppression}; budget {b}; photcons "
            f"flag {r.photcons_flag}")
        return out

    reset_launch_counts()
    drv.evolve3d, r.run_slice = timed_evolve, recorded_slice
    t0 = time.perf_counter()
    try:
        all_stats = r.run()
        torch.cuda.synchronize()
    finally:
        drv.evolve3d = evolve
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"Run3D.run() {mesh}^3 heating float32, {sweep_engine(r.evolve_cfg)} "
        f"engine: {len(all_stats)} slices x "
        f"{cfg.steps_per_slice} steps in {wall:.3f} s")
    for i, (w, st) in enumerate(steps):
        log(f"  step {i}: {w:.3f} s, {st}")
    outputs = sorted(os.listdir(results))
    log(f"  outputs ({len(outputs)}): {outputs}")
    check_launches(f"driver {mesh}^3", counts, mine)
    for t in r.state:
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError("the driver produced non-finite state")
    n_slices = len(zreds) - 1
    if not (len(all_stats) == n_slices and len(steps) == 2 * n_slices
            and len(outputs) >= 5 * n_slices
            and all(math.isfinite(float(v)) for v in r.last_budget)
            and r.last_suppression.n_total == 64):
        raise AssertionError("the driver run is incomplete")
    return r, used[-1], {mine[0]: counts[mine[0]]}


def phase_lls_times(r, sources):
    """The per-cell LLS sweep (heating, float32) at the shapes of the
    driver's last step: its state, LLS grid, sources, subbox radius and
    proper cell size."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    sweep = r.evolve_cfg.sweep
    dev = r.device
    fstack = ps.stack_sweep_fields(sweep, fields_of(r.state))
    Rf, Rb = ps.trace_extents(sweep.mesh, r._subbox_radius)
    srcpos = torch.as_tensor(sources.srcpos, dtype=torch.int32, device=dev)
    nflux = torch.as_tensor(sources.nflux, dtype=torch.float32, device=dev)
    dr = float(r.dr_proper)
    t = sweep_times(sweep, fstack, srcpos, nflux, Rf, Rb, dr=dr,
                    vos=dr**3 / sweep.flux_scale, lls=r._current_lls_grid())
    b = sweep_bound(sweep, srcpos.shape[0], Rf, Rb, lls=True)
    log(f"LLS sweep (heating) at {sweep.mesh}^3 x {srcpos.shape[0]} sources, "
        f"radius {r._subbox_radius}: kernel {t[0]:.3f} ms, plain {t[1]:.3f} "
        f"ms, bound {b[0]:.3f} ms ({b[1]}), max |kernel - plain| "
        f"{t[2]:.3e} (f32 rates)")
    return t, b


# ---- the shell and octant engines (phases 15-17)

def engine_trace_fns(engine, table=None):
    """(kernel, plain version) of the shell (over `table`) or octant
    engine, each mapping (sweep config, fstack, srcpos, nflux) to
    (slab, photon loss, LLS loss)."""
    from c2ray_tpu_torch.sweep import octant_sweep as oc
    from c2ray_tpu_torch.sweep import source_sweep as ss

    if engine == "shells":
        return tuple(lambda c, *a, fn=fn: fn(c, table, *a)
                     for fn in (ss.shell_sweep_cuda, ss.shell_sweep_plain))

    def with_lls(fn):
        def run(*a):
            slab, ploss = fn(*a)
            return slab, ploss, torch.zeros_like(ploss)
        return run
    return with_lls(oc.octant_sweep_cuda), with_lls(oc.octant_sweep_plain)


def compare_engine(cfg64, cfg32, M, dev, engine, table, lls):
    """One case of phase 15: the engine's kernel vs its plain version on
    3 random sources (one at a grid edge), float64 within rtol 1e-10 and
    float32 within twice the plain float32 error against float64 plus
    1e-5, each part (rates, heat, photon and LLS loss) on its own scale.
    Returns the worst float32 relative error of the kernel."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    kern, plain = engine_trace_fns(engine, table)
    out = {}
    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        sweep = dataclasses.replace(cfg.sweep, coldensh_LLS=lls)
        state, srcpos, nflux = random_case(M, 3, dtype, dev, seed=5)
        fstack = ps.stack_sweep_fields(sweep, fields_of(state))
        unit = sweep.flux_scale / cfg64.sweep.flux_scale
        out[name] = tuple(_sweep_parts(fn(sweep, fstack, srcpos, nflux), unit)
                          for fn in (kern, plain))
    (k64, p64), (k32, p32) = out["f64"], out["f32"]
    extents = ("full" if table is None
               else f"{table.lo[0]}..{table.hi[0]}")
    label = f"{engine} {M}^3 extents {extents} lls={lls:g}"
    for a, b, w in zip(k64, p64, SWEEP_PARTS):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * scale,
                                   msg=f"f64 {label} {w}")
    worst = 0.0
    for a64, a, b, ref, w in zip(k64, k32, p32, p64, SWEEP_PARTS):
        ek = rel_err(a.double(), ref)
        ep = rel_err(b.double(), ref)
        log(f"  {label} {w}: f64 kernel-plain {rel_err(a64, ref):.3e}; vs "
            f"f64 plain: f32 kernel {ek:.3e}, f32 plain {ep:.3e}")
        if not ek <= 2.0 * ep + 1e-5:
            raise AssertionError(f"f32 {label} {w}: kernel error {ek:.3e} "
                                 f"vs plain {ep:.3e}")
        worst = max(worst, ek)
    return worst


def phase_compare_engines(dev):
    """Phase 15: the shell kernel vs its plain version at 32^3 (full
    extents), 33^3 (odd) and 32^3 under build_shell_table(32, 8), the
    octant kernel at 32^3, each float64 and float32, isothermal and
    heating, without and with a homogeneous LLS column; then the shell,
    octant and pyramid kernels against each other at 32^3 in float64
    (rates, heat and photon loss within rtol 1e-10: the JAX package's
    own pyramid-vs-octant tolerance).  Returns the worst float32 error
    of each kernel variant."""
    from c2ray_tpu_torch.sweep import build_shell_table
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    worst = {}
    for heating in (False, True):
        sfx = "_heat" if heating else ""
        cfgs = {M: tuple(setup(M, 1e48, 5e4, 10.0, dt, dev, heating)[0]
                         for dt in (torch.float64, torch.float32))
                for M in (32, 33)}
        cases = [("shells", 32, build_shell_table(32)),
                 ("shells", 33, build_shell_table(33)),
                 ("shells", 32, build_shell_table(32, 8)),
                 ("octant", 32, None)]
        for engine, M, table in cases:
            for lls in (0.0, 1.0e15):
                e = compare_engine(*cfgs[M], M, dev, engine, table, lls)
                key = ENGINE_KERNEL[engine] + sfx
                worst[key] = max(worst.get(key, 0.0), e)
        sweep = cfgs[32][0].sweep
        state, srcpos, nflux = random_case(32, 3, torch.float64, dev, seed=5)
        fstack = ps.stack_sweep_fields(sweep, fields_of(state))
        Rf, Rb = ps.trace_extents(32)
        pyr = ps.trace_cuda(sweep, fstack, srcpos, nflux, Rf, Rb)
        for engine, table in (("shells", build_shell_table(32)),
                              ("octant", None)):
            other = engine_trace_fns(engine, table)[0](sweep, fstack, srcpos,
                                                       nflux)
            errs = []
            for a, b, w in ((other[0][..., :3], pyr[0][..., :3], "rates"),
                            (other[0][..., 3], pyr[0][..., 3], "heat"),
                            (other[1], pyr[1], "photon_loss")):
                torch.testing.assert_close(
                    a, b, rtol=1e-10, atol=1e-10 * float(b.abs().max()),
                    msg=f"{engine} vs pyramid kernels, {w}")
                errs.append(rel_err(a, b))
            log(f"  {engine} vs pyramid kernels at 32^3 f64"
                f"{' heating' if heating else ''}: rates {errs[0]:.3e}, "
                f"heat {errs[1]:.3e}, photon loss {errs[2]:.3e}")
    log("shell and octant kernels vs plain, and vs the pyramid kernel: ok")
    return worst


def phase_engine_times(cfg, s, srcpos, nflux, engine):
    """The shell or octant kernel's time (CUDA events, mean of 3 after a
    warm-up) and its plain version's (one pass) at the main path's
    shapes (phase 16's state), and their largest differences, within
    the float32 tolerance of the pyramid kernel's main-path check (1e-4
    with 1e-4 of each part's largest value as the floor).  Returns (ms,
    plain_ms, max |kernel - plain| of the rates (1/s), the heat's
    largest difference relative to its largest value)."""
    from c2ray_tpu_torch.sweep import build_shell_table
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    mesh = cfg.sweep.mesh
    kern, plain = engine_trace_fns(engine, build_shell_table(mesh))
    args = (cfg.sweep, ps.stack_sweep_fields(cfg.sweep, fields_of(s)),
            srcpos, nflux)
    ms = event_ms(lambda: kern(*args), 3)
    k = kern(*args)
    p, wall = synced(plain, *args)
    for a, b, w in zip(_sweep_parts(k, 1.0), _sweep_parts(p, 1.0),
                       SWEEP_PARTS):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()),
                                   msg=f"{engine} sweep {w} at {mesh}^3")
    abs_err = float((k[0][..., :3] - p[0][..., :3]).abs().max())
    heat_rel = rel_err(k[0][..., 3], p[0][..., 3])
    b = sweep_bound(cfg.sweep, srcpos.shape[0], mesh // 2, mesh // 2 - 1)
    v = "heating " if not cfg.sweep.isothermal else ""
    log(f"{v}{engine} sweep at {mesh}^3 x {srcpos.shape[0]}: kernel {ms:.3f} "
        f"ms, plain {1e3 * wall:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), max "
        f"|kernel - plain| {abs_err:.3e} (f32 rates, 1/s), heat {heat_rel:.3e}"
        f" of its largest value")
    return ms, 1e3 * wall, abs_err, heat_rel, b


# ---- the multi-GPU slice (phases 18-21)

# the slab shapes of the halo kernels' comparisons, (mesh, ranks,
# radius): D = 8 at 32^3 and radius 5 (S = 4, H = 6: several hops), and
# the main path's at world size 1: D = 1 at 128^3, full radius (S = 128,
# H = 64)
HALO_SHAPES = ((32, 8, 5), (128, 1, 64))


def halo_case(M, D, radius, dtype, dev, C=5, seed=4):
    """A rank's inputs of the three halo kernels at a slab shape: its
    field slabs (a fifth of the fractions 0, below epsilon), the received
    halos, a rate slab, three windows and their cubes, and the received
    fold chunks with their table."""
    from c2ray_tpu_torch.parallel import domain

    S = M // D
    Mw, _, H = domain._window_geometry(M, radius)
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, dtype=dtype,
                                  device=dev)
    n = S * M * M
    fields = [1e-4 + 1e-2 * u(n)]
    fields += [torch.where(u(n) < 0.2, 0.0, u(n)) for _ in range(4)]
    fields += [1e18 * u(n) for _ in range(C - 5)]
    left, right = u(H, M, M, C), u(H, M, M, C)
    rc = u(S + 2 * H, M + 2 * H, M + 2 * H, 4)
    rng = np.random.RandomState(seed)
    starts = [tuple(int(rng.randint(0, e - Mw + 1)) for e in rc.shape[:3])
              for _ in range(3)]
    cubes = [u(Mw, Mw, Mw, 4) for _ in starts]
    chunks, b0 = [], 0
    for _, lo, hi, at in domain._fold_messages(S, H):
        chunks.append((b0, at, hi - lo))
        b0 += hi - lo
    return dict(S=S, H=H, Mw=Mw, fields=fields, left=left, right=right,
                rc=rc, starts=starts, cubes=cubes, recv=u(b0, M, M, 4),
                chunks=chunks)


def halo_pairs(c, M):
    """(name, kernel result, plain result) of every halo kernel use on
    the case `c`: the pack and the planes sent, three window adds in
    order, the fold and the halo planes sent."""
    from c2ray_tpu_torch.parallel import halo

    S, H = c["S"], c["H"]
    pack = (c["fields"], M, 1e-20, c["left"], c["right"], H)
    sends = (c["fields"], M, 1e-20, None, None, 0, (max(0, S - H), S))
    rk, rp = c["rc"].clone(), c["rc"].clone()
    for st, cube in zip(c["starts"], c["cubes"]):
        halo.window_accumulate_cuda(rk, cube, st)
        halo.window_accumulate_plain(rp, cube, st)
    fold = (c["rc"], M, (H, H + S), c["recv"], c["chunks"])
    fold_sends = (c["rc"], M, (0, H), None, (), False)
    return [("halo_pack", halo.halo_pack_cuda(*pack),
             halo.halo_pack_plain(*pack)),
            ("halo_pack sends", halo.halo_pack_cuda(*sends),
             halo.halo_pack_plain(*sends)),
            ("window_accumulate", rk, rp),
            ("fold_halo", halo.fold_halo_cuda(*fold),
             halo.fold_halo_plain(*fold)),
            ("fold_halo sends", halo.fold_halo_cuda(*fold_sends),
             halo.fold_halo_plain(*fold_sends))]


def phase_compare_halo(dev):
    """Phase 18: the three halo kernels against their plain versions on
    the card, float64 and float32, at HALO_SHAPES, with and without the
    LLS channel: equal to the bit (they copy, take a max and add in the
    plain versions' order)."""
    for M, D, radius in HALO_SHAPES:
        for dtype in (torch.float64, torch.float32):
            for C in (5, 6):
                c = halo_case(M, D, radius, dtype, dev, C=C)
                for name, k, p in halo_pairs(c, M):
                    if k.shape != p.shape or not torch.equal(k, p):
                        raise AssertionError(
                            f"{name} at {M}^3 D={D} radius {radius} {dtype}"
                            f" C={C}: kernel differs from plain by "
                            f"{float((k - p).abs().max()):.3e}")
                del c
        log(f"halo kernels at {M}^3, D = {D}, radius {radius}: kernel == "
            f"plain to the bit, f64 and f32, 5 and 6 channels")


def init_nccl(dev, workdir):
    """The NCCL process group of one rank on `dev`, met through a
    FileStore under the script's build directory."""
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(workdir, "nccl_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=dev)


def phase_nccl(dev, workdir, mesh=128):
    """Phase 19: NCCL at world size 1: the collectives of the parallel
    iterations on the card (the ppermute to the rank itself a local
    copy), a CPU tensor refused, and the time of one all-reduce of the
    four rate grids and one all-gather of the chemistry's 12 fields."""
    import torch.distributed as dist

    from c2ray_tpu_torch.parallel import comm

    init_nccl(dev, workdir)
    x = torch.arange(12.0, device=dev).view(4, 3)
    if not (torch.equal(comm.psum(x), x)
            and torch.equal(comm.all_gather(x), x)
            and torch.equal(comm.ppermute(x, 1), x)
            and comm.axis_size() == 1 and comm.rank() == 0):
        raise AssertionError("NCCL collectives at world size 1 differ")
    try:
        comm.psum(torch.zeros(2))
    except ValueError:
        pass
    else:
        raise AssertionError("a CPU tensor on an NCCL group was accepted")
    buf = torch.rand(4 * mesh**3, device=dev)
    ar_ms = event_ms(lambda: dist.all_reduce(buf), 10)
    blk = torch.rand(1, 12, mesh**3, device=dev)
    ag_ms = event_ms(lambda: comm.all_gather(blk), 10)
    log(f"NCCL world size 1 ({dist.get_backend()}): all_reduce of "
        f"{buf.numel() * 4 / 1e6:.1f} MB {ar_ms:.4f} ms; all_gather of "
        f"{blk.numel() * 4 / 1e6:.1f} MB {ag_ms:.4f} ms")
    return {"all_reduce_ms": ar_ms, "all_reduce_MB": buf.numel() * 4 / 1e6,
            "all_gather_ms": ag_ms, "all_gather_MB": blk.numel() * 4 / 1e6}


def _rate_parts(out):
    r = out[4]
    return torch.stack([r.phih, r.phihe0, r.phihe1]), r.phiheat


def phase_parallel_main(dev, heating=False, mesh=128, n_src=8, n_iter=4):
    """Phase 20: the bench configuration of phase 4 (5) in float32
    through the parallel entry points at world size 1: make_domain_
    iteration at the full radius and make_parallel_iteration beside the
    single-device make_evolve3d_iteration, timed in turns (single,
    domain, source, source, domain, single; a warm-up and n_iter
    iterations each), then one timestep each of evolve3d, domain_
    evolve3d and parallel_evolve3d.  The first iteration of each from
    the same state is held to the single-device one: the rate grids and
    the photon loss to phase 4's sweep tolerance (rtol 1e-4, 1e-4 of
    the largest value as the floor, each part on its own scale), the
    state to the chemistry's (2e-2: a cell whose 1% test flips stops one
    iteration apart); the timesteps' mean ionized fractions within 1%.
    Returns the halo kernels' launches and the rates."""
    from c2ray_tpu_torch.parallel import (ParallelConfig, domain_evolve3d,
                                          group_sources_by_slab,
                                          make_domain_iteration,
                                          make_parallel_iteration,
                                          parallel_evolve3d,
                                          shard_state_slabs)
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import evolve3d, make_evolve3d_iteration

    v = "heating " if heating else ""
    cfg, _ = setup(mesh, *BENCH_SOURCE, torch.float32, dev, heating)
    rng = np.random.RandomState(7)
    sp_np = rng.randint(0, mesh, size=(n_src, 3))
    nf_np = np.concatenate([rng.uniform(0.5, 2.0, (n_src, 1)),
                            np.zeros((n_src, 2))], axis=1)
    srcpos = torch.as_tensor(sp_np, device=dev)
    nflux = torch.as_tensor(nf_np, dtype=torch.float32, device=dev)
    state0 = initial_grid_state(np.full((mesh,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                                1.0e4, dtype=torch.float32, device=dev)
    dt = 1.0e14
    pcfg = ParallelConfig(cfg)
    gsp, gnf = group_sources_by_slab(sp_np, nf_np, mesh, 1)
    gnf = torch.as_tensor(gnf, dtype=torch.float32, device=dev)
    modes = {
        "single": (make_evolve3d_iteration(cfg, return_rates=True), state0,
                   srcpos, nflux),
        "domain": (make_domain_iteration(pcfg, mesh // 2, return_rates=True),
                   shard_state_slabs(state0), gsp, gnf),
        "source": (make_parallel_iteration(pcfg, return_rates=True), state0,
                   srcpos, nflux)}
    sfx = "_heat" if heating else ""
    mine = {"single": ("pyramid_sweep" + sfx, "chemistry" + sfx),
            "source": ("pyramid_sweep" + sfx, "chemistry" + sfx),
            "domain": ("pyramid_sweep" + sfx, "chemistry" + sfx, "halo_pack",
                       "window_accumulate", "fold_halo")}
    first, spi, halo_counts = {}, {k: [] for k in modes}, {}
    for mode in ("single", "domain", "source", "source", "domain", "single"):
        it, s, sp, nf = modes[mode]
        reset_launch_counts()
        out, warm = synced(it, s, sp, nf, dt)
        first.setdefault(mode, out)
        s = out[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            s = it(s, sp, nf, dt)[0]
        torch.cuda.synchronize()
        spi[mode].append((time.perf_counter() - t0) / n_iter)
        counts = launch_counts()
        check_launches(f"{v}{mode} iteration", counts, mine[mode])
        if mode == "domain":
            for k in mine[mode][2:]:
                halo_counts[k] = halo_counts.get(k, 0) + counts[k]
        log(f"  {v}{mode}: warm-up {warm:.3f} s")
    for mode, w in spi.items():
        log(f"{v}{mode} iteration {mesh}^3 x {n_src} float32, world size 1: "
            f"{mesh**3 * n_src / np.mean(w):.6e} cell-source-updates/s, "
            f"{', '.join(f'{x:.6f}' for x in w)} s/iteration")
    ref = first["single"]
    for mode in ("domain", "source"):
        out = first[mode]
        for a, b, what in zip(_rate_parts(out) + (out[2],),
                              _rate_parts(ref) + (ref[2],),
                              ("rates", "heat", "photon_loss")):
            err = rel_err(a.double(), b.double())
            log(f"  {v}{mode} vs single {what}: {err:.3e} of the largest")
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()),
                                       msg=f"{v}{mode} {what}")
        for a, b, nm in zip(out[0], ref[0], ref[0]._fields):
            if nm == "clumping":
                continue
            torch.testing.assert_close(
                a, b, rtol=2e-2, atol=0.0 if nm.startswith("t_") else 2e-2,
                msg=f"{v}{mode} state {nm}")
        log(f"  {v}{mode} vs single: conv_flag {int(out[1])} / "
            f"{int(ref[1])}, largest |h_av1| difference "
            f"{float((out[0].h_av1 - ref[0].h_av1).abs().max()):.3e}")
    # one timestep of each (the adaptive subbox ladder from radius 8)
    steps = {}
    (s1, st1), w1 = synced(evolve3d, cfg, state0, srcpos, nflux, dt)
    steps["single"] = (w1, st1, s1.h1)
    reset_launch_counts()
    (sd, std), wd = synced(domain_evolve3d, pcfg, shard_state_slabs(state0),
                           sp_np, nf_np, dt)
    counts = launch_counts()
    for k in mine["domain"][2:]:
        halo_counts[k] += counts[k]
    steps["domain"] = (wd, std, sd.h1)
    (sp_, stp), wp = synced(parallel_evolve3d, pcfg, state0, sp_np, nf_np,
                            dt)
    steps["source"] = (wp, stp, sp_.h1)
    x_ref = float(s1.h1.double().mean())
    for mode, (w, st, h1) in steps.items():
        x = float(h1.double().mean())
        log(f"  {v}{mode} timestep: {w:.3f} s, "
            f"{mesh**3 * n_src * st.n_iterations / w:.6e} cell-source-"
            f"updates/s over its iterations, {st}, mean ionized fraction "
            f"{x:.6e}")
        if not (bool(torch.isfinite(h1).all()) and h1.shape == (mesh**3,)
                and abs(x - x_ref) <= 1e-2 * x_ref):
            raise AssertionError(f"{v}{mode} timestep differs from the "
                                 f"single-device one")
    return halo_counts


def phase_driver_domain(dev, workdir, r10, mesh=128, zreds=(9.0, 8.95, 8.9)):
    """Phase 21: Run3D(parallel="domain", n_devices=1) on phase 10's
    configuration and synthetic tree (128^3, heating, float32, 2 slices
    x 2 steps): the domain iteration at world size 1 under the driver,
    its ladder of windows from radius 8.  Its mean ionized fraction
    within 1% of phase 10's (each cell's fixed point converges to 1%),
    the same output files (rank 0 writes)."""
    from c2ray_tpu_torch import driver as drv

    results = os.path.join(workdir, f"run3d_domain_results{mesh}")
    cfg = driver_config(dev, workdir, mesh, zreds, results,
                        parallel="domain", n_devices=1)
    r = drv.Run3D(cfg)
    reset_launch_counts()
    (all_stats, wall) = synced(r.run)
    counts = launch_counts()
    mine = ("pyramid_sweep_lls", "chemistry_heat", "halo_pack",
            "window_accumulate", "fold_halo")
    check_launches("driver domain", counts, mine)
    x, x10 = (float(t.h1.double().mean()) for t in (r.state, r10.state))
    outputs = sorted(os.listdir(results))
    want = sorted(os.listdir(r10.config.results_dir))
    log(f"Run3D.run() parallel='domain' {mesh}^3 heating float32 at world "
        f"size 1: {wall:.3f} s; mean ionized fraction {x:.6e} (phase 10: "
        f"{x10:.6e}, {abs(x - x10) / x10:.3e} relative); "
        f"{[[s.n_iterations for s in sl] for sl in all_stats]} iterations")
    if not (abs(x - x10) <= 1e-2 * x10 and outputs == want
            and all(bool(torch.isfinite(t).all()) for t in r.state
                    if t.dtype.is_floating_point)):
        raise AssertionError("the domain-mode driver run differs from "
                             "phase 10's")
    return {k: counts[k] for k in mine[2:]}


def phase_halo_times(dev, M=128, radius=64):
    """The halo kernels' device times beside their plain versions' and,
    for the window add, the strided PyTorch add, at the main path's
    shapes (world size 1, 128^3, full radius, float32, 5 channels);
    each one's bound: the bytes it must move (inputs read once, outputs
    written once) at 3.35 TB/s, its adds at the float32 rate."""
    from c2ray_tpu_torch.parallel import halo

    c = halo_case(M, 1, radius, torch.float32, dev)
    S, H, Mw, C = c["S"], c["H"], c["Mw"], 5
    pack = (c["fields"], M, 1e-20, c["left"], c["right"], H)
    rc, cube, st = c["rc"], c["cubes"][0], c["starts"][0]
    w = tuple(slice(s, s + Mw) for s in st)
    fold = (rc, M, (H, H + S), c["recv"], c["chunks"])
    Y, nrecv = M + 2 * H, c["recv"].shape[0]
    errs = {n: float((k - p).abs().max()) for n, k, p in halo_pairs(c, M)}
    out = {}
    for name, kern, plain, lib, nbytes, adds in (
            ("halo_pack", lambda: halo.halo_pack_cuda(*pack),
             lambda: halo.halo_pack_plain(*pack), None,
             4 * C * (S * M * M + 2 * H * M * M + (S + 2 * H) * Y * Y), 0),
            ("window_accumulate",
             lambda: halo.window_accumulate_cuda(rc, cube, st),
             lambda: halo.window_accumulate_plain(rc, cube, st),
             lambda: rc[w].add_(cube), 4 * 3 * Mw**3 * 4, Mw**3 * 4),
            ("fold_halo", lambda: halo.fold_halo_cuda(*fold),
             lambda: halo.fold_halo_plain(*fold), None,
             4 * 4 * (S * Y * Y + nrecv * M * M + S * M * M),
             4 * S * M * M * 3)):
        ms = event_ms(kern, 10)
        plain_ms = event_ms(plain, 3)
        lib_ms = None if lib is None else event_ms(lib, 10)
        err = errs[name]
        b = bound(nbytes, adds, 0)
        out[name] = (ms, plain_ms, err, b, lib_ms)
        log(f"{name} at {M}^3, world size 1, radius {radius} float32: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms"
            + ("" if lib_ms is None else f", rc[window].add_ {lib_ms:.4f} ms")
            + f", bound {b[0]:.4f} ms ({b[1]}, {nbytes / 1e6:.1f} MB), "
            f"max |kernel - plain| {err:.3e}")
    return out


# ---- the 1D program (phases 11-13)

MYR = 1.0e6 * 3.15576e7     # s (c2ray_tpu_torch.constants.YEAR)

# phase 11's variants: (test problem, isothermal, quadrature route,
# monochromatic tables, dt in Myr); heating runs take 1 Myr steps, whose
# fixed points converge in a few rounds (ROADMAP Queue 3)
ONED_VARIANTS = {
    "quadrature": (1, True, True, False, 10.0),
    "quadrature heating": (1, False, True, False, 1.0),
    "table": (1, True, False, False, 10.0),
    "table heating": (1, False, False, False, 1.0),
    "monochromatic": (1, True, True, True, 10.0),
    "test 4": (4, True, True, False, 5.0),
}
# the kernel variant each runs, the name of its `kernels` entry
ONED_KERNEL = {"quadrature": "evolve1d", "quadrature heating": "evolve1d_heat",
               "table": "evolve1d_table",
               "table heating": "evolve1d_table_heat",
               "monochromatic": "evolve1d", "test 4": "evolve1d"}
# phase 12's runs and phase 14's: (kernels entry, isothermal, quadrature)
ONED_MAIN = (("evolve1d", True, True), ("evolve1d_heat", False, True),
             ("evolve1d_table", True, False))
ONED_FULL_MESH = 10000     # files_for_1D/sizes.f90:27


def oned_problem(testnum, isothermal=True):
    """(problem, r_out in kpc, blackbody S_star) of the four problems of
    tools/tpu_1d_check.py (a 1e5 K blackbody each)."""
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.onedim import OneDProblem

    kpc = const.kpc
    if testnum == 1:
        return OneDProblem(testnum=1, dens_val=1.0e-3, temper_val=1e4,
                           isothermal=isothermal), 10.0, 5.0e48
    if testnum == 2:
        return OneDProblem(testnum=2, dens_val=1.0e-3, r_core=kpc,
                           temper_val=1e4, isothermal=isothermal), 8.0, 4.8e47
    if testnum == 3:
        n_core = 1.2e-3
        S_star = 4.0 * const.pi * n_core**2 * kpc**3 * const.bh00 * 4.0 / 3.0
        return OneDProblem(testnum=3, dens_val=n_core, r_core=kpc,
                           temper_val=1e4, isothermal=isothermal), 6.0, S_star
    return OneDProblem(testnum=4, dens_val=1.87e-4 / 1000.0, temper_val=1e4,
                       isothermal=isothermal, zred00=9.0), 700.0, 3.0e50


def oned_run(testnum, mesh, dtype, device, isothermal=True, quadrature=True,
             mono=False):
    """A `OneDRun` of a test problem on `device`; `mono`: the 13.6 eV
    monochromatic tables (one band, K = 1, a zero HeI mask)."""
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.grid import RadialGrid
    from c2ray_tpu_torch.onedim.driver import OneDRun
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.radiation.monochromatic import \
        build_monochromatic_tables

    problem, r_out, S_star = oned_problem(testnum, isothermal)
    sed = SEDConfig(bb=BlackBodySED(T_eff=1.0e5, S_star=S_star))
    run = OneDRun.setup(problem, RadialGrid(0.0, r_out * const.kpc, mesh),
                        sed, dtype=dtype, use_quadrature=quadrature,
                        device=device)
    if mono:
        qt, _, bands = build_monochromatic_tables(
            sed, 13.6, isothermal=isothermal, dtype=dtype, device=device)
        run.ctx = dataclasses.replace(
            run.ctx, tables=qt, flux_scale=bands.flux_scale,
            vol=torch.as_tensor(run.grid.vol / bands.flux_scale,
                                dtype=dtype, device=device))
    return run


def oned_errors(state, ref):
    """(largest |difference| of the fractions, largest relative one of
    the temperatures) of a 1D state from the float64 reference."""
    frac = max(float((getattr(state, f).double().cpu()
                      - getattr(ref, f).double().cpu()).abs().max())
               for f in ("xh", "xhe"))
    t = ref.temper.double().cpu()
    temp = float(((state.temper.double().cpu() - t).abs() / t).max())
    return frac, temp


def phase_compare_1d(dev, mesh=128, n_steps=2):
    """Phase 11: the 1D kernel against its plain version (on the CPU),
    each variant from the same initial state over n_steps timesteps.
    float64: each shell's iteration count equal, fractions within 1e-10
    relative with a 1e-12 floor, temperatures within 1e-10.  float32:
    the kernel's error against the plain float64 run within twice the
    plain float32 run's, plus 1e-5 (the lanes add the bands in another
    order and FMA contraction rounds the columns differently; fractions
    absolute, temperatures relative).  Returns, per variant, (the
    kernel's worst float32 error, max |kernel - plain| in float32, the
    kernel's and the plain version's float32 step walls in ms)."""
    cpu = torch.device("cpu")
    out = {}
    for variant, (testnum, iso, quad, mono, dt_myr) in ONED_VARIANTS.items():
        dt = dt_myr * MYR
        runs = {(dtype, where): oned_run(testnum, mesh, dtype, where, iso,
                                         quad, mono)
                for dtype in (torch.float64, torch.float32)
                for where in (dev, cpu)}
        worst = kp_abs = 0.0
        for step in range(n_steps):
            nits, walls = {}, {}
            for key, run in runs.items():
                nits[key], walls[key] = synced(run.step, dt)
            k64, p64 = runs[torch.float64, dev], runs[torch.float64, cpu]
            k32, p32 = runs[torch.float32, dev], runs[torch.float32, cpu]
            if not torch.equal(nits[torch.float64, dev].cpu(),
                               nits[torch.float64, cpu]):
                raise AssertionError(f"1D {variant} f64: iteration counts "
                                     f"differ in step {step}")
            for f in ("xh", "xhe", "temper"):
                torch.testing.assert_close(
                    getattr(k64.state, f).cpu(), getattr(p64.state, f),
                    rtol=1e-10, atol=0.0 if f == "temper" else 1e-12,
                    msg=f"1D {variant} f64 {f} step {step}")
            fk, tk = oned_errors(k32.state, p64.state)
            fp, tp = oned_errors(p32.state, p64.state)
            kp_abs = max(kp_abs, oned_errors(k32.state, p32.state)[0])
            f64f, f64t = oned_errors(k64.state, p64.state)
            log(f"  1D {variant} step {step}: f64 kernel-plain fractions "
                f"{f64f:.3e} T {f64t:.3e} (iterations "
                f"{int(nits[torch.float64, cpu].sum())}, equal); f32 vs f64 "
                f"plain: kernel fractions {fk:.3e} T {tk:.3e}, plain "
                f"fractions {fp:.3e} T {tp:.3e}; f32 counters kernel "
                f"{k32.last_counters.tolist()}, plain "
                f"{p32.last_counters.tolist()}; f32 walls kernel "
                f"{1e3 * walls[torch.float32, dev]:.3f} ms, plain (CPU) "
                f"{1e3 * walls[torch.float32, cpu]:.1f} ms")
            if not (fk <= 2.0 * fp + 1e-5 and tk <= 2.0 * tp + 1e-5):
                raise AssertionError(f"1D {variant} f32: kernel error "
                                     f"{fk:.3e}/{tk:.3e} vs plain "
                                     f"{fp:.3e}/{tp:.3e}")
            worst = max(worst, fk, tk)
        out[variant] = (worst, kp_abs, 1e3 * walls[torch.float32, dev],
                        1e3 * walls[torch.float32, cpu])
    log("1D kernel vs plain: ok")
    return out


def phase_main_1d(dev, mesh=ONED_FULL_MESH, n_steps=12):
    """Phase 12: the 1D main path at full width, test 1 in float32 at
    the reference program's 10000 shells (files_for_1D/sizes.f90:27),
    12 x 10 Myr through `OneDRun`, three ways.  Each run launches its
    kernel variant once per step and no other kernel; the isothermal
    fronts lie within 5% of the analytic one, the heating front (hotter
    gas recombines more slowly) within 10% of it."""
    from c2ray_tpu_torch.onedim.output import (front_comparison,
                                               photon_statistics_1d)

    out = {}
    dt = 10.0 * MYR
    for name, iso, quad in ONED_MAIN:
        run = oned_run(1, mesh, torch.float32, dev, iso, quad)
        reset_launch_counts()
        walls, hosts, counters, capped = [], [], [], []
        for _ in range(n_steps):
            before = run.state
            # the host's share: the time until step() returns (the launch
            # is asynchronous; the first step also packs the tables)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nits = run.step(dt)
            hosts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counters.append(run.last_counters.tolist())
            capped.append(int((nits == run.ctx.max_cell_iter).sum()))
        counts = launch_counts()
        stats = photon_statistics_1d(run, before, dt)
        fc = front_comparison(run)
        its = [c[0] for c in counters]
        log(f"1D main path {name} (test 1, mesh {mesh}, float32, {n_steps} x "
            f"10 Myr): step wall mean {1e3 * np.mean(walls):.3f} ms, largest "
            f"{1e3 * max(walls):.3f} ms; iterations summed {sum(its)} "
            f"(per step {its}), largest of a shell "
            f"{max(c[1] for c in counters)}, shells at the "
            f"{run.ctx.max_cell_iter}-iteration cap per step {capped}; "
            f"thermal sub-steps largest "
            f"{max(c[2] for c in counters)}, summed "
            f"{sum(c[3] for c in counters)}")
        log(f"  host time in step(): first step {1e3 * hosts[0]:.3f} ms "
            f"(packs the tables), later steps mean "
            f"{1e3 * np.mean(hosts[1:]):.3f} ms; host share of the step "
            f"walls {sum(hosts) / sum(walls):.3e}")
        log(f"  front {fc.numerical:.6e} cm vs analytic {fc.analytic:.6e} cm "
            f"(relative error {fc.relative_error:.5f}); last step photon "
            f"conservation {stats.photon_conservation:.6f} ({stats})")
        check_launches(f"1D main path {name}", counts, (name,))
        if counts[name] != n_steps:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{n_steps} steps")
        for t in run.state:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"1D {name} produced non-finite state")
        if run.state.xh.shape != (mesh, 2) or run.state.xhe.shape != (mesh, 3):
            raise AssertionError(f"1D {name} state has the wrong shape")
        limit = 0.05 if iso else 0.10
        if not (fc.relative_error < limit
                and math.isfinite(stats.photon_conservation)):
            raise AssertionError(f"1D {name}: front error "
                                 f"{fc.relative_error:.4f} (limit {limit})")
        out[name] = {"run": run, "dt": dt, "launches": counts[name],
                     "front": fc, "walls": walls,
                     "host_share": sum(hosts) / sum(walls)}
    return out


def phase_physics_1d(dev, main):
    """Phase 13: the four analytic fronts of tools/tpu_1d_check.py in
    float32 on the card (mesh 128, its tolerances), and the test-1 front
    at mesh 128, 512 and 10000 (phase 12)."""
    from c2ray_tpu_torch.onedim.output import front_comparison

    cases = ((1, 120e6, 12, 0.07), (2, 300e6, 15, 0.12),
             (3, 300e6, 15, 0.22), (4, 50e6, 10, 0.17))
    ok, fronts = True, {}
    for testnum, years, n_steps, tol in cases:
        run = oned_run(testnum, 128, torch.float32, dev)
        for _ in range(n_steps):
            run.step(years / 1e6 * MYR / n_steps)
        err = front_comparison(run).relative_error
        ok = ok and err < tol
        if testnum == 1:
            fronts[128] = err
        log(f"  {'PASS' if err < tol else 'FAIL'} 1D test {testnum}: front "
            f"relative error {err:.5f} (limit {tol})")
    run = oned_run(1, 512, torch.float32, dev)
    for _ in range(12):
        run.step(10.0 * MYR)
    fronts[512] = front_comparison(run).relative_error
    fronts[10000] = main["evolve1d"]["front"].relative_error
    log("  test-1 front error in float32 by mesh: " + ", ".join(
        f"{m}: {e:.5f}" for m, e in sorted(fronts.items())))
    if not ok:
        raise AssertionError("1D physics check failed")


# phase 14's conditioning runs of the heating variant: its plain step
# over the first ONED_PREFIX shells (which depend on no later one) with
# their volumes k float64 ulps off, k = +-1..+-ONED_ULPS
ULP = "+ulp"
ONED_PREFIX = 64
ONED_ULPS = 8


def oned_reference(name, out_path):
    """Phase 14's plain run of one variant: one float64 10 Myr step of
    test 1 at mesh 10000 from the initial state on the CPU, in a process
    of its own; writes the state, the iteration counts and the wall to
    `out_path` (.npz).  With ULP, the variant's conditioning runs
    instead: the largest relative change of each of the first
    ONED_PREFIX shells' temperatures over them."""
    from c2ray_tpu_torch.onedim.evolve import State1D, evolve1d_plain

    torch.set_num_threads(1)
    base = name.removesuffix(ULP)
    _, iso, quad = next(v for v in ONED_MAIN if v[0] == base)
    run = oned_run(1, ONED_FULL_MESH, torch.float64, "cpu", iso, quad)
    if name != base:
        head = State1D(*(t[:ONED_PREFIX] for t in run.state))

        def prefix_t(k):
            ctx = dataclasses.replace(
                run.ctx, vol=run.ctx.vol[:ONED_PREFIX] * (1.0 + k * 2.0**-52))
            return evolve1d_plain(ctx, head, 10.0 * MYR)[0].temper.numpy()

        t_ref = prefix_t(0)
        ks = [k for k in range(-ONED_ULPS, ONED_ULPS + 1) if k]
        spread = np.max([_rel(prefix_t(k), t_ref) for k in ks], axis=0)
        np.savez(out_path + ".tmp.npz", spread=spread)
    else:
        t0 = time.perf_counter()
        nits = run.step(10.0 * MYR)
        wall = time.perf_counter() - t0
        st = run.state
        np.savez(out_path + ".tmp.npz", xh=st.xh.numpy(),
                 xhe=st.xhe.numpy(), temper=st.temper.numpy(),
                 nits=nits.numpy(), counters=run.last_counters.numpy(),
                 wall=wall)
    os.replace(out_path + ".tmp.npz", out_path)


def start_oned_references(workdir):
    """Start phase 14's plain runs, one process per variant and one for
    the heating variant's conditioning, that see no GPU; returns {name:
    (process, result path, log path)}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    refs = {}
    for name in [v[0] for v in ONED_MAIN] + ["evolve1d_heat" + ULP]:
        out = os.path.join(workdir, f"{name}_f64_plain.npz")
        logp = os.path.join(workdir, f"{name}_f64_plain.log")
        with open(logp, "w") as lf:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--oned-reference",
                 name, out], env=env, stdout=lf, stderr=subprocess.STDOUT)
        refs[name] = (proc, out, logp)
    return refs


def _oned_reference_result(refs, name):
    """The saved result of one of phase 14's plain runs, after waiting
    for its process; (arrays, seconds waited)."""
    proc, path, logp = refs[name]
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(path):
        with open(logp) as f:
            log(f.read())
        raise AssertionError(f"the CPU float64 run of {name} failed "
                             f"(exit {rc})")
    return np.load(path), waited


def _rel(a, b):
    """Per-entry |a - b| / |b| where |b| lies above the fractions'
    1e-10 floor (0 elsewhere)."""
    a, b = np.asarray(a), np.asarray(b)
    big = np.abs(b) > 1e-10
    return np.where(big, np.abs(a - b) / np.where(big, np.abs(b), 1.0), 0.0)


def phase_compare_1d_full(dev, refs):
    """Phase 14: the 1D kernel against its plain version at the main
    path's mesh: each variant of phase 12 in float64, one 10 Myr step of
    test 1 at mesh 10000 from the initial state, the kernel on the card
    and the plain version in its CPU process (started after phase 8).
    Every shell's iteration count equal; fractions within 1e-10 relative
    with a 1e-12 floor, temperatures within 1e-10 (phase 11's limits).
    With heating the problem itself is ill-conditioned next to the source
    (shell 0's temperature moves by ~3e-5 when its volume moves by an
    ulp, with the same iteration and sub-step counts): the conditioning
    runs measure that, and a temperature may differ by 1e-10 plus 10x
    the largest relative change they show.  Returns, per kernel,
    (max |kernel - plain| of the fractions, the largest relative
    difference of values above 1e-10, the kernel's step wall in ms, the
    plain version's in ms)."""
    out = {}
    for name, iso, quad in ONED_MAIN:
        run = oned_run(1, ONED_FULL_MESH, torch.float64, dev, iso, quad)
        nits, wall = synced(run.step, 10.0 * MYR)
        ref, waited = _oned_reference_result(refs, name)
        if not np.array_equal(nits.cpu().numpy(), ref["nits"]):
            bad = np.nonzero(nits.cpu().numpy() != ref["nits"])[0]
            raise AssertionError(f"{name} f64 mesh {ONED_FULL_MESH}: "
                                 f"iteration counts differ at shells "
                                 f"{bad[:10].tolist()}")
        got = {f: getattr(run.state, f).cpu().numpy()
               for f in ("xh", "xhe", "temper")}
        t_tol, note = 1e-10, ""
        if not iso:
            spread = _oned_reference_result(refs, name + ULP)[0]["spread"]
            dt_k = _rel(got["temper"], ref["temper"])
            t_tol = 1e-10 + 10.0 * float(spread.max())
            note = (f"; 1 to {ONED_ULPS} ulps of the volumes move the plain "
                    f"temperatures of the first {ONED_PREFIX} shells by up "
                    f"to {spread.max():.3e} relative (shell "
                    f"{int(spread.argmax())}; {int((spread > 1e-10).sum())} "
                    f"shells above 1e-10); the kernel's differ by "
                    f"up to {dt_k.max():.3e} (shell {int(dt_k.argmax())}; "
                    f"{int((dt_k > 1e-10).sum())} shells above 1e-10; "
                    f"limit {t_tol:.3e}); thermal sub-steps summed: kernel "
                    f"{int(run.last_counters[3])}, plain "
                    f"{int(ref['counters'][3])}")
        frac_abs = max(float(np.abs(got[f] - ref[f]).max())
                       for f in ("xh", "xhe"))
        rel = max(float(_rel(got[f], ref[f]).max()) for f in got)
        log(f"{name} f64 mesh {ONED_FULL_MESH}, one 10 Myr step: kernel vs "
            f"plain fractions {frac_abs:.3e} absolute, largest relative "
            f"difference {rel:.3e} (values above 1e-10); iterations "
            f"{int(ref['counters'][0])} (largest of a shell "
            f"{int(ref['counters'][1])}), equal in every shell; walls "
            f"kernel {1e3 * wall:.3f} ms, plain (CPU) "
            f"{1e3 * float(ref['wall']):.1f} ms; waited {waited:.1f} s for "
            f"the plain run{note}")
        for f in got:
            torch.testing.assert_close(
                torch.from_numpy(got[f]), torch.from_numpy(ref[f]),
                rtol=t_tol if f == "temper" else 1e-10,
                atol=0.0 if f == "temper" else 1e-12,
                msg=lambda m: f"{name} f64 mesh {ONED_FULL_MESH} {f}: {m}")
        out[name] = (frac_abs, rel, 1e3 * wall, 1e3 * float(ref["wall"]))
    log("1D kernel vs plain at full width: ok")
    return out


# The 1D kernel's latency bound: the dependent chain of one fixed-point
# iteration, counted from csrc/evolve1d.cu, band_rates.cuh and
# chemistry.cuh in float32 instructions that each wait for the one
# before.  A division counts 6 (MUFU.RCP and the 5 FFMA of the IEEE
# refinement: the build has no fast math), an exponential 6, a square
# root 5, expm1 and log10 12 each, pow 25; a shuffle, a select, a
# conversion and a load 1.  Independent work counts once: a lane's K
# nodes, the three species' divisions, doric's three exp and three
# expm1, its X/Y/Z divisions.  Isothermal, quadrature (from the start of
# an iteration): the rates of a lane's two bands 34 (columns 4, tau 3,
# min and exp 8, the node sum 7, the thick/thin select 2, / vol and the
# sums 10); the warp sums 10 (5 shuffles and adds); the per-atom rates 7;
# the first doric pass 52 (the ionization sums 4, the helium sector's
# divisions 6, the matrix terms 6, the square root 6, the root identity
# 10, r2 and X2's divisions 18, the solution and the clamps 10 -- its
# doric factors come from the previous iteration); the second 55 (its
# electron density and the same chain); the average, the 1% test and
# the loop branch 13: 171.  The table route's positions (log10 and a
# division) and reads take 47 for a lane's bands in place of 34: 184.
# Heating adds 38 (the Ricotti powers, two pows in sequence, gate the
# heating sums; the thermal call's set-up and end; the temperature test)
# and 52 per thermal sub-step (coolin's log10, division, read and
# 5-term sum, the step size's division, the update and pressr2temper's
# division).  Each instruction waits at least 4 cycles, the dependent-
# issue latency of the float32 pipe; MUFU, shuffles and loads wait
# longer, so this stays a lower bound.  At the card's largest clock.
ONED_CHAIN = {(False, False): 171, (False, True): 184,
              (True, False): 209, (True, True): 209}
ONED_CHAIN_SUBSTEP = 52
CYCLES_PER_DEPENDENT_OP = 4
SM_CLOCK_HZ = 1.98e9


def _sass_blocks(listing):
    """(basic blocks as (first, end) instruction indices, successors) of
    one function of a `cuobjdump -sass` listing.  Calls (the slow paths
    of division and the like) fall through: their callees are reached
    only through them and so count for nothing."""
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)([^;]*);", listing):
        op = m.group(3)
        t = re.search(r"0x([0-9a-f]+)", m.group(4)) if op == "BRA" else None
        ins.append((int(m.group(1), 16), m.group(2) is not None, op,
                    int(t.group(1), 16) if t else None))
    at = {a: i for i, (a, _, _, _) in enumerate(ins)}
    lead = {0}
    for i, (_, _, op, t) in enumerate(ins):
        if op in ("BRA", "EXIT", "RET"):
            lead.add(i + 1)
            if op == "BRA":
                lead.add(at[t])
    lead = sorted(x for x in lead if x < len(ins))
    ends = lead[1:] + [len(ins)]
    block_of = {s: k for k, s in enumerate(lead)}
    succ = []
    for s, e in zip(lead, ends):
        _, pred, op, t = ins[e - 1]
        nxt = [block_of[e]] if e < len(ins) else []
        if op == "BRA":
            succ.append([block_of[at[t]]] + (nxt if pred else []))
        else:
            succ.append(nxt if pred or op not in ("EXIT", "RET") else [])
    return list(zip(lead, ends)), succ


def sass_issue_floor(listing):
    """One warp's issue floor of one fixed-point iteration: the fewest
    instructions on a path through the fixed-point loop's body, from its
    header to a branch back to it, in the SASS `listing` of one
    evolve1d_kernel.  The loop is the largest natural loop inside the
    march over the shells (the largest loop); inner loops count once,
    rarely taken branches not at all.  A warp issues at most one
    instruction per cycle, so an iteration takes at least this many."""
    blocks, succ = _sass_blocks(listing)
    n = len(blocks)
    preds = [[] for _ in range(n)]
    for k in range(n):
        for j in succ[k]:
            preds[j].append(k)
    # dominators (Cooper, Harvey and Kennedy) over reverse postorder
    post, seen, stack = [], {0}, [(0, iter(succ[0]))]
    while stack:
        v, it = stack[-1]
        w = next((w for w in it if w not in seen), None)
        if w is None:
            post.append(stack.pop()[0])
        else:
            seen.add(w)
            stack.append((w, iter(succ[w])))
    rank = {v: i for i, v in enumerate(reversed(post))}
    idom = {0: 0}
    changed = True
    while changed:
        changed = False
        for v in reversed(post[:-1]):
            ps = [p for p in preds[v] if p in idom]
            d = ps[0]
            for p in ps[1:]:
                while d != p:
                    while rank[d] > rank[p]:
                        d = idom[d]
                    while rank[p] > rank[d]:
                        p = idom[p]
            if idom.get(v) != d:
                idom[v], changed = d, True

    def dominates(h, v):
        while v != h and v != 0:
            v = idom[v]
        return v == h

    back = {(s, h) for s in seen for h in succ[s] if dominates(h, s)}
    loops = {}
    for s, h in back:
        body, todo = loops.setdefault(h, {h}), [s]
        while todo:
            v = todo.pop()
            if v not in body:
                body.add(v)
                todo.extend(preds[v])
    size = lambda v: blocks[v][1] - blocks[v][0]
    (march, outer), *inner = sorted(
        loops.items(), key=lambda kv: -sum(size(v) for v in kv[1]))
    h, body = next((h, b) for h, b in inner if h != march and b <= outer)
    dist, heap = {h: size(h)}, [(size(h), h)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        for w in succ[v]:
            if w in body and (v, w) not in back and d + size(w) < dist.get(
                    w, math.inf):
                dist[w] = d + size(w)
                heapq.heappush(heap, (dist[w], w))
    return min(dist[s] for s, hh in back if hh == h and s in dist)


def oned_issue_floors():
    """sass_issue_floor of each float32 evolve1d_kernel instantiation of
    this run's build: {(heat, table): instructions}."""
    from c2ray_tpu_torch import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(cuda_build.library_path("evolve1d"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    floors = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.match(r"\S*evolve1d_kernelIfLb([01])ELb([01])E", fn)
        if m:
            floors[m.group(1) == "1", m.group(2) == "1"] = \
                sass_issue_floor(fn)
    return floors


def oned_bound(ctx, counters, heat, table, floors):
    """(bound_ms, bound_by, which) of one float32 1D timestep with these
    counters (this step's summed iterations and thermal sub-steps): the
    largest of (a) `bound` on the work done -- the state read and written
    once, per iteration the exponentials of every live band's K nodes
    (quadrature) or two logarithms and 4-10 table reads per band (tables)
    and CHEM_SFU_PER_ITERATION, per sub-step a logarithm and 20 flops --,
    (b) the latency of the iterations' dependent chains (ONED_CHAIN) and
    (c) one warp's issue floor, `floors` instructions per iteration at
    one a cycle."""
    from c2ray_tpu_torch.radiation.quadrature import packed_band_rows

    its, subs = int(counters[0]), int(counters[3])
    mesh = ctx.vol.shape[0]
    if table:
        nb = ctx.tables.sigma_HI.shape[0]
        sfu_it, flops_it = 2 * nb, nb * (60 if heat else 20)
    else:
        packed, _, K = packed_band_rows(ctx.tables, torch.float32, heat,
                                        ctx.has_bb, ctx.has_pl, ctx.has_qso)
        nodes = packed.shape[0] * K
        sfu_it, flops_it = 2 * nodes, nodes * (25 if heat else 10)
    nbytes = 4 * mesh * (7 + 6) + 4 * mesh
    work = bound(nbytes, its * (flops_it + CHEM_FLOPS_PER_ITERATION)
                 + subs * 20,
                 its * (sfu_it + CHEM_SFU_PER_ITERATION) + subs)
    cycles = CYCLES_PER_DEPENDENT_OP * (its * ONED_CHAIN[heat, table]
                                        + subs * ONED_CHAIN_SUBSTEP)
    lat_ms = 1e3 * cycles / SM_CLOCK_HZ
    issue_ms = 1e3 * its * floors[heat, table] / SM_CLOCK_HZ
    return max((work[0], work[1], "throughput"),
               (lat_ms, "operations", "latency of the dependent chain"),
               (issue_ms, "operations", "one warp's instruction issue"))


def phase_oned_times(main, compare):
    """The 1D kernels' times at mesh 10000 (CUDA events, a wrapper call
    on phase 12's final state, mean of 3 after a warm-up) beside their
    bounds; the plain version's step wall from phase 11 (mesh 128, on
    the CPU)."""
    from c2ray_tpu_torch.onedim import evolve as ev1

    floors = oned_issue_floors()
    log(f"issue floors, SASS instructions per fixed-point iteration: "
        f"{floors}")
    rows = {}
    for name, variant, heat, table in (
            ("evolve1d", "quadrature", False, False),
            ("evolve1d_heat", "quadrature heating", True, False),
            ("evolve1d_table", "table", False, True)):
        run, dt = main[name]["run"], main[name]["dt"]
        ms = event_ms(lambda: ev1.evolve1d_cuda(run.ctx, run.state, dt), 3)
        _, _, counters = ev1.evolve1d_cuda(run.ctx, run.state, dt)
        b = oned_bound(run.ctx, counters.tolist(), heat, table, floors)
        worst, kp_abs, k128, p128 = compare[variant]
        log(f"{name} at mesh {run.ctx.vol.shape[0]}: {ms:.3f} ms per step "
            f"({int(counters[0])} iterations, {int(counters[3])} thermal "
            f"sub-steps), bound {b[0]:.3f} ms ({b[2]}); at mesh 128 kernel "
            f"{k128:.3f} ms, plain (CPU) {p128:.1f} ms")
        rows[name] = (ms, b, worst, kp_abs, k128, p128, counters.tolist())
    return rows



def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from c2ray_tpu_torch import cuda_build

    t0 = time.perf_counter()
    names = ("pyramid_sweep", "chemistry", "photon_losses", "evolve1d",
             "shell_sweep", "octant_sweep", "domain_halo")
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(cuda_build.load, n) for n in names]:
            f.result()
    # ptxas -v per kernel: registers, stack and spills
    for name in names:
        kernel = ""
        for line in cuda_build.build_log(name).splitlines():
            m = re.search(r"Compiling entry .*?(stage_kernel"
                          r"|source_cell_kernel|chemistry_kernel"
                          r"|photon_losses_kernel|evolve1d_kernel"
                          r"|shell_kernel|plane_kernel|halo_pack_kernel"
                          r"|window_accumulate_kernel|fold_halo_kernel)"
                          r"I([fd])(?:Lb([01])E)?"
                          r"(?:Lb([01])E)?", line)
            if m:
                dtype = "float" if m.group(2) == "f" else "double"
                heat = ", heat" if m.group(3) == "1" else ""
                flag = ("table" if m.group(1).startswith("evolve1d")
                        else "track")
                second = f", {flag}" if m.group(4) == "1" else ""
                kernel = f"{m.group(1)}<{dtype}{heat}{second}>"
            elif kernel and ("registers" in line or "spill" in line):
                log(f"  {name}.cu {kernel}: {line.split(':', 1)[-1].strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")


def main():
    if sys.argv[1:2] == ["--cpu-reference"]:
        # phases 9 and 17's float64 references, started by the script
        cpu_reference(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--oned-reference"]:
        # phase 14's float64 plain runs, started by the script itself
        oned_reference(sys.argv[2], sys.argv[3])
        return
    # -- 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    log(f"card: {smi_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ref = start_cpu_reference(workdir)                              # 9.
    oned_refs = {}     # phase 14's CPU runs, started after phase 8
    try:
        kernels = run_phases(dev, workdir, ref, oned_refs)
    finally:
        for proc in [ref[0]] + [r[0] for r in oned_refs.values()]:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_phases(dev, workdir, ref, oned_refs):
    """Phases 2-17; returns the entries of the `kernels` line.  Phase
    14's CPU runs start, into `oned_refs`, once the 3D main paths
    (phases 4, 5, 8 and 16) have been timed, so that they do not share
    the host with those timings."""
    def phase(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[phase {label}: {time.perf_counter() - t0:.1f} s]")
        return out

    phase("build", build_kernels)                                   # 2.
    sweep_err32, chem_err32 = phase("compare", phase_compare, dev)  # 3.
    hsweep_err32, hchem_err32 = phase("compare heating", phase_compare,
                                      dev, heating=True)
    cfg, s, srcpos, nflux, dt, counts = phase("main path", phase_main,
                                              dev)                 # 4.
    hcfg, hs, hsrc, hnfl, hdt, hcounts = phase(
        "heating main path", phase_main, dev, heating=True)        # 5.
    phase("Stroemgren", phase_physics, dev)                         # 6.
    phase("heating physics", phase_heating_physics, dev)
    errs = [phase("compare LLS, tracking, photon losses",           # 7.
                  phase_compare_slice, dev),
            phase("compare LLS, tracking, photon losses heating",
                  phase_compare_slice, dev, heating=True)]
    lls_err, track_err, pl_err = (max(e) for e in zip(*errs))
    pcfg, ps_, psrc, pnfl, _, pcounts = phase(                      # 8.
        "photon-loss main path", phase_main, dev, photon_losses=True)
    eng_err = phase("compare shell and octant engines",              # 15.
                    phase_compare_engines, dev)
    eng = {(engine, heating): phase(                                # 16.
        f"{engine} engine{' heating' if heating else ''} main path",
        phase_main, dev, heating=heating, engine=engine)
        for engine in ("shells", "octant") for heating in (False, True)}
    phase("compare halo kernels", phase_compare_halo, dev)            # 18.
    nccl = phase("NCCL", phase_nccl, dev, workdir)                   # 19.
    par_counts = [phase(f"parallel{' heating' if heating else ''} main "
                        "path", phase_parallel_main, dev, heating=heating)
                  for heating in (False, True)]                     # 20.
    oned_refs.update(start_oned_references(workdir))                # 14.
    # the 1D program while phase 9's CPU reference runs
    compare_1d = phase("1D compare", phase_compare_1d, dev)          # 11.
    main_1d = phase("1D main path", phase_main_1d, dev)              # 12.
    phase("1D physics", phase_physics_1d, dev, main_1d)              # 13.
    phase("driver physics", phase_driver_physics, dev, workdir, ref)  # 9.
    ocounts = phase("driver physics 33^3", phase_driver_physics,    # 17.
                    dev, workdir, ref, mesh=33)
    r, last_sources, dcounts = phase("driver", phase_driver_full,  # 10.
                                     dev, workdir)
    _, _, counts203 = phase("driver 203^3", phase_driver_full,      # 17.
                            dev, workdir, mesh=203, zreds=(9.0, 8.95),
                            mine=("shell_sweep_heat", "chemistry_heat"))
    par_counts.append(phase("driver domain", phase_driver_domain, dev,
                            workdir, r))                            # 21.
    full_1d = phase("1D compare at full width", phase_compare_1d_full,
                    dev, oned_refs)                                 # 14.
    # the kernel times last, when phase 9's CPU reference process no
    # longer shares the host with the launches
    iso_t = phase("kernel times", phase_kernel_times, cfg, s, srcpos,
                  nflux, dt)
    heat_t = phase("heating kernel times", phase_kernel_times, hcfg, hs,
                   hsrc, hnfl, hdt)
    track_t, pl_t = phase("photon-loss kernel times", phase_track_times,
                          pcfg, ps_, psrc, pnfl)
    lls_t = phase("LLS kernel times", phase_lls_times, r, last_sources)
    oned_t = phase("1D kernel times", phase_oned_times, main_1d, compare_1d)
    eng_t = {key: phase(f"{key[0]} engine{' heating' if key[1] else ''} "
                        "kernel times", phase_engine_times, *out[:4], key[0])
             for key, out in eng.items()}
    halo_t = phase("halo kernel times", phase_halo_times, dev)

    # each kernel's launches on its own path: phases 4, 5, 8 and 10
    counts = {**counts, **hcounts, **pcounts, **dcounts}
    M = cfg.sweep.mesh
    Rf, Rb = (M // 2, M // 2 - 1)
    kernels = []
    for (sw, ch), sw_err, ch_err, sfx, c in (
            (iso_t, sweep_err32, chem_err32, "", cfg),
            (heat_t, hsweep_err32, hchem_err32, "_heat", hcfg)):
        sb = sweep_bound(c.sweep, srcpos.shape[0], Rf, Rb)
        cb = chemistry_bound(M**3, bool(sfx))
        kernels += [
            {"name": "pyramid_sweep" + sfx, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/pyramid_sweep.cu",
             "replaces": ("c2ray_tpu/radiation/quadrature.py:330" if sfx
                          else "c2ray_tpu/sweep/pyramid_sweep.py:116"),
             "launches": counts["pyramid_sweep" + sfx], "max_abs_err": sw[2],
             "max_rel_err_heat": sw[3],
             "max_rel_err_f32_32cube": sw_err,
             "ms": sw[0], "plain_ms": sw[1], "bound_ms": sb[0],
             "bound_by": sb[1], "library_ms": None},
            {"name": "chemistry" + sfx, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/chemistry.cu",
             "replaces": ("c2ray_tpu/thermal.py:119" if sfx
                          else "c2ray_tpu/sweep/global_pass.py:140"),
             "launches": counts["chemistry" + sfx], "max_abs_err": ch[2],
             "max_rel_err_temperature": ch[3],
             "max_err_f32_32cube": ch_err,
             "ms": ch[0], "plain_ms": ch[1], "bound_ms": cb[0],
             "bound_by": cb[1], "library_ms": None},
        ]
    (lms, lplain, labs), lb = lls_t
    (tms, tplain, tabs), tb = track_t
    (pms, pplain, pabs), pb, plib = pl_t
    kernels += [
        {"name": "pyramid_sweep_lls", "route": "cuda",
         "source": "c2ray_tpu_torch/csrc/pyramid_sweep.cu",
         "replaces": "c2ray_tpu/sweep/pyramid_sweep.py:116",
         "launches": counts["pyramid_sweep_lls"], "max_abs_err": labs,
         "max_err_f32_32cube": lls_err, "ms": lms, "plain_ms": lplain,
         "bound_ms": lb[0], "bound_by": lb[1], "library_ms": None},
        {"name": "pyramid_sweep_track", "route": "cuda",
         "source": "c2ray_tpu_torch/csrc/pyramid_sweep.cu",
         "replaces": "c2ray_tpu/radiation/quadrature.py:330",
         "launches": counts["pyramid_sweep_track"], "max_abs_err": tabs,
         "max_err_f32_32cube": track_err, "ms": tms, "plain_ms": tplain,
         "bound_ms": tb[0], "bound_by": tb[1], "library_ms": None},
        {"name": "photon_losses", "route": "cuda",
         "source": "c2ray_tpu_torch/csrc/photon_losses.cu",
         "replaces": "c2ray_tpu/sweep/photon_losses.py:45",
         "launches": counts["photon_losses"], "max_abs_err": pabs,
         "max_err_f32_32cube": pl_err, "ms": pms, "plain_ms": pplain,
         "bound_ms": pb[0], "bound_by": pb[1], "library_ms": plib},
    ]
    # the shell and octant kernels: launches on phases 16 and 17, time,
    # plain time and bound at 128^3 x 8 (the bound over the unique cells:
    # the table's, or the octants' without their shared faces)
    for (engine, heating), out in eng.items():
        name = ENGINE_KERNEL[engine] + ("_heat" if heating else "")
        ms, plain_ms, abs_err, heat_rel, b = eng_t[engine, heating]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"c2ray_tpu_torch/csrc/{ENGINE_KERNEL[engine]}.cu",
             "replaces": ("c2ray_tpu/sweep/source_sweep.py:138"
                          if engine == "shells"
                          else "c2ray_tpu/sweep/octant_sweep.py:113"),
             "launches": (out[5][name] + ocounts.get(name, 0)
                          + counts203.get(name, 0)),
             "max_abs_err": abs_err, "max_rel_err_heat": heat_rel,
             "max_err_f32_32cube": eng_err[name],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
             "bound_by": b[1], "library_ms": None})
    # the 1D kernels: launches on phase 12's runs, time and bound at mesh
    # 10000; the error against the plain version at mesh 10000 in float64
    # (phase 14), and at mesh 128 in float32 beside the plain version's
    # step wall there (phase 11)
    for name, replaces in (
            ("evolve1d", "c2ray_tpu/onedim/evolve.py:104"),
            ("evolve1d_heat", "c2ray_tpu/onedim/evolve.py:104"),
            ("evolve1d_table", "c2ray_tpu/radiation/photo.py:185")):
        ms, b, worst, kp_abs, k128, p128, counters = oned_t[name]
        f_abs, f_rel, k_full, p_full = full_1d[name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/evolve1d.cu",
             "replaces": replaces, "launches": main_1d[name]["launches"],
             "max_abs_err": f_abs,
             "max_abs_err_of": "float64, mesh 10000, one 10 Myr step",
             "max_rel_err_f64_mesh10000": f_rel,
             "max_abs_err_f32_mesh128": kp_abs,
             "max_err_f32_vs_f64_mesh128": worst,
             "ms": ms, "plain_ms": p128,
             "plain_shape": "mesh 128, one float32 step, on the CPU",
             "ms_mesh128": k128,
             "ms_f64_mesh10000_step0": k_full,
             "plain_ms_f64_mesh10000_step0": p_full,
             "host_share_of_step_wall": main_1d[name]["host_share"],
             "bound_ms": b[0], "bound_by": b[1],
             "bound_detail": b[2], "counters": counters,
             "library_ms": None})
    # the halo kernels: launches on the domain paths of phases 20 and 21,
    # time, plain time and bound at world size 1, 128^3, full radius
    for name, replaces in (
            ("halo_pack", "c2ray_tpu/parallel/domain.py:81"),
            ("window_accumulate", "c2ray_tpu/parallel/domain.py:393"),
            ("fold_halo", "c2ray_tpu/parallel/domain.py:100")):
        ms, plain_ms, err, b, lib_ms = halo_t[name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/domain_halo.cu",
             "replaces": replaces,
             "launches": sum(c[name] for c in par_counts),
             "max_abs_err": err,
             "max_abs_err_of": "float32 at 128^3, world size 1, full "
                               "radius; 0 in f64 and f32 at 32^3 D = 8 "
                               "too (phase 18)",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
             "bound_by": b[1], "library_ms": lib_ms,
             "library_call": ("rc[window].add_(cube)"
                              if lib_ms is not None else None)})
    log(f"NCCL at world size 1: {nccl}")
    return kernels


if __name__ == "__main__":
    main()
