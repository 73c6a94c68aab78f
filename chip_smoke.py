"""Drive the PyTorch + CUDA port of the 3D timestep on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: require CUDA, print the card's name and power limit;
2. build: compile the kernels of ``c2ray_tpu_torch/csrc`` with nvcc;
3. kernel vs plain at 32^3 x 3 sources (one at a grid edge), radius
   None and 8, float64 and float32: the sweep's per-source rates and
   losses, and one chemistry pass;
4. main path: the bench configuration of ``bench.py`` (5e4 K blackbody,
   S_star 3e51, 50 kpc box, n = 1e-4, dt = 1e14 s, 128^3 x 8 sources
   from RandomState(7)) in float32: one warm-up iteration, 4 timed
   iterations of `make_evolve3d_iteration`, the sweep and chemistry
   walls of 4 more, then one full `evolve3d` timestep; both kernels must
   have been launched by it;
5. physics: the isothermal Stroemgren sphere (M = 20, 4 x 10 Myr) in
   float32 against the analytic front.

Then each kernel's time and its plain version's at the main path's
shapes, and their agreement there within the stated float32
tolerances.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import subprocess
import sys
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


def setup(mesh, S_star, T_eff, box, dtype, dev):
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
    from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                       SweepConfig)

    tables, sed, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=T_eff, S_star=S_star)),
        isothermal=True, dtype=dtype, device=dev)
    sweep = SweepConfig(tables=tables, mesh=mesh, dr=box * const.kpc / mesh,
                        isothermal=True, flux_scale=bands.flux_scale)
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


def compare_sweep(cfg64, cfg32, M, dev, radius, lls):
    """Sweep kernel vs plain at float64 (tight) and float32 (against
    the float64 plain result, as accurate as the float32 plain
    version).  Returns the worst float32 relative error of the
    kernel."""
    import dataclasses

    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    out = {}
    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        cfg = dataclasses.replace(cfg.sweep, coldensh_LLS=lls)
        state, srcpos, nflux = random_case(M, 3, dtype, dev, seed=5)
        fstack = ps.stack_sweep_fields(cfg, fields_of(state))
        Rf, Rb = ps.trace_extents(M, radius)
        out[name] = (ps.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb),
                     ps.trace_plain(cfg, fstack, srcpos, nflux, Rf, Rb))
    (k64, p64), (k32, p32) = out["f64"], out["f32"]
    # losses are in the tables' flux units: bring float32's to float64's
    unit = cfg32.sweep.flux_scale / cfg64.sweep.flux_scale
    k32 = (k32[0], k32[1].double() * unit, k32[2].double() * unit)
    p32 = (p32[0], p32[1].double() * unit, p32[2].double() * unit)
    # float64: the JAX package's own pyramid-vs-octant tolerance
    for a, b, what in zip(k64, p64, ("rates", "photon_loss", "lls_loss")):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * scale,
                                   msg=f"f64 sweep {what} radius={radius}")
    worst = 0.0
    for a64, a, b, ref, what in zip(k64, k32, p32, p64,
                                    ("rates", "photon_loss", "lls_loss")):
        ek = rel_err(a.double(), ref)
        ep = rel_err(b.double(), ref)
        log(f"  sweep radius={radius} lls={lls:g} {what}: f64 kernel-plain "
            f"{rel_err(a64, ref):.3e}; vs f64 plain: f32 kernel {ek:.3e}, "
            f"f32 plain {ep:.3e}")
        # float32: the kernel's error against float64 within twice the
        # plain version's (float32 rounding of columns accumulated over
        # up to M/2 layers, amplified by tau in e^-tau and by the
        # E_in - E_out cancellation just above TAU_PHOTO_LIMIT)
        if not ek <= 2.0 * ep + 1e-6:
            raise AssertionError(f"f32 sweep {what}: kernel error {ek:.3e} "
                                 f"vs plain {ep:.3e}")
        worst = max(worst, ek)
    return worst


def compare_chemistry(cfg64, cfg32, M, dev):
    """One chemistry pass, kernel vs plain, on the plain sweep's rates."""
    from c2ray_tpu_torch.sweep import RateGrids
    from c2ray_tpu_torch.sweep import global_pass as gp
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    names = ("h_int0", "h_int1", "he_int0", "he_int1", "he_int2", "h_av0",
             "h_av1", "he_av0", "he_av1", "he_av2", "t_inter", "t_av")
    res = {}
    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        state, srcpos, nflux = random_case(M, 3, dtype, dev, seed=6)
        fstack = ps.stack_sweep_fields(cfg.sweep, fields_of(state))
        Rf, Rb = ps.trace_extents(M)
        slab, pl, ll = ps.trace_plain(cfg.sweep, fstack, srcpos, nflux, Rf,
                                      Rb)
        rg = slab.sum(dim=0)
        rates = RateGrids(rg[:, 0], rg[:, 1], rg[:, 2], rg[:, 3], pl.sum(),
                          ll.sum())
        dt = 1.0e14
        res[name] = (gp.chemistry_pass_cuda(cfg.chem, state, rates, dt),
                     gp.chemistry_pass_plain(cfg.chem, state, rates, dt))
    (k64, p64), (k32, p32) = res["f64"], res["f32"]
    log(f"  chemistry f64: conv_flag {int(k64[1])}/{int(p64[1])}, "
        f"iterations {int(k64[2])}/{int(p64[2])} (kernel/plain)")
    log(f"  chemistry f32: conv_flag {int(k32[1])}/{int(p32[1])}, "
        f"iterations {int(k32[2])}/{int(p32[2])} (kernel/plain)")
    if (int(k64[1]), int(k64[2])) != (int(p64[1]), int(p64[2])):
        raise AssertionError("f64 chemistry conv_flag / iterations differ")
    worst = 0.0
    for nm in names:
        a64, b64 = getattr(k64[0], nm), getattr(p64[0], nm)
        # fractions in [0, 1]: 1e-12 absolute, 1e-10 relative
        torch.testing.assert_close(a64, b64, rtol=1e-10, atol=1e-12,
                                   msg=f"f64 chemistry {nm}")
        ek = float((getattr(k32[0], nm).double() - b64).abs().max())
        ep = float((getattr(p32[0], nm).double() - b64).abs().max())
        # float32: within twice the plain float32 error against float64
        # plus 1e-6 (a cell whose 1% convergence test flips in float32
        # stops one fixed-point iteration earlier or later)
        if not ek <= 2.0 * ep + 1e-6:
            raise AssertionError(f"f32 chemistry {nm}: kernel error "
                                 f"{ek:.3e} vs plain {ep:.3e}")
        worst = max(worst, ek)
    log(f"  chemistry worst abs error vs f64: f32 kernel {worst:.3e}")
    return worst


def phase_compare(dev, M=32):
    """Phase 3: kernel vs plain at M^3 x 3 sources."""
    cfg64, _ = setup(M, 1e48, 5e4, 10.0, torch.float64, dev)
    cfg32, _ = setup(M, 1e48, 5e4, 10.0, torch.float32, dev)
    sweep_err32 = max(compare_sweep(cfg64, cfg32, M, dev, None, 0.0),
                      compare_sweep(cfg64, cfg32, M, dev, 8, 1.0e15))
    chem_err32 = compare_chemistry(cfg64, cfg32, M, dev)
    log("kernel vs plain: ok")
    return sweep_err32, chem_err32


def phase_main(dev, mesh=128, n_src=8, n_iter=4):
    """Phase 4: the bench configuration in float32 through the public
    entry points; returns what the kernel timings need and the
    launch counts of this run."""
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import (evolve3d, global_pass,
                                       make_evolve3d_iteration,
                                       pyramid_sweep)

    cfg, _ = setup(mesh, 3e51, 5e4, 50.0, torch.float32, dev)
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

    pyramid_sweep.launches = 0
    global_pass.launches = 0
    (s, conv, ploss, _), warm = synced(iteration, state0, srcpos, nflux, dt)
    log(f"warm-up iteration: {warm:.3f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        s, conv, ploss, _ = iteration(s, srcpos, nflux, dt)
    torch.cuda.synchronize()
    spi = (time.perf_counter() - t0) / n_iter
    rate = mesh**3 * n_src / spi
    # per-phase walls of n_iter more iterations
    sweep_w, chem_w = [], []
    st = s
    for _ in range(n_iter):
        rates, w = synced(pyramid_sweep.sweep_pyramid_source_batch,
                          cfg.sweep, fields_of(st), srcpos, nflux)
        sweep_w.append(w)
        (st, _), w = synced(global_pass.global_chemistry_pass, cfg.chem, st,
                            rates, dt)
        chem_w.append(w)
    (s_evo, stats), evo_w = synced(evolve3d, cfg, state0, srcpos, nflux, dt)
    counts = {"pyramid_sweep": pyramid_sweep.launches,
              "chemistry": global_pass.launches}

    xion = float(s.h_av1.double().mean())
    log(f"main path {mesh}^3 x {n_src} float32: {rate:.6e} "
        f"cell-source-updates/s, {spi:.6f} s/iteration")
    log(f"  sweep wall per iteration: {np.mean(sweep_w):.6f} s "
        f"({', '.join(f'{w:.4f}' for w in sweep_w)})")
    log(f"  chemistry wall per iteration: {np.mean(chem_w):.6f} s "
        f"({', '.join(f'{w:.4f}' for w in chem_w)})")
    log(f"  last timed iteration: conv_flag {int(conv)}, photon_loss "
        f"{float(ploss):.6e}, mean ionized fraction {xion:.6e}")
    log(f"  evolve3d timestep: {evo_w:.3f} s, {stats}")
    log(f"  launches: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"main path never launched {name}")
    for t in (*s, *s_evo):
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError("main path produced non-finite state")
    if not (math.isfinite(xion) and math.isfinite(float(ploss))
            and math.isfinite(stats.photon_loss)):
        raise AssertionError("main path produced non-finite diagnostics")
    if s.h1.shape != (mesh**3,) or s_evo.h1.shape != (mesh**3,):
        raise AssertionError("main path state has the wrong shape")
    return cfg, s, srcpos, nflux, dt, counts


def phase_physics(dev, M=20):
    """Phase 5: isothermal Stroemgren sphere in float32."""
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


def phase_kernel_times(cfg, s, srcpos, nflux, dt):
    """Each kernel's device time beside its plain version's, at the
    main path's shapes, and their largest absolute difference."""
    from c2ray_tpu_torch.sweep import global_pass, pyramid_sweep

    mesh = cfg.sweep.mesh
    fstack = pyramid_sweep.stack_sweep_fields(cfg.sweep, fields_of(s))
    Rf, Rb = pyramid_sweep.trace_extents(mesh)
    args = (cfg.sweep, fstack, srcpos, nflux, Rf, Rb)
    sweep_ms = event_ms(lambda: pyramid_sweep.trace_cuda(*args), 3)
    sweep_plain_ms = event_ms(lambda: pyramid_sweep.trace_plain(*args), 1)
    k = pyramid_sweep.trace_cuda(*args)
    p = pyramid_sweep.trace_plain(*args)
    sweep_abs = float((k[0] - p[0]).abs().max())
    rates = pyramid_sweep.sweep_pyramid_source_batch(cfg.sweep, fields_of(s),
                                                     srcpos, nflux)
    chem_args = (cfg.chem, s, rates, dt)
    chem_ms = event_ms(lambda: global_pass.chemistry_pass_cuda(*chem_args), 3)
    chem_plain_ms = event_ms(
        lambda: global_pass.chemistry_pass_plain(*chem_args), 1)
    kc = global_pass.chemistry_pass_cuda(*chem_args)
    pc = global_pass.chemistry_pass_plain(*chem_args)
    chem_abs = max(float((a - b).abs().max()) for a, b in zip(kc[0], pc[0])
                   if a.dtype.is_floating_point and a.shape == b.shape)
    log(f"sweep at {mesh}^3 x {srcpos.shape[0]}: kernel {sweep_ms:.3f} ms, "
        f"plain {sweep_plain_ms:.3f} ms, max |kernel - plain| "
        f"{sweep_abs:.3e} (f32 rates, 1/s)")
    log(f"chemistry at {mesh}^3: kernel {chem_ms:.3f} ms, plain "
        f"{chem_plain_ms:.3f} ms, max |kernel - plain| {chem_abs:.3e} "
        f"(f32 fractions); iterations {int(kc[2])}/{int(pc[2])}")
    # float32 kernel vs float32 plain, the tolerances of
    # tests/test_torch_kernels.py: sweep 1e-4 relative, with 1e-4 of the
    # largest value as the absolute floor (columns summed over up to M/2
    # layers with and without FMA contraction, amplified by tau in
    # e^-tau); chemistry 2e-2 (a cell whose 1% convergence test flips
    # stops one fixed-point iteration apart; fractions are O(1))
    for a, b, what in zip(k, p, ("rates", "photon_loss", "lls_loss")):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()),
                                   msg=f"sweep {what} at {mesh}^3")
    for a, b, nm in zip(kc[0], pc[0], s._fields):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2,
                                   msg=f"chemistry {nm} at {mesh}^3")
    return (sweep_ms, sweep_plain_ms, sweep_abs), (chem_ms, chem_plain_ms,
                                                    chem_abs)


def main():
    # -- 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    log(f"card: {smi_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from c2ray_tpu_torch import cuda_build

    # -- 2. build
    t0 = time.perf_counter()
    for name in ("pyramid_sweep", "chemistry"):
        cuda_build.load(name)
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    sweep_err32, chem_err32 = phase_compare(dev)          # -- 3.
    cfg, s, srcpos, nflux, dt, counts = phase_main(dev)   # -- 4.
    phase_physics(dev)                                    # -- 5.
    (sw_ms, sw_plain, sw_err), (ch_ms, ch_plain, ch_err) = \
        phase_kernel_times(cfg, s, srcpos, nflux, dt)

    kernels = [
        {"name": "pyramid_sweep", "route": "cuda",
         "source": "c2ray_tpu_torch/csrc/pyramid_sweep.cu",
         "replaces": "c2ray_tpu/sweep/pyramid_sweep.py:116",
         "launches": counts["pyramid_sweep"], "max_abs_err": sw_err,
         "max_rel_err_f32_32cube": sweep_err32,
         "ms": sw_ms, "plain_ms": sw_plain},
        {"name": "chemistry", "route": "cuda",
         "source": "c2ray_tpu_torch/csrc/chemistry.cu",
         "replaces": "c2ray_tpu/sweep/global_pass.py:140",
         "launches": counts["chemistry"], "max_abs_err": ch_err,
         "max_abs_err_f32_32cube": chem_err32,
         "ms": ch_ms, "plain_ms": ch_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
