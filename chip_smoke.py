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
tolerances.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import re
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


def _sweep_parts(out, unit):
    """(rates, heat, photon_loss, lls_loss) of a trace; losses are in
    the tables' flux units, brought to float64 physical by `unit`."""
    slab, ploss, lls = out
    return (slab[..., :3], slab[..., 3], ploss.double() * unit,
            lls.double() * unit)


def compare_sweep(cfg64, cfg32, M, dev, radius, lls):
    """Sweep kernel vs plain at float64 (tight) and float32 (against
    the float64 plain result, as accurate as the float32 plain
    version), the heating column on its own.  Returns the worst float32
    relative error of the kernel."""
    import dataclasses

    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    out = {}
    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        cfg = dataclasses.replace(cfg.sweep, coldensh_LLS=lls)
        state, srcpos, nflux = random_case(M, 3, dtype, dev, seed=5)
        fstack = ps.stack_sweep_fields(cfg, fields_of(state))
        Rf, Rb = ps.trace_extents(M, radius)
        unit = cfg.flux_scale / cfg64.sweep.flux_scale
        out[name] = (
            _sweep_parts(ps.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb),
                         unit),
            _sweep_parts(ps.trace_plain(cfg, fstack, srcpos, nflux, Rf, Rb),
                         unit))
    (k64, p64), (k32, p32) = out["f64"], out["f32"]
    what = ("rates", "heat", "photon_loss", "lls_loss")
    # float64: the JAX package's own pyramid-vs-octant tolerance
    for a, b, w in zip(k64, p64, what):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * scale,
                                   msg=f"f64 sweep {w} radius={radius}")
    worst = 0.0
    for a64, a, b, ref, w in zip(k64, k32, p32, p64, what):
        ek = rel_err(a.double(), ref)
        ep = rel_err(b.double(), ref)
        log(f"  sweep radius={radius} lls={lls:g} {w}: f64 kernel-plain "
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
        slab, pl, ll = ps.trace_plain(cfg.sweep, fstack, srcpos, nflux, Rf,
                                      Rb)
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


def launch_counts():
    from c2ray_tpu_torch.sweep import global_pass, pyramid_sweep

    return {"pyramid_sweep": pyramid_sweep.launches,
            "pyramid_sweep_heat": pyramid_sweep.launches_heat,
            "chemistry": global_pass.launches,
            "chemistry_heat": global_pass.launches_heat}


def reset_launch_counts():
    from c2ray_tpu_torch.sweep import global_pass, pyramid_sweep

    pyramid_sweep.launches = pyramid_sweep.launches_heat = 0
    global_pass.launches = global_pass.launches_heat = 0


def phase_main(dev, heating=False, mesh=128, n_src=8, n_iter=4):
    """Phases 4 and 5: the bench configuration in float32 through the
    public entry points, isothermal or with heating; returns what the
    kernel timings need and the launch counts of this run."""
    from c2ray_tpu_torch import photonstats
    from c2ray_tpu_torch.rates import rate_coefficients
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import (evolve3d, global_pass,
                                       make_evolve3d_iteration,
                                       pyramid_sweep)

    name = "heating main path" if heating else "main path"
    cfg, sed = setup(mesh, *BENCH_SOURCE, torch.float32, dev, heating)
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
    sweep_w, chem_w, chem_it, chem_sub = [], [], [], []
    st = s
    for _ in range(n_iter):
        rates, w = synced(pyramid_sweep.sweep_pyramid_source_batch,
                          cfg.sweep, fields_of(st), srcpos, nflux)
        sweep_w.append(w)
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
    log(f"  launches: {counts}")
    mine = (("pyramid_sweep_heat", "chemistry_heat") if heating
            else ("pyramid_sweep", "chemistry"))
    for k, c in counts.items():
        if (c <= 0) if k in mine else (c != 0):
            raise AssertionError(f"{name} launched {k} {c} times")
    for t in (*s, *s_evo):
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} produced non-finite state")
    if not (math.isfinite(xion) and math.isfinite(float(ploss))
            and math.isfinite(stats.photon_loss)):
        raise AssertionError(f"{name} produced non-finite diagnostics")
    if s.h1.shape != (mesh**3,) or s_evo.h1.shape != (mesh**3,):
        raise AssertionError(f"{name} state has the wrong shape")
    return cfg, s, srcpos, nflux, dt, {k: counts[k] for k in mine}


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


def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from c2ray_tpu_torch import cuda_build

    t0 = time.perf_counter()
    names = ("pyramid_sweep", "chemistry")
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(cuda_build.load, n) for n in names]:
            f.result()
    # ptxas -v per kernel: registers, stack and spills
    for name in names:
        kernel = ""
        for line in cuda_build.build_log(name).splitlines():
            m = re.search(r"Compiling entry .*?\d([a-z_]+_kernel)I([fd])"
                          r"(?:Lb([01])E)?", line)
            if m:
                dtype = "float" if m.group(2) == "f" else "double"
                heat = ", heat" if m.group(3) == "1" else ""
                kernel = f"{m.group(1)}<{dtype}{heat}>"
            elif kernel and ("registers" in line or "spill" in line):
                log(f"  {name}.cu {kernel}: {line.split(':', 1)[-1].strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")


def main():
    # -- 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    log(f"card: {smi_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

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
    iso_t = phase("kernel times", phase_kernel_times, cfg, s, srcpos,
                  nflux, dt)
    heat_t = phase("heating kernel times", phase_kernel_times, hcfg, hs,
                   hsrc, hnfl, hdt)
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    counts.update(hcounts)
    kernels = []
    for (sw, ch), sw_err, ch_err, sfx in (
            (iso_t, sweep_err32, chem_err32, ""),
            (heat_t, hsweep_err32, hchem_err32, "_heat")):
        kernels += [
            {"name": "pyramid_sweep" + sfx, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/pyramid_sweep.cu",
             "replaces": ("c2ray_tpu/radiation/quadrature.py:330" if sfx
                          else "c2ray_tpu/sweep/pyramid_sweep.py:116"),
             "launches": counts["pyramid_sweep" + sfx], "max_abs_err": sw[2],
             "max_rel_err_heat": sw[3],
             "max_rel_err_f32_32cube": sw_err,
             "ms": sw[0], "plain_ms": sw[1]},
            {"name": "chemistry" + sfx, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/chemistry.cu",
             "replaces": ("c2ray_tpu/thermal.py:119" if sfx
                          else "c2ray_tpu/sweep/global_pass.py:140"),
             "launches": counts["chemistry" + sfx], "max_abs_err": ch[2],
             "max_rel_err_temperature": ch[3],
             "max_err_f32_32cube": ch_err,
             "ms": ch[0], "plain_ms": ch[1]},
        ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
