"""Profile the port's 3D iteration on one GPU: device time by kernel.

    python3 tools/profile_torch_iteration.py [--heating] [--lls]
        [--photon-losses] [--engine pyramid|octant|shells] [--iters N]
        [--lanes G1,G2,...]

Runs the bench configuration of ``chip_smoke.py`` (128^3 x 8 sources,
float32, isothermal or with heating) through `make_evolve3d_iteration`;
`--lls` gives the sweep a per-cell LLS grid (seeded, 1e14-1e17 cm^-2
per cell: the LLS variant of the sweep kernel), `--photon-losses` turns
on band tracking and the photon-loss redistribution, `--engine` picks
the sweep engine (`Evolve3DConfig.engine`): one warm-up iteration,
then N iterations timed without the profiler and the same N
iterations again under ``torch.profiler``.  Prints the
device time per iteration of each kernel, the wall per iteration
(unprofiled and profiled), and the device's idle share (1 - device
time / unprofiled wall, so the profiler's own overhead is not counted
as idle; the port runs on one stream, so device time does not overlap
itself).

`--lanes` times the pyramid and shell kernels instead, at the same
configuration, isothermal and with heating, once built as they are for
each lane count G per cell (a power of two dividing 32): each build
compiles csrc/pyramid_sweep.cu and csrc/shell_sweep.cu from a copy of
csrc/ under build/lanes<G>/ with band_rates.cuh's kCellLanes = G, and
the counts run in turns (G1, G2, ..., G2, G1), CUDA events, mean of 5
calls after a warm-up each.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--heating", action="store_true")
    ap.add_argument("--lls", action="store_true")
    ap.add_argument("--photon-losses", action="store_true")
    ap.add_argument("--engine", default="pyramid",
                    choices=("pyramid", "octant", "shells"))
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--mesh", type=int, default=128)
    ap.add_argument("--sources", type=int, default=8)
    ap.add_argument("--lanes", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_iteration: needs a CUDA GPU")

    import dataclasses

    import chip_smoke as cs
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import make_evolve3d_iteration
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    M, S = args.mesh, args.sources
    cfg, _ = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, dev, args.heating)
    cfg = dataclasses.replace(cfg, engine=args.engine)
    if args.photon_losses:
        cfg = dataclasses.replace(
            cfg, add_photon_losses=True,
            sweep=dataclasses.replace(cfg.sweep, track_band_loss=True))
    kw = {}
    if args.lls:
        kw["lls_grid"] = torch.as_tensor(
            10.0 ** np.random.RandomState(8).uniform(14.0, 17.0, M**3),
            dtype=torch.float32, device=dev)
    rng = np.random.RandomState(7)
    srcpos = torch.as_tensor(rng.randint(0, M, size=(S, 3)), device=dev)
    nflux = torch.as_tensor(np.concatenate(
        [rng.uniform(0.5, 2.0, (S, 1)), np.zeros((S, 2))], axis=1),
        dtype=torch.float32, device=dev)
    state = initial_grid_state(np.full((M,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                               1.0e4, dtype=torch.float32, device=dev)
    if args.lanes:
        time_lanes([int(g) for g in args.lanes.split(",")], state, srcpos,
                   nflux, M)
        return
    iteration = make_evolve3d_iteration(cfg)
    start = iteration(state, srcpos, nflux, 1.0e14, **kw)[0]

    def run():
        """Wall seconds per iteration of the N iterations after the
        warm-up (each run starts from the same state)."""
        state = start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state = iteration(state, srcpos, nflux, 1.0e14, **kw)[0]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.iters

    wall = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_profiled = run()

    # device-side rows only: the CPU operators that launched the kernels
    # carry the same device time again
    rows = sorted(((e.self_device_time_total / args.iters,
                    e.count // args.iters, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    variant = f"{args.engine} engine, " + (
        "heating" if args.heating else "isothermal") + (
        " + LLS grid" if args.lls else "") + (
        " + photon losses" if args.photon_losses else "")
    print(f"{cs.smi_line()}; {variant} {M}^3 x {S} float32, {args.iters} "
          f"profiled iterations")
    print(f"wall per iteration {wall * 1e3:.3f} ms ({wall_profiled * 1e3:.3f} "
          f"ms profiled), device time {busy:.3f} ms, idle share "
          f"{1.0 - busy / (wall * 1e3):.4f} of the unprofiled wall")
    for us, count, key in rows[:20]:
        print(f"  {us / 1e3:9.3f} ms  {count:5d} launches  {key[:90]}")


def build_with_lanes(G):
    """{name: ctypes library} of csrc/pyramid_sweep.cu and shell_sweep.cu
    built, both nvcc at once, from a copy of csrc/ with kCellLanes = G."""
    import ctypes
    import re
    import shutil
    import subprocess

    from c2ray_tpu_torch import cuda_build

    d = cuda_build.BUILD_DIR.parent / f"lanes{G}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    h = d / "band_rates.cuh"
    text, n = re.subn(r"constexpr int kCellLanes = \d+;",
                      f"constexpr int kCellLanes = {G};", h.read_text())
    if n != 1:
        raise RuntimeError("kCellLanes not found in band_rates.cuh")
    h.write_text(text)
    names = ("pyramid_sweep", "shell_sweep")
    procs = [subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                               "-o", str(d / f"lib{n}.so"),
                               str(d / f"{n}.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n in names]
    for p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed at {G} lanes per cell:\n{out}")
    return {n: ctypes.CDLL(str(d / f"lib{n}.so")) for n in names}


def time_lanes(lanes, state, srcpos, nflux, M):
    """The pyramid and shell kernels' times at each lane count, in
    turns."""
    import chip_smoke as cs
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import build_shell_table
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps
    from c2ray_tpu_torch.sweep import source_sweep as ss

    libs = {G: build_with_lanes(G) for G in lanes}
    table = build_shell_table(M)
    Rf, Rb = ps.trace_extents(M)
    print(f"{cs.smi_line()}; {M}^3 x {srcpos.shape[0]} float32, kernel ms "
          f"per lane count G in turns")
    for heating in (False, True):
        cfg = cs.setup(M, *cs.BENCH_SOURCE, torch.float32, state.h1.device,
                       heating)[0].sweep
        fstack = ps.stack_sweep_fields(cfg, cs.fields_of(state))
        for G in lanes + lanes[::-1]:
            cuda_build._LIBS.update(libs[G])
            pyr = cs.event_ms(lambda: ps.trace_cuda(cfg, fstack, srcpos,
                                                    nflux, Rf, Rb), 5)
            shell = cs.event_ms(lambda: ss.shell_sweep_cuda(
                cfg, table, fstack, srcpos, nflux), 5)
            print(f"  {'heating' if heating else 'isothermal'} G = {G}: "
                  f"pyramid {pyr:.3f} ms, shell {shell:.3f} ms")


if __name__ == "__main__":
    main()
