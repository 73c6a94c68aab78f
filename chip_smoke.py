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

Then the 1D kernels' times at mesh 10000 (phase 12's last steps)
after the others'.

The shell and octant slice adds, after phase 8:

15. shell and octant kernels vs plain: the shell kernel at 32^3 (full
   extents), 33^3 (odd) and 32^3 under build_shell_table(32, 8), the
   octant kernel at 32^3, 3 sources (one at a grid edge), float64 and
   float32, isothermal and heating, without and with a homogeneous LLS
   column; the shell kernel at 203^3 at 1.3 times the cell size with a
   per-cell LLS grid; then the shell, octant and pyramid kernels against
   each other at 32^3 in float64 (rtol 1e-10);
16. the bench configuration of phase 4 (128^3 x 8, float32) on
   engine="shells" and engine="octant", isothermal and heating, timed
   as in 4 and 5, each new kernel variant launched;
17. after phase 9, the Run3D physics check of phase 9 at mesh 33 (odd:
   the shell engine) in float32 on the card against the port's plain
   float64 on the CPU (run after phase 9's in the same child process);
   after phase 10, `Run3D.run()` at 203^3 (the radiative-transfer grid
   of Iliev et al. 2006, MNRAS 369, 1625), heating, float32, on phase
   10's synthetic tree with 64 halos, 1 slice x 2 steps, on the shell
   engine, which sweeps each step at its own cell size and per-cell LLS
   column (the JAX package's shell engine takes neither).

Then the shell and octant kernels' times at 128^3 x 8, last.

The multi-GPU slice adds, after phase 16 (the card has one H100, so
the parallel paths run at world size 1; their exchange between ranks
is held against the JAX package by the CPU tests in gloo processes):

18. the three halo kernels (``csrc/domain_halo.cu``: halo_pack,
   window_accumulate, fold_halo) against their plain versions on the
   card, float64 and float32, with 5 and 6 channels, at the slab shapes
   of 8 ranks at 32^3 radius 5 (S = 4, H = 6), of one rank at 128^3,
   full radius (S = 128, H = 64), and of one rank at 18^3, radius 1
   (H = 2: float32 pack rows not 16-byte aligned): equal to the bit;
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

Then the halo kernels' times at 128^3, world size 1, full radius, with
the rate each achieves and its share of the bound.

The sweep redesign (lanes per cell, the node loop unrolled, one
division per band) adds, last:

22. for the pyramid stage kernel, the shell kernel and the octant plane
   kernel at 128^3 x 8, float32, isothermal and heating (phases 4 and
   5's states): the band loop's instruction mix from `cuobjdump -sass`
   (`sass_band_mix`: MUFU.EX2, float32-pipe and all instructions per
   band; one MUFU.EX2 per exponential and one MUFU.RCP), the launches'
   device times from torch.profiler grouped by layer, shell or plane
   (`octant_plane_groups`) with their cell steps, against the sweep's
   CUDA-event time (the rest: launch gaps and the sweep's other work),
   the octant kernel's plane launches by lanes per cell, and two calls
   equal to the bit.  The tracer now and then keeps no record of a
   launch: after five windows without one, a split is logged as not
   measured, and a single kernel's device time (phase 23) is taken
   with CUDA events behind a sleep kernel instead (`kernel_ms`).

The chemistry and photon-loss redesign adds, last:

23. with a parent build unpacked under build/parent/ (a `git archive`
   of the commit before the redesign, built after phase 2; without one
   these two parts are not run): the 1D and halo sources compile to
   the parent's SASS (the sweep sources' fixed rule is held to the
   parent's time by tools/profile_torch_iteration.py --builds), and #3
   and #5 are timed
   in turns against the
   parent's kernels (wrapper call and kernel device ms), #3's outputs
   and counters equal to the parent's to the bit; at phases 4 and 5's
   states, from a stamped copy of the chemistry kernel
   (tools/kernel_study.py), each cell's iterations and
   thermal sub-steps: their histograms and sums, the warp efficiency in
   cell order, the cycles per part, the achieved occupancy; the
   chemistry bound from the counted work; at phase 8's state the
   photon-loss band loop's SASS per band (no shared-memory load, no
   division check, one MUFU.RCP), the whole-row and strided layouts
   against the plain version; two calls of each equal to the bit.

The tau-table and "auto" routes of the three sweep kernels add, after
phase 16:

24. the tau-table and "auto" quadrature routes of the pyramid kernel
   (32^3, full extents and radius 8, each without and with a per-cell
   LLS grid), the shell kernel (32^3, 33^3, 32^3 under
   build_shell_table(32, 8)) and the octant kernel (32^3) against their
   plain versions, 3 sources, float64 (rtol 1e-10) and float32 (the
   sweep gates of phases 3 and 15), isothermal and heating;
25. the bench configuration of phases 4 and 5 (128^3 x 8, float32, 4
   timed iterations of `make_evolve3d_iteration`) on the tau tables on
   each engine and on the "auto" quadrature on the pyramid engine (with
   a parent build under build/parent, on every engine, each in turns
   with the parent's), isothermal and heating: cell-source-updates/s, each route's sweep
   kernel launched, its time, plain time and bound (`table_bound` for
   the tau tables: the positions' log10s and the reads' arithmetic over
   the bands of nonzero table columns); on the tau tables the float64
   kernel against the float64 plain version at the same state (rtol
   1e-10) besides the float32 gate against float64.

The last slice (the cross-check and the tools) adds, after phase 13:

27. the 1D/3D cross-check of tests/test_1d3d_crosscheck.py at the
   bench's width in float32: one 1e5 K blackbody of 2e51 photons/s at
   the centre of a 128^3 grid of n = 1e-3 with 1 kpc cells, isothermal,
   the 6-node rule, 6 x 10 Myr through `evolve3d`, and the same problem
   through `OneDRun` on 512 shells out to 128 kpc: the 3D front (from
   the ionized volume, summed in float64 on the host) within one cell
   of the 1D front, the on-axis 3D ionized fraction within 0.15 of the
   1D profile at 1/4, 1/2 and 3/4 of the front; the pyramid, chemistry
   and 1D kernels launched by it (the kernels line counts them in);
28. tools/table_write_torch.py on the card against the CPU, in its
   three modes (heating and isothermal tau tables, 8-node quadrature):
   the same files, byte for byte;
29. tools/bench_scaling_torch.py at world size 1 over NCCL (one spawned
   rank) at 128^3 x 8 sources in the source and domain modes: its JSON
   line.

The pyramid engine's batch entry adds each source group's rate slabs
into the rate grids with the group sum kernel
(``csrc/group_accumulate.cu``): every pyramid main path above must
launch it, the shell and octant engines and the domain mode must not.
After the halo kernels' times:

30. the group sum kernel against its plain version (the masked sum and
   add) at 128^3 x 8 and 250^3 x 8, float32, and 250^3 x 8 float64,
   two of the eight sources dropped: equal to the sum in source order
   to the bit, within 4 S roundings of the masked sum; then its time,
   the plain version's and the bound ((S + 2) M^3 16-byte rows at
   3.35 TB/s), every source live.

Each entry of the `kernels` line carries its bound: the larger of the
bytes the function must move over the card's memory rate and its
operations over their peak rate (`bound`; for the 1D kernels the
largest of that, the latency of the iterations' dependent chains and
one warp's instruction issue, `oned_bound`; for the chemistry the
arithmetic that its counted iterations and sub-steps need, the fewer of
this build's and the parent's instructions, at the issue, float64 and
special-function rates, `chemistry_bound`).  The
chemistry and photon-loss entries count their launches over every
main-path run (MAIN_PATH_LAUNCHES).
The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from c2ray_tpu_torch.utils import clocks

# the SASS readers and the stamped chemistry build, shared with
# tools/profile_torch_iteration.py
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools"))
from kernel_study import (  # noqa: E402
    achieved_occupancy, build_chem_split, build_oned, chem_pass_with,
    chem_split_run, chem_split_stats, comparable_sass, histogram, kernel_sass,
    oned_block_rows, parent_evolve1d, parent_oned_tables,
    parent_photon_losses, parent_sweeps, sass_band_mix, sass_issue_floor,
    sass_loop_mix, sass_per_band, with_library)

# a library's SASS is read once a run: the builds do not change in it
kernel_sass = functools.lru_cache(maxsize=None)(kernel_sass)


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
    of the K nodes of each live band, cell and source (the blocks' own
    K with "auto" tables), 2 exponentials (e_in, e_out) on the
    special-function units and 10 flops of the photo sums (25 with the
    heating sums) on the float32 pipes; an expm1 per cell with LLS, an
    add per band and cell with tracking.  Tau tables: table_bound."""
    from c2ray_tpu_torch.radiation.quadrature import (QuadTables,
                                                      packed_band_blocks)
    from c2ray_tpu_torch.sweep.source_sweep import sweep_heats

    if not isinstance(sweep_cfg.tables, QuadTables):
        return table_bound(sweep_cfg, S, Rf, Rb, lls)
    heat = sweep_heats(sweep_cfg)
    _, blocks = packed_band_blocks(sweep_cfg.tables, torch.float32, heat,
                                   sweep_cfg.has_bb, sweep_cfg.has_pl,
                                   sweep_cfg.has_qso)
    M = sweep_cfg.mesh
    nlive = sum(b[2] for b in blocks)
    cells = S * (Rf + Rb + 1) ** 3
    nodes = cells * sum(b[2] * b[3] for b in blocks)
    nbytes = 4 * (M**3 * (6 if lls else 5) + S * M**3 * 4)
    flops = nodes * (25 if heat else 10) + (cells * nlive if track else 0)
    return bound(nbytes, flops, 2 * nodes + (cells if lls else 0))


# the tau-table route per cell and band of a float32 sweep
# (csrc/table_rates.cuh:table_rates): tau_in, tau_out, the three tau
# shares and their reciprocal, two positions (a log10 on the special-
# function units and 4 flops each), and per source type two linear
# reads (3 flops each) and 11 flops of sums; with heating per species
# two more reads and 8 flops, the Ricotti fractions 24 flops a band
TABLE_FLOPS = (32, 11)             # per band, per band and type
TABLE_HEAT_FLOPS = (24, 3 * 14)    # the same with heating
TABLE_SFU = 3                      # 2 log10 and the share's reciprocal


def table_bound(sweep_cfg, S, Rf, Rb, lls=False):
    """Bound of one float32 tau-table sweep of S sources over (Rf + Rb +
    1)^3 cells: the larger of the bytes (the 5 field channels and the
    LLS grid read once, the rate slab written once, the tables' nonzero
    columns read once from device memory: they sit in the 50 MB L2, so a
    cell's reads that miss it are the tables' first) and the operations
    (TABLE_FLOPS, TABLE_SFU): the per-band part over the bands where
    some type's tables are nonzero, the per-type part over each type's
    own nonzero bands (the tables hold zero columns outside a type's
    band range, whose rates add nothing)."""
    from c2ray_tpu_torch.radiation.tables import packed_table_route
    from c2ray_tpu_torch.sweep.source_sweep import sweep_heats

    heat = sweep_heats(sweep_cfg)
    tr = packed_table_route(sweep_cfg.tables, torch.float32, "cpu", heat,
                            sweep_cfg.has_bb, sweep_cfg.has_pl,
                            sweep_cfg.has_qso)
    live = tr.photo.ne(0).any(dim=2).any(dim=1)          # (ntypes, nb)
    n_any, n_type = int(live.any(dim=0).sum()), int(live.sum())
    cells = S * (Rf + Rb + 1) ** 3
    flops = TABLE_FLOPS[0] * n_any + TABLE_FLOPS[1] * n_type
    if heat:
        flops += TABLE_HEAT_FLOPS[0] * n_any + TABLE_HEAT_FLOPS[1] * n_type
    cols = [t.ne(0).any(dim=-2) for t in (tr.photo, tr.heat) if t is not None]
    tables = (tr.photo.shape[-2]) * sum(int(c.sum()) for c in cols)
    M = sweep_cfg.mesh
    nbytes = 4 * (M**3 * (6 if lls else 5) + S * M**3 * 4 + tables)
    return bound(nbytes, cells * flops,
                 cells * n_any * TABLE_SFU + (cells if lls else 0))


# one fixed-point iteration of one cell of the 1D march (oned_bound;
# lower estimates): two doric solves, each a square root, 3
# exponentials and 3 expm1, and about 200 flops
CHEM_SFU_PER_ITERATION = 14
CHEM_FLOPS_PER_ITERATION = 200

# A warp issues one instruction a cycle on each of an SM's 4
# schedulers: 128 thread-instructions per SM and clock when every lane
# works; the float64 pipe takes 64 of them, the special-function units 16
# (CUDA C++ Programming Guide, arithmetic instruction throughput, 9.0).
ISSUE_PER_SM_CLOCK = 128
FP64_PER_SM_CLOCK = 64
SFU_PER_SM_CLOCK = 16


# The chemistry kernel's arithmetic before its redesign (commit 8446144,
# tools/profile_torch_iteration.py --chem --parent): per variant
# (heating or not), the float32-pipe instructions, the divisions' range
# checks among them (FCHK), the float64 and the special-function
# instructions (kernel_study.MIX_KEYS) of one pass through the
# fixed-point loop and of one thermal sub-step (None: isothermal).
# chemistry_bound takes the fewer of these and this build's: both builds
# compute the same function, so the fewer instructions bound it.
PARENT_CHEM_MIX = {
    False: ({"fp32": 889, "fchk": 43, "fp64": 0, "mufu": 63}, None),
    True: ({"fp32": 1261, "fchk": 61, "fp64": 0, "mufu": 85},
           {"fp32": 75, "fchk": 3, "fp64": 0, "mufu": 2})}


def chem_arithmetic(loop, inner):
    """The arithmetic of a chemistry kernel's SASS mixes (a pass through
    the fixed-point loop, a thermal sub-step or None): ({pipe: per
    iteration, the sub-step taken out}, {pipe: per sub-step}) for the
    pipes "fp32" (less the divisions' range checks, FCHK: the IEEE
    division's guard of its slow path), "fp64" and "mufu"."""
    def arith(m):
        if m is None:
            return dict.fromkeys(("fp32", "fp64", "mufu"), 0)
        return {"fp32": m["fp32"] - m["fchk"], "fp64": m["fp64"],
                "mufu": m["mufu"]}

    per_sub = arith(inner)
    return {k: v - per_sub[k] for k, v in arith(loop).items()}, per_sub


def chemistry_bound(n, heat, iterations, substeps, mix):
    """Bound of one float32 chemistry pass over n cells whose fixed
    points took `iterations` iterations and `substeps` thermal sub-steps
    in all (summed over the cells): the larger of the bytes (20 state and
    rate rows read, 22 with heating, 12 written) over the memory rate and
    the function's arithmetic over the card's rates.  The arithmetic is
    chem_arithmetic of `mix` (sass_loop_mix of this build's kernel) or of
    PARENT_CHEM_MIX[heat], the fewer of the two per pipe: per iteration
    a pass through the fixed-point loop with its thermal sub-cycle taken
    out, per sub-step a pass through the sub-cycle.  Its instructions
    issue at ISSUE_PER_SM_CLOCK, the float64 ones at FP64_PER_SM_CLOCK
    and the special-function ones at SFU_PER_SM_CLOCK, all at once,
    every lane of every warp at work.  A cell's loads and write-back are
    left to the bytes; the hand-out of cells, predicates, addresses and
    the division's checks are not the function's work."""
    it_mine, sub_mine = chem_arithmetic(mix["loop"], mix["inner"])
    it_par, sub_par = chem_arithmetic(*PARENT_CHEM_MIX[heat])
    count = {k: iterations * min(it_mine[k], it_par[k])
             + substeps * min(sub_mine[k], sub_par[k]) for k in it_mine}
    per_s = 132 * SM_CLOCK_HZ
    t_ops = max(sum(count.values()) / (ISSUE_PER_SM_CLOCK * per_s),
                count["fp64"] / (FP64_PER_SM_CLOCK * per_s),
                count["mufu"] / (SFU_PER_SM_CLOCK * per_s))
    t_mem = 4 * n * ((22 if heat else 20) + 12) / HBM_BYTES_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def photon_losses_bound(n, nb):
    """Bound of one float32 photon-loss redistribution over n cells and
    nb bands: 4 field rows read, 3 rate rows read and written; per cell
    and band the 3-term denominator (5 flops), its reciprocal (one
    special-function result) and 3 multiply-adds (6 flops)."""
    return bound(4 * n * 10, n * nb * 11, n * nb)


# the bench configuration's source and box (bench.py:70-136): S_star,
# blackbody T_eff in K, box in kpc
BENCH_SOURCE = (3e51, 5e4, 50.0)


def setup(mesh, S_star, T_eff, box, dtype, dev, heating=False,
          tables="quad"):
    """The configuration of a blackbody source in a box; `tables` is
    "quad" (the default 6-node rule), "auto" (the "auto" quadrature
    blocks) or "tau" (the tau tables)."""
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.cooling import setup_cooling_tables
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
    from c2ray_tpu_torch.radiation.tables import build_radiation_tables
    from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                       SweepConfig)

    spec = SEDConfig(bb=BlackBodySED(T_eff=T_eff, S_star=S_star))
    if tables == "tau":
        tables, sed, bands = build_radiation_tables(
            spec, isothermal=not heating, dtype=dtype, device=dev)
    else:
        tables, sed, bands = build_quadrature_tables(
            spec, isothermal=not heating, dtype=dtype, device=dev,
            **({"n_nodes": "auto"} if tables == "auto" else {}))
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


# each kernel's launch counter in the program's store (utils/clocks.py),
# by this script's name for it: <library>[_route][_variant]
LAUNCH_COUNTERS = {
    "pyramid_sweep_lls": "launches.pyramid_sweep.lls",
    "pyramid_sweep_track": "launches.pyramid_sweep.track",
    "chemistry": "launches.chemistry",
    "chemistry_heat": "launches.chemistry.heat",
    "photon_losses": "launches.photon_losses",
    "group_accumulate": "launches.group_accumulate",
    "halo_pack": "launches.domain_halo.pack",
    "window_accumulate": "launches.domain_halo.accumulate",
    "fold_halo": "launches.domain_halo.fold",
    # the fixed rule, the tau tables and the "auto" blocks, isothermal
    # and heating, of the three sweep kernels and the 1D kernel
    **{f"{lib}{route}{sfx}": (f"launches.{lib}" + route.replace("_", ".")
                              + sfx.replace("_", "."))
       for lib in ("pyramid_sweep", "shell_sweep", "octant_sweep",
                   "evolve1d")
       for route in ("", "_table", "_auto") for sfx in ("", "_heat")}}


def launch_counts():
    return {k: clocks.counter(v) for k, v in LAUNCH_COUNTERS.items()}


def plane_lanes():
    """{lanes per cell: the octant kernel's plane launches} so far."""
    from c2ray_tpu_torch.sweep.octant_sweep import PLANE_LANES

    return {G: clocks.counter(f"launches.octant_sweep.lanes{G}")
            for G in PLANE_LANES}


# each kernel's launches over every main-path run that check_launches
# saw (the kernels line's "launches" of the chemistry and photon-loss
# kernels)
MAIN_PATH_LAUNCHES = {}


def check_launches(name, counts, mine):
    """Every kernel in `mine` launched by the run, no other; the counts
    go into MAIN_PATH_LAUNCHES."""
    log(f"  launches: {counts}")
    for k, c in counts.items():
        MAIN_PATH_LAUNCHES[k] = MAIN_PATH_LAUNCHES.get(k, 0) + c
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
# the pyramid engine's batch entry adds each source group's slabs into
# the rate grids with the group sum kernel; the other engines sum their
# own way
PYRAMID_SUM = {"pyramid": ("group_accumulate",)}


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

    clocks.reset()
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
                "chemistry_heat" if heating else "chemistry",
                "group_accumulate")
    else:
        sfx = "_heat" if heating else ""
        mine = (ENGINE_KERNEL.get(engine, "pyramid_sweep") + sfx,
                "chemistry" + sfx) + PYRAMID_SUM.get(engine, ())
    check_launches(name, counts, mine)
    if engine == "octant":
        log(f"  octant plane launches by lanes per cell: {plane_lanes()}")
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
    clocks.reset()
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
                      mine=("pyramid_sweep_lls", "chemistry_heat",
                            "group_accumulate")):
    """Phases 10 and 17: Run3D.run() at full width, heating, float32, on
    a synthetic CubeP3M tree, through the config loader a run file would
    use: 2 slices at 128^3 (the pyramid engine with the per-cell LLS
    sweep), 1 slice at 203^3 (the RT grid of Iliev et al. 2006, odd: the
    shell engine, at each step's cell size and per-cell LLS column).  Cuts from a production run:
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

    clocks.reset()
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


def compare_engine(cfg64, cfg32, M, dev, engine, table, lls, dr_factor=1.0,
                   lls_grid=None):
    """One case of phase 15: the engine's kernel vs its plain version on
    3 random sources (one at a grid edge), float64 within rtol 1e-10 and
    float32 within twice the plain float32 error against float64 plus
    1e-5, each part (rates, heat, photon and LLS loss) on its own scale.
    The shell engine may sweep at `dr_factor` times the configuration's
    cell size and with `lls_grid` (numpy, M^3), a per-cell LLS column,
    as a cosmological Run3D step gives them.  Returns the worst float32
    relative error of the kernel."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    kern, plain = engine_trace_fns(engine, table)
    out = {}
    for name, cfg, dtype in (("f64", cfg64, torch.float64),
                             ("f32", cfg32, torch.float32)):
        sweep = dataclasses.replace(
            cfg.sweep, coldensh_LLS=lls, dr=dr_factor * cfg.sweep.dr,
            lls_grid=(None if lls_grid is None else
                      torch.as_tensor(lls_grid, dtype=dtype, device=dev)))
        state, srcpos, nflux = random_case(M, 3, dtype, dev, seed=5)
        fstack = ps.stack_sweep_fields(sweep, fields_of(state))
        unit = sweep.flux_scale / cfg64.sweep.flux_scale
        out[name] = tuple(_sweep_parts(fn(sweep, fstack, srcpos, nflux), unit)
                          for fn in (kern, plain))
    (k64, p64), (k32, p32) = out["f64"], out["f32"]
    extents = ("full" if table is None
               else f"{table.lo[0]}..{table.hi[0]}")
    label = (f"{engine} {M}^3 extents {extents} lls={lls:g}"
             + (f" dr x{dr_factor:g}" if dr_factor != 1.0 else "")
             + (" lls grid" if lls_grid is not None else ""))
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
    heating, without and with a homogeneous LLS column; the shell kernel
    at 203^3 (full extents: phase 17's driver grid) at 1.3 times the
    configuration's cell size with a per-cell LLS grid, as a
    cosmological step sweeps; then the shell,
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
                for M in (32, 33, 203)}
        cases = [("shells", 32, build_shell_table(32)),
                 ("shells", 33, build_shell_table(33)),
                 ("shells", 32, build_shell_table(32, 8)),
                 ("octant", 32, None)]
        for engine, M, table in cases:
            for lls in (0.0, 1.0e15):
                e = compare_engine(*cfgs[M], M, dev, engine, table, lls)
                key = ENGINE_KERNEL[engine] + sfx
                worst[key] = max(worst.get(key, 0.0), e)
        # a type-2 LLS grid as phase 7's, 1e14-1e17 cm^-2 a cell
        grid = 10.0 ** np.random.RandomState(8).uniform(14.0, 17.0, 203**3)
        e = compare_engine(*cfgs[203], 203, dev, "shells",
                           build_shell_table(203), 0.0, dr_factor=1.3,
                           lls_grid=grid)
        worst["shell_sweep" + sfx] = max(worst["shell_sweep" + sfx], e)
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


# ---- the tau-table and "auto" rate routes (phases 24 and 25)

ROUTES = ("tau", "auto")
ROUTE_SUFFIX = {"tau": "_table", "auto": "_auto"}
# the JAX functions each route replaces in the sweep kernels
ROUTE_REPLACES = {"tau": "c2ray_tpu/radiation/photo.py:185",
                  "auto": "c2ray_tpu/radiation/quadrature.py:486"}


def phase_compare_routes(dev):
    """Phase 24: the tau-table and "auto" routes of the three sweep
    kernels against their plain versions, 3 sources (one at a grid
    edge): the pyramid kernel at 32^3, full extents and radius 8, each
    without and with a per-cell LLS grid; the shell kernel at 32^3, 33^3
    and 32^3 under build_shell_table(32, 8); the octant kernel at 32^3;
    float64 within rtol 1e-10 and float32 within the sweep gates of
    phases 3 and 15 (compare_sweep, compare_engine); isothermal and
    heating.  Returns the worst float32 error of each kernel variant."""
    from c2ray_tpu_torch.sweep import build_shell_table

    grid = 10.0 ** np.random.RandomState(8).uniform(14.0, 17.0, 32**3)
    worst = {}
    for route in ROUTES:
        for heating in (False, True):
            sfx = ROUTE_SUFFIX[route] + ("_heat" if heating else "")
            cfgs = {M: tuple(setup(M, 1e48, 5e4, 10.0, dt, dev, heating,
                                   tables=route)[0]
                             for dt in (torch.float64, torch.float32))
                    for M in (32, 33)}
            worst["pyramid_sweep" + sfx] = max(
                compare_sweep(*cfgs[32], 32, dev, r, 0.0, lls_grid=g)
                for r in (None, 8) for g in (None, grid))
            for engine, M, table in (("shells", 32, build_shell_table(32)),
                                     ("shells", 33, build_shell_table(33)),
                                     ("shells", 32,
                                      build_shell_table(32, 8)),
                                     ("octant", 32, None)):
                key = ENGINE_KERNEL[engine] + sfx
                worst[key] = max(worst.get(key, 0.0), compare_engine(
                    *cfgs[M], M, dev, engine, table, 0.0))
    log("tau-table and auto routes of the sweep kernels vs plain: ok")
    return worst


def route_trace_fns(engine, mesh):
    """(kernel, plain version) of an engine's sweep at the full extents,
    each mapping (sweep config, fstack, srcpos, nflux) to (slab, photon
    loss, LLS loss)."""
    from c2ray_tpu_torch.sweep import build_shell_table
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    if engine != "pyramid":
        return engine_trace_fns(engine, build_shell_table(mesh))
    Rf, Rb = ps.trace_extents(mesh)
    return tuple(lambda c, f, sp, nf, fn=fn: fn(c, f, sp, nf, Rf, Rb)[:3]
                 for fn in (ps.trace_cuda, ps.trace_plain))


def phase_main_route(dev, route, engine="pyramid", heating=False, mesh=128,
                     n_src=8, n_iter=4, psweeps=None):
    """Phase 25: the bench configuration of phases 4 and 5 (128^3 x 8
    sources from RandomState(7), float32) with the tau tables or the
    "auto" quadrature on `engine`: a warm-up and n_iter timed iterations
    of make_evolve3d_iteration (cell-source-updates/s), which must
    launch the route's sweep kernel and the chemistry kernel and nothing
    else; then, at that state, the sweep kernel's time (CUDA events,
    mean of 3 after a warm-up), its plain version's (one pass), their
    largest difference and the bound.  The gate: "auto" blocks, whose
    exponentials are the plain version's op for op, the main path's
    float32 one (1e-4, with 1e-4 of each part's largest value as the
    floor); tau tables, whose float32 table positions round apart from
    the plain version's (its division by dlogtau runs as a product with
    the reciprocal on the card) and whose thick reads cancel next to the
    sources: the float64 kernel against the float64 plain version on
    the same state within rtol 1e-10 (phase 24's float64 gate), and the
    float32 kernel's error against the float64 plain version within
    twice the float32 plain version's, plus 1e-6 (the heat 1e-7), the
    sweep gate of phases 3 and 24.  With the parent build's sweep
    libraries (`psweeps`), the sweep kernel is also timed in turns with
    the parent's design of the route (sweeps_in_turns) and the two
    outputs compared.  Returns the route's entry of the kernels line."""
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import make_evolve3d_iteration
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    kernel = ENGINE_KERNEL.get(engine, "pyramid_sweep")
    sfx = "_heat" if heating else ""
    name = kernel + ROUTE_SUFFIX[route] + sfx
    label = (f"{engine} engine {'heating ' if heating else ''}main path on "
             f"the {'tau tables' if route == 'tau' else 'auto quadrature'}")
    cfg, _ = setup(mesh, *BENCH_SOURCE, torch.float32, dev, heating,
                   tables=route)
    cfg = dataclasses.replace(cfg, engine=engine)
    rng = np.random.RandomState(7)
    srcpos = torch.as_tensor(rng.randint(0, mesh, size=(n_src, 3)),
                             device=dev)
    nflux = torch.as_tensor(np.concatenate(
        [rng.uniform(0.5, 2.0, (n_src, 1)), np.zeros((n_src, 2))], axis=1),
        dtype=torch.float32, device=dev)
    s = initial_grid_state(np.full((mesh,) * 3, 1.0e-4), 0.0, 0.0, 0.0,
                           1.0e4, dtype=torch.float32, device=dev)
    dt = 1.0e14
    iteration = make_evolve3d_iteration(cfg)

    clocks.reset()
    (s, conv, ploss, _), warm = synced(iteration, s, srcpos, nflux, dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        s, conv, ploss, _ = iteration(s, srcpos, nflux, dt)
    torch.cuda.synchronize()
    spi = (time.perf_counter() - t0) / n_iter
    counts = launch_counts()
    rate = mesh**3 * n_src / spi
    log(f"{label} {mesh}^3 x {n_src} float32: {rate:.6e} "
        f"cell-source-updates/s, {spi:.6f} s/iteration (warm-up "
        f"{warm:.3f} s); conv_flag {int(conv)}, photon_loss "
        f"{float(ploss):.6e}, mean ionized fraction "
        f"{float(s.h_av1.double().mean()):.6e}")
    check_launches(label, counts,
                   (name, "chemistry" + sfx) + PYRAMID_SUM.get(engine, ()))
    for t in s:
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label} produced non-finite state")
    if s.h1.shape != (mesh**3,) or not math.isfinite(float(ploss)):
        raise AssertionError(f"{label}: wrong shape or non-finite loss")

    kern, plain = route_trace_fns(engine, mesh)
    args = (cfg.sweep, ps.stack_sweep_fields(cfg.sweep, fields_of(s)),
            srcpos, nflux)
    ms = event_ms(lambda: kern(*args), 3)
    k = kern(*args)
    p, wall = synced(plain, *args)
    abs_err = float((k[0][..., :3] - p[0][..., :3]).abs().max())
    parts = zip(_sweep_parts(k, 1.0), _sweep_parts(p, 1.0), SWEEP_PARTS)
    if route == "auto":
        for a, b, w in parts:
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()),
                                       msg=f"{label}: sweep {w}")
    else:
        cfg64, _ = setup(mesh, *BENCH_SOURCE, torch.float64, dev, heating,
                         tables=route)
        s64 = type(s)(*(t.double() for t in s))
        args64 = (cfg64.sweep, ps.stack_sweep_fields(cfg64.sweep,
                                                     fields_of(s64)),
                  srcpos, nflux.double())
        p64 = plain(*args64)
        # the float64 kernel, the same template code at the main path's
        # shapes, against the float64 plain version: phase 24's gate
        for a, b, w in zip(_sweep_parts(kern(*args64), 1.0),
                           _sweep_parts(p64, 1.0), SWEEP_PARTS):
            scale = float(b.abs().max())
            log(f"  {label} {w}: f64 kernel vs f64 plain "
                f"{rel_err(a, b):.3e} of the largest value")
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * scale,
                                       msg=f"{label}: f64 sweep {w}")
        unit = cfg.sweep.flux_scale / cfg64.sweep.flux_scale
        for a, b, ref, w in zip(_sweep_parts(k, unit), _sweep_parts(p, unit),
                                _sweep_parts(p64, 1.0), SWEEP_PARTS):
            ek, ep = rel_err(a.double(), ref), rel_err(b.double(), ref)
            log(f"  {label} {w}: vs f64 plain: f32 kernel {ek:.3e}, f32 "
                f"plain {ep:.3e}; f32 kernel vs plain "
                f"{rel_err(a, b):.3e} of the largest value")
            if not ek <= 2.0 * ep + (1e-7 if w == "heat" else 1e-6):
                raise AssertionError(f"{label}: sweep {w} kernel error "
                                     f"{ek:.3e} vs plain {ep:.3e}")
    b = sweep_bound(cfg.sweep, n_src, mesh // 2, mesh // 2 - 1)
    log(f"{label}: sweep kernel {ms:.3f} ms, plain {1e3 * wall:.3f} ms, "
        f"bound {b[0]:.3f} ms ({b[1]}), max |kernel - plain| {abs_err:.3e} "
        f"(f32 rates, 1/s)")
    entry = {"name": name, "route": "cuda",
             "source": f"c2ray_tpu_torch/csrc/{kernel}.cu",
             "replaces": ROUTE_REPLACES[route], "launches": counts[name],
             "max_abs_err": abs_err, "ms": ms, "plain_ms": 1e3 * wall,
             "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
             "cell_source_updates_per_s": rate}
    if psweeps is not None:
        with parent_sweeps(psweeps, PARENT_CSRC):
            pk = kern(*args)
        same = all(torch.equal(x, y) for x, y in zip(pk, k))
        diff = max(rel_err(x, y) for x, y in zip(_sweep_parts(k, 1.0),
                                                   _sweep_parts(pk, 1.0)))
        t = sweeps_in_turns(lambda: kern(*args), psweeps)
        log(f"  {label}: in turns with the parent build's design (ms): "
            f"parent {t['parent'][0]:.3f} / {t['parent'][1]:.3f}, this "
            f"{t['this'][0]:.3f} / {t['this'][1]:.3f}; this/parent "
            f"{turns_ratio(t):.4f}; outputs equal to the bit: {same}, "
            f"largest difference {diff:.3e} of the largest value")
        entry["parent_in_turns_ms"] = t
    return entry


# ---- the redesigned sweep kernels' evidence (phase 22)

# the launches' layers (pyramid) or shells (shell kernel), grouped
LAYER_GROUPS = ((1, 16), (17, 40), (41, 64), (65, 10**9))


def octant_plane_groups(R):
    """The octant kernel's planes s = 1..3R (R = M/2) in groups: the
    narrow head (s <= R/4, then <= 5R/8), the middle, and the tail's
    mirror images (at R = 64: 1-16, 17-40, 41-152, 153-176, 177-192)."""
    q1, q2, n = R // 4, 5 * R // 8, 3 * R
    return ((1, q1), (q1 + 1, q2), (q2 + 1, n - q2), (n - q2 + 1, n - q1),
            (n - q1 + 1, n))


def pyramid_layer_cells(M, S):
    """Cell steps of each layer l = 1..M/2 of the pyramid kernel over S
    sources: the offsets of the extents -(M/2-1)..M/2 at Chebyshev
    distance l."""
    Rf, Rb = M // 2, M // 2 - 1
    w = lambda l: min(l, Rb) + min(l, Rf) + 1
    return [S * (w(l)**3 - w(l - 1)**3) for l in range(1, Rf + 1)]


def octant_plane_cells(M, S):
    """Cell steps of each plane s = 1..3R of the octant kernel over S
    sources: the valid positions of the 8 octants (face cells once per
    octant that holds them)."""
    from c2ray_tpu_torch.sweep.octant_sweep import plane_rows

    return [S * int(n) for n in plane_rows(M)[2]]


def grouped_launches(durs, groups, cells, per=1):
    """[(label, launches, device ms, cell steps, ns per cell step)] of a
    sweep's launches (device ms in launch order, `per` launches to a
    layer or plane) by groups of layers or planes (1-based, inclusive);
    `cells` the cell steps of each layer or plane."""
    out = []
    for lo, hi in groups:
        hi = min(hi, len(durs) // per)
        if lo > hi:
            continue
        ms = sum(durs[per * (lo - 1):per * hi])
        n = int(sum(cells[lo - 1:hi]))
        out.append((f"{lo}-{hi}", per * (hi - lo + 1), ms, n, 1e6 * ms / n))
    return out


def launch_profile(fn, kernel, n, windows=5, required=True):
    """(device ms of each of the n launches of a kernel whose name holds
    `kernel` in one fn(), in launch order; ms from the first one's start
    to the last one's end) under torch.profiler.  fn runs twice in the
    profiled window and the first call's launches count: the tracer may
    drop the records of a window's last launches, and now and then all of
    them, so a window that saw fewer than n is profiled again, up to
    `windows` windows.  After that it raises, or, with required=False,
    logs it and returns None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA and kernel in e.name)
        if len(ev) >= n:
            break
    else:
        what = (f"torch.profiler saw {len(ev)} launches of {kernel} in "
                f"{windows} windows, fewer than one call's {n}")
        if required:
            raise AssertionError(what)
        log(f"  {what}")
        return None
    ev = ev[:n]
    return [(b - a) / 1e3 for a, b in ev], (ev[-1][1] - ev[0][0]) / 1e3


def queued_ms(fn, reps=5):
    """Device ms of fn()'s work on the stream (CUDA events, mean of
    reps): a sleep kernel ahead of the start event keeps the card busy
    while the host queues the calls, so no host time falls between the
    events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel):
    """(device ms of the one launch of `kernel` in fn(), how it was
    taken): torch.profiler's, or, when the tracer keeps no record of the
    launch, fn()'s device work from CUDA events (queued_ms: the kernel
    and whatever else the call queues)."""
    prof = launch_profile(fn, kernel, 1, required=False)
    if prof is not None:
        return prof[0][0], "torch.profiler"
    return queued_ms(fn), "CUDA events"


def phase_sweep_redesign(cfg, s, srcpos, nflux):
    """Phase 22: the redesigned pyramid stage kernel, shell kernel and
    octant plane kernel at the main path's shapes (phase 4's or 5's
    state, float32): their band loop's SASS mix (`sass_band_mix` of the
    instantiation this table's K runs; the octant kernel's at the lanes
    per cell of its widest plane) with one MUFU.EX2 per exponential (2K
    per band) and one MUFU.RCP (the tau share's reciprocal: no division
    by the cell volume); each kernel's launches' device times from
    torch.profiler, grouped by layer, shell or plane (LAYER_GROUPS,
    octant_plane_groups) with their cell steps, against the sweep's
    CUDA-event time, the rest being launch gaps and the sweep's other
    work (zeroing, the source cells, the partial sums); two calls equal
    to the bit.  Returns {kernels-line name: extra keys}."""
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.radiation.quadrature import packed_band_rows
    from c2ray_tpu_torch.sweep import build_shell_table
    from c2ray_tpu_torch.sweep import octant_sweep as oc
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps
    from c2ray_tpu_torch.sweep.source_sweep import sweep_heats

    sw = cfg.sweep
    M, S = sw.mesh, srcpos.shape[0]
    heat = sweep_heats(sw)
    K = packed_band_rows(sw.tables, torch.float32, heat, sw.has_bb,
                         sw.has_pl, sw.has_qso)[2]
    kk, flag = unrolled_k(K), int(heat)
    fstack = ps.stack_sweep_fields(sw, fields_of(s))
    Rf, Rb = ps.trace_extents(M)
    table = build_shell_table(M)
    shell = engine_trace_fns("shells", table)[0]
    ocells = octant_plane_cells(M, S)
    wide = oc._plane_lanes(max(ocells))
    sfx = "_heat" if heat else ""
    cases = (
        ("pyramid_sweep" + sfx, "pyramid_sweep", "stage_kernel",
         rf"stage_kernelIfLb{flag}ELb0ELi{kk}E", 3 * Rf, "layers",
         LAYER_GROUPS, pyramid_layer_cells(M, S), 3,
         lambda: ps.trace_cuda(sw, fstack, srcpos, nflux, Rf, Rb)),
        ("shell_sweep" + sfx, "shell_sweep", "shell_kernel",
         rf"shell_kernelIfLb{flag}ELi{kk}E", table.n_shells, "shells",
         LAYER_GROUPS, [S * int(m.sum()) for m in table.mask], 1,
         lambda: shell(sw, fstack, srcpos, nflux)),
        ("octant_sweep" + sfx, "octant_sweep", "plane_kernel",
         rf"plane_kernelIfLb{flag}ELi{kk}ELi{wide}E", 3 * (M // 2),
         "planes", octant_plane_groups(M // 2), ocells, 1,
         lambda: oc.octant_sweep_cuda(sw, fstack, srcpos, nflux)))
    out = {}
    for (name, lib, kernel, mangled, n_launch, what, groups, cells, per,
         fn) in cases:
        sass = kernel_sass(cuda_build.library_path(lib))
        fns = [v for k, v in sass.items() if re.search(mangled, k)]
        if len(fns) != 1:
            raise AssertionError(f"{lib}: {len(fns)} functions match "
                                 f"{mangled}")
        mix = sass_band_mix(fns[0], 2 * K)
        a, b = fn(), fn()
        same = all(x is None and y is None or torch.equal(x, y)
                   for x, y in zip(a, b))
        ms = event_ms(fn, 3)
        prof = launch_profile(fn, kernel, n_launch, required=False)
        lanes0 = plane_lanes()
        fn()
        lanes = {G: n - lanes0[G]
                 for G, n in plane_lanes().items() if n > lanes0[G]}
        log(f"{name} at {M}^3 x {S}, K = {K}: band loop "
            f"per band {mix['ex2']:g} MUFU.EX2, {mix['fp32']:g} float32-pipe, "
            f"{mix['rcp']:g} MUFU.RCP, {mix['expf_reduction']:g} expf "
            f"range-reduction, {mix['total']:g} instructions in all")
        if prof is None:
            rows, busy = [], None
            split = (f"  launches of {kernel}: not measured (no profiler "
                     f"records); sweep {ms:.3f} ms (CUDA events)")
        else:
            durs, span = prof
            rows = grouped_launches(durs, groups, cells, per)
            busy = sum(durs)
            split = (f"  {len(durs)} launches of {kernel}: "
                     + ", ".join(f"{what} {k} {n} launches {t:.3f} ms "
                                 f"({c} cell steps, {ns:.3f} ns each)"
                                 for k, n, t, c, ns in rows)
                     + f"; device {busy:.3f} ms, first start to last end "
                     f"{span:.3f} ms (profiled); sweep {ms:.3f} ms (CUDA "
                     f"events): launch gaps and other work {ms - busy:.3f} "
                     f"ms ({(ms - busy) / ms:.1%})")
        log(split + f"; two calls equal to the bit: {same}"
            + (f"; plane launches by lanes per cell {lanes}"
               if lib == "octant_sweep" else ""))
        if not same:
            raise AssertionError(f"{name}: two calls differ")
        if not (mix["ex2"] == 2 * K and mix["rcp"] == 1):
            raise AssertionError(f"{name}: band loop mix {mix}")
        out[name] = {"sass_band_mix_K": K, "sass_band_mix": mix,
                     f"device_ms_by_{what[:-1]}_group": {
                         k: t for k, _, t, _, _ in rows} or None,
                     f"ns_per_cell_step_by_{what[:-1]}_group": {
                         k: ns for k, _, _, _, ns in rows} or None,
                     "device_ms": busy, "event_ms": ms,
                     "gaps_and_other_ms": None if busy is None
                     else ms - busy}
        if lib == "octant_sweep":
            out[name]["plane_launches_by_lanes"] = lanes
    return out


# ---- the chemistry and photon-loss redesign's evidence (phase 23)

# the parent build that phase 23 times in turns, when it is there: a
# `git archive` of the commit before the redesign unpacked under build/
PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "parent")
PARENT_CSRC = os.path.join(PARENT_DIR, "c2ray_tpu_torch", "csrc")
# the kernel sources whose SASS is held to the parent's: the halo
# kernels to the instruction, the 1D kernel's parent functions compared
# and, where any differs, its three main-path variants timed in turns
# with the parent's (phase_oned_in_turns; the sweep sources' fixed rule
# is held to the parent's time: phase_fixed_rule_in_turns, tools/
# profile_torch_iteration.py --builds and the card test
# test_fixed_rule_sweeps_time_as_the_parent)
SAME_SASS = ("evolve1d", "domain_halo")
SASS_FATAL = ("domain_halo",)
# functions of those sources that a redesign changed, left out of the
# comparison: the 1D kernel's "auto" instantiations (kK = kBlockRoute)
REDESIGNED_FUNCTIONS = {"evolve1d": r"evolve1d_kernelI[fd]Lb[01]ELb0ELin2E"}


# phase 23 times the chemistry and photon-loss kernels of commit
# 8446144 (their C entries: kernel_study.parent_chemistry_pass and
# parent_photon_losses); a parent whose sources of the two equal this
# tree's has nothing to time
REDESIGNED_SOURCES = ("chemistry.cu", "chemistry.cuh", "photon_losses.cu",
                      "common.cuh")


# the parent's sweep sources, whose route kernels phase 25 times in
# turns with this build's (kernel_study.parent_sweeps)
PARENT_SWEEPS = ("pyramid_sweep", "shell_sweep", "octant_sweep")


def start_parent_build():
    """{source: nvcc process} of the parent build (its chemistry,
    photon-loss, 1D, halo and sweep sources), started beside phase 2's
    build; None when no parent is unpacked under build/parent."""
    from c2ray_tpu_torch import cuda_build

    psrc = pathlib.Path(PARENT_CSRC)
    if not psrc.is_dir():
        return None
    base = cuda_build.BUILD_DIR.parent / "parent_libs"
    names = ("chemistry", "photon_losses") + SAME_SASS + PARENT_SWEEPS
    return {n: build_oned(psrc, base / f"lib{n}.so", source=n)
            for n in names}


def parent_libraries(procs=None):
    """({source: ctypes library} of the parent build's chemistry and
    photon-loss sources, None when they are this tree's; the other
    sources' SASS compared with this build's ({source: (equal functions,
    parent's functions)}); {source: ctypes library} of its sweep and 1D
    sources), or (None, None, None) when no parent is unpacked under
    build/parent.  `procs`: start_parent_build's processes (started here
    when not given)."""
    import ctypes

    from c2ray_tpu_torch import cuda_build

    procs = start_parent_build() if procs is None else procs
    if procs is None:
        log(f"  no parent build under {PARENT_DIR}: the in-turns timing "
            f"and the SASS comparison are not run")
        return None, None, None
    psrc = PARENT_CSRC
    base = cuda_build.BUILD_DIR.parent / "parent_libs"
    for n, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {n}.cu:\n{out}")
    same = {}
    for n in SAME_SASS:
        cuda_build.load(n)
        mine = comparable_sass(cuda_build.library_path(n))
        theirs = {k: v for k, v in comparable_sass(
            base / f"lib{n}.so").items()
            if not re.search(REDESIGNED_FUNCTIONS.get(n, "^$"), k)}
        same[n] = (sum(mine.get(k) == v for k, v in theirs.items()),
                   len(theirs))
        for k, v in theirs.items():
            if mine.get(k) != v:
                a, b = (mine.get(k) or "").splitlines(), v.splitlines()
                at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                          min(len(a), len(b)))
                log(f"  {n}.cu differs from the parent in {k[:120]} "
                    f"({len(a)} / {len(b)} lines) from line {at}:\n    "
                    + "\n    ".join(a[at:at + 4]) + "\n  parent:\n    "
                    + "\n    ".join(b[at:at + 4]))
    log("  SASS equal to the parent's (functions; the redesigned ones "
        f"{REDESIGNED_FUNCTIONS} left out): " + ", ".join(
            f"{n}.cu {a} of {b}" for n, (a, b) in same.items()))
    if any(same[n][0] != same[n][1] for n in SASS_FATAL):
        raise AssertionError(f"a source outside the redesign compiles to "
                             f"other SASS than the parent's: {same}")
    sweeps = {n: ctypes.CDLL(str(base / f"lib{n}.so"))
              for n in PARENT_SWEEPS + ("evolve1d",)}
    if all(pathlib.Path(psrc, f).read_bytes()
           == (cuda_build.CSRC / f).read_bytes() for f in REDESIGNED_SOURCES):
        log("  the parent's chemistry and photon-loss sources are this "
            "tree's: their in-turns timing is not run")
        return None, same, sweeps
    return ({n: ctypes.CDLL(str(base / f"lib{n}.so"))
             for n in ("chemistry", "photon_losses")}, same, sweeps)


def sweeps_in_turns(fn, psweeps, reps=3):
    """{"parent": [ms, ms], "this": [ms, ms]} of fn() (a sweep through
    this tree's wrappers) with the parent build's sweep libraries and
    with this build's, in turns (parent, this, this, parent; CUDA
    events, mean of reps calls after a warm-up)."""
    out = {}
    for key in ("parent", "this", "this", "parent"):
        if key == "parent":
            with parent_sweeps(psweeps, PARENT_CSRC):
                ms = event_ms(fn, reps)
        else:
            ms = event_ms(fn, reps)
        out.setdefault(key, []).append(ms)
    return out


def turns_ratio(t):
    return sum(t["this"]) / sum(t["parent"])


def phase_fixed_rule_in_turns(cfg, s, srcpos, nflux, psweeps):
    """Phase 25, the fixed 6-node rule: its pyramid, shell and octant
    sweeps at phase 4's (heating: 5's) state in turns with the parent
    build (sweeps_in_turns); the route redesign is to leave them within
    +-1% of the parent's.  Returns {engine: times}, or None without a
    parent."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    if psweeps is None:
        log("  no parent build: the fixed rule's in-turns timing is not run")
        return None
    M = cfg.sweep.mesh
    fstack = ps.stack_sweep_fields(cfg.sweep, fields_of(s))
    out = {}
    for engine in ("pyramid", "shells", "octant"):
        kern = route_trace_fns(engine, M)[0]
        t = sweeps_in_turns(lambda: kern(cfg.sweep, fstack, srcpos, nflux),
                            psweeps)
        out[engine] = t
        log(f"  fixed rule, {engine} sweep, "
            f"{'heating' if not cfg.chem.isothermal else 'isothermal'}, in "
            f"turns with the parent build (ms): parent "
            f"{t['parent'][0]:.3f} / {t['parent'][1]:.3f}, this "
            f"{t['this'][0]:.3f} / {t['this'][1]:.3f}; this/parent "
            f"{turns_ratio(t):.4f}")
    return out


def in_turns(fns, kernel, reps):
    """{key: [(wrapper call ms (CUDA events, mean of reps), the kernel's
    device ms (kernel_ms))] in the order parent, this, this, parent} of
    the callables in `fns`."""
    out = {}
    for key in ("parent", "this", "this", "parent"):
        f = fns[key]
        out.setdefault(key, []).append(
            (event_ms(f, reps), kernel_ms(f, kernel)[0]))
    return out


# the stamped copy of the chemistry kernel, built once
_STAMPED = {}


def stamped_chemistry():
    """(ctypes library, layout, threads a block) of the stamped copy of
    csrc/chemistry.cu (tools/kernel_study.py:
    build_chem_split), built on the first call."""
    from c2ray_tpu_torch import cuda_build

    if "this" not in _STAMPED:
        _STAMPED["this"] = build_chem_split("this", cuda_build.CSRC)
    return _STAMPED["this"]


def phase_chem_redesign(cfg, s, srcpos, nflux, dt, parent):
    """Phase 23, chemistry: at phase 4's (isothermal) or 5's (heating)
    state, float32, the inputs of phase_kernel_times: a stamped copy of
    the kernel (tools/kernel_study.py: build_chem_split) gives
    each cell's iterations and thermal sub-steps (their histograms, the
    warp efficiency in cell order, their sums for the bound) and the
    cycles per part; its outputs equal the kernel's; the bound from the
    counted work (chemistry_bound, sass_loop_mix of this build); two
    calls equal to the bit; with the parent build, both timed in turns
    and their outputs and counters equal to the bit.  Returns {kernels
    line name: extra keys}."""
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import global_pass as gp
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    heat = not cfg.chem.isothermal
    name = "chemistry" + ("_heat" if heat else "")
    n = s.ndens.shape[0]
    rates = ps.sweep_pyramid_source_batch(cfg.sweep, fields_of(s), srcpos,
                                          nflux)
    call = lambda: gp.chemistry_pass_cuda(cfg.chem, s, rates, dt)
    ref = chem_pass_with(cuda_build.load("chemistry"), "this", cfg.chem,
                         s, rates, dt)
    again = chem_pass_with(cuda_build.load("chemistry"), "this", cfg.chem,
                           s, rates, dt)
    same = torch.equal(ref[0], again[0]) and torch.equal(ref[1], again[1])
    lib, layout, block = stamped_chemistry()
    nit, nsub, cycles, blocks, sout = chem_split_run(
        lib, layout, cfg.chem, s, rates, dt)
    stamped_same = (torch.equal(sout[0], ref[0])
                    and torch.equal(sout[1], ref[1]))
    stats, lines = chem_split_stats(nit, nsub, cycles, heat)
    occ = achieved_occupancy(blocks, block)
    sass = kernel_sass(cuda_build.library_path("chemistry"))
    fname = next(k for k in sass
                 if re.search(rf"chemistry_kernelIfLb{int(heat)}E", k))
    # the thermal sub-step: the innermost loop that reads the cooling
    # table (through __ldg)
    mix = sass_loop_mix(sass[fname], "ex2", "ldg" if heat else None)
    b = chemistry_bound(n, heat, stats["iterations"], stats["substeps"], mix)
    log(f"{name} at {round(n ** (1 / 3))}^3 (phase {5 if heat else 4}'s "
        f"state): counters {ref[1].tolist()}; two calls equal to the bit: "
        f"{same}; the stamped copy's outputs equal: {stamped_same}; "
        f"achieved occupancy {occ:.3f}")
    for line in lines:
        log(f"  {line}")
    arith = chem_arithmetic(mix["loop"], mix["inner"])
    log(f"  SASS a pass of the fixed-point loop {mix['loop']}; a thermal "
        f"sub-step {mix['inner']}; arithmetic per iteration and per "
        f"sub-step {arith[0]} / {arith[1]} (the parent's "
        f"{chem_arithmetic(*PARENT_CHEM_MIX[heat])}); bound from the "
        f"counted work {b[0]:.4f} ms ({b[1]})")
    if not (same and stamped_same):
        raise AssertionError(f"{name}: two calls, or the stamped copy, "
                             f"differ")
    device_ms, how = kernel_ms(call, "chemistry_kernel")
    log(f"  kernel device ms ({how}) {device_ms:.4f}")
    extra = {"bound_ms": b[0], "bound_by": b[1], "device_ms": device_ms,
             "device_ms_from": how,
             "iterations_summed": stats["iterations"],
             "substeps_summed": stats["substeps"],
             "iteration_histogram": histogram(nit),
             "substep_histogram": histogram(nsub) if heat else None,
             "warp_efficiency_in_cell_order": stats["warp_efficiency"],
             "cycle_shares": stats["shares"], "achieved_occupancy": occ,
             "sass_per_iteration": mix["loop"],
             "sass_per_substep": mix["inner"],
             "arithmetic_per_iteration_and_substep": arith}
    if parent is not None:
        fns = {"this": call, "parent": lambda: chem_pass_with(
            parent["chemistry"], "8446144", cfg.chem, s, rates, dt)}
        pout = fns["parent"]()
        eq = torch.equal(pout[0], ref[0]) and torch.equal(pout[1], ref[1])
        t = in_turns(fns, "chemistry_kernel", 5)
        log(f"  in turns with the parent build (wrapper ms, kernel device "
            f"ms): " + ", ".join(f"{k} {a:.4f} / {d:.4f}" for k, v in
                                  t.items() for a, d in v)
            + f"; outputs and counters equal to the parent's: {eq}")
        if not eq:
            raise AssertionError(f"{name} differs from the parent's kernel")
        extra["parent_in_turns_ms"] = t
    return {name: extra}


def phase_ploss_redesign(cfg, s, srcpos, nflux, parent):
    """Phase 23, photon losses: at phase 8's state, float32, the band
    loop's SASS per band (sass_per_band of the 48-band instantiation: no
    shared-memory load, no division check, one MUFU.RCP), the kernel on
    the whole-row layout (the sweep's (n, 4) rates) and on a strided
    one against the plain version (rtol 1e-5), phiheat untouched, two
    calls equal to the bit; with the parent build, both timed in turns.
    Returns {"photon_losses": extra keys}."""
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import photon_losses as pls
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    f = fields_of(s)
    tables = cfg.sweep.tables
    vos = cfg.sweep.vol / cfg.sweep.flux_scale
    rates = ps.sweep_pyramid_source_batch(cfg.sweep, f, srcpos, nflux)
    sass = kernel_sass(cuda_build.library_path("photon_losses"))
    fns = [v for k, v in sass.items()
           if re.search(r"photon_losses_kernelIfLi6E", k)]
    if len(fns) != 1:
        raise AssertionError(f"{len(fns)} functions match the 48-band "
                             f"float32 photon-loss kernel")
    mix, per_pass = sass_per_band(fns[0])
    log(f"photon losses at phase 8's state: SASS per band (of {per_pass} "
        f"bands a pass) " + ", ".join(f"{k} {v:.2f}" for k, v in mix.items()
                                      if v))
    if not (mix["lds"] == 0 and mix["fchk"] == 0 and mix["rcp"] == 1):
        raise AssertionError(f"photon-loss band loop mix {mix}")
    z = lambda t: torch.zeros_like(t)
    whole = rates._replace(phih=z(rates.phih), phihe0=z(rates.phihe0),
                           phihe1=z(rates.phihe1))
    # the sweep's rate grid: one (n, 4) slab, the heat column kept
    slab = torch.stack([whole.phih, whole.phihe0, whole.phihe1,
                        rates.phiheat], dim=1)
    whole = whole._replace(phih=slab[:, 0], phihe0=slab[:, 1],
                           phihe1=slab[:, 2], phiheat=slab[:, 3])
    rows3 = torch.zeros((3, slab.shape[0]), dtype=slab.dtype,
                        device=slab.device)
    strided = whole._replace(phih=rows3[0], phihe0=rows3[1],
                             phihe1=rows3[2])
    p = _added(pls.distribute_photon_losses_plain(
        tables, _zero_ion_rates(rates), f, vos))
    heat0 = slab[:, 3].clone()
    k_whole = _added(pls.distribute_photon_losses_cuda(tables, whole, f, vos))
    k_strided = _added(pls.distribute_photon_losses_cuda(tables, strided, f,
                                                         vos))
    again = _added(pls.distribute_photon_losses_cuda(
        tables, _zero_ion_rates(rates), f, vos))
    once = _added(pls.distribute_photon_losses_cuda(
        tables, _zero_ion_rates(rates), f, vos))
    for k, what in ((k_whole, "whole rows"), (k_strided, "strided rows")):
        torch.testing.assert_close(k, p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()),
                                   msg=f"photon losses, {what}")
    ok = (torch.equal(slab[:, 3], heat0) and torch.equal(again, once)
          and torch.equal(k_whole, k_strided))
    log(f"  whole-row and strided layouts against the plain version: max "
        f"|kernel - plain| {float((k_whole - p).abs().max()):.3e} / "
        f"{float((k_strided - p).abs().max()):.3e}; the two layouts equal, "
        f"phiheat untouched and two calls equal to the bit: {ok}")
    if not ok:
        raise AssertionError("photon losses: layouts, phiheat or two calls "
                             "differ")
    device_ms, how = kernel_ms(lambda: pls.distribute_photon_losses_cuda(
        tables, rates, f, vos), "photon_losses_kernel")
    log(f"  kernel device ms ({how}) {device_ms:.4f}")
    extra = {"sass_per_band_and_cell": mix, "device_ms": device_ms,
             "device_ms_from": how}
    if parent is not None:
        fns = {"this": lambda: pls.distribute_photon_losses_cuda(
                   tables, rates, f, vos),
               "parent": lambda: parent_photon_losses(
                   parent["photon_losses"], tables, rates, f, vos)}
        t = in_turns(fns, "photon_losses_kernel", 20)
        log(f"  in turns with the parent build (wrapper ms, kernel device "
            f"ms): " + ", ".join(f"{k} {a:.4f} / {d:.4f}" for k, v in
                                  t.items() for a, d in v))
        extra["parent_in_turns_ms"] = t
    return {"photon_losses": extra}


# ---- the multi-GPU slice (phases 18-21)

# the slab shapes of the halo kernels' comparisons, (mesh, ranks,
# radius): D = 8 at 32^3 and radius 5 (S = 4, H = 6: several hops), the
# main path's at world size 1: D = 1 at 128^3, full radius (S = 128,
# H = 64), and 18^3 radius 1 (H = 2: a float32 pack row of 22 x 5
# values, 440 bytes, is not 16-byte aligned)
HALO_SHAPES = ((32, 8, 5), (128, 1, 64), (18, 1, 1))


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


def phase_group_sum(dev, S=8, reps=20):
    """Phase 30: the group sum kernel (`accumulate_group_cuda`,
    ``csrc/group_accumulate.cu``) against its plain version, torch's
    masked sum and add (`accumulate_group_plain`), at the main path's
    128^3 x 8 and the benchmark's 250^3 x 8, float32 and (250^3)
    float64: uniform [0, 1) slabs added into uniform grids, sources 2
    and 5 dropped, source 5's slab NaN (a dropped slab is never read).
    The kernel equals the sum in source order to the bit and lies
    within 4 S roundings of the masked sum (torch's order).  Then,
    every source live, the kernel's and the plain version's device
    times (CUDA events, mean of `reps` after a warm-up) and the bound:
    the S slabs read once and the grids read and written once, (S + 2)
    M^3 16-byte rows at 3.35 TB/s.  Returns {(mesh, dtype): (ms,
    plain_ms, bound, largest absolute and relative difference from the
    masked sum)}."""
    from c2ray_tpu_torch.sweep import pyramid_sweep as ps

    out = {}
    for M, dtype in ((128, torch.float32), (250, torch.float32),
                     (250, torch.float64)):
        what = f"group sum at {M}^3 x {S} {str(dtype)[6:]}"
        g = torch.Generator(device=dev).manual_seed(M)
        slab = torch.rand((S, M**3, 4), generator=g, dtype=dtype,
                          device=dev)
        rg = torch.rand((M**3, 4), generator=g, dtype=dtype, device=dev)
        live = torch.ones(S, dtype=torch.bool, device=dev)
        live[[2, 5]] = False
        slab[5] = float("nan")
        acc = torch.zeros_like(rg)
        for i in range(S):
            acc = acc + torch.where(live[i], slab[i], 0.0)
        in_order = rg + acc
        masked = ps.accumulate_group_plain(rg, slab, live)
        got = ps.accumulate_group_cuda(rg.clone(), slab, live)
        if not torch.equal(got, in_order):
            raise AssertionError(f"{what}: not the sum in source order")
        torch.testing.assert_close(
            got, masked, rtol=4 * S * torch.finfo(dtype).eps, atol=0.0,
            msg=f"{what} vs the masked sum")
        abs_err = float((got - masked).abs().max())
        rel = float(((got - masked).abs() / masked.abs()).max())
        del acc, in_order, masked, got
        slab[5] = torch.rand((M**3, 4), generator=g, dtype=dtype,
                             device=dev)
        live[:] = True
        ms = event_ms(lambda: ps.accumulate_group_cuda(rg, slab, live), reps)
        plain_ms = event_ms(lambda: ps.accumulate_group_plain(rg, slab, live),
                            reps)
        nbytes = (S + 2) * M**3 * 4 * slab.element_size()
        b = bound(nbytes, S * M**3 * 4, 0)
        log(f"{what}: kernel {ms:.4f} ms ({nbytes / ms * 1e-6:.1f} GB/s), "
            f"plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); equal "
            f"to the sum in source order, {rel:.3e} relative "
            f"({abs_err:.3e} absolute) from the masked sum")
        out[M, dtype] = (ms, plain_ms, b, abs_err, rel)
        del slab, rg
    return out


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
    mine = {"single": ("pyramid_sweep" + sfx, "chemistry" + sfx,
                       "group_accumulate"),
            "source": ("pyramid_sweep" + sfx, "chemistry" + sfx,
                       "group_accumulate"),
            "domain": ("pyramid_sweep" + sfx, "chemistry" + sfx, "halo_pack",
                       "window_accumulate", "fold_halo")}
    first, spi, halo_counts = {}, {k: [] for k in modes}, {}
    for mode in ("single", "domain", "source", "source", "domain", "single"):
        it, s, sp, nf = modes[mode]
        clocks.reset()
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
    clocks.reset()
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
    clocks.reset()
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
        out[name] = (ms, plain_ms, err, b, lib_ms, nbytes / ms / 1e6)
        log(f"{name} at {M}^3, world size 1, radius {radius} float32: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms"
            + ("" if lib_ms is None else f", rc[window].add_ {lib_ms:.4f} ms")
            + f", bound {b[0]:.4f} ms ({b[1]}, {nbytes / 1e6:.1f} MB): "
            f"{nbytes / ms / 1e6:.1f} GB/s, {b[0] / ms:.1%} of the bound; "
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
    "auto": (1, True, True, "auto", 10.0),
    "auto heating": (1, False, True, "auto", 1.0),
}
# the kernel variant each runs, the name of its `kernels` entry
ONED_KERNEL = {"quadrature": "evolve1d", "quadrature heating": "evolve1d_heat",
               "table": "evolve1d_table",
               "table heating": "evolve1d_table_heat",
               "monochromatic": "evolve1d", "test 4": "evolve1d",
               "auto": "evolve1d_auto", "auto heating": "evolve1d_auto_heat"}
# phase 12's runs and phase 14's: (kernels entry, isothermal, quadrature)
ONED_MAIN = (("evolve1d", True, True), ("evolve1d_heat", False, True),
             ("evolve1d_table", True, False))
# phase 26's runs: (kernels entry, isothermal) on "auto" tables
ONED_AUTO = (("evolve1d_auto", True), ("evolve1d_auto_heat", False))
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
    """A `OneDRun` of a test problem on `device`; `mono`: True for the
    13.6 eV monochromatic tables (one band, K = 1, a zero HeI mask),
    "auto" for the "auto" quadrature blocks (a 1e5 K blackbody: 7 blocks
    of K = 12, 3, 4, 3, 5, 8, 8)."""
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.grid import RadialGrid
    from c2ray_tpu_torch.onedim.driver import OneDRun
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.radiation.monochromatic import \
        build_monochromatic_tables
    from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables

    problem, r_out, S_star = oned_problem(testnum, isothermal)
    sed = SEDConfig(bb=BlackBodySED(T_eff=1.0e5, S_star=S_star))
    run = OneDRun.setup(problem, RadialGrid(0.0, r_out * const.kpc, mesh),
                        sed, dtype=dtype, use_quadrature=quadrature,
                        device=device)
    if mono:
        qt, _, bands = (build_quadrature_tables(
            sed, isothermal=isothermal, dtype=dtype, device=device,
            n_nodes="auto") if mono == "auto" else build_monochromatic_tables(
            sed, 13.6, isothermal=isothermal, dtype=dtype, device=device))
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, iso, quad in ONED_MAIN:
        run = oned_run(1, mesh, torch.float32, dev, iso, quad)
        clocks.reset()
        walls, hosts, counters, capped, event_ms = [], [], [], [], []
        for _ in range(n_steps):
            before = run.state
            # the host's share: the time until step() returns (the launch
            # is asynchronous; the first step also packs the tables)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            nits = run.step(dt)
            end.record()
            hosts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            event_ms.append(start.elapsed_time(end))
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
                     "front": fc, "walls": walls, "event_ms": event_ms,
                     "counters": counters,
                     "host_share": sum(hosts) / sum(walls)}
    return out


def phase_auto_1d(dev, compare, plibs=None, mesh=ONED_FULL_MESH):
    """Phase 26: the 1D kernel on "auto" quadrature tables at full
    width: one test-1 10 Myr step at 10000 shells in float32 through
    `OneDRun`, isothermal and heating (CUDA events around the step, the
    tables packed before it), each launching its variant once and no
    other kernel and leaving a finite state of the right shape that has
    begun to ionize.  With a parent build (`plibs`) the same step from
    the same state then runs with the parent's library and with this
    build's in turns (parent, this, this, parent;
    kernel_study.parent_evolve1d: the parent's entries on its block
    list), their fractions compared.  Returns the two entries of the
    kernels line, with phase 11's mesh-128 comparison (kernel against
    plain, float64 and float32)."""
    from c2ray_tpu_torch.onedim import evolve as ev1

    out = []
    floors = oned_issue_floors()
    dt = 10.0 * MYR
    for name, iso in ONED_AUTO:
        run = oned_run(1, mesh, torch.float32, dev, iso, True, "auto")
        ev1._kernel_tables(run.ctx, torch.float32, dev)
        before = run.state
        clocks.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        nits = run.step(dt)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        counts = launch_counts()
        check_launches(f"1D {name}", counts, (name,))
        counters = run.last_counters.tolist()
        for t in run.state:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"1D {name} produced non-finite state")
        if (run.state.xh.shape != (mesh, 2)
                or not float(run.state.xh[0, 1]) > 0.5):
            raise AssertionError(f"1D {name}: wrong shape or no ionization")
        b = oned_bound(run.ctx, counters, not iso, False, floors)
        worst, kp_abs, k128, p128 = compare["auto" if iso else "auto heating"]
        turns = None
        if plibs is not None:
            turns = {}
            mine = lambda: ev1.evolve1d_cuda(run.ctx, before, dt)
            theirs = lambda: parent_evolve1d(plibs["evolve1d"], run.ctx,
                                             before, dt)
            parent_oned_tables(run.ctx, torch.float32, dev)
            for key in ("parent", "this", "this", "parent"):
                turns.setdefault(key, []).append(
                    event_ms(theirs if key == "parent" else mine, 1))
            diff = max(float((a - b).abs().max()) for a, b in zip(
                mine()[0][2:], theirs()[0][2:]))
            log(f"  1D {name}, one step at mesh {mesh} in turns with the "
                f"parent build (ms): parent {turns['parent'][0]:.3f} / "
                f"{turns['parent'][1]:.3f}, this {turns['this'][0]:.3f} / "
                f"{turns['this'][1]:.3f}; this/parent "
                f"{turns_ratio(turns):.4f}; fractions differ by at most "
                f"{diff:.3e}")
        blocks, (nodes, rows, slots) = oned_block_rows(run.ctx)
        its = counters[0]
        log(f"1D {name} (test 1, mesh {mesh}, float32, one 10 Myr step): "
            f"{ms:.3f} ms, {its} iterations ({1e3 * ms / its:.4f} us each), "
            f"{counters[3]} thermal sub-steps, largest of a shell "
            f"{counters[1]}, shells at the cap "
            f"{int((nits == run.ctx.max_cell_iter).sum())}; blocks (K, "
            f"bands, live lanes of the parent's passes) {blocks}, dealt as "
            f"{rows} rows of {ev1.ROW_NODES} nodes ({nodes} nodes) in "
            f"{slots} slots; bound {b[0]:.3f} ms ({b[2]}); at mesh 128 "
            f"kernel {k128:.3f} ms, plain (CPU) {p128:.1f} ms")
        out.append({
            "name": name, "route": "cuda",
            "source": "c2ray_tpu_torch/csrc/evolve1d.cu",
            "replaces": "c2ray_tpu/radiation/quadrature.py:486",
            "launches": counts[name], "max_abs_err": kp_abs,
            "max_abs_err_of": "float32 kernel vs plain, mesh 128, 2 steps "
                              "(phase 11; float64 within rtol 1e-10 there)",
            "max_err_f32_vs_f64_mesh128": worst,
            "ms": ms, "plain_ms": p128,
            "plain_shape": "mesh 128, one float32 step, on the CPU",
            "us_per_iteration": 1e3 * ms / its,
            "substeps_per_iteration": counters[3] / its,
            "parent_in_turns_ms": turns,
            "bound_ms": b[0], "bound_by": b[1], "bound_detail": b[2],
            "counters": counters, "library_ms": None})
    return out


def phase_oned_in_turns(main, plibs, same):
    """Phase 26, the 1D fixed rule against the parent build: when a
    parent function of csrc/evolve1d.cu compiles to other SASS here, the
    three kernel variants of phase 12 (quadrature isothermal and heating,
    tau tables) each run one step on phase 12's final state with the
    parent's library and with this build's, in turns (parent, this,
    this, parent; CUDA events), their outputs compared; the "auto"
    blocks are to leave them within +-1%.  Returns {name: times}, or
    None (no parent, or the SASS equal)."""
    from c2ray_tpu_torch.onedim import evolve as ev1

    if plibs is None or same["evolve1d"][0] == same["evolve1d"][1]:
        log("  the 1D kernel's parent functions: "
            + ("no parent build" if plibs is None else "SASS equal")
            + "; no timing in turns")
        return None
    out = {}
    for name, _, _ in ONED_MAIN:
        run, dt = main[name]["run"], main[name]["dt"]
        call = lambda: ev1.evolve1d_cuda(run.ctx, run.state, dt)
        mine = call()
        theirs = with_library("evolve1d", plibs["evolve1d"], call)
        equal = all(torch.equal(a, b) for a, b in zip(mine[0], theirs[0]))
        t = {}
        for key in ("parent", "this", "this", "parent"):
            fn = ((lambda: with_library("evolve1d", plibs["evolve1d"], call))
                  if key == "parent" else call)
            t.setdefault(key, []).append(event_ms(fn, 1))
        out[name] = t
        log(f"  1D {name}, one step at mesh {run.ctx.vol.shape[0]} in turns "
            f"with the parent build (ms): parent {t['parent'][0]:.3f} / "
            f"{t['parent'][1]:.3f}, this {t['this'][0]:.3f} / "
            f"{t['this'][1]:.3f}; this/parent {turns_ratio(t):.4f}; "
            f"states equal to the bit: {equal}")
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


# phase 27's problem: tests/test_1d3d_crosscheck.py's (uniform n = 1e-3,
# one 1e5 K blackbody, 1 kpc cells, isothermal, the 6-node rule) at the
# bench's width, 128^3 and 4 x 128 = 512 shells out to 128 kpc;
# S_star 2e51 photons/s puts the Stroemgren radius near 40 kpc, and after
# 6 x 10 Myr (t ~ t_rec / 2) the front near 0.75 of it, ~30 cells, well
# inside the box's half width of 64
CROSSCHECK_MESH = 128
CROSSCHECK_S_STAR = 2.0e51
CROSSCHECK_STEPS = 6
CROSSCHECK_KERNELS = ("pyramid_sweep", "chemistry", "evolve1d",
                      "group_accumulate")


def phase_crosscheck(dev, M=CROSSCHECK_MESH, S_star=CROSSCHECK_S_STAR,
                     n_steps=CROSSCHECK_STEPS):
    """Phase 27: the 1D/3D cross-check of tests/test_1d3d_crosscheck.py
    in float32 on the card through the public entry points: `OneDRun`
    (4M shells out to M dr) and `evolve3d` (one source at the centre of
    an M^3 grid), n_steps x 10 Myr each.  The 3D front, from the ionized
    volume summed in float64 on the host, within one cell of the 1D
    front (`numerical_front`); the on-axis 3D ionized fraction within
    0.15 of the 1D profile at 1/4, 1/2 and 3/4 of the 1D front.  The
    pyramid, chemistry and 1D kernels must have run it, no other kernel
    and no plain version.  Returns their launches."""
    from c2ray_tpu_torch import constants as const
    from c2ray_tpu_torch.grid import RadialGrid
    from c2ray_tpu_torch.onedim import OneDProblem, numerical_front
    from c2ray_tpu_torch.onedim.driver import OneDRun
    from c2ray_tpu_torch.onedim.evolve import MAX_CELL_ITER
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
    from c2ray_tpu_torch.state import initial_grid_state
    from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                       SweepConfig, build_shell_table,
                                       evolve3d)

    dens, dr, dt = 1.0e-3, const.kpc, 10.0 * MYR
    sed = SEDConfig(bb=BlackBodySED(T_eff=1.0e5, S_star=S_star))
    t0 = time.perf_counter()
    clocks.reset()
    problem = OneDProblem(testnum=1, dens_val=dens, temper_val=1e4,
                          isothermal=True)
    rgrid = RadialGrid(r_in=0.0, r_out=M * dr, mesh=4 * M)
    run1d = OneDRun.setup(problem, rgrid, sed, dtype=torch.float32,
                          device=dev)
    its, capped = [], []
    for _ in range(n_steps):
        nits = run1d.step(dt)
        its.append(int(run1d.last_counters[0]))
        capped.append(int((nits >= MAX_CELL_ITER).sum()))
    xh1 = run1d.state.xh[:, 1].double().cpu().numpy()
    front_1d = numerical_front(rgrid.x, rgrid.dr, xh1)
    wall_1d = time.perf_counter() - t0

    t1 = time.perf_counter()
    tables, _, bands = build_quadrature_tables(
        sed, isothermal=True, dtype=torch.float32, device=dev)
    cfg = Evolve3DConfig(
        sweep=SweepConfig(tables=tables, mesh=M, dr=dr, isothermal=True,
                          flux_scale=bands.flux_scale),
        chem=ChemistryConfig(isothermal=True, isothermal_temperature=1.0e4),
        shells=build_shell_table(M))
    state = initial_grid_state(np.full((M,) * 3, dens), 0.0, 0.0, 0.0,
                               1.0e4, dtype=torch.float32, device=dev)
    srcpos = torch.tensor([[M // 2] * 3], device=dev)
    nflux = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float32, device=dev)
    steps = []
    for _ in range(n_steps):
        state, stats = evolve3d(cfg, state, srcpos, nflux, dt)
        steps.append((stats.n_iterations, stats.subbox_radius,
                      stats.conv_flag))
    h1 = state.h1.double().cpu().numpy().reshape(M, M, M)
    wall_3d = time.perf_counter() - t1
    counts = launch_counts()

    front_3d = (3.0 * h1.sum() * dr**3 / (4.0 * np.pi)) ** (1.0 / 3.0)
    log(f"1D/3D cross-check {M}^3 / {4 * M} shells float32, S_star "
        f"{S_star:.3e}, {n_steps} x 10 Myr: 1D front {front_1d / dr:.5f} "
        f"cells, 3D front {front_3d / dr:.5f} cells (difference "
        f"{(front_3d - front_1d) / dr:+.5f})")
    log(f"  3D steps (iterations, subbox radius, conv_flag): {steps}")
    log(f"  1D summed iterations per step {its}; shells at the "
        f"{MAX_CELL_ITER} cap per step {capped}")
    log(f"  walls: 1D {wall_1d:.3f} s, 3D {wall_3d:.3f} s, phase "
        f"{time.perf_counter() - t0:.3f} s")
    check_launches("1D/3D cross-check", counts, CROSSCHECK_KERNELS)
    if not (np.isfinite(h1).all() and np.isfinite(xh1).all()
            and h1.shape == (M,) * 3 and xh1.shape == (4 * M,)):
        raise AssertionError("1D/3D cross-check state is not finite or has "
                             "the wrong shape")
    if not 0.0 < front_1d < 0.5 * M * dr:
        raise AssertionError(f"1D front {front_1d / dr} cells outside "
                             f"(0, {M // 2})")
    if abs(front_3d - front_1d) >= dr:
        raise AssertionError(f"3D front {front_3d / dr} and 1D front "
                             f"{front_1d / dr} cells more than a cell apart")
    prof_3d = h1[M // 2, M // 2, M // 2:]
    for frac in (0.25, 0.5, 0.75):
        k = int(round(frac * front_1d / dr))
        i1 = int(np.argmin(np.abs(np.asarray(rgrid.x) - k * dr)))
        log(f"  profile at {frac} of the front (cell {k}): 3D "
            f"{prof_3d[k]:.6f}, 1D {xh1[i1]:.6f}")
        if abs(prof_3d[k] - xh1[i1]) >= 0.15:
            raise AssertionError(f"on-axis profile at cell {k}: 3D "
                                 f"{prof_3d[k]} vs 1D {xh1[i1]}")
    return {k: counts[k] for k in CROSSCHECK_KERNELS}


TABLE_WRITE_MODES = (("heating", ()), ("isothermal", ("--isothermal",)),
                     ("quadrature", ("--quadrature",)))


def phase_table_write(workdir):
    """Phase 28: tools/table_write_torch.py with --device cuda against
    --device cpu, in its three modes: the same files, byte for byte."""
    import table_write_torch

    for mode, extra in TABLE_WRITE_MODES:
        dirs = {d: os.path.join(workdir, f"tables_{mode}_{d}")
                for d in ("cuda", "cpu")}
        for d, path in dirs.items():
            with contextlib.redirect_stdout(io.StringIO()):
                table_write_torch.main([path, *extra, "--device", d])
        names = sorted(os.listdir(dirs["cpu"]))
        if not names or sorted(os.listdir(dirs["cuda"])) != names:
            raise AssertionError(f"table_write {mode}: files differ")
        for n in names:
            a = pathlib.Path(dirs["cuda"], n).read_bytes()
            if a != pathlib.Path(dirs["cpu"], n).read_bytes():
                raise AssertionError(f"table_write {mode}: {n} differs "
                                     f"between cuda and cpu")
        log(f"table_write {mode}: cuda and cpu dumps equal byte for byte "
            f"({', '.join(names)})")


def phase_bench_scaling(mesh=128, src=8):
    """Phase 29: tools/bench_scaling_torch.py at world size 1 over NCCL
    (a spawned rank on the card) in both parallel modes; logs its JSON
    line."""
    import bench_scaling_torch

    for mode in ("source", "domain"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = bench_scaling_torch.main(
                ["--mesh", str(mesh), "--src-per-device", str(src),
                 "--devices", "1", "--mode", mode, "--device", "cuda"])
        line = buf.getvalue().strip().splitlines()[-1]
        log(f"bench_scaling {mode}: {line}")
        d = out["detail"]["1"]
        if (json.loads(line) != out or out["metric"] !=
                f"weak_scaling_efficiency_{mode}_isothermal_1dev_mesh{mesh}"
                or not all(math.isfinite(v) and v > 0 for v in d.values())):
            raise AssertionError(f"bench_scaling {mode}: {line}")


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
# before. A division counts 6, the cheaper of the two sequences the
# kernel's builds have used: the compiler's (MUFU.RCP and the 5 FFMA of
# the IEEE refinement, behind a branch that serialized every division
# of a lone warp) and div_flat's (12: the conversion to double,
# MUFU.RCP64H, eight dependent DFMA/DMUL, the select and the conversion
# back). An exponential 6, a square root 5, expm1 and log10 12 each,
# pow 25; a shuffle, a select, a conversion and a load 1. Independent
# work counts once: a lane's K nodes, the three species' divisions, the
# X/Y/Z divisions, the shell's 1/vol. The shell's incoming side (once
# per shell) is not on the chain: its exponentials and table reads can
# run beside the outgoing ones. Isothermal, quadrature (from the start
# of an iteration): the outgoing rates of a lane's two bands 29
# (columns 4, tau_out 3, min and exp 8, e_in - e_out and the node sum 7,
# the thick/thin branch 2, x 1/vol and the sums 5); the warp sums 10 (5
# shuffles and adds); the per-atom rates 7; the first doric pass 53
# (the ionization sums 4, the helium sector's divisions 6, the matrix
# terms 6, the square root 6, the root identity 10, r2 and X2's
# divisions 18, the solution and the clamps 10, and the shuffle that
# gathers the exponentials the lanes spread -- its doric factors come
# from the previous iteration); the second 56 (its electron density and
# the same chain); the average, the 1% test and the loop branch 13:
# 168. On the table route the outgoing rates of a lane's bands, the
# position (log10 and a division) and the reads, take 47: 186. Heating
# adds 40 (the spread fits: a division, two pows in sequence with the
# shuffle between them, the gathering shuffle, gating the heating sums;
# the thermal call's set-up and end; the temperature test; 27 on the
# table route, where the fits run beside the position's log10) and 52
# per thermal sub-step (coolin's log10, division, read and 5-term sum,
# the step size's division, the update and pressr2temper's division).
# Each instruction waits at least 4 cycles, the dependent-issue latency
# of the float32 pipe; MUFU, double, shuffles and loads wait longer, so
# this stays a lower bound. At the card's largest clock.
ONED_CHAIN = {(False, False): 168, (False, True): 186,
              (True, False): 208, (True, True): 213}
ONED_CHAIN_SUBSTEP = 52
# The issue floors of the kernel before its redesign: sass_issue_floor
# per fixed-point iteration, (heat, table, kK) as in oned_issue_floors
# (tools/profile_torch_iteration.py --oned [--auto] --parent); the fixed
# rule and the tau tables of commit a26c0a1, the "auto" blocks (kK = -2)
# of commit e7dcd29 (the block loop counted once).  oned_bound takes the
# smaller of these and this build's floor: both builds compute the same
# function, so the fewer instructions bound it.
PARENT_ONED_FLOORS = {(False, False, 6): 1111, (True, False, 6): 1861,
                      (False, True, 0): 1115, (True, True, 0): 1888,
                      (False, False, -2): 1481, (True, False, -2): 2207}
CYCLES_PER_DEPENDENT_OP = 4
SM_CLOCK_HZ = 1.98e9


def unrolled_k(K):
    """The node count of the kernel instantiation that a K-node table
    runs: K where the kernels unroll it (band_rates.cuh: with_nodes),
    else 0 (the runtime-K loop)."""
    return K if K in (6, 8) else 0


def oned_issue_floors(path=None):
    """sass_issue_floor of each float32 evolve1d_kernel instantiation of
    the library at `path` (default: this run's build): {(heat, table,
    kK): instructions}, kK the unrolled node count (0: at run time; -2
    the "auto" blocks, csrc/table_rates.cuh: kBlockRoute)."""
    from c2ray_tpu_torch import cuda_build

    floors = {}
    for name, fn in kernel_sass(
            path or cuda_build.library_path("evolve1d")).items():
        m = re.match(r"\S*evolve1d_kernelIfLb([01])ELb([01])ELi(n?\d+)E",
                     name)
        if m:
            floors[m.group(1) == "1", m.group(2) == "1",
                   int(m.group(3).replace("n", "-"))] = sass_issue_floor(fn)
    return floors


def oned_bound(ctx, counters, heat, table, floors):
    """(bound_ms, bound_by, which) of one float32 1D timestep with these
    counters (this step's summed iterations and thermal sub-steps): the
    largest of (a) `bound` on the work done -- the state read and written
    once, per iteration the exponentials of every live band's K nodes
    (quadrature) or two logarithms and 4-10 table reads per band (tables)
    and CHEM_SFU_PER_ITERATION, per sub-step a logarithm and 20 flops --,
    (b) the latency of the iterations' dependent chains (ONED_CHAIN) and
    (c) one warp's issue floor at one instruction a cycle: per
    iteration the fewer of `floors` (this build's) and
    PARENT_ONED_FLOORS (the same function built before the redesign);
    "auto" tables (blocks of several K) count every block's nodes, not
    the zero nodes that the kernel's row deal pads them with."""
    from c2ray_tpu_torch.radiation.quadrature import (packed_band_blocks,
                                                      packed_band_rows)

    its, subs = int(counters[0]), int(counters[3])
    mesh = ctx.vol.shape[0]
    flags = (ctx.has_bb, ctx.has_pl, ctx.has_qso)
    blocks = (None if table else
              packed_band_blocks(ctx.tables, torch.float32, heat, *flags)[1])
    if table:
        nb = ctx.tables.sigma_HI.shape[0]
        sfu_it, flops_it = 2 * nb, nb * (60 if heat else 20)
        kk = 0
    elif len({b[3] for b in blocks}) > 1:
        nodes = sum(b[2] * b[3] for b in blocks)
        sfu_it, flops_it = 2 * nodes, nodes * (25 if heat else 10)
        kk = -2
    else:
        packed, _, K = packed_band_rows(ctx.tables, torch.float32, heat,
                                        ctx.has_bb, ctx.has_pl, ctx.has_qso)
        nodes = packed.shape[0] * K
        sfu_it, flops_it = 2 * nodes, nodes * (25 if heat else 10)
        kk = unrolled_k(K)
    nbytes = 4 * mesh * (7 + 6) + 4 * mesh
    work = bound(nbytes, its * (flops_it + CHEM_FLOPS_PER_ITERATION)
                 + subs * 20,
                 its * (sfu_it + CHEM_SFU_PER_ITERATION) + subs)
    cycles = CYCLES_PER_DEPENDENT_OP * (its * ONED_CHAIN[heat, table]
                                        + subs * ONED_CHAIN_SUBSTEP)
    lat_ms = 1e3 * cycles / SM_CLOCK_HZ
    floor = min(floors.get((heat, table, kk), math.inf),
                PARENT_ONED_FLOORS.get((heat, table, kk), math.inf))
    issue_ms = 1e3 * its * floor / SM_CLOCK_HZ if floor < math.inf else 0.0
    return max((work[0], work[1], "throughput"),
               (lat_ms, "operations", "latency of the dependent chain"),
               (issue_ms, "operations", "one warp's instruction issue"))


def phase_oned_times(main, compare, full):
    """The 1D kernels' times at mesh 10000 (phase 12's last step: CUDA
    events around `OneDRun.step`, whose one launch is the step's device
    work, and that step's counters) beside their bounds, per fixed-point
    iteration and thermal sub-steps per iteration too, and the float64
    step wall of phase 14's one step (`full`); the plain version's step
    wall from phase 11 (mesh 128, on the CPU)."""
    floors = oned_issue_floors()
    log("issue floors, SASS instructions per fixed-point iteration (this "
        "build; the parent build's, a26c0a1, in parentheses; the bound "
        "takes the smaller): " + ", ".join(
            f"{k}: {v} ({PARENT_ONED_FLOORS.get(k, 'not measured')})"
            for k, v in sorted(floors.items())))
    rows = {}
    for name, variant, heat, table in (
            ("evolve1d", "quadrature", False, False),
            ("evolve1d_heat", "quadrature heating", True, False),
            ("evolve1d_table", "table", False, True)):
        run = main[name]["run"]
        ms, counters = main[name]["event_ms"][-1], main[name]["counters"][-1]
        b = oned_bound(run.ctx, counters, heat, table, floors)
        worst, kp_abs, k128, p128 = compare[variant]
        its, subs = counters[0], counters[3]
        log(f"{name} at mesh {run.ctx.vol.shape[0]}: {ms:.3f} ms per step "
            f"({its} iterations, {subs} thermal sub-steps): "
            f"{1e3 * ms / its:.4f} us per iteration, {subs / its:.3f} "
            f"sub-steps per iteration; bound {b[0]:.3f} ms ({b[2]}); "
            f"float64 one step from the initial state (phase 14) "
            f"{full[name][2]:.3f} ms; at mesh 128 kernel {k128:.3f} ms, "
            f"plain (CPU) {p128:.1f} ms")
        rows[name] = (ms, b, worst, kp_abs, k128, p128, counters)
    return rows



def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from c2ray_tpu_torch import cuda_build

    t0 = time.perf_counter()
    names = ("pyramid_sweep", "chemistry", "photon_losses", "evolve1d",
             "shell_sweep", "octant_sweep", "domain_halo")
    def timed_load(name):
        t = time.perf_counter()
        cuda_build.load(name)
        return name, time.perf_counter() - t

    with ThreadPoolExecutor(len(names)) as pool:
        seconds = dict(pool.map(timed_load, names))
    # ptxas -v per kernel: registers, stack and spills
    for name in names:
        kernel = ""
        for line in cuda_build.build_log(name).splitlines():
            m = re.search(r"Compiling entry .*?(stage_kernel(?:_capped)?"
                          r"|source_cell_kernel|chemistry_kernel"
                          r"|photon_losses_kernel|evolve1d_kernel"
                          r"|shell_kernel(?:_capped)?"
                          r"|plane_kernel(?:_capped)?|halo_pack_kernel"
                          r"|window_accumulate_kernel|fold_halo_kernel)"
                          r"I([fd])(?:Lb([01])E)?"
                          r"(?:Lb([01])E)?(?:Li(n?\d+)E)?(?:Li(\d+)E)?",
                          line)
            if m:
                dtype = "float" if m.group(2) == "f" else "double"
                heat = ", heat" if m.group(3) == "1" else ""
                flag = ("table" if m.group(1).startswith("evolve1d")
                        else "track")
                second = f", {flag}" if m.group(4) == "1" else ""
                nodes = ("" if m.group(5) is None else
                         f", C = {m.group(5)}"
                         if m.group(1) == "halo_pack_kernel" else
                         ", tau tables" if m.group(5) == "n1" else
                         ", auto blocks" if m.group(5) == "n2" else
                         f", K = {m.group(5)}" if m.group(5) != "0"
                         else ", K at run time")
                lanes = ("" if m.group(6) is None
                         else f", {m.group(6)} lanes")
                kernel = (f"{m.group(1)}<{dtype}{heat}{second}{nodes}"
                          f"{lanes}>")
            elif kernel and ("registers" in line or "spill" in line):
                log(f"  {name}.cu {kernel}: {line.split(':', 1)[-1].strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{n}.cu {seconds[n]:.1f} s" for n in names) + ")")


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
    """Phases 2-30; returns the entries of the `kernels` line.  Phase
    14's CPU runs start, into `oned_refs`, once the 3D main paths
    (phases 4, 5, 8 and 16) have been timed, so that they do not share
    the host with those timings."""
    def phase(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[phase {label}: {time.perf_counter() - t0:.1f} s]")
        return out

    procs = start_parent_build()      # the parent's nvcc beside phase 2's
    phase("build", build_kernels)                                   # 2.
    # phase 23's and 25's libraries, loaded before torch.profiler's first
    # window (phase 22): the profiler showed no launch from a library
    # loaded after it
    parent, same, plibs = phase("parent build", parent_libraries, procs)
    psweeps = (None if plibs is None
               else {n: plibs[n] for n in PARENT_SWEEPS})
    phase("stamped chemistry build", stamped_chemistry)
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
    route_err = phase("compare tau-table and auto routes",           # 24.
                      phase_compare_routes, dev)
    # the "auto" blocks on the shell and octant engines (phase 24 holds
    # them to plain at 32^3 / 33^3) only in turns with a parent build
    route_main = [phase(f"{route} route, {engine} engine"            # 25.
                        f"{' heating' if heating else ''} main path",
                        phase_main_route, dev, route, engine, heating,
                        psweeps=psweeps)
                  for route in ("tau", "auto")
                  for engine in ("pyramid", "shells", "octant")
                  for heating in (False, True)
                  if route == "tau" or engine == "pyramid" or psweeps]
    for c, st in ((cfg, s), (hcfg, hs)):
        phase(f"fixed rule in turns{'' if c.chem.isothermal else ' heating'}",
              phase_fixed_rule_in_turns, c, st, srcpos, nflux, psweeps)
    phase("compare halo kernels", phase_compare_halo, dev)            # 18.
    nccl = phase("NCCL", phase_nccl, dev, workdir)                   # 19.
    par_counts = [phase(f"parallel{' heating' if heating else ''} main "
                        "path", phase_parallel_main, dev, heating=heating)
                  for heating in (False, True)]                     # 20.
    oned_refs.update(start_oned_references(workdir))                # 14.
    # the 1D program while phase 9's CPU reference runs
    compare_1d = phase("1D compare", phase_compare_1d, dev)          # 11.
    main_1d = phase("1D main path", phase_main_1d, dev)              # 12.
    auto_1d = phase("1D auto blocks", phase_auto_1d, dev, compare_1d,  # 26.
                    plibs)
    phase("1D fixed rule in turns", phase_oned_in_turns, main_1d, plibs,
          same)
    phase("1D physics", phase_physics_1d, dev, main_1d)              # 13.
    cross = phase("1D/3D cross-check", phase_crosscheck, dev)        # 27.
    phase("table_write on the card", phase_table_write, workdir)     # 28.
    phase("bench_scaling at world size 1", phase_bench_scaling)      # 29.
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
    oned_t = phase("1D kernel times", phase_oned_times, main_1d, compare_1d,
                   full_1d)
    eng_t = {key: phase(f"{key[0]} engine{' heating' if key[1] else ''} "
                        "kernel times", phase_engine_times, *out[:4], key[0])
             for key, out in eng.items()}
    halo_t = phase("halo kernel times", phase_halo_times, dev)
    group_t = phase("group sum", phase_group_sum, dev)               # 30.
    redesign = {**phase("sweep redesign", phase_sweep_redesign, cfg, s,
                        srcpos, nflux),                             # 22.
                **phase("heating sweep redesign", phase_sweep_redesign,
                        hcfg, hs, hsrc, hnfl)}
    redesign.update({                                               # 23.
        **phase("chemistry redesign", phase_chem_redesign, cfg, s, srcpos,
                nflux, dt, parent),
        **phase("heating chemistry redesign", phase_chem_redesign, hcfg, hs,
                hsrc, hnfl, hdt, parent),
        **phase("photon-loss redesign", phase_ploss_redesign, pcfg, ps_,
                psrc, pnfl, parent)})

    # each kernel's launches on its own path: phases 4, 5, 8 and 10
    counts = {**counts, **hcounts, **pcounts, **dcounts}
    M = cfg.sweep.mesh
    Rf, Rb = (M // 2, M // 2 - 1)
    kernels = []
    for (sw, ch), sw_err, ch_err, sfx, c in (
            (iso_t, sweep_err32, chem_err32, "", cfg),
            (heat_t, hsweep_err32, hchem_err32, "_heat", hcfg)):
        sb = sweep_bound(c.sweep, srcpos.shape[0], Rf, Rb)
        cb = (redesign["chemistry" + sfx].pop("bound_ms"),
              redesign["chemistry" + sfx].pop("bound_by"))
        kernels += [
            {"name": "pyramid_sweep" + sfx, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/pyramid_sweep.cu",
             "replaces": ("c2ray_tpu/radiation/quadrature.py:330" if sfx
                          else "c2ray_tpu/sweep/pyramid_sweep.py:116"),
             "launches": (counts["pyramid_sweep" + sfx]
                          + cross.get("pyramid_sweep" + sfx, 0)),
             "launches_of": "phase 4 (5) and the 1D/3D cross-check "
                            "(phase 27)",
             "launches_crosscheck": cross.get("pyramid_sweep" + sfx, 0),
             "max_abs_err": sw[2],
             "max_rel_err_heat": sw[3],
             "max_rel_err_f32_32cube": sw_err,
             "ms": sw[0], "plain_ms": sw[1], "bound_ms": sb[0],
             "bound_by": sb[1], "library_ms": None},
            {"name": "chemistry" + sfx, "route": "cuda",
             "source": "c2ray_tpu_torch/csrc/chemistry.cu",
             "replaces": ("c2ray_tpu/thermal.py:119" if sfx
                          else "c2ray_tpu/sweep/global_pass.py:140"),
             "launches": MAIN_PATH_LAUNCHES["chemistry" + sfx],
             "launches_of": "every main-path run that checks its "
                            "launches (phases 4, 5, 8, 10, 16, 17, 20, "
                            "21, 27)",
             "launches_crosscheck": cross.get("chemistry" + sfx, 0),
             "max_abs_err": ch[2],
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
         "launches": MAIN_PATH_LAUNCHES["photon_losses"],
         "launches_of": "every main-path run", "max_abs_err": pabs,
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
             "replaces": replaces,
             "launches": (main_1d[name]["launches"]
                          + cross.get(name, 0)),
             "launches_of": "phase 12 and the 1D/3D cross-check (phase 27)",
             "launches_crosscheck": cross.get(name, 0),
             "max_abs_err": f_abs,
             "max_abs_err_of": "float64, mesh 10000, one 10 Myr step",
             "max_rel_err_f64_mesh10000": f_rel,
             "max_abs_err_f32_mesh128": kp_abs,
             "max_err_f32_vs_f64_mesh128": worst,
             "ms": ms, "plain_ms": p128,
             "plain_shape": "mesh 128, one float32 step, on the CPU",
             "ms_mesh128": k128,
             "us_per_iteration": 1e3 * ms / counters[0],
             "substeps_per_iteration": counters[3] / counters[0],
             "ms_f64_mesh10000_step0": k_full,
             "plain_ms_f64_mesh10000_step0": p_full,
             "host_share_of_step_wall": main_1d[name]["host_share"],
             "bound_ms": b[0], "bound_by": b[1],
             "bound_detail": b[2], "counters": counters,
             "library_ms": None})
    kernels += auto_1d
    # the halo kernels: launches on the domain paths of phases 20 and 21,
    # time, plain time and bound at world size 1, 128^3, full radius
    for name, replaces in (
            ("halo_pack", "c2ray_tpu/parallel/domain.py:81"),
            ("window_accumulate", "c2ray_tpu/parallel/domain.py:393"),
            ("fold_halo", "c2ray_tpu/parallel/domain.py:100")):
        ms, plain_ms, err, b, lib_ms, gbs = halo_t[name]
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
             "bound_by": b[1], "achieved_GB_per_s": gbs,
             "share_of_bound": b[0] / ms, "library_ms": lib_ms,
             "library_call": ("rc[window].add_(cube)"
                              if lib_ms is not None else None)})
    # the group sum: launches on the pyramid engine's main paths, time,
    # plain time and bound at 250^3 x 8 float32 (128^3 and float64 beside)
    ms, plain_ms, b, abs_err, rel = group_t[250, torch.float32]
    kernels.append(
        {"name": "group_accumulate", "route": "cuda",
         "source": "c2ray_tpu_torch/csrc/group_accumulate.cu",
         "replaces": "c2ray_tpu/sweep/pyramid_sweep.py:585",
         "launches": MAIN_PATH_LAUNCHES["group_accumulate"],
         "launches_of": "every pyramid-engine main-path run that checks "
                        "its launches (phases 4, 5, 8, 10, 20, 25, 27)",
         "shape": "250^3 x 8 sources, float32, every source live",
         "max_abs_err": abs_err,
         "max_abs_err_of": "against the masked sum (torch's order); the "
                           "sum in source order to the bit",
         "max_rel_err_masked_sum": rel,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
         "bound_by": b[1], "share_of_bound": b[0] / ms,
         "ms_128cube": group_t[128, torch.float32][0],
         "bound_ms_128cube": group_t[128, torch.float32][2][0],
         "ms_f64": group_t[250, torch.float64][0],
         "plain_ms_f64": group_t[250, torch.float64][1],
         "bound_ms_f64": group_t[250, torch.float64][2][0],
         "library_ms": None})
    # the tau-table and auto routes: launches, time, plain time and bound
    # on phase 25's runs at 128^3 x 8, the float32 error at 32^3 from
    # phase 24
    for entry in route_main:
        entry["max_err_f32_32cube"] = route_err[entry["name"]]
        kernels.append(entry)
    for entry in kernels:
        entry.update(redesign.get(entry["name"], {}))
    log(f"NCCL at world size 1: {nccl}")
    return kernels


if __name__ == "__main__":
    main()
