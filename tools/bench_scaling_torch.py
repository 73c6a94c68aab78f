#!/usr/bin/env python
"""Source-parallel and domain scaling benchmark over N ranks (PyTorch port).

Port of ``tools/bench_scaling.py`` onto ``c2ray_tpu_torch.parallel``:
measures the sharded {sweep + psum + chemistry} iteration
(`make_parallel_iteration`) or the x-slab domain iteration
(`make_domain_iteration`) at 1..N ranks with proportional source counts
(weak scaling over sources, the reference's MPI scaling axis, SURVEY.md
section 2.5).  Each world size is one `parallel.launch` of spawned
ranks: NCCL with one card per rank on ``--device cuda`` (the default;
it stops, saying so on stderr, at the first world size with more ranks
than cards), gloo ranks on ``--device cpu``.  Each rank builds the
configuration, runs one warm-up iteration, meets the others at a
barrier and times one iteration (synchronising the card); the slowest
rank's time is the world size's.  float32 on the card, float64 on the
CPU.

``--heating`` runs the port's heating chemistry inside the iteration.
The JAX tool's heating runs took the TPU's host-driven split chemistry
(`split_chem=True`); that is a TPU workaround the port leaves out
(ROADMAP "Not ported"), and the port's parallel iterations accept and
ignore the flag, so nothing is passed for it here.

Prints one line per world size on stderr and one JSON line on stdout
(`weak_scaling_efficiency_{mode}_{phys}_{n}dev_mesh{M}`, the time of
world size 1 over that of the largest, with `detail` per world size and
the device the ranks ran on).  This is not the port's benchmark and
writes no file.

Usage: python tools/bench_scaling_torch.py [--mesh 32] [--devices 1 2 4 8]
       [--src-per-device 2] [--mode source|domain] [--heating]
       [--radius R] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from c2ray_tpu_torch import constants as const  # noqa: E402
from c2ray_tpu_torch.cooling import setup_cooling_tables  # noqa: E402
from c2ray_tpu_torch.parallel import (  # noqa: E402
    ParallelConfig, group_sources_by_slab, make_domain_iteration,
    make_parallel_iteration, max_domain_radius, pad_sources,
    shard_state_slabs)
from c2ray_tpu_torch.parallel.launch import launch  # noqa: E402
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig  # noqa: E402
from c2ray_tpu_torch.radiation.quadrature import (  # noqa: E402
    build_quadrature_tables)
from c2ray_tpu_torch.state import (  # noqa: E402
    begin_timestep, initial_grid_state)
from c2ray_tpu_torch.sweep import (  # noqa: E402
    ChemistryConfig, Evolve3DConfig, SweepConfig, build_shell_table)

DT = 1.0e14


def rank_seconds(mode, M, heating, radius, srcpos, nflux):
    """One rank's seconds for one iteration of `mode` ("source" or
    "domain") at mesh M on the bench's blackbody, after a warm-up and a
    barrier.  Runs inside `parallel.launch`: the device is the rank's
    card under NCCL, the CPU under gloo."""
    cuda = dist.get_backend() == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    dtype = torch.float32 if cuda else torch.float64
    iso = not heating
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=3e51)),
        isothermal=iso, dtype=dtype, device=dev)
    chem = (ChemistryConfig(isothermal=True, isothermal_temperature=1e4)
            if iso else
            ChemistryConfig(isothermal=False,
                            cooling=setup_cooling_tables(dtype, dev)))
    cfg = Evolve3DConfig(
        sweep=SweepConfig(tables=tables, mesh=M, dr=50 * const.kpc / M,
                          isothermal=iso, flux_scale=bands.flux_scale),
        chem=chem, shells=build_shell_table(M))
    state = begin_timestep(initial_grid_state(
        np.full((M,) * 3, 1e-4), 0.0, 0.0, 0.0, 1e4, dtype=dtype,
        device=dev))
    nd = dist.get_world_size()
    pcfg = ParallelConfig(cfg=cfg)
    if mode == "domain":
        # grid-sharded mode: per-rank memory M^3/nd; sources grouped by
        # owning slab, their list on the host
        it = make_domain_iteration(
            pcfg, min(radius or M // 4, max_domain_radius(M)))
        sp, nf = group_sources_by_slab(srcpos, nflux, M, nd)
        st = shard_state_slabs(state)
    else:
        it = make_parallel_iteration(pcfg)
        sp, nf = pad_sources(srcpos, nflux, nd)
        sp = torch.as_tensor(sp, device=dev)
        st = state
    nf = torch.as_tensor(nf, dtype=dtype, device=dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    it(st, sp, nf, DT)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    it(st, sp, nf, DT)
    sync()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=32)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--src-per-device", type=int, default=2)
    ap.add_argument("--mode", choices=["source", "domain"],
                    default="source")
    ap.add_argument("--heating", action="store_true",
                    help="non-isothermal: 47-band heating and the heating "
                         "chemistry")
    ap.add_argument("--radius", type=int, default=None,
                    help="domain-mode trace radius (default mesh/4)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            ap.error("--device cuda but CUDA is not available; pass "
                     "--device cpu to run gloo ranks on the CPU")
        cards = torch.cuda.device_count()
        device_name = torch.cuda.get_device_name(0)
    else:
        device_name = "cpu"

    M = args.mesh
    rng = np.random.RandomState(11)
    results = {}
    t1 = None
    for nd in args.devices:
        if args.device == "cuda" and nd > cards:
            print(f"# [{args.mode}] stopping at {nd} ranks: {cards} CUDA "
                  f"card(s) on this machine", file=sys.stderr)
            break
        n_src = args.src_per_device * nd
        srcpos = rng.randint(0, M, (n_src, 3)).astype(np.int32)
        nflux = np.column_stack([rng.uniform(0.5, 2.0, n_src),
                                 np.zeros((n_src, 2))])
        # one torch thread per CPU rank: the ranks share the host's cores
        seconds = launch(rank_seconds, nd,
                         args=(args.mode, M, args.heating, args.radius,
                               srcpos, nflux),
                         device=args.device,
                         threads=1 if args.device == "cpu" else 0)
        el = max(seconds)
        rate = M**3 * n_src / el
        if t1 is None:
            t1 = el
        eff = t1 / el  # weak scaling: ideal = const time
        results[nd] = dict(seconds=el, rate=rate, weak_efficiency=eff)
        print(f"# [{args.mode}] {nd} devices, {n_src} sources: {el:.3f}s "
              f"{rate:.3e} cell-src/s weak-eff {eff:.2f}",
              file=sys.stderr)
    if not results:
        sys.exit(f"bench_scaling_torch: no world size of {args.devices} "
                 f"could run")

    best = max(results)
    phys = "heating" if args.heating else "isothermal"
    out = {
        "metric": (f"weak_scaling_efficiency_{args.mode}_{phys}_"
                   f"{best}dev_mesh{M}"),
        "value": results[best]["weak_efficiency"],
        "unit": "fraction",
        "vs_baseline": 1.0,
        "detail": {str(k): v for k, v in results.items()},
        "device": device_name,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
