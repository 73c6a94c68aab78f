"""Rank bodies of the port's multi-process tests (no JAX here).

`c2ray_tpu_torch.parallel.launch` runs each of these in gloo ranks on
the CPU; the test files compare what they return with the JAX
package's functions in the parent process.  The inputs are made with
numpy from a seed, the same in every rank and in the parent.  Each
function returns host values (numpy arrays, floats, ints).
"""

import numpy as np
import torch

from c2ray_tpu_torch import constants as const
from c2ray_tpu_torch.parallel import comm
from c2ray_tpu_torch.parallel.domain import (exchange_slab_halo,
                                             fold_slab_halo,
                                             gather_state_slabs,
                                             group_sources_by_slab,
                                             make_domain_iteration,
                                             shard_state_slabs)
from c2ray_tpu_torch.parallel.sharding import (ParallelConfig,
                                               make_parallel_iteration,
                                               pad_sources)
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
from c2ray_tpu_torch.state import begin_timestep, initial_grid_state
from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                   SweepConfig, build_shell_table)

DT = 5e13


def setup(M=16, isothermal=True, coldensh_LLS=0.0, engine="pyramid",
          shells=None):
    """The port's twin of tests/test_domain.py:_setup (float64, CPU)."""
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=1.0e5, S_star=1.0e49)),
        isothermal=isothermal, dtype=torch.float64)
    cooling = None
    if not isothermal:
        from c2ray_tpu_torch.cooling import setup_cooling_tables
        cooling = setup_cooling_tables(torch.float64)
    cfg = Evolve3DConfig(
        sweep=SweepConfig(tables=tables, mesh=M, dr=14.0 * const.kpc / M,
                          isothermal=isothermal, coldensh_LLS=coldensh_LLS,
                          flux_scale=bands.flux_scale),
        chem=ChemistryConfig(cooling=cooling, isothermal=isothermal,
                             isothermal_temperature=1.0e4),
        shells=shells if shells is not None else build_shell_table(M),
        engine=engine)
    state = initial_grid_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0,
                               1.0e4)
    return cfg, state


def random_sources(M, n, seed=3):
    rng = np.random.RandomState(seed)
    srcpos = rng.randint(0, M, (n, 3)).astype(np.int32)
    nflux = np.column_stack([rng.uniform(0.5, 2.0, n), np.zeros((n, 2))])
    return srcpos, nflux


def halo_data(M, H, seed=11):
    """A global (M, 3) slab array and a (D (S + 2H), 3) extended one."""
    rng = np.random.RandomState(seed + H)
    return rng.uniform(size=(M, 3)), rng.uniform(size=(8 * (M // 8 + 2 * H),
                                                       3))


def halo_rank(Hs, M=16):
    """exchange_slab_halo and fold_slab_halo of this rank's block of
    `halo_data`, for each H of Hs."""
    D, d = comm.axis_size(), comm.rank()
    S = M // D
    out = {}
    for H in Hs:
        x, ext = halo_data(M, H)
        slab = torch.as_tensor(x[d * S:(d + 1) * S])
        core = torch.as_tensor(ext[d * (S + 2 * H):(d + 1) * (S + 2 * H)])
        out[H] = (exchange_slab_halo(slab, H).numpy(),
                  fold_slab_halo(core, H).numpy())
    return out


def _gathered(state, group=None):
    full = gather_state_slabs(state, group)
    return {k: v.numpy() for k, v in full._asdict().items()}


def domain_iteration_rank(radius, M=16, n_src=5, isothermal=True,
                          lls_col=0.0, dt=DT, extra_halo=0):
    """One make_domain_iteration on the ranks' slabs of the test grid;
    the gathered state, conv_flag and losses."""
    cfg, state = setup(M, isothermal=isothermal)
    D = comm.axis_size()
    srcpos, nflux = random_sources(M, n_src)
    sp, nf = group_sources_by_slab(srcpos, nflux, M, D)
    it = make_domain_iteration(ParallelConfig(cfg), radius,
                               extra_halo=extra_halo)
    lls = torch.full((M**3,), lls_col, dtype=torch.float64) if lls_col \
        else None
    s, conv, pl, ll = it(shard_state_slabs(begin_timestep(state)), sp,
                         torch.as_tensor(nf), dt, lls_grid=lls)
    return _gathered(s), int(conv), float(pl), float(ll)


def halo_and_domain_rank(Hs, radius):
    return halo_rank(Hs), domain_iteration_rank(radius)


def parallel_iteration_rank(M=16, n_src=5, engine="pyramid", max_subbox=None):
    """One make_parallel_iteration on the padded test sources."""
    cfg, state = setup(M, engine=engine,
                       shells=build_shell_table(M, max_subbox))
    srcpos, nflux = random_sources(M, n_src)
    sp, nf = pad_sources(srcpos, nflux, comm.axis_size())
    it = make_parallel_iteration(ParallelConfig(cfg))
    s, conv, pl, ll = it(begin_timestep(state), torch.as_tensor(sp),
                         torch.as_tensor(nf), DT)
    return ({k: v.numpy() for k, v in s._asdict().items()}, int(conv),
            float(pl), float(ll))


def parallel_iterations_rank(cases):
    return [parallel_iteration_rank(**c) for c in cases]


def domain_iteration_kw_rank(kw):
    return domain_iteration_rank(**kw)


# tests/test_domain.py's full-step and resume sources; a heating step
# of 3e13 s (f64 heating comparisons stay below ~3e13 s, see
# tests/test_torch_chemistry.py)
STEP_SOURCES = (np.array([[8, 8, 8], [3, 12, 5]], dtype=np.int32),
                np.array([[1.0, 0, 0], [0.7, 0, 0]]))
STEP_DT = 3e13


def domain_evolve3d_rank(radius):
    """domain_evolve3d over one heating step at a fixed radius; the
    gathered state and (iterations, conv_flag)."""
    from c2ray_tpu_torch.parallel import domain_evolve3d

    cfg, state = setup(16, isothermal=False)
    s, stats = domain_evolve3d(ParallelConfig(cfg), shard_state_slabs(state),
                               *STEP_SOURCES, STEP_DT, radius=radius)
    return _gathered(s), (stats.n_iterations, stats.conv_flag)


def iterdump_resume_rank(mode, dump_dir):
    """A step dumping every iteration, then the step resumed from its
    last dump: (reference, resumed, dumped iteration count), each run as
    (gathered state, iterations)."""
    import torch.distributed as dist

    from c2ray_tpu_torch.io.checkpoint import load_iterdump
    from c2ray_tpu_torch.parallel import domain_evolve3d, parallel_evolve3d
    from c2ray_tpu_torch.state import GridState
    from c2ray_tpu_torch.sweep.source_sweep import RateGrids

    cfg, state = setup(16)
    pcfg = ParallelConfig(cfg)

    def run(**kw):
        if mode == "domain":
            s, st = domain_evolve3d(pcfg, shard_state_slabs(state),
                                    *STEP_SOURCES, DT, radius=6,
                                    dump_dir=dump_dir, **kw)
            return _gathered(s), st.n_iterations
        s, st = parallel_evolve3d(pcfg, state, *STEP_SOURCES, DT,
                                  dump_dir=dump_dir, **kw)
        return {k: v.numpy() for k, v in s._asdict().items()}, \
            st.n_iterations

    ref = run(dump_interval_s=0.0)
    dist.barrier()      # rank 0's last dump is on disk
    niter = load_iterdump(dump_dir, GridState, RateGrids)[0]
    res = run(dump_interval_s=1e9, start_from_dump=True)
    return ref, res, niter


RUN_SOURCES = (np.array([[8, 8, 8]], dtype=np.int32),
               np.array([[1.0, 0.0, 0.0]]))


def run3d_rank(mode, workdir):
    """Run3D(parallel=mode, n_devices=2) at 16^3 through one slice (the
    configuration of tests/test_domain.py:366-410): h1 and the
    iteration count of the slice's step."""
    import os

    from c2ray_tpu_torch.driver import Run3D, Run3DConfig
    from c2ray_tpu_torch.io.writers import OutputStreams
    from c2ray_tpu_torch.nbody import test_nbody
    from c2ray_tpu_torch.sources import SourceList

    cfg = Run3DConfig(
        mesh=16, nbody=test_nbody(),
        sed=SEDConfig(bb=BlackBodySED(T_eff=5.0e4, S_star=3e56)),
        isothermal=True, steps_per_slice=1,
        results_dir=os.path.join(workdir, "results"), dump_dir=workdir,
        streams=OutputStreams(), parallel=mode, n_devices=2, device="cpu")
    run = Run3D(cfg)
    run.init_uniform_material()
    stats = run.run_slice(0, SourceList(srcpos=RUN_SOURCES[0],
                                        nflux=RUN_SOURCES[1]))
    return run.state.h1.numpy(), stats[0].n_iterations


def shared_seed_rank():
    from c2ray_tpu_torch.driver import shared_seed

    return shared_seed(torch.device("cpu"))
