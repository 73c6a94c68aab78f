"""The L1-shell engine with a cosmological step's cell size and LLS
column, and the reion_203 configuration (Iliev et al. 2006, a 203^3 grid
on PMFAST halos) that runs it; this file imports no JAX.

CPU, float64, the port's plain versions: the benchmark's PMFAST tree at
17^3 through `Run3D` (the harness's `Cell`) on the shell engine, with the
type-1 LLS column switched on, against the benchmark's plain reference
(``benchmark/reference``); the generator's one realisation, seen in
an orientation and from an origin drawn from the seed;
`shell_sweep_plain` against the reference's shell sweep at another cell
size and a per-cell LLS grid; the sweep's spans and counters.  Card
(marker `gpu`, skipped without CUDA): the shell kernel with a per-cell
LLS grid and another cell size against `shell_sweep_plain` at 33^3, and
the kernels it counts.  On a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_reion203.py -m gpu
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from c2ray_tpu_torch import constants as const
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
from c2ray_tpu_torch.state import initial_grid_state
from c2ray_tpu_torch.sweep import (SourceFields, SweepConfig,
                                   build_shell_table, pyramid_sweep,
                                   source_sweep, sweep_sources_accumulate)
from c2ray_tpu_torch.utils import clocks

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CELL = "reion_203.mid_isothermal"
SEED = 2**31 + 203


@pytest.fixture(scope="module")
def bench():
    """The benchmark's folder on the import path (harness, reference)."""
    sys.path.insert(0, str(BENCH))
    yield
    sys.path.remove(str(BENCH))


@pytest.fixture
def fresh_store():
    clocks.tracing(False)
    clocks.reset()
    yield
    clocks.tracing(False)
    clocks.reset()


def _state(M, dtype, device, seed=5):
    rng = np.random.RandomState(seed)
    n = M**3
    h1 = rng.uniform(0.0, 0.8, n)
    he1 = rng.uniform(0.0, 0.5, n)
    he2 = rng.uniform(0.0, 0.3, n) * (1.0 - he1)
    return initial_grid_state(10.0 ** rng.uniform(-4, -2, n), h1, he1, he2,
                              1.0e4, dtype=dtype, device=device)


def _fields(state):
    return SourceFields(state.ndens, state.h_av0, state.h_av1, state.he_av0,
                        state.he_av1)


def _sources(M, S, dtype, device, seed=7):
    rng = np.random.RandomState(seed)
    srcpos = rng.randint(0, M, size=(S, 3))
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (S, 1)),
                            np.zeros((S, 2))], axis=1)
    return (torch.as_tensor(srcpos, device=device),
            torch.as_tensor(nflux, dtype=dtype, device=device))


def _sweep_config(M, dtype, device, **kw):
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48)), isothermal=True,
        dtype=dtype, device=device)
    return SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                       isothermal=True, flux_scale=bands.flux_scale, **kw)


def _lls_grid(M, dtype, device, seed=11):
    """A per-cell LLS column with empty cells among thick ones."""
    rng = np.random.RandomState(seed)
    g = 10.0 ** rng.uniform(16.0, 17.5, M**3)
    g[rng.uniform(size=M**3) < 0.3] = 0.0
    return torch.as_tensor(g, dtype=dtype, device=device)


def test_the_pmfast_cell_on_the_shell_engine_agrees_with_the_reference(
        bench, tmp_path):
    """The cell's PMFAST tree at 17^3, one cosmological slice through
    Run3D on the shell engine, with the type-1 LLS column switched on:
    every step sweeps at its own cell size and LLS column, and every
    number the check compares is within 1e-9 of the reference's."""
    from harness.cell import Cell

    over = dict(n_sources=6, run3d={"isothermal": True,
                                    "initial_temperature": 1.0e4,
                                    "lls": {"type_of_LLS": 1}})
    cell = Cell(CELL, SEED, device="cpu", mesh=17, workdir=str(tmp_path),
                overrides=over)
    cell.setup()
    assert cell.engine == "shells"
    run = cell.run
    assert run.config.nbody.nbody_type == "pmfast"
    # the grid holds the cosmic mean: (n_box / mesh)^3 in grid units
    mean = run.config.nbody.density_convert_grid(17) * (3248 / 17) ** 3
    zf = (1.0 + float(run.config.nbody.zred_array[0])) ** 3
    assert float(run.state.ndens.mean()) == pytest.approx(mean * zf,
                                                         rel=0.1)
    cell.window(0.0)
    cap = cell.capture
    dr_config = run.evolve_cfg.sweep.dr
    cell.release()
    ref = cell.reference()
    steps = ref.steps(1)
    # each step sweeps at its own cell size, not the configuration's,
    # with the step's LLS column in every cell
    assert len({dr_config, steps[0]["dr"], steps[1]["dr"]}) == 3
    for step, rec in cap.records.items():
        assert rec["dr"] == steps[step]["dr"]
        lls = rec["lls_grid"]
        assert lls is not None and float(lls[0]) > 0.0
        assert torch.equal(lls, torch.full_like(lls, float(lls[0])))
        assert rec["stats"].lls_loss > 0.0
    nums, _, _ = cell.judged(ref)
    assert set(nums) == set(cell.traffic["check"]["limits"])
    assert all(v <= 1e-9 for v in nums.values()), nums


def test_the_seed_views_one_realisation(bench, tmp_path):
    """Every seed writes the configuration's one realisation, rotated or
    reflected and shifted on the periodic grid: each halo keeps its
    mass, its density and its restart fractions, at a position that
    moves with the seed, and every cell of a cube moves where its
    halos do."""
    from harness import spec
    from reference.plain.io.fortran_records import read_unformatted_cube

    cfg = spec.config("reion_203")
    traffic = dict(spec.traffic(CELL), n_sources=6)
    gen = spec.generator(cfg["generator"])

    def tree(seed):
        wd = tmp_path / str(seed)
        gen.make(cfg, traffic, seed, str(wd), mesh=17)
        dens, = (wd / "tree" / "coarser_densities").glob("*n_all.dat")
        cat, = (wd / "tree" / "sources").glob("*_wsubgrid_sources.dat")
        xh, = (wd / "results").glob("xfrac3d_*.bin")
        rows = cat.read_text().split("\n")[1:7]
        pos = np.array([[int(x) - 1 for x in r.split()[:3]] for r in rows])
        mass = [r.split()[3:] for r in rows]
        d = read_unformatted_cube(dens, dtype=np.float32)
        x = read_unformatted_cube(xh, dtype=np.float64)
        at = tuple(pos.T)
        return pos, mass, d[at], x[at], float(d.mean())

    rng = np.random.default_rng(3)
    cube = rng.uniform(size=(17, 17, 17))
    for perm in ([0, 1, 2], [2, 0, 1], [1, 0, 2]):
        view = (np.array(perm), rng.integers(0, 2, 3).astype(bool),
                rng.integers(0, 17, 3))
        moved = gen._viewed(cube, view)
        for p in rng.integers(0, 17, (20, 3)):
            assert moved[tuple(gen._cell(p, view, 17))] == cube[tuple(p)]
    a, b = tree(SEED), tree(SEED + 1)
    assert not np.array_equal(a[0], b[0])
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])
    assert a[4] == pytest.approx((3248 / 17) ** 3, rel=1e-5)
    assert a[4] == pytest.approx(b[4], rel=1e-6)


@pytest.mark.parametrize("M,radius", [(9, None), (16, 5)])
def test_shell_sweep_plain_equals_the_reference_at_another_dr_and_lls_grid(
        bench, M, radius):
    """`shell_sweep_plain` given a cell size other than the
    configuration's and a per-cell LLS grid, through its configuration,
    against the reference's shell sweep given them as arguments."""
    from reference.plain.radiation import quadrature as rquad
    from reference.plain.radiation import sed as rsed
    from reference.plain.sweep import shell_sweep as rshell
    from reference.plain.sweep import source_sweep as rsweep

    dtype = torch.float64
    cfg = _sweep_config(M, dtype, "cpu")
    rtables, _, _ = rquad.build_quadrature_tables(
        rsed.SEDConfig(bb=rsed.BlackBodySED(T_eff=5e4, S_star=1e48)),
        isothermal=True, dtype=dtype)
    rcfg = rsweep.SweepConfig(tables=rtables, mesh=M, dr=cfg.dr,
                              isothermal=True, flux_scale=cfg.flux_scale)
    dr = 1.37 * cfg.dr
    lls = _lls_grid(M, dtype, "cpu")
    state = _state(M, dtype, "cpu")
    srcpos, nflux = _sources(M, 3, dtype, "cpu")
    fstack = source_sweep.stack_sweep_fields(cfg, _fields(state))
    got = source_sweep.shell_sweep_plain(
        dataclasses.replace(cfg, dr=dr, lls_grid=lls),
        build_shell_table(M, radius), fstack, srcpos, nflux)
    want = rshell.shell_plain(
        rcfg, rshell.build_shell_table(M, radius),
        rsweep.stack_sweep_fields(rcfg, _fields(state)), srcpos, nflux,
        dr=dr, vol_over_scale=dr**3 / cfg.flux_scale, lls=lls)
    assert float(want[2].abs().max()) > 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))
    # the configuration's own dr and no grid give another answer
    base = source_sweep.shell_sweep_plain(cfg, build_shell_table(M, radius),
                                          fstack, srcpos, nflux)
    assert not torch.equal(base[0], got[0])


@pytest.mark.parametrize("engine", ["shells", "pyramid"])
def test_the_sweep_counts_its_groups_bytes_and_kernels(fresh_store, engine):
    """The shell engine's spans and counters, as the pyramid engine's:
    a group each, the bytes it allocates zeroed (column cube, slab,
    losses) and the slabs its masked sum reads.  The plain versions
    launch no kernel, so they count none (the kernels' count:
    `test_shell_kernel_takes_dr_and_lls_grid`)."""
    M, S, group = 9 if engine == "shells" else 8, 5, 2
    dtype = torch.float64
    cfg = _sweep_config(M, dtype, "cpu", source_chunk=group)
    state = _state(M, dtype, "cpu")
    srcpos, nflux = _sources(M, S, dtype, "cpu")
    clocks.tracing(True)
    if engine == "shells":
        table = build_shell_table(M)
        sweep_sources_accumulate(cfg, table, _fields(state), srcpos, nflux,
                                 batch_size=group)
        assert table.n_shells == 3 * (M // 2)
    else:
        pyramid_sweep.sweep_pyramid_source_batch(cfg, _fields(state), srcpos,
                                                 nflux)
    sizes = [min(group, S - g0) for g0 in range(0, S, group)]
    snap = clocks.snapshot()
    c, spans = snap["counters"], snap["spans"]
    n, item = M**3, 8
    assert c["sweep.groups"] == len(sizes) == 3
    assert "sweep.kernels" not in c
    # plain versions: the column cube, the slab and the two losses
    assert c["sweep.zeroed_bytes"] == sum(s * (3 * n + 4 * n + 2) * item
                                          for s in sizes)
    assert c["sweep.summed_bytes"] == sum(s * 4 * n * item for s in sizes)
    assert spans["c2ray.sweep.stack"]["count"] == 1
    assert spans["c2ray.sweep.group"]["count"] == \
        spans["c2ray.sweep.sum"]["count"] == len(sizes)


def test_a_batch_sweep_takes_the_steps_dr_and_lls_grid():
    """`sweep_sources_accumulate` with `dr` and `lls_grid` equals the
    sum of the traces of a configuration that carries them."""
    M = 9
    dtype = torch.float64
    cfg = _sweep_config(M, dtype, "cpu")
    table = build_shell_table(M)
    state = _state(M, dtype, "cpu")
    srcpos, nflux = _sources(M, 3, dtype, "cpu")
    dr, lls = 0.8 * cfg.dr, _lls_grid(M, dtype, "cpu")
    got = sweep_sources_accumulate(cfg, table, _fields(state), srcpos, nflux,
                                   dr=dr, lls_grid=lls.numpy())
    carried = dataclasses.replace(cfg, dr=dr, lls_grid=lls)
    fstack = source_sweep.stack_sweep_fields(cfg, _fields(state))
    slab, pl, ll = source_sweep.shell_sweep_plain(carried, table, fstack,
                                                  srcpos, nflux)
    torch.testing.assert_close(got.phih, slab[..., 0].sum(0), rtol=1e-13,
                               atol=0.0)
    torch.testing.assert_close(got.lls_loss, ll.sum(), rtol=1e-13, atol=0.0)
    assert float(got.lls_loss) > 0.0
    with pytest.raises(ValueError, match="lls_grid"):
        source_sweep.shell_sweep_plain(
            dataclasses.replace(cfg, lls_grid=lls[:-1]), table, fstack,
            srcpos, nflux)
    # the volume factor that goes with the step's dr is taken; another
    # is refused, not ignored
    same = sweep_sources_accumulate(cfg, table, _fields(state), srcpos,
                                    nflux, dr=dr,
                                    vol_over_scale=dr**3 / cfg.flux_scale,
                                    lls_grid=lls)
    torch.testing.assert_close(same.phih, got.phih, rtol=0.0, atol=0.0)
    with pytest.raises(ValueError, match="volume factor"):
        sweep_sources_accumulate(cfg, table, _fields(state), srcpos, nflux,
                                 dr=dr, vol_over_scale=cfg.vol / cfg.flux_scale)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_shell_kernel_takes_dr_and_lls_grid(cuda_device, dtype):
    """The shell kernel at 33^3 with a per-cell LLS grid and a cell size
    other than the configuration's, against `shell_sweep_plain` on the
    same inputs: float64 within rtol 1e-10 of each part's largest value
    (rates, heat, photon loss, LLS loss); float32 within twice the plain
    float32 version's error against the float64 plain result, plus 1e-5
    (the shell gates of tests/test_torch_kernels.py)."""
    M = 33
    table = build_shell_table(M)
    parts = {}
    clocks.reset()
    for dt in (torch.float64, dtype):
        cfg = _sweep_config(M, dt, cuda_device)
        cfg = dataclasses.replace(cfg, dr=1.3 * cfg.dr,
                                  lls_grid=_lls_grid(M, dt, cuda_device))
        state = _state(M, dt, cuda_device)
        srcpos, nflux = _sources(M, 3, dt, cuda_device)
        fstack = source_sweep.stack_sweep_fields(cfg, _fields(state))
        k = source_sweep.shell_sweep_cuda(cfg, table, fstack, srcpos, nflux)
        p = source_sweep.shell_sweep_plain(cfg, table, fstack, srcpos, nflux)
        parts[dt] = tuple([t[0][..., :3], t[0][..., 3], t[1], t[2]]
                          for t in (k, p))
    # the kernels launched, counted where they launch: 1 + n_shells for
    # each of the two kernel calls, none for the plain version's
    assert clocks.counter("sweep.kernels") == 2 * (1 + table.n_shells)
    clocks.reset()
    (k64, p64), (k, p) = parts[torch.float64], parts[dtype]
    assert float(p64[3].abs().max()) > 0.0
    for a, b, ref in zip(k, p, p64):
        if dtype == torch.float64:
            torch.testing.assert_close(a, b, rtol=1e-10,
                                       atol=1e-10 * float(b.abs().max()))
        else:
            ek, ep = _rel_err(a.double(), ref), _rel_err(b.double(), ref)
            assert ek <= 2.0 * ep + 1e-5, (ek, ep)
