"""The port's x-slab domain decomposition against the JAX package,
float64 on the CPU.

The port's ranks are gloo processes started by
`c2ray_tpu_torch.parallel.launch` (their bodies are in
`torch_parallel_ranks.py`); JAX runs in this process on the 8 host
devices of tests/conftest.py.  Inputs are made with numpy from seeds.

- the halo exchange and fold at D = 8, S = 2, H in {1, 2, 5} (5 > S:
  several hops) equal JAX's exchange_slab_halo / fold_slab_halo;
- the host functions (message pairs, source grouping, window geometry,
  memory model, the capped ladder and its warning) equal JAX's;
- the plain versions of the three halo kernels equal a reference built
  from JAX's own operations at the slab shapes of D = 1 and D = 8;
- make_domain_iteration at 16^3, D = 8, radius 5 (H = 6 > S = 2) against
  JAX's make_domain_iteration (state rtol 1e-9 with a 1e-11 floor,
  he_av2 rtol 1e-7 with a 1e-14 floor, photon loss rtol 1e-11, conv_flag
  equal) and against the port's replicated make_evolve3d_iteration at
  radius 5 (tests/test_domain.py's tolerances);
- the error paths: the kernel wrappers refuse CPU tensors, a tensor of
  the wrong device kind on a gloo group raises, and the parallel
  iterations refuse add_photon_losses.

The slow tests (-m slow) add the LLS-grid iteration, the full-extent
radius 7, a heating iteration, domain_evolve3d over a full step, the
iterdump resume and Run3D in both parallel modes at n_devices = 2.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_ranks as R
from c2ray_tpu import constants as jconst
from c2ray_tpu.parallel import ParallelConfig as JParallelConfig
from c2ray_tpu.parallel import domain as jdom
from c2ray_tpu.radiation import BlackBodySED as JBB
from c2ray_tpu.radiation import SEDConfig as JSED
from c2ray_tpu.radiation.quadrature import \
    build_quadrature_tables as j_tables
from c2ray_tpu.state import begin_timestep as j_begin
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import SweepConfig as JSweepConfig
from c2ray_tpu.sweep import build_shell_table as j_shells
from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
from c2ray_tpu_torch.parallel import comm, halo, launch
from c2ray_tpu_torch.parallel import domain as tdom
from c2ray_tpu_torch.parallel.sharding import (ParallelConfig,
                                               make_parallel_iteration)
from c2ray_tpu_torch.state import begin_timestep
from c2ray_tpu_torch.sweep import make_evolve3d_iteration
from c2ray_tpu_torch.utils.clocks import counter

torch.set_num_threads(1)

HALOS = (1, 2, 5)
RADIUS = 5


def _mesh(n=8):
    return Mesh(np.array(jax.devices()[:n]), ("d",))


def _jax_setup(M=16, isothermal=True, coldensh_LLS=0.0):
    """tests/test_domain.py:_setup."""
    tables, _, bands = j_tables(JSED(bb=JBB(T_eff=1.0e5, S_star=1.0e49)),
                                isothermal=isothermal, dtype=jnp.float64)
    cooling = None
    if not isothermal:
        from c2ray_tpu.cooling import setup_cooling_tables
        cooling = setup_cooling_tables(dtype=jnp.float64)
    cfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, mesh=M, dr=14.0 * jconst.kpc / M,
                           isothermal=isothermal, coldensh_LLS=coldensh_LLS,
                           flux_scale=bands.flux_scale),
        chem=JChemConfig(cooling=cooling, isothermal=isothermal,
                         isothermal_temperature=1.0e4),
        shells=j_shells(M))
    state = j_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0, 1.0e4)
    return cfg, state


def _jax_domain_iteration(radius, M=16, n_src=5, isothermal=True,
                          lls_col=0.0, dt=R.DT, extra_halo=0):
    """JAX's make_domain_iteration on the inputs of
    torch_parallel_ranks.domain_iteration_rank."""
    cfg, state = _jax_setup(M, isothermal)
    mesh = _mesh()
    srcpos, nflux = R.random_sources(M, n_src)
    sp, nf = jdom.group_sources_by_slab(srcpos, nflux, M, 8)
    it = jdom.make_domain_iteration(JParallelConfig(cfg=cfg, mesh=mesh),
                                    radius, extra_halo=extra_halo)
    kw = {}
    if lls_col:
        kw["lls_grid"] = jnp.full((M**3,), lls_col, dtype=jnp.float64)
    return it(jdom.shard_state_slabs(j_begin(state), mesh), jnp.asarray(sp),
              jnp.asarray(nf), jnp.float64(dt), **kw)


def _assert_state_close(port, ref, rtol=1e-9, atol=1e-11,
                        he2=(1e-7, 1e-14)):
    for k in ("h_av0", "h_av1", "he_av0", "he_av1", "h_int0", "h_int1",
              "he_int0", "he_int1", "he_int2", "t_av", "t_inter"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(ref, k)),
                                   rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_allclose(port["he_av2"], np.asarray(ref.he_av2),
                               rtol=he2[0], atol=he2[1])


@pytest.fixture(scope="module")
def ranks8():
    """One launch of 8 gloo ranks: the halo exchange and fold for each H
    of HALOS, and one domain iteration at radius 5 (per rank)."""
    return launch.launch(R.halo_and_domain_rank, 8, args=(HALOS, RADIUS),
                         device="cpu", threads=1)


# ---- the halo exchange and fold, equal to JAX's

@pytest.mark.parametrize("H", HALOS)
def test_halo_exchange_and_fold_equal_jax(ranks8, H):
    D, M = 8, 16
    S = M // D
    x, ext = R.halo_data(M, H)
    mesh = _mesh()
    ex = shard_map(lambda s: jdom.exchange_slab_halo(s, H), mesh=mesh,
                   in_specs=P("d"), out_specs=P("d"))
    want_ex = np.asarray(jax.jit(ex)(jnp.asarray(x))).reshape(D, -1, 3)
    fo = shard_map(lambda s: jdom.fold_slab_halo(s, H), mesh=mesh,
                   in_specs=P("d"), out_specs=P("d"))
    want_fo = np.asarray(jax.jit(fo)(jnp.asarray(ext))).reshape(D, S, 3)
    for d in range(D):
        got_ex, got_fo = ranks8[d][0][H]
        np.testing.assert_array_equal(got_ex, want_ex[d])
        np.testing.assert_array_equal(got_fo, want_fo[d])


# ---- host functions, equal to JAX's

@pytest.mark.parametrize("k,D", [(1, 8), (-1, 8), (3, 4), (0, 2)])
def test_perm_equals_jax(k, D):
    assert tdom._perm(k, D) == jdom._perm(k, D)


def _catalog(M, n, seed, clustered=False):
    rng = np.random.RandomState(seed)
    x = rng.randint(4, 6, n) if clustered else rng.randint(0, M, n)
    srcpos = np.column_stack([x, rng.randint(0, M, n),
                              rng.randint(0, M, n)]).astype(np.int32)
    nflux = np.column_stack([rng.uniform(0.5, 2.0, n), np.zeros((n, 2))])
    return srcpos, nflux


@pytest.mark.parametrize("D", [1, 2, 8])
def test_source_grouping_equals_jax(D):
    M = 16
    srcpos, nflux = _catalog(M, 9, seed=D)
    for got, want in (
            (tdom.group_sources_by_slab(srcpos, nflux, M, D),
             jdom.group_sources_by_slab(srcpos, nflux, M, D)),
            (tdom.group_sources_balanced(srcpos, nflux, M, D, 4),
             jdom.group_sources_balanced(srcpos, nflux, M, D, 4))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # the n_dev == 1 case keeps the absolute x, never a negative offset
    if D == 1:
        sp, _ = tdom.group_sources_by_slab(srcpos, nflux, M, 1)
        np.testing.assert_array_equal(np.sort(sp[:, 0]),
                                      np.sort(srcpos[:, 0]))


def test_balanced_grouping_of_a_clustered_catalog_equals_jax():
    srcpos, nflux = _catalog(16, 8, seed=11, clustered=True)
    got = tdom.group_sources_balanced(srcpos, nflux, 16, 8, 4)
    want = jdom.group_sources_balanced(srcpos, nflux, 16, 8, 4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    counts = np.any(got[1].reshape(8, -1, 3) > 0, axis=2).sum(axis=1)
    assert counts.max() <= 2


@pytest.mark.parametrize("M", [16, 64, 128])
def test_window_geometry_and_memory_model_equal_jax(M):
    assert tdom.max_domain_radius(M) == jdom.max_domain_radius(M)
    assert tdom.replicated_memory_elements(M, 6) == \
        jdom.replicated_memory_elements(M, 6)
    for r in (1, 2, 5, 7, M // 4, M // 2):
        for e in (0, 3):
            assert tdom._window_geometry(M, r, e) == \
                jdom._window_geometry(M, r, e)
            for D in (1, 2, 8):
                assert tdom.domain_memory_elements(M, D, r, e) == \
                    jdom.domain_memory_elements(M, D, r, e)


@pytest.mark.parametrize("M,D,E,cap", [(64, 8, 0, True), (128, 8, 16, True),
                                       (512, 8, 0, True), (64, 1, 0, True),
                                       (128, 8, 0, False)])
def test_domain_radii_equal_jax_with_its_warning(M, D, E, cap):
    from types import SimpleNamespace

    cfg = SimpleNamespace(sweep=SimpleNamespace(mesh=M), subbox_start=8)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = tdom._domain_radii(cfg, n_dev=D, extra_halo=E, cap_memory=cap)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = jdom._domain_radii(cfg, n_dev=D, extra_halo=E, cap_memory=cap)
    assert got == want
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert bool(wt) == (cap and D > 1 and got[-1] < M // 2)


@pytest.mark.parametrize("D,H", [(8, 1), (8, 2), (8, 5), (2, 7), (4, 3)])
def test_halo_messages_cover_the_owners(D, H):
    """Every halo-extended plane is received once from its owner, and
    every halo plane is folded once onto its owner's plane."""
    M = 16
    S = M // D
    for d in range(D):
        seen = {}
        for k, lo, hi, at in tdom._halo_messages(S, H):
            src = (d - k) % D
            for p in range(lo, hi):
                seen[at + p - lo] = (src * S + p) % M
        assert sorted(seen) == list(range(H)) + list(range(S + H,
                                                            S + 2 * H))
        for x, g in seen.items():
            assert g == (d * S + x - H) % M
    for d in range(D):
        got = []
        for k, lo, hi, at in tdom._fold_messages(S, H):
            sender = (d - k) % D
            for x in range(lo, hi):
                assert (sender * S + x - H) % M == d * S + at + x - lo
                got.append(x)
        assert sorted(got) == list(range(H)) + list(range(S + H, S + 2 * H))


# ---- the halo kernels' plain versions against JAX's operations

def _slab_case(M, D, radius, C, seed=4):
    """The rank's fields, halos and rate slab at a slab shape."""
    S = M // D
    _, _, H = tdom._window_geometry(M, radius)
    rng = np.random.RandomState(seed)
    fields = [rng.uniform(1e-4, 1e-2, S * M * M)]
    fields += [np.where(rng.uniform(size=S * M * M) < 0.2, 0.0,
                        rng.uniform(size=S * M * M)) for _ in range(4)]
    fields += [rng.uniform(0, 1e18, S * M * M)] * (C - 5)
    left, right = (rng.uniform(size=(H, M, M, C)) for _ in range(2))
    rc = rng.uniform(size=(S + 2 * H, M + 2 * H, M + 2 * H, 4))
    return S, H, fields, left, right, rc


SLAB_SHAPES = [(16, 8, 5, 5), (16, 8, 5, 6), (16, 1, 8, 5), (32, 8, 5, 6),
               (32, 1, 16, 5)]


@pytest.mark.parametrize("M,D,radius,C", SLAB_SHAPES)
def test_halo_pack_plain_equals_jax(M, D, radius, C):
    S, H, fields, left, right, _ = _slab_case(M, D, radius, C)
    eps = 1e-20
    chans = [fields[0]] + [jnp.maximum(f, eps) for f in fields[1:5]]
    chans += fields[5:]
    fl = jnp.stack([jnp.asarray(c) for c in chans], -1).reshape(S, M, M, C)
    want = jnp.concatenate([left, fl, right], axis=0)
    want = np.asarray(jdom._cyclic_pad(jdom._cyclic_pad(want, H, 1), H, 2))
    got = halo.halo_pack([torch.as_tensor(f) for f in fields], M, eps,
                         left=torch.as_tensor(left),
                         right=torch.as_tensor(right), pad=H)
    np.testing.assert_array_equal(got.numpy(), want)
    # the planes a rank sends: its stacked planes, no halo, no pad
    lo, hi = max(0, S - H), S
    sent = halo.halo_pack([torch.as_tensor(f) for f in fields], M, eps,
                          planes=(lo, hi))
    np.testing.assert_array_equal(sent.numpy(), np.asarray(fl[lo:hi]))


@pytest.mark.parametrize("M,D,radius,C", SLAB_SHAPES[:1] + SLAB_SHAPES[2:3])
def test_window_accumulate_plain_equals_jax(M, D, radius, C):
    S, H, _, _, _, rc = _slab_case(M, D, radius, C)
    Mw, Rb, _ = tdom._window_geometry(M, radius)
    rng = np.random.RandomState(9)
    starts = [(rng.randint(0, S + 2 * H - Mw + 1),
               rng.randint(0, M + 2 * H - Mw + 1),
               rng.randint(0, M + 2 * H - Mw + 1)) for _ in range(3)]
    cubes = [rng.uniform(size=(Mw, Mw, Mw, 4)) for _ in starts]
    want = jnp.asarray(rc)
    got = torch.as_tensor(rc.copy())
    for st, cube in zip(starts, cubes):
        start = tuple(jnp.int32(v) for v in st) + (jnp.int32(0),)
        patch = jax.lax.dynamic_slice(want, start, (Mw, Mw, Mw, 4))
        want = jax.lax.dynamic_update_slice(want, patch + cube, start)
        halo.window_accumulate(got, torch.as_tensor(cube), st)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="leaves"):
        halo.window_accumulate(got, torch.as_tensor(cubes[0]),
                               (S + 2 * H - Mw + 1, 0, 0))


@pytest.mark.parametrize("M,D,radius,C", SLAB_SHAPES[:1] + SLAB_SHAPES[2:3]
                         + SLAB_SHAPES[4:])
def test_fold_halo_plain_equals_jax(M, D, radius, C):
    S, H, _, _, _, rc = _slab_case(M, D, radius, C)
    rng = np.random.RandomState(13)
    msgs = tdom._fold_messages(S, H)
    recv, chunks, b0 = [], [], 0
    for _, lo, hi, at in msgs:
        recv.append(rng.uniform(size=(hi - lo, M, M, 4)))
        chunks.append((b0, at, hi - lo))
        b0 += hi - lo
    recv = np.concatenate(recv)
    # JAX: _fold_cyclic on y then z, then the chunks added in order
    want = jdom._fold_cyclic(jdom._fold_cyclic(jnp.asarray(rc), H, 1), H, 2)
    halos = np.asarray(want)
    local = want[H:H + S]
    for b, lo, n in chunks:
        local = local.at[lo:lo + n].add(recv[b:b + n])
    want4 = np.asarray(local).reshape(-1, 4).T
    rc_t = torch.as_tensor(rc)
    got = halo.fold_halo(rc_t, M, (H, H + S), recv=torch.as_tensor(recv),
                         chunks=chunks)
    np.testing.assert_array_equal(got.numpy(), want4)
    sent = halo.fold_halo(rc_t, M, (0, H), planar=False)
    np.testing.assert_array_equal(sent.numpy(), halos[:H])


# ---- the domain iteration against JAX and the port's replicated one

def _port_state(ranks8):
    return ranks8[0][1]


def test_domain_iteration_matches_jax(ranks8):
    port, conv, pl, ll = _port_state(ranks8)
    s8, conv8, pl8, ll8 = _jax_domain_iteration(RADIUS)
    _assert_state_close(port, s8)
    np.testing.assert_allclose(pl, float(pl8), rtol=1e-11)
    assert ll == float(ll8) == 0.0
    assert conv == int(conv8)
    # every rank gathered the same state
    for r in ranks8[1:]:
        for k, v in port.items():
            np.testing.assert_array_equal(r[1][0][k], v)


def test_domain_iteration_matches_port_replicated(ranks8):
    port, conv, pl, _ = _port_state(ranks8)
    cfg, state = R.setup(16)
    srcpos, nflux = R.random_sources(16, 5)
    s1, conv1, pl1, _ = make_evolve3d_iteration(cfg, radius=RADIUS)(
        begin_timestep(state), torch.as_tensor(srcpos),
        torch.as_tensor(nflux), R.DT)
    np.testing.assert_allclose(port["h_av1"], s1.h_av1.numpy(), rtol=5e-11)
    np.testing.assert_allclose(port["he_av2"], s1.he_av2.numpy(), rtol=1e-7,
                               atol=1e-14)
    np.testing.assert_allclose(pl, float(pl1), rtol=1e-11)
    assert conv == int(conv1)


# ---- error paths

def test_halo_kernel_wrappers_refuse_cpu_tensors():
    M, S = 4, 2
    f = [torch.ones(S * M * M, dtype=torch.float64) for _ in range(5)]
    rc = torch.zeros((S + 2, M + 2, M + 2, 4), dtype=torch.float64)
    counts = lambda: tuple(counter("launches.domain_halo." + k)
                           for k in ("pack", "accumulate", "fold"))
    before = counts()
    with pytest.raises(ValueError, match="CUDA"):
        halo.halo_pack_cuda(f, M, 1e-20)
    with pytest.raises(ValueError, match="CUDA"):
        halo.window_accumulate_cuda(rc, torch.zeros((2, 2, 2, 4),
                                                    dtype=torch.float64),
                                    (0, 0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        halo.fold_halo_cuda(rc, M, (1, 1 + S))
    # the dispatchers take the plain versions for CPU tensors
    halo.halo_pack(f, M, 1e-20, pad=1)
    halo.fold_halo(rc, M, (1, 1 + S))
    assert counts() == before


def test_wrong_device_kind_on_a_gloo_group_raises(tmp_path):
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        x = torch.arange(6.0)
        # one rank: ppermute is the tensor itself, psum a copy
        assert torch.equal(comm.ppermute(x, 1), x)
        assert torch.equal(comm.psum(x), x)
        assert torch.equal(comm.all_gather(x.view(2, 3)), x.view(2, 3))
        with pytest.raises(ValueError, match="gloo"):
            comm.psum(torch.zeros(2, device="meta"))
        with pytest.raises(ValueError, match="gloo"):
            comm.exchange([(torch.zeros(2, device="meta"), 1)])
    finally:
        dist.destroy_process_group()


def test_parallel_iterations_refuse_photon_losses():
    cfg, _ = R.setup(16)
    cfg = dataclasses.replace(
        cfg, add_photon_losses=True,
        sweep=dataclasses.replace(cfg.sweep, track_band_loss=True))
    with pytest.raises(ValueError, match="add_photon_losses"):
        tdom.make_domain_iteration(ParallelConfig(cfg), 4)
    with pytest.raises(ValueError, match="add_photon_losses"):
        make_parallel_iteration(ParallelConfig(cfg))


# ---- slow: the rest of tests/test_domain.py's cases

def _launch(fn, *args, n=8):
    return launch.launch(fn, n, args=args, device="cpu", threads=1)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["lls", "full_extent", "heating"])
def test_domain_iteration_variants_match_jax(case):
    kw = {"lls": dict(radius=6, lls_col=2.0e21),
          "full_extent": dict(radius=7),
          "heating": dict(radius=5, isothermal=False, dt=3e13)}[case]
    port, conv, pl, ll = _launch(R.domain_iteration_kw_rank, kw)[0]
    s8, conv8, pl8, ll8 = _jax_domain_iteration(**kw)
    _assert_state_close(port, s8)
    np.testing.assert_allclose(pl, float(pl8), rtol=1e-11, atol=1e-30)
    np.testing.assert_allclose(ll, float(ll8), rtol=1e-11)
    assert conv == int(conv8)
    if case == "lls":
        assert ll > 0.0


@pytest.mark.slow
def test_domain_evolve3d_matches_jax_full_step():
    port, stats = _launch(R.domain_evolve3d_rank, 6)[0]
    cfg, state = _jax_setup(16, isothermal=False)
    mesh = _mesh()
    srcpos, nflux = R.STEP_SOURCES
    s8, st8 = jdom.domain_evolve3d(JParallelConfig(cfg=cfg, mesh=mesh),
                                   jdom.shard_state_slabs(state, mesh),
                                   srcpos, nflux, R.STEP_DT, radius=6)
    assert stats[0] == st8.n_iterations
    assert stats[1] == st8.conv_flag
    np.testing.assert_allclose(port["h1"], np.asarray(s8.h1), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(port["t_final"], np.asarray(s8.t_final),
                               rtol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["domain", "source"])
def test_iterdump_resume(mode, tmp_path):
    ref, res, niter_dumped = _launch(R.iterdump_resume_rank, mode,
                                     str(tmp_path))[0]
    assert niter_dumped >= 1
    assert res[1] == ref[1]
    np.testing.assert_allclose(res[0]["h1"], ref[0]["h1"], rtol=1e-10)
    # the dump is the single-device format: JAX's loader reads it
    from c2ray_tpu.io.checkpoint import load_iterdump
    from c2ray_tpu.state import GridState
    from c2ray_tpu.sweep.source_sweep import RateGrids
    assert load_iterdump(str(tmp_path), GridState, RateGrids)[0] >= 1


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["domain", "source"])
def test_run3d_parallel_matches_jax(mode, tmp_path):
    from c2ray_tpu.driver import Run3D as JRun3D
    from c2ray_tpu.driver import Run3DConfig as JRun3DConfig
    from c2ray_tpu.io.writers import OutputStreams as JStreams
    from c2ray_tpu.nbody import test_nbody as j_test_nbody
    from c2ray_tpu.sources import SourceList as JSourceList

    port = _launch(R.run3d_rank, mode, str(tmp_path / "port"), n=2)
    jcfg = JRun3DConfig(
        mesh=16, nbody=j_test_nbody(),
        sed=JSED(bb=JBB(T_eff=5.0e4, S_star=3e56)), isothermal=True,
        steps_per_slice=1, results_dir=str(tmp_path / "jax" / "results"),
        dump_dir=str(tmp_path / "jax"), streams=JStreams(),
        parallel=mode, n_devices=2)
    run = JRun3D(jcfg)
    run.init_uniform_material()
    stats = run.run_slice(0, JSourceList(srcpos=R.RUN_SOURCES[0],
                                         nflux=R.RUN_SOURCES[1]))
    h1 = np.asarray(run.state.h1)
    for r in port:
        assert r[1] == stats[0].n_iterations
        np.testing.assert_allclose(r[0], h1, rtol=1e-5, atol=1e-12)
    # only rank 0 wrote, and its files are JAX's
    pdir, jdir = tmp_path / "port" / "results", tmp_path / "jax" / "results"
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
