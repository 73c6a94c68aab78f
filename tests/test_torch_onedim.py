"""The port's 1D program equals the JAX package's.

The same problems (made from the same parameters; the random profiles
from numpy seeds) go through `c2ray_tpu.onedim` and the port's plain
version on the CPU in float64.  Tolerances:

- material, analytic fronts, the 1D config loader and the parameters:
  host numpy in both packages, equal;
- one timestep of `evolve1d` (the radial march with each shell's fixed
  point): fractions within 1e-10 relative with a 1e-12 absolute floor
  (values down to 1e-20 carry no relative digits), temperatures within
  1e-10 relative, and each shell's iteration count equal -- for the
  quadrature and tau-table rate routes, isothermal and heating, the
  "auto" quadrature blocks, the monochromatic tables and the
  cosmological test 4.  Heating runs use
  1 Myr steps, whose fixed points converge in a few rounds (longer ones
  amplify last-bit differences, ROADMAP Queue 3);
- the 1D kernel's packing of "auto" blocks (the row deal, its slot
  count, the shared memory it asks for), no card needed;
- the output file byte for byte, the photon statistics to rtol 1e-13
  (the rate fit at T differs in the last bit between XLA and PyTorch).
"""

import dataclasses
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import config as j_config
from c2ray_tpu import constants as const
from c2ray_tpu import parameters as j_parameters
from c2ray_tpu.grid import RadialGrid as JGrid
from c2ray_tpu.onedim import analytic as j_analytic
from c2ray_tpu.onedim import evolve as j_evolve
from c2ray_tpu.onedim import material as j_material
from c2ray_tpu.onedim import output as j_output
from c2ray_tpu.onedim.driver import OneDRun as JRun
from c2ray_tpu.radiation import monochromatic as j_mono
from c2ray_tpu.radiation import quadrature as j_quad
from c2ray_tpu.radiation import sed as j_sed
from c2ray_tpu_torch import config as t_config
from c2ray_tpu_torch import convert
from c2ray_tpu_torch import parameters as t_parameters
from c2ray_tpu_torch.grid import RadialGrid
from c2ray_tpu_torch.onedim import analytic as t_analytic
from c2ray_tpu_torch.onedim import evolve as t_evolve
from c2ray_tpu_torch.onedim import material as t_material
from c2ray_tpu_torch.onedim import output as t_output
from c2ray_tpu_torch.onedim.driver import OneDRun
from c2ray_tpu_torch.radiation import monochromatic as t_mono
from c2ray_tpu_torch.radiation import quadrature as t_quad
from c2ray_tpu_torch.radiation import sed as t_sed

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

kpc = const.kpc
MYR = 1e6 * const.YEAR

# (problem fields, r_out in kpc, blackbody (T_eff, S_star)) per test
# problem, the parameters of tests/test_onedim.py
_PROBLEMS = {
    1: (dict(testnum=1, dens_val=1.0e-3, temper_val=1e4), 10.0, (1e5, 5e48)),
    2: (dict(testnum=2, dens_val=1.0e-3, r_core=1.0 * kpc, temper_val=1e4),
        8.0, (1e5, 4.8e47)),
    3: (dict(testnum=3, dens_val=1.2e-3, r_core=1.0 * kpc, temper_val=1e4),
        6.0, (1e5, 4.0 * const.pi * 1.2e-3**2 * kpc**3 * const.bh00 * 4 / 3)),
    4: (dict(testnum=4, dens_val=1.87e-4 / 1000.0, temper_val=1e4,
             zred00=9.0), 700.0, (1e5, 3.0e50)),
}


def _problem(mod, testnum, **kw):
    fields, _, _ = _PROBLEMS[testnum]
    return mod.OneDProblem(**{**fields, **kw})


def _sed(mod, testnum, pl=False):
    T_eff, S_star = _PROBLEMS[testnum][2]
    return mod.SEDConfig(bb=mod.BlackBodySED(T_eff=T_eff, S_star=S_star),
                         pl=mod.PowerLawSED(index=2.5, S_star=1e48)
                         if pl else None)


def _grid(mod, testnum, mesh):
    return mod(r_in=0.0, r_out=_PROBLEMS[testnum][1] * kpc, mesh=mesh)


@pytest.mark.parametrize("testnum", [1, 2, 3, 4])
def test_init_material_matches(testnum):
    a = t_material.init_material(_problem(t_material, testnum),
                                 _grid(RadialGrid, testnum, 64))
    b = j_material.init_material(_problem(j_material, testnum),
                                 _grid(JGrid, testnum, 64))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if testnum == 4:
        assert (t_material.analytic_parameters_test4(
            _problem(t_material, 4))
            == j_material.analytic_parameters_test4(_problem(j_material, 4)))


def test_uvb_initial_fractions_match():
    kw = dict(dens_val=1.0e-4, gamma_uvb=(1e-12, 1e-13, 1e-15))
    a = t_material.init_material(_problem(t_material, 1, **kw),
                                 _grid(RadialGrid, 1, 8))
    b = j_material.init_material(_problem(j_material, 1, **kw),
                                 _grid(JGrid, 1, 8))
    # the rate fits at T enter the fixed point; XLA's and PyTorch's
    # powers may round differently in the last bit
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-13, atol=0.0)
    assert np.all(a[2][:, 1] > 0.9)


@pytest.mark.parametrize("testnum", [1, 2, 3, 4])
def test_analytic_fronts_match(testnum):
    T_eff, S_star = _PROBLEMS[testnum][2]
    pt, pj = _problem(t_analytic, testnum), _problem(j_analytic, testnum)
    kw = dict(zred=8.5, t0=3.0e15) if testnum == 4 else {}
    for t in (1.0 * MYR, 30.0 * MYR, 300.0 * MYR):
        assert (t_analytic.analytic_front(pt, S_star, t, **kw)
                == j_analytic.analytic_front(pj, S_star, t, **kw))
    assert (t_analytic.stromgren_radius(S_star, 1e-3)
            == j_analytic.stromgren_radius(S_star, 1e-3))


def test_numerical_fronts_match():
    rng = np.random.RandomState(11)
    grid = _grid(RadialGrid, 1, 64)
    for _ in range(20):
        x = np.sort(rng.uniform(0.0, 1.0, 64))[::-1].copy()
        for xl in (0.5, 0.1):
            assert (t_analytic.numerical_front(grid.x, grid.dr, x, xl)
                    == j_analytic.numerical_front(grid.x, grid.dr, x, xl))
    x = np.zeros(64)
    assert (t_analytic.numerical_front(grid.x, grid.dr, x)
            == j_analytic.numerical_front(grid.x, grid.dr, x))


def test_oned_problem_from_dict_matches():
    d = {"testnum": 4, "dens_val": 1.87e-7, "zred00": 9.0,
         "cosmology": "TEST4", "gamma_uvb": [1e-13, 0.0, 0.0],
         "isothermal": False, "clumping": 2.0}
    a, b = t_config.oned_problem_from_dict(d), j_config.oned_problem_from_dict(d)
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "cosmology":
            assert dataclasses.asdict(va) == dataclasses.asdict(vb)
        else:
            assert va == vb, f.name


def test_parameters_match():
    assert t_parameters.__all__ == j_parameters.__all__
    for name in j_parameters.__all__:
        assert getattr(t_parameters, name) == getattr(j_parameters, name), name


def test_setup_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OneDRun.setup(_problem(t_material, 1), _grid(RadialGrid, 1, 8),
                      _sed(t_sed, 1))


# variant: (test problem, isothermal, quadrature route, power law beside
# the blackbody, monochromatic tables, UV background, mesh, dt in Myr);
# the "auto" variants swap in "auto" quadrature tables
_VARIANTS = {
    "auto": (1, True, True, True, False, False, 48, 10.0),
    "auto_heating": (1, False, True, False, False, False, 32, 1.0),
    "quadrature": (1, True, True, True, False, False, 48, 10.0),
    "quadrature_heating": (1, False, True, False, False, False, 48, 1.0),
    "table": (2, True, False, True, False, True, 48, 10.0),
    "table_heating": (1, False, False, True, False, False, 32, 1.0),
    "monochromatic": (3, True, True, False, True, False, 48, 10.0),
    "test4": (4, True, True, False, False, False, 48, 5.0),
}


def _runs(variant):
    testnum, iso, quad, pl, mono, uvb, mesh, dt = _VARIANTS[variant]
    kw = dict(isothermal=iso)
    if uvb:
        kw["gamma_uvb"] = (1e-14, 1e-15, 1e-17)
    jr = JRun.setup(_problem(j_material, testnum, **kw),
                    _grid(JGrid, testnum, mesh), _sed(j_sed, testnum, pl),
                    use_quadrature=quad)
    tr = OneDRun.setup(_problem(t_material, testnum, **kw),
                       _grid(RadialGrid, testnum, mesh),
                       _sed(t_sed, testnum, pl), use_quadrature=quad,
                       device="cpu")
    if mono:
        # 30 eV photons: HI and HeI absorb (the HeI mask is 1), HeII not
        jq, _, _ = j_mono.build_monochromatic_tables(_sed(j_sed, testnum),
                                                     30.0, isothermal=iso)
        tq, _, _ = t_mono.build_monochromatic_tables(_sed(t_sed, testnum),
                                                     30.0, isothermal=iso)
        jr.ctx = dataclasses.replace(jr.ctx, tables=jq)
        jr._step_fn = j_evolve.make_evolve1d(jr.ctx)
        tr.ctx = dataclasses.replace(tr.ctx, tables=tq)
    if variant.startswith("auto"):
        jq, _, _ = j_quad.build_quadrature_tables(
            _sed(j_sed, testnum, pl), isothermal=iso, n_nodes="auto",
            dtype=jnp.float64)
        tq, _, _ = t_quad.build_quadrature_tables(
            _sed(t_sed, testnum, pl), isothermal=iso, n_nodes="auto",
            dtype=torch.float64)
        assert len({b.sigma_hat.shape[1] for b in tq.bb}) > 1
        jr.ctx = dataclasses.replace(jr.ctx, tables=jq)
        jr._step_fn = j_evolve.make_evolve1d(jr.ctx)
        tr.ctx = dataclasses.replace(tr.ctx, tables=tq)
    return jr, tr, dt * MYR


def _assert_states_close(ts, js):
    for f in ("xh", "xhe"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-10,
                                   atol=1e-12, err_msg=f)
    np.testing.assert_allclose(ts.temper.numpy(), np.asarray(js.temper),
                               rtol=1e-10, atol=0.0, err_msg="temper")
    np.testing.assert_array_equal(ts.ndens.numpy(), np.asarray(js.ndens))


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_evolve1d_plain_matches_jax(variant):
    jr, tr, dt = _runs(variant)
    for _ in range(2):
        nj = np.asarray(jr.step(dt))
        nt = tr.step(dt)
        assert nt.dtype == torch.int32
        np.testing.assert_array_equal(nt.numpy(), nj)
        _assert_states_close(tr.state, jr.state)
        c = tr.last_counters.numpy()
        np.testing.assert_array_equal(c[:2], [nj.sum(), nj.max()])
        assert c[3] >= c[2] * (c[2] > 0)
    assert tr.time == jr.time
    assert tr.grid == tr.grid.__class__(jr.grid.r_in, jr.grid.r_out,
                                        jr.grid.mesh)
    np.testing.assert_allclose(tr.ctx.vol.numpy(), np.asarray(jr.ctx.vol),
                               rtol=1e-15)
    if not _VARIANTS[variant][1]:
        # the heating runs do heat, and run the thermal sub-cycle
        assert tr.last_counters[2] > 0
        assert float(tr.state.temper.max()) > 1.5e4


@pytest.mark.parametrize("heat", [False, True])
def test_evolve1d_kernel_packs_auto_blocks(heat, monkeypatch):
    """The 1D kernel's tables of "auto" blocks (no card needed): the
    blocks of packed_band_blocks dealt as rows (`_row_deal`: every node
    once, rows of ROW_NODES nodes, 32 to a slot; the deal itself in
    tests/test_torch_oned_blocks.py), the layout int of the "auto"
    entries (the slot count), no block list, and the shared memory they
    need -- the rows, every row's incoming side, with heating the
    cooling table -- refused over the limit."""
    from c2ray_tpu_torch.cooling import setup_cooling_tables, stacked

    _, tr, _ = _runs("auto_heating" if heat else "auto")
    ctx = tr.ctx
    if heat:
        assert ctx.cooling is not None
    kt = t_evolve._pack_kernel_tables(ctx, torch.float32, "cpu")
    flat, blocks = t_quad.packed_band_blocks(ctx.tables, torch.float32, heat,
                                             ctx.has_bb, ctx.has_pl,
                                             ctx.has_qso)
    rows, slots, deal = t_evolve._row_deal(flat, blocks, heat)
    assert torch.equal(kt.bands, rows) and kt.photo is None
    assert kt.hbin is None and kt.route == "auto"
    assert kt.layout == (slots,) and slots == -(-len(deal) // 32)
    nodes = sum(d[3] for d in deal if d is not None)
    assert nodes == sum(nb * K for _, _, nb, K, _ in blocks)
    n_in = slots * t_evolve.ROW_LANES * t_evolve._row_in_values(heat)
    cool = stacked(ctx.cooling).numel() if heat else 0
    need = 4 * (rows.numel() + n_in + cool)
    monkeypatch.setattr(t_evolve.cuda_build, "SHARED_MEM_LIMIT", need)
    t_evolve._pack_kernel_tables(ctx, torch.float32, "cpu")
    monkeypatch.setattr(t_evolve.cuda_build, "SHARED_MEM_LIMIT", need - 1)
    with pytest.raises(ValueError, match=f"need {need} B of shared"):
        t_evolve._pack_kernel_tables(ctx, torch.float32, "cpu")
    assert setup_cooling_tables  # the cooling tables the heating run has


def test_evolve1d_one_step_direct():
    """evolve1d on the converted JAX context and state, outside the
    driver: the same (state, nits) and counters that add up."""
    jr, tr, dt = _runs("quadrature")
    state = convert.state1d_from_numpy(jr.state)
    js, nj = j_evolve.evolve1d(jr.ctx, jr.state, dt)
    ts, nt, counters = t_evolve.evolve1d(tr.ctx, state, dt)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    _assert_states_close(ts, js)
    assert int(counters[0]) == int(nt.sum()) and int(counters[2]) == 0
    back = convert.state1d_to_numpy(ts)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float64
               for a in back)


def test_stromgren_front_through_the_driver():
    """Test 1 of tests/test_onedim.py through OneDRun(device="cpu"): the
    front within 5% of the analytic one after 120 Myr."""
    run = OneDRun.setup(_problem(t_material, 1), _grid(RadialGrid, 1, 128),
                        _sed(t_sed, 1), device="cpu")
    run.run(120.0 * MYR, 12)
    fc = t_output.front_comparison(run)
    assert fc.relative_error < 0.05, fc


def _same_state_runs(isothermal, testnum=1):
    """A JAX run after one step, and a port run holding the same state."""
    jr = JRun.setup(_problem(j_material, testnum, isothermal=isothermal),
                    _grid(JGrid, testnum, 16), _sed(j_sed, testnum))
    before = jr.state
    jr.step(1.0 * MYR)
    tr = OneDRun.setup(_problem(t_material, testnum, isothermal=isothermal),
                       _grid(RadialGrid, testnum, 16), _sed(t_sed, testnum),
                       device="cpu")
    tr.state = convert.state1d_from_numpy(jr.state)
    tr.time, tr.grid, tr.clock = jr.time, RadialGrid(
        jr.grid.r_in, jr.grid.r_out, jr.grid.mesh), jr.clock
    return jr, tr, before


@pytest.mark.parametrize("isothermal", [True, False])
def test_write_profile_is_byte_identical(isothermal, tmp_path):
    jr, tr, _ = _same_state_runs(isothermal)
    pa = t_output.write_profile(tr, 3, str(tmp_path / "torch"))
    pb = j_output.write_profile(jr, 3, str(tmp_path / "jax"))
    assert filecmp.cmp(pa, pb, shallow=False)


def test_photon_statistics_and_front_comparison_match():
    jr, tr, before = _same_state_runs(True)
    a = t_output.photon_statistics_1d(
        tr, convert.state1d_from_numpy(before), 1.0 * MYR)
    b = j_output.photon_statistics_1d(jr, before, 1.0 * MYR)
    np.testing.assert_allclose(np.array(a), np.array(b), rtol=1e-13)
    assert a.photon_conservation > 0.0
    fa, fb = t_output.front_comparison(tr), j_output.front_comparison(jr)
    assert tuple(fa) == tuple(fb)
