"""The glue round a source group of the pyramid sweep: which of the
kernel's buffers are zeroed, what that moves, and the hand-written pass
that adds a group's rate slabs into the rate grids
(``csrc/group_accumulate.cu``).  This file imports no JAX.

CPU: the coverage rule, the counters' bytes, the plain sum.  Card
(marker `gpu`, skipped without CUDA): buffers the kernel overwrites
hold NaN before the launches and the outputs are the zero-filled run's
bits; the pass against the sum in source order and against torch's
masked sum; two runs equal to the bit.  On the card:

    python -m pytest --noconftest tests/test_torch_group_accumulate.py -m gpu
"""

import dataclasses

import numpy as np
import pytest
import torch

from c2ray_tpu_torch import constants as const
from c2ray_tpu_torch.parallel.domain import _window_geometry
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
from c2ray_tpu_torch.state import initial_grid_state
from c2ray_tpu_torch.sweep import SourceFields, SweepConfig, pyramid_sweep
from c2ray_tpu_torch.utils.clocks import counter

torch.set_num_threads(1)

ps = pyramid_sweep


# -- the rule and the counters (CPU) -----------------------------------------

@pytest.mark.parametrize("M, Rf, Rb, covers", [
    (250, 125, 124, True), (250, 124, 124, False), (250, 64, 64, False),
    (16, 8, 7, True), (16, 7, 7, False), (16, 0, 0, False),
    # the stage kernels sweep the layers 1..Rf only
    (16, 7, 8, False)])
def test_coverage_rule(M, Rf, Rb, covers):
    assert ps.covers_cube(M, Rf, Rb) == covers
    assert ("slab" in ps.zeroed_buffers(M, Rf, Rb, False)) != covers


@pytest.mark.parametrize("M, radius", [(250, None), (250, 125), (250, 124),
                                       (16, 8), (16, 3)])
def test_extents_cover_the_cube_from_half_the_mesh(M, radius):
    Rf, Rb = ps.trace_extents(M, radius)
    assert ps.covers_cube(M, Rf, Rb) == (radius is None or radius >= M // 2)


@pytest.mark.parametrize("M, radius", [(64, 3), (64, 31), (16, 7), (16, 8)])
def test_domain_window_zeroes_its_slab_unless_it_is_the_cube(M, radius):
    """The domain mode traces a window cube of Mw = min(2r + 2, M) cells
    over [-Rb, Rf]: one plane per axis stays outside the extents unless
    the window is the whole cube at full radius, so its slab stays
    zeroed."""
    Mw, Rb, _ = _window_geometry(M, radius)
    Rf, _ = ps.trace_extents(Mw, radius)
    assert ps.covers_cube(Mw, Rf, Rb) == (Mw == M and radius >= M // 2)


def _shapes(S, M, nslots, nb, track):
    """The sweep kernel's buffers by name, as `trace_cuda` allocates
    them."""
    shapes = dict(cd=(S, M, M, M, 3), slab=(S, M**3, 4),
                  partials=(S, nslots, 2))
    if track:
        shapes["band_partials"] = (S, nslots, nb)
    return shapes


@pytest.mark.parametrize("radius, track", [(None, False), (64, False),
                                           (None, True), (0, False)])
def test_group_glue_bytes(radius, track):
    """A group of 8 float32 sources at 250^3: a covering group zeroes
    nothing but the tracked band escape, a subbox group its 2 GB slab."""
    M, S, itemsize, nb = 250, 8, 4, 47
    Rf, Rb = ps.trace_extents(M, radius)
    nslots = 100
    shapes = _shapes(S, M, nslots, nb, track)
    zeroed = ps.zeroed_buffers(M, Rf, Rb, track)
    slab_b = S * M**3 * 4 * itemsize
    band_b = S * nslots * nb * itemsize if track else 0
    want = {None: band_b, 64: slab_b, 0: slab_b + S * nslots * 2 * itemsize}
    assert ps.zeroed_bytes(shapes, zeroed, itemsize) == want[radius]
    assert slab_b == 2 * 10**9
    assert set(zeroed) <= set(shapes)


@pytest.mark.parametrize("radius", [None, 3])
def test_summed_bytes_count_every_slab_of_a_group(radius):
    """The sum's counter takes every slab of a group, a source without
    flux included, at any radius: groups of 3 and 2 of 5 sources at
    8^3 in float64 count 5 slabs."""
    M, S = 8, 5
    cfg = dataclasses.replace(_sweep_config(M, torch.float64, "cpu", False),
                              source_chunk=3)
    fields, srcpos, nflux, _ = _inputs(M, S, torch.float64, "cpu",
                                       dead=(1,))
    before = counter("sweep.summed_bytes")
    ps.sweep_pyramid_source_batch(cfg, fields, srcpos, nflux, radius)
    assert counter("sweep.summed_bytes") - before == S * M**3 * 4 * 8


def test_sweep_buffers_zero_what_they_name():
    shapes = _shapes(2, 4, 3, 5, True)
    buf = ps.sweep_buffers(shapes, ("slab", "band_partials"), torch.float32,
                           "cpu")
    assert {n: tuple(t.shape) for n, t in buf.items()} == shapes
    assert all(t.dtype == torch.float32 for t in buf.values())
    assert not buf["slab"].any() and not buf["band_partials"].any()


def test_plain_sum_drops_what_live_drops():
    g = torch.Generator().manual_seed(3)
    slab = torch.rand((3, 10, 4), generator=g, dtype=torch.float64)
    slab[1] = float("nan")
    rg = torch.rand((10, 4), generator=g, dtype=torch.float64)
    live = torch.tensor([True, False, True])
    out = ps.accumulate_group_plain(rg, slab, live)
    torch.testing.assert_close(out, rg + slab[0] + slab[2], rtol=1e-15,
                               atol=0.0)


def test_group_sum_kernel_refuses_cpu_tensors():
    before = counter("launches.group_accumulate")
    with pytest.raises(ValueError):
        ps.accumulate_group_cuda(torch.zeros(4, 4), torch.zeros(1, 4, 4),
                                 torch.ones(1, dtype=torch.bool))
    assert counter("launches.group_accumulate") == before


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def _sweep_config(M, dtype, device, heating):
    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5e4, S_star=1e48)),
        isothermal=not heating, dtype=dtype, device=device)
    return SweepConfig(tables=tables, mesh=M, dr=50.0 * const.kpc / M,
                       isothermal=not heating, flux_scale=bands.flux_scale)


def _inputs(M, S, dtype, device, seed=5, dead=()):
    """Fields of a random partly ionized state, S sources (those in
    `dead` with zero flux) and a per-cell LLS grid."""
    rng = np.random.RandomState(seed)
    n = M**3
    he1 = rng.uniform(0.0, 0.5, n)
    st = initial_grid_state(10.0 ** rng.uniform(-4, -2, n),
                            rng.uniform(0.0, 0.8, n), he1,
                            rng.uniform(0.0, 0.3, n) * (1.0 - he1), 1.0e4,
                            dtype=dtype, device=device)
    fields = SourceFields(st.ndens, st.h_av0, st.h_av1, st.he_av0,
                          st.he_av1)
    srcpos = rng.randint(0, M, size=(S, 3))
    srcpos[0] = (0, M - 1, M // 3)
    nflux = np.concatenate([rng.uniform(0.5, 2.0, (S, 1)),
                            np.zeros((S, 2))], axis=1)
    nflux[list(dead)] = 0.0
    lls = torch.as_tensor(10.0 ** rng.uniform(14.0, 17.0, n), dtype=dtype,
                          device=device)
    return (fields, torch.as_tensor(srcpos, device=device),
            torch.as_tensor(nflux, dtype=dtype, device=device), lls)


def _filled(value, only_unzeroed):
    """`sweep_buffers` with its buffers filled with `value`: the ones it
    leaves unzeroed, or all of them."""
    real = ps.sweep_buffers

    def buffers(shapes, zeroed, dtype, device):
        buf = real(shapes, zeroed, dtype, device)
        for n, t in buf.items():
            if not (only_unzeroed and n in zeroed):
                t.fill_(value)
        return buf
    return buffers


# extents of a 16^3 trace: the whole cube, a subbox, the domain mode's
# window cube (8^3 at radius 3: one plane per axis outside the extents)
_EXTENTS = {"cube": (16, None), "subbox": (16, 4), "window": (8, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("lls", [False, True])
@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("extents", sorted(_EXTENTS))
def test_unzeroed_buffers_are_written_before_read(cuda_device, monkeypatch,
                                                  extents, dtype, heating,
                                                  lls, S):
    """cd, the partials and (covering) the slab filled with NaN before
    the launches: slab and losses are the zero-filled run's bits, and
    the counters count what was zeroed."""
    M, radius = _EXTENTS[extents]
    cfg = _sweep_config(M, dtype, cuda_device, heating)
    fields, srcpos, nflux, lls_grid = _inputs(M, S, dtype, cuda_device)
    fstack = ps.stack_sweep_fields(cfg, fields)
    Rf, Rb = ps.trace_extents(M, radius)
    kw = dict(lls=lls_grid) if lls else {}
    monkeypatch.setattr(ps, "sweep_buffers", _filled(0.0, False))
    ref = ps.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb, **kw)
    monkeypatch.setattr(ps, "sweep_buffers", _filled(float("nan"), True))
    names = ("sweep.zeroed_bytes", "sweep.covering_groups")
    before = [counter(n) for n in names]
    out = ps.trace_cuda(cfg, fstack, srcpos, nflux, Rf, Rb, **kw)
    covers = extents == "cube"
    itemsize = fstack.element_size()
    assert [counter(n) - b for n, b in zip(names, before)] == [
        0 if covers else S * M**3 * 4 * itemsize, int(covers)]
    if heating:
        assert float(ref[0][..., 3].abs().max()) > 0.0
    if lls:
        assert float(ref[2].abs().max()) > 0.0
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)


def _in_order(rg, slab, live):
    """The sum in source order, then into rg."""
    acc = torch.zeros_like(rg)
    for s in range(slab.shape[0]):
        acc = acc + torch.where(live[s], slab[s], 0.0)
    return rg + acc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("extents", ["cube", "subbox", "random"])
def test_group_sum_kernel_matches_the_masked_sum(cuda_device, dtype,
                                                 extents):
    """Slabs of 8 sources, two of them without flux (NaN in one of
    theirs: a dropped slab is never read), added into nonzero grids:
    the kernel equals the sum in source order to the bit, and torch's
    masked sum (another order) within a few roundings."""
    S = 8
    if extents == "random":
        g = torch.Generator(device=cuda_device).manual_seed(11)
        slab = torch.rand((S, 24**3, 4), generator=g, dtype=dtype,
                          device=cuda_device)
        live = torch.ones(S, dtype=torch.bool, device=cuda_device)
        live[[2, 5]] = False
    else:
        M, radius = _EXTENTS[extents]
        cfg = _sweep_config(M, dtype, cuda_device, True)
        fields, srcpos, nflux, _ = _inputs(M, S, dtype, cuda_device,
                                           dead=(2, 5))
        fstack = ps.stack_sweep_fields(cfg, fields)
        slab = ps.trace_cuda(cfg, fstack, srcpos, nflux,
                             *ps.trace_extents(M, radius))[0]
        live = torch.any(nflux > 0.0, dim=1)
    slab[5] = float("nan")
    rg = torch.rand(slab.shape[1:], dtype=dtype, device=cuda_device) * float(
        slab[live].abs().max())
    want = _in_order(rg, slab, live)
    masked = ps.accumulate_group_plain(rg, slab, live)
    before = counter("launches.group_accumulate")
    got = ps.accumulate_group_cuda(rg.clone(), slab, live)
    assert counter("launches.group_accumulate") == before + 1
    assert torch.equal(got, want)
    eps = torch.finfo(dtype).eps
    torch.testing.assert_close(got, masked, rtol=4 * S * eps, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [None, 4])
def test_two_sweeps_are_the_same_bits(cuda_device, radius):
    """Three groups (source_chunk 3 of 8 sources, one without flux) at
    the cube's and a subbox's extents: two sweeps give the same bits,
    and the group sums count one launch a group."""
    M, S = 16, 8
    cfg = dataclasses.replace(
        _sweep_config(M, torch.float32, cuda_device, True), source_chunk=3)
    fields, srcpos, nflux, lls = _inputs(M, S, torch.float32, cuda_device,
                                         dead=(4,))
    before = counter("launches.group_accumulate")
    a = ps.sweep_pyramid_source_batch(cfg, fields, srcpos, nflux, radius,
                                      lls_grid=lls)
    b = ps.sweep_pyramid_source_batch(cfg, fields, srcpos, nflux, radius,
                                      lls_grid=lls)
    assert counter("launches.group_accumulate") == before + 6
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x, y)
    assert float(a.phiheat.abs().max()) > 0.0
