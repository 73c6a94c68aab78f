"""What the chemistry and photon-loss kernels are handed, checked on the
CPU (no card): the photon-loss kernel's constant-bank band table, the
chemistry kernel's input rows and its cooling table, and the evidence
that chip_smoke.py and tools/profile_torch_iteration.py compute around
them (the chemistry bound from counted work, the SASS mixes, the warp
efficiency, the stamped copy of the kernel and the variants timed
against it).  This file imports no JAX.
"""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from c2ray_tpu_torch import cuda_build
from c2ray_tpu_torch.cooling import setup_cooling_tables, stacked
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig
from c2ray_tpu_torch.radiation.quadrature import build_quadrature_tables
from c2ray_tpu_torch.state import initial_grid_state
from c2ray_tpu_torch.sweep import ChemistryConfig, global_pass
from c2ray_tpu_torch.sweep import photon_losses as pls
from c2ray_tpu_torch.sweep.source_sweep import RateGrids

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
import kernel_study as ks  # noqa: E402
import profile_torch_iteration as pti  # noqa: E402


def _tables(nb):
    """QuadTables of the 47 bands, or the first `nb` bands of them."""
    tables = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=5.0e4, S_star=1.0e48)),
        isothermal=True, dtype=torch.float64)[0]
    if nb == tables.sigma_HI.shape[0]:
        return tables
    return types.SimpleNamespace(**{
        k: getattr(tables, k)[:nb] for k in ("sigma_HI", "sigma_HeI",
                                             "mask_HeI", "sigma_HeII",
                                             "mask_HeII")})


def _constant(name, path):
    text = (cuda_build.CSRC / path).read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb", [47, 5])
def test_band_table_packs_scaled_sigma_and_weights(nb, dtype):
    """The photon-loss kernel's band table: its first nb rows are
    scaled_sigma_and_weights' sig.T and W to the bit, the rest padding
    rows (1, 1, 1, 0, 0, 0), in groups of BAND_GROUP rows; the scaled
    cross sections are built once per tables."""
    tables = _tables(nb)
    plb = torch.as_tensor(np.random.RandomState(3).uniform(0.0, 2.0, nb),
                          dtype=dtype)
    n, vos = 4096, 3.7e-3
    tab = pls.band_table(tables, plb, n, vos, dtype)
    sig, W = pls.scaled_sigma_and_weights(tables, plb, n, vos, dtype)
    rows = -(-nb // pls.BAND_GROUP) * pls.BAND_GROUP
    assert tab.shape == (rows, 6) and tab.dtype == dtype
    assert torch.equal(tab[:nb, :3], sig.T) and torch.equal(tab[:nb, 3:], W)
    pad = torch.tensor((1.0, 1.0, 1.0, 0.0, 0.0, 0.0),
                       dtype=dtype).expand(rows - nb, 6)
    assert torch.equal(tab[nb:], pad)
    assert pls._scaled_sigma(tables) is pls._scaled_sigma(tables)


def test_band_table_refuses_more_bands_than_the_constant_bank():
    """MAX_BANDS and BAND_GROUP are the kernel's kMaxBands and
    kBandGroup; a table of more bands raises, it is not cut."""
    assert pls.BAND_GROUP == int(_constant("kBandGroup", "photon_losses.cu"))
    assert pls.MAX_BANDS == pls.BAND_GROUP * int(
        _constant("kMaxGroups", "photon_losses.cu"))
    nb = pls.MAX_BANDS + 1
    base = _tables(47)
    tables = types.SimpleNamespace(**{
        k: torch.cat([getattr(base, k), getattr(base, k)])[:nb]
        for k in ("sigma_HI", "sigma_HeI", "mask_HeI", "sigma_HeII",
                  "mask_HeII")})
    with pytest.raises(ValueError, match="at most 48 bands"):
        pls.band_table(tables, torch.ones(nb, dtype=torch.float64), 8, 1.0,
                       torch.float32)


def test_chemistry_kernel_rows_follow_the_kernel_order():
    """kernel_rows hands the kernel the state's and the rates' own
    tensors (strided views too) in CHEM_ROWS order, and CHEM_ROWS is
    the order of csrc/chemistry.cu's Row enum and row comment."""
    text = (cuda_build.CSRC / "chemistry.cu").read_text()
    enum = dict(re.findall(r"k(\w+) = (\d+)",
                           re.search(r"enum Row \{([^}]*)\}", text).group(1)))
    names = {"Ndens": "ndens", "H0": "h0", "HAv0": "h_av0",
             "HeAv0": "he_av0", "HeAv2": "he_av2", "HInt0": "h_int0",
             "TAv": "t_av", "PhiH": "phih", "PhiHe0": "phihe0",
             "PhiHe1": "phihe1", "TFinal": "t_final", "PhiHeat": "phiheat",
             "Clump": "clumping"}
    assert {global_pass.CHEM_ROWS[int(v)] for v in enum.values()} == set(
        names[k] for k in enum)
    for k, v in enum.items():
        assert global_pass.CHEM_ROWS[int(v)] == names[k]
    assert int(re.search(r"constexpr int kRows = (\d+);", text).group(1)) \
        == len(global_pass.CHEM_ROWS)
    n = 64
    state = initial_grid_state(np.full(n, 1e-3), 0.1, 0.05, 0.01, 1.0e4,
                               dtype=torch.float64)
    slab = torch.rand((n, 4), dtype=torch.float64)
    rates = RateGrids(slab[:, 0], slab[:, 1], slab[:, 2], slab[:, 3],
                      torch.zeros(()), torch.zeros(()))
    rows = global_pass.kernel_rows(state, rates)
    for name, r in zip(global_pass.CHEM_ROWS, rows):
        assert r is getattr(rates if name.startswith("phi") else state, name)
    assert [r.stride(0) for r in rows[17:20]] == [4, 4, 4]


def test_kernel_cooling_table_is_built_once():
    """The heating kernel's cooling table: cooling.stacked in the
    dtype, built once per cooling tables, dtype and device."""
    cfg = ChemistryConfig(isothermal=False,
                          cooling=setup_cooling_tables(torch.float64))
    a = global_pass.kernel_cooling_table(cfg, torch.float32, "cpu")
    assert a is global_pass.kernel_cooling_table(cfg, torch.float32,
                                                 torch.device("cpu"))
    b = global_pass.kernel_cooling_table(cfg, torch.float64, "cpu")
    assert b is not a and b.dtype == torch.float64
    assert torch.equal(a, stacked(cfg.cooling).to(torch.float32))
    other = ChemistryConfig(isothermal=False,
                            cooling=setup_cooling_tables(torch.float64))
    assert global_pass.kernel_cooling_table(other, torch.float32,
                                            "cpu") is not a


# a fixed-point loop (header 0x20) with two MUFU and a double FMA around
# an inner loop (header 0x40) that reads shared memory
_SASS_CHEM = """
        Function : _Z4chemPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   MOV R1, RZ ;
        /*0020*/                   MUFU.EX2 R3, R2 ;
        /*0030*/                   FFMA R4, R3, R3, R4 ;
        /*0040*/                   LDS R5, [R6] ;
        /*0050*/                   FADD R5, R5, 1 ;
        /*0060*/                   ISETP.GE.AND P0, PT, R5, 0x4, PT ;
        /*0070*/              @!P0 BRA 0x40 ;
        /*0080*/                   MUFU.RCP R7, R4 ;
        /*0090*/                   DFMA R8, R8, R8, R8 ;
        /*00a0*/                   ISETP.GE.AND P1, PT, R1, 0x3, PT ;
        /*00b0*/              @!P1 BRA 0x20 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0;
"""
# two bands unrolled whole, after an early exit of the idle threads
_SASS_BANDS = """
        Function : _Z5bandsPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   LDG.E R2, [R4] ;
        /*0040*/                   FMUL R3, R2, c[0x3][0x0] ;
        /*0050*/                   FFMA R3, R2, c[0x3][0x4], R3 ;
        /*0060*/                   MUFU.RCP R5, R3 ;
        /*0070*/                   FFMA R6, R5, c[0x3][0xc], R6 ;
        /*0080*/                   FMUL R3, R2, c[0x3][0x18] ;
        /*0090*/                   FFMA R3, R2, c[0x3][0x1c], R3 ;
        /*00a0*/                   MUFU.RCP R5, R3 ;
        /*00b0*/                   FFMA R6, R5, c[0x3][0x24], R6 ;
        /*00c0*/                   STG.E [R4], R6 ;
        /*00d0*/                   EXIT ;
"""


def test_sass_mixes_of_the_redesigned_kernels():
    """sass_loop_mix: one pass through the innermost loop with an
    MUFU.EX2 (the inner loop once), the inner loop with an LDS, the path
    from the entry to EXIT; sass_per_band: the unrolled bands' path over
    its MUFU.RCP count."""
    mix = ks.sass_loop_mix(_SASS_CHEM, "ex2", "lds")
    assert {k: mix["loop"][k] for k in ("total", "fp32", "fp64", "mufu",
                                        "ex2", "rcp", "lds")} == dict(
        total=10, fp32=2, fp64=1, mufu=2, ex2=1, rcp=1, lds=1)
    assert (mix["inner"]["total"], mix["inner"]["lds"]) == (4, 1)
    assert mix["whole"]["total"] == 13
    band, per_pass = ks.sass_per_band(_SASS_BANDS)
    assert per_pass == 2
    assert {k: band[k] for k in ("total", "fp32", "rcp", "ldg", "stg",
                                 "lds")} == dict(total=7.0, fp32=3.0,
                                                 rcp=1.0, ldg=0.5, stg=0.5,
                                                 lds=0.0)


@pytest.mark.parametrize("heat", [False, True])
def test_chemistry_bound_counts_the_work(heat):
    """chemistry_bound: per iteration the fixed-point loop's arithmetic
    less one sub-step's, per sub-step the inner loop's (float32-pipe
    instructions less FCHK, float64, special-function), the fewer of this
    build's and the parent's (PARENT_CHEM_MIX) per pipe, at 128 issued,
    64 float64 and 16 special-function instructions per SM and clock;
    against the bytes of 20 (22) rows read and 12 written."""
    mix = ks.sass_loop_mix(_SASS_CHEM, "ex2", "lds" if heat else None)
    # the listing: a pass FFMA FADD (fp32), DFMA, MUFU.EX2 MUFU.RCP; the
    # sub-step FADD
    per_it = (dict(fp32=1, fp64=1, mufu=2) if heat
              else dict(fp32=2, fp64=1, mufu=2))
    per_sub = dict(fp32=1, fp64=0, mufu=0) if heat else dict.fromkeys(
        per_it, 0)
    assert chip_smoke.chem_arithmetic(mix["loop"], mix["inner"]) == (
        per_it, per_sub)
    # the fewer per pipe: the parent's kernel has no float64
    ploop, pinner = chip_smoke.PARENT_CHEM_MIX[heat]
    assert ploop["fp64"] == 0 and (pinner or ploop)["fp64"] == 0
    per_it["fp64"] = per_sub["fp64"] = 0
    per_s = 132 * chip_smoke.SM_CLOCK_HZ
    n, subs = 1000, 3 * 10 ** 9 if heat else 0
    for its in (4000, 10 ** 9):
        c = {k: its * per_it[k] + subs * per_sub[k] for k in per_it}
        want_ops = max(sum(c.values()) / (128 * per_s),
                       c["fp64"] / (64 * per_s), c["mufu"] / (16 * per_s))
        want_mem = (4 * n * ((22 if heat else 20) + 12)
                    / chip_smoke.HBM_BYTES_PER_S)
        ms, by = chip_smoke.chemistry_bound(n, heat, its, subs, mix)
        assert ms == pytest.approx(1e3 * max(want_ops, want_mem), rel=1e-12)
        assert by == ("bytes" if want_mem >= want_ops else "operations")
    assert by == "operations"
    # a build with more instructions than the parent's: the parent's
    # arithmetic bounds it, FCHK left out
    big = {k: dict(dict.fromkeys(ks.MIX_KEYS, m * 10 ** 4), fchk=0)
           for k, m in (("loop", 2), ("inner", 1))}
    if not heat:
        big["inner"] = None
    loop, inner = chip_smoke.PARENT_CHEM_MIX[heat]
    inner = inner or dict.fromkeys(loop, 0)
    its = 10 ** 9
    c = {k: its * (loop[k] - inner[k]) + subs * inner[k]
         for k in ("fp32", "fchk", "fp64", "mufu")}
    want = max((c["fp32"] - c["fchk"] + c["fp64"] + c["mufu"])
               / (128 * per_s), c["fp64"] / (64 * per_s),
               c["mufu"] / (16 * per_s))
    assert chip_smoke.chemistry_bound(n, heat, its, subs, big) == (
        pytest.approx(1e3 * want, rel=1e-12), "operations")


def test_warp_efficiency_and_histogram():
    """The warp efficiency of per-cell work in cell order (a last warp
    padded with idle lanes) and the power-of-two histogram."""
    work = torch.tensor([1] * 31 + [3] + [2] * 32 + [5])
    assert ks.warp_efficiency(work) == pytest.approx(
        (34 + 64 + 5) / (32 * (3 + 2 + 5)))
    assert ks.warp_efficiency(torch.zeros(64)) == 1.0
    assert ks.histogram(torch.tensor([0, 1, 2, 3, 4, 9, 17])) == {
        "0": 1, "1": 1, "2-3": 2, "4-7": 1, "8-15": 1, "16-31": 1}


def test_chemistry_split_stamps_fit_the_kernel():
    """tools/profile_torch_iteration.py --chem and chip_smoke.py's phase
    23 time the parts of the chemistry kernel in a copy of
    csrc/chemistry.cu (tools/kernel_study.py) with clock64()
    stamps: each stamp finds its one place in the kernel as it stands,
    the stamps run in the order of an iteration, and the copy is the
    kernel plus the stamps; a kernel without a stamp's place raises."""
    src = (cuda_build.CSRC / "chemistry.cu").read_text()
    assert ks.chem_layout(src) == "this"
    out = ks.stamp_chemistry(src)
    body = out[out.index("CHEM_SPLIT_INIT();"):out.index(
        "CHEM_SPLIT_STORE();")]
    assert re.findall(r"CHEM_SPLIT\((\w+)\);", body) == [
        "kChemLoads", "kChemFits", "kChemDoric", "kChemBlend",
        "kChemThermal", "kChemConv", "kChemStores", "kChemLoads"]
    assert [p.lower() for p in ks._CHEM_STAMPS["this", True]] == [
        "loads", "fits", "doric", "blend", "thermal", "convergence",
        "stores", "loads"]
    bare = re.sub(r"\n *(CHEM_SPLIT(_INIT|_STORE)?\(\w*\)|CHEM_CELL\([^)]*\)"
                  r"|chem_sub \+= th\.nsub);", "",
                  out.replace(ks._CHEM_DEFS, "")
                  .replace(ks._CHEM_ENTRY, ""))
    assert bare == src
    with pytest.raises(RuntimeError, match="places for a stamp"):
        ks.stamp_chemistry(src.replace("if (!work) continue;",
                                        "if (!work) { continue; }"))


@pytest.mark.parametrize("name", sorted(pti.CHEM_VARIANTS))
def test_chemistry_variants_apply_to_the_kernel(name):
    """Each variant that --chem --variants times is a set of edits that
    each find their one place in csrc/ as it stands (the knobs it flips
    live only in the copy it builds), and changes the kernel's source."""
    src = {f: (cuda_build.CSRC / f).read_text()
           for f in ("chemistry.cu", "chemistry.cuh")}
    out = dict(src)
    pti.apply_chem_variant(name, out.__getitem__, out.__setitem__)
    assert out != src
    with pytest.raises(RuntimeError, match="places in"):
        pti.apply_chem_variant(name, lambda f: "", out.__setitem__)


def test_chip_smoke_does_not_import_the_profiling_tool():
    """chip_smoke.py and tools/profile_torch_iteration.py share
    tools/kernel_study.py, which imports neither; chip_smoke.py does not
    import the tool."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "import kernel_study; "
            "assert 'profile_torch_iteration' not in sys.modules; "
            "print(sorted(m for m in sys.modules if m.startswith('jax')))")
    r = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
    text = open(os.path.join(ROOT, "tools", "kernel_study.py")).read()
    assert not re.search(r"^\s*(import|from) (chip_smoke|profile_torch_iteration)",
                         text, re.M)


def test_comparable_sass_drops_the_layout_only(monkeypatch):
    """Two builds' listings compare equal when cuobjdump lays them out
    apart (column padding, blank lines, zero-padded addresses, the
    anonymous namespace's hash) and unequal when an instruction,
    operand or encoding differs."""
    ins = ("/*{a}*/{p}LDC R1, c[0x0][0x28] ;{q}/* 0x00000a00ff017b82 */\n"
           "{p2}/* 0x000e220000000800 */\n")
    parent = ("_ZN5c2ray12_GLOBAL__N__1a2b3c4d_shell_sweep_cu_0f1e2d3c"
              "1fEv\n" + ins.format(a="0000", p=" " * 19, q=" " * 46,
                                   p2=" " * 99) + "\n")
    mine = ("_ZN5c2ray12_GLOBAL__N__9z8y7x6w_shell_sweep_cu_a0b1c2d3"
            "1fEv\n" + ins.format(a="00000", p=" " * 23, q=" " * 50,
                                  p2=" " * 103) + "\n\n\n")
    listings = {"parent": parent, "mine": mine,
                "other": mine.replace("0x28", "0x30")}
    monkeypatch.setattr(ks, "kernel_sass", lambda path: {
        listings[path].split(None, 1)[0]: listings[path]})
    a, b, c = (ks.comparable_sass(k) for k in ("parent", "mine", "other"))
    assert list(a) == list(b) == list(c)
    assert a == b and a != c


def test_comparable_sass_names_the_earlier_source_cell_kernel(monkeypatch):
    """An earlier build's source_cell_kernel<T, kHeat> compares with this
    build's fixed-rule source_cell_kernel<T, kHeat, 0>, not with its
    route instantiations (kK = -1, -2)."""
    body = "\n        /*0000*/ EXIT ; /* 0x000000000000794d */\n"
    old = "_ZN5c2ray12_GLOBAL__N_118source_cell_kernelIfLb1EEEvNS0_6ParamsIT_EE"
    new = {k: old.replace("Lb1EEEv", f"Lb1ELi{k}EEEv")
           for k in ("0", "n1", "n2")}
    listings = {"parent": {old: old + body},
                "mine": {n: n + body for n in new.values()}}
    monkeypatch.setattr(ks, "kernel_sass", lambda path: listings[path])
    theirs, mine = ks.comparable_sass("parent"), ks.comparable_sass("mine")
    assert list(theirs) == [new["0"]]
    assert theirs[new["0"]] == mine[new["0"]]
    assert len(mine) == 3


@pytest.mark.parametrize("heating", [False, True])
def test_table_bound_counts_the_live_bands(heating):
    """The tau-table sweep kernels loop over the bands from the first to
    the last nonzero table column (TableRoute.live, passed in the route
    ints), which for a blackbody is its band range (_bb_band_limits);
    chip_smoke.table_bound counts its operations over those bands and
    its bytes over the nonzero columns only."""
    from c2ray_tpu_torch.radiation.bands import make_bands
    from c2ray_tpu_torch.radiation.tables import (_bb_band_limits,
                                                  packed_table_route)
    from c2ray_tpu_torch.sweep import source_sweep as ss

    cfg, sed = chip_smoke.setup(8, *chip_smoke.BENCH_SOURCE, torch.float64,
                                "cpu", heating, tables="tau")
    tr = packed_table_route(cfg.sweep.tables, torch.float64, "cpu", heating)
    lo, hi = _bb_band_limits(make_bands(), sed.bb.h_over_kT)
    assert tr.live == (lo, hi + 1)
    nb = tr.rows.shape[0]
    assert 0 < hi + 1 - lo < nb
    kt = ss._kernel_tables(cfg.sweep, torch.float64)
    ints = ss._route_args(kt)[2]
    assert ints[0] == ss.ROUTE_TABLE and list(ints[8:10]) == [lo, hi + 1]

    S, R = 2, 4
    cells = S * (2 * R) ** 3
    nlive = hi + 1 - lo
    flops = nlive * (sum(chip_smoke.TABLE_FLOPS) + (
        sum(chip_smoke.TABLE_HEAT_FLOPS) if heating else 0))
    tables = (2001 * nlive * 2
              + (2001 * int(tr.heat.ne(0).any(dim=-2).sum())
                 if heating else 0))
    nbytes = 4 * (8**3 * 5 + S * 8**3 * 4 + tables)
    want = chip_smoke.bound(nbytes, cells * flops,
                            cells * nlive * chip_smoke.TABLE_SFU)
    assert chip_smoke.table_bound(cfg.sweep, S, R, R - 1) == want


def test_earlier_sweep_entries_drop_the_route_arguments():
    """tools/profile_torch_iteration.py drives a sweep library built
    before the rate routes through this tree's wrappers: its sweep
    entries get the call without the four route pointers, the stream
    last; other entries pass through unchanged."""
    calls = []

    class Fn:
        def __call__(self, *args):
            calls.append(args)
            return 0

    lib = types.SimpleNamespace(pyramid_sweep_f32=Fn(),
                                pyramid_sweep_slots=Fn())
    entries = pti.EarlierSweepEntries(lib)
    fn = entries.pyramid_sweep_f32
    fn.argtypes = ["p"] * 3 + ["route", "photo", "heat", "hbin", "stream"]
    fn.restype = int
    assert lib.pyramid_sweep_f32.argtypes == ["p"] * 3 + ["stream"]
    assert lib.pyramid_sweep_f32.restype is int
    assert fn(1, 2, 3, "r", "ph", "h", "hb", "s") == 0
    assert calls[-1] == (1, 2, 3, "s")
    assert entries.pyramid_sweep_slots is lib.pyramid_sweep_slots


def test_kernel_ms_outlives_a_profiler_without_records(monkeypatch):
    """chip_smoke.py's device times survive a tracer that keeps no
    record of a launch: launch_profile raises, or with required=False
    returns None, after its windows; kernel_ms then times the call with
    CUDA events (queued_ms) and says so."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    fn = lambda: calls.append(1)
    with pytest.raises(AssertionError, match="saw 0 launches of nothing"):
        chip_smoke.launch_profile(fn, "nothing", 1, windows=2)
    assert len(calls) == 1 + 2 * 2
    assert chip_smoke.launch_profile(fn, "nothing", 3, windows=1,
                                     required=False) is None
    monkeypatch.setattr(chip_smoke, "queued_ms", lambda f: 1.5)
    assert chip_smoke.kernel_ms(fn, "nothing") == (1.5, "CUDA events")
    monkeypatch.setattr(chip_smoke, "launch_profile",
                        lambda f, k, n, required: ([0.25], 0.25))
    assert chip_smoke.kernel_ms(fn, "nothing") == (0.25, "torch.profiler")


@pytest.mark.parametrize("name", sorted(pti.ROUTE_VARIANTS))
def test_route_variants_apply_to_the_kernel(name):
    """Each knock-out copy or lane count that --route times is a set of
    edits that finds its one place in csrc/ as it stands (the knobs live
    only in the copy it builds) and changes the source; csrc/ that has
    none of the places raises."""
    files = sorted({e[0] for alts in pti.ROUTE_VARIANTS.values()
                    for edits in alts for e in edits})
    src = {f: (cuda_build.CSRC / f).read_text() for f in files}
    out = dict(src)
    pti.apply_route_variant(name, out.__getitem__, out.__setitem__)
    assert out != src
    with pytest.raises(RuntimeError, match="no set of edits"):
        pti.apply_route_variant(name, lambda f: "", out.__setitem__)


def test_lane_node_terms_deal_each_block():
    """--route's node terms per lane: the bands of each block dealt to
    the lanes from lane 0 (the design before the node groups): the
    bench's blocks give 69 and 57 at two lanes."""
    blocks = [(0, 0, 1, 12, 0), (0, 1, 26, 3, 0), (0, 27, 6, 6, 0)]
    assert pti.lane_node_terms(blocks, 2) == [69, 57]
    assert pti.lane_node_terms(blocks, 1) == [126]


@pytest.mark.parametrize("route", ["tau", "auto", "quad"])
def test_parent_route_tables_and_arguments(route):
    """kernel_study.parent_route_tables / parent_route_args give the
    parent build's (commit 91213d1) tables and arguments: the unpacked
    tau tables with their hbin pointer, the blocks of
    packed_band_blocks, the fixed rule as this tree's; parent_sweeps
    swaps them into the sweep modules and back."""
    from c2ray_tpu_torch.radiation.quadrature import packed_band_blocks
    from c2ray_tpu_torch.sweep import octant_sweep, pyramid_sweep
    from c2ray_tpu_torch.sweep import source_sweep as ss

    cfg = chip_smoke.setup(8, *chip_smoke.BENCH_SOURCE, torch.float32,
                           torch.device("cpu"), heating=True,
                           tables=route)[0].sweep
    kt = ks.parent_route_tables(cfg, torch.float32)
    K, ints, route_ints, ptrs = ks.parent_route_args(kt)
    if route == "tau":
        assert kt.K == ss.ROUTE_TABLE and kt.types.photo.dim() == 4
        assert ptrs[1].value == kt.types.photo.data_ptr()
        assert ptrs[3].value == kt.types.hbin.data_ptr()
        assert route_ints[3] == kt.types.heat.shape[-1]
    elif route == "auto":
        blocks = packed_band_blocks(cfg.tables, torch.float32, True)[1]
        assert kt.K == ss.ROUTE_BLOCKS and kt.types == blocks
        assert list(route_ints[3:]) == [x for b in blocks for x in b]
    else:
        mine = ss._kernel_tables(cfg, torch.float32)
        assert kt.K == mine.K == 6 and torch.equal(kt.packed, mine.packed)
    with ks.parent_sweeps({}):
        for mod in (ss, pyramid_sweep, octant_sweep):
            assert mod._kernel_tables is ks.parent_route_tables
            assert mod._route_args is ks.parent_route_args
    for mod in (ss, pyramid_sweep, octant_sweep):
        assert mod._kernel_tables is ss._kernel_tables
        assert mod._route_args is ss._route_args


def test_parent_sweeps_keep_this_trees_arguments_for_newer_parents(
        tmp_path):
    """A parent whose tau route reads band-major records (table_rates.cuh
    with load_rec, as this tree's: commit e7dcd29 on) takes this tree's
    tables and route arguments: parent_sweeps(libs, src) then swaps the
    libraries alone, and back."""
    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import octant_sweep, pyramid_sweep
    from c2ray_tpu_torch.sweep import source_sweep as ss

    (tmp_path / "table_rates.cuh").write_text(
        (cuda_build.CSRC / "table_rates.cuh").read_text())
    assert "load_rec(" in (tmp_path / "table_rates.cuh").read_text()
    lib = object()
    before = cuda_build._LIBS.get("pyramid_sweep")
    with ks.parent_sweeps({"pyramid_sweep": lib}, tmp_path):
        assert cuda_build._LIBS["pyramid_sweep"] is lib
        for mod in (ss, pyramid_sweep, octant_sweep):
            assert mod._kernel_tables is ss._kernel_tables
            assert mod._route_args is ss._route_args
    assert cuda_build._LIBS.get("pyramid_sweep") is before
    (tmp_path / "table_rates.cuh").write_text("// commit 91213d1's reads\n")
    with ks.parent_sweeps({}, tmp_path):
        assert pyramid_sweep._kernel_tables is ks.parent_route_tables
