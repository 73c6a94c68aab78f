"""The harness on the paths Run3D takes besides one rank with the pyramid
engine, on the CPU with the port's plain versions in float64: the
source-parallel mode on four gloo ranks at 16^3, and the L1-shell engine
at an odd mesh; and the reference's N-body backends and SEDs."""

import bench_path  # noqa: F401  (the import path; first)

import json

import numpy as np
import pytest
import torch

import run
from harness.cell import Cell

SOURCE4 = ("cubep3m_250.source4", dict(n_sources=8, n_low_mass=2))
LATE = "cubep3m_250.late_isothermal"
SEED = 2**31 + 7


def _run4(traced=0, fault=None):
    name, over = SOURCE4
    return run.run_cell(name, SEED, 0.01, traced, device="cpu", mesh=16,
                        overrides=over, fault=fault)


@pytest.mark.parametrize("traced", [0, 1])
def test_four_ranks_agree_with_the_reference(traced):
    result, compared = _run4(traced)
    for name, value, _ in compared:
        assert value <= 1e-9, (name, value)
    assert result["correct"]
    assert result["device"]["count"] == 4
    assert list(result)[-1] == "check"
    json.loads(json.dumps(result))
    ranks = result["ranks"]
    assert len(ranks) == 4
    # every rank ran the window's steps, the same iterations, and traced
    # its own block of the sources in each sweep
    assert {r["steps"] for r in ranks} == {result["attempted"]}
    assert len({r["iterations"] for r in ranks}) == 1
    assert all(r["traces"] >= r["iterations"] > 0 for r in ranks)
    if traced:
        assert result["metrics"]["iterations_per_step"]["value"] > 0


def _rank1_rates_altered(port):
    """Rank 1's sweep returns its HI rates 1% high; the sum over the
    ranks carries them."""
    if torch.distributed.get_rank() != 1:
        return
    sweep = port.sharding.sweep_pyramid_source_batch

    def altered(*a, **kw):
        r = sweep(*a, **kw)
        return r._replace(phih=r.phih * 1.01)
    port.patch(port.sharding, "sweep_pyramid_source_batch", altered)


def _rank1_half_the_sources(port):
    """Rank 1 traces every other source of its block with no flux."""
    if torch.distributed.get_rank() != 1:
        return
    trace = port.pyramid.trace_plain

    def half(cfg, fstack, srcpos, nflux, *a, **kw):
        nflux = nflux.clone()
        nflux[1::2] = 0.0
        return trace(cfg, fstack, srcpos, nflux, *a, **kw)
    port.patch(port.pyramid, "trace_plain", half)


def _no_exchange(port):
    """Each rank keeps its own sources' rates: the all-reduce between the
    cards left out."""
    port.patch(port.sharding, "psum_rates", lambda rates, group=None: rates)


def _unchanged_step(port):
    """The step returns the state it started from (no promotion of the
    converged fractions)."""
    port.patch(port.sharding, "finish_timestep", lambda state: state)


@pytest.mark.parametrize("fault", [_rank1_rates_altered,
                                   _rank1_half_the_sources, _no_exchange,
                                   _unchanged_step],
                         ids=["rates_altered", "half_the_sources",
                              "no_exchange", "unchanged_step"])
def test_a_fault_on_rank_1_is_not_correct(fault):
    result, compared = _run4(fault=fault)
    assert not result["correct"], compared


def _source4_readings(workdir):
    """On each rank: the source4 cell's window; on rank 0 the numbers of
    the port and of the control (the reference in bfloat16 in the
    port's place) against the float64 reference, and the limits."""
    name, over = SOURCE4
    cell = Cell(name, SEED, device="cpu", mesh=16, workdir=workdir,
                overrides=over)
    cell.setup()
    cell.window(0.01)
    cell.release()
    if cell.rank != 0:
        return None
    nums, want, steps = cell.judged(cell.reference())
    return (nums, cell.control(want, steps, torch.bfloat16),
            cell.traffic["check"]["limits"])


def test_the_control_of_four_ranks_is_not_correct(tmp_path):
    from c2ray_tpu_torch.parallel.launch import launch

    nums, ctrl, limits = launch(_source4_readings, 4, args=(str(tmp_path),),
                                device="cpu", threads=1)[0]
    assert all(nums[k] <= limits[k] for k in nums), nums
    assert any(not v <= limits[k] for k, v in ctrl.items()), ctrl


# the late cell at an odd mesh, not cosmological: the port's shell
# engine takes the configuration's cell size and LLS column, which such
# a run keeps (a cosmological step's own reach the pyramid engine only)
SHELLS = dict(n_sources=8, n_low_mass=2,
              run3d={"isothermal": True, "initial_temperature": 1.0e4,
                     "cosmological": False})


def test_the_shell_engine_at_an_odd_mesh(tmp_path):
    cell = Cell(LATE, SEED, device="cpu", mesh=17, workdir=str(tmp_path),
                overrides=SHELLS)
    cell.setup()
    assert cell.engine == "shells"
    cell.window(0.0)
    p, cap = cell.probe, cell.capture
    # every sweep traced the whole table, +-8 cells, one launch a shell
    # and one for the source cells, with the LLS column
    assert p.traces and all(t[1:] == (8, 8, True) for t in p.traces)
    assert set(p.trace_launches) == {1 + 24}
    assert sum(t[0] for t in p.traces) == p.chem_passes * 7
    slabs = cap.records[cap.last]["iterations"][-1]["slabs"]
    assert sorted(slabs) == cap.sample and len(cap.sample) == 4
    assert all(v[0].shape == (17**3, 4) for v in slabs.values())
    cell.release()
    nums, _, _ = cell.judged(cell.reference())
    assert all(v <= 1e-9 for v in nums.values()), nums
    assert set(nums) == set(cell.traffic["check"]["limits"])


def test_the_reference_takes_every_nbody_backend_and_sed(tmp_path):
    """The reference's N-body backends and SED components against the
    program's configuration loader."""
    from c2ray_tpu_torch.config import _NBODY_FACTORIES
    from c2ray_tpu_torch.cosmology import COSMOLOGIES as PORT_COSMO
    from c2ray_tpu_torch.sources import qso_luminosity_to_nflux as port_qso
    from reference import run3d as ref3d
    from reference.plain.cosmology import COSMOLOGIES
    from reference.plain.sources import qso_luminosity_to_nflux

    assert set(ref3d._NBODY) == set(_NBODY_FACTORIES)
    zfile = tmp_path / "redshifts.txt"
    zfile.write_text("3\n9.0\n8.5\n8.1\n")
    spec = {"redshift_file": str(zfile), "boxsize": 100.0,
            "base_dir": str(tmp_path) + "/"}
    for kind in ("test", "cubep3m", "pmfast"):
        ref = ref3d._NBODY[kind](dict(spec), COSMOLOGIES["WMAP5"])
        port = _NBODY_FACTORIES[kind](dict(spec), PORT_COSMO["WMAP5"])
        for f in ("nbody_type", "boxsize", "n_box", "dir_dens", "dir_src",
                  "id_str"):
            assert getattr(ref, f) == getattr(port, f), (kind, f)
        np.testing.assert_array_equal(ref.zred_array, port.zred_array)
    sed = ref3d._sed({"bb": {"T_eff": 5.0e4, "S_star": 1.0e48},
                      "pl": {"index": 1.8, "S_star": 1.0e47},
                      "qso": {"index": 1.5, "S_star": 1.0e46}})
    assert sed.bb and sed.pl and sed.qso
    with pytest.raises(ValueError):
        ref3d._sed({"xray": {}})
    lum = np.array([1e40, 3e41])
    from c2ray_tpu_torch.radiation.sed import PowerLawSED, SEDConfig

    port_sed = SEDConfig(qso=PowerLawSED(index=1.5, S_star=1.0e46))
    np.testing.assert_allclose(qso_luminosity_to_nflux(lum, sed),
                               port_qso(lum, port_sed), rtol=1e-15)
