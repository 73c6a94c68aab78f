"""The harness driven end to end on the CPU, at 16^3 with the port's
plain versions in float64: the result line, the reference against the
port's plain path, the control in a lower precision and faults planted
under the timed path.  The look for a card is skipped: `run_cell` is
called with device="cpu"."""

import bench_path  # noqa: F401  (the import path; first)

import json
import math

import pytest
import torch

import run
from harness.cell import Cell

EARLY = ("cubep3m_250.early_heating", dict(n_sources=8, n_low_mass=2))
LATE = ("cubep3m_250.late_isothermal", dict(n_sources=8, n_low_mass=2))
SEED = 2**31 + 7


def _run(cell, traced=0, fault=None, seed=SEED, tmp_path=None):
    name, over = cell
    return run.run_cell(name, seed, 0.01, traced, device="cpu", mesh=16,
                        overrides=over, fault=fault,
                        workdir=None if tmp_path is None else str(tmp_path))


@pytest.mark.parametrize("traced", [0, 1])
def test_result_line(traced):
    result, compared = _run(EARLY, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if traced:
        keys.append("breakdown")
    assert sorted(result) == sorted(keys + ["check"])
    assert list(result)[-1] == "check"
    assert set(result["check"]) == {k for k, _, _ in compared}
    json.loads(json.dumps(result))
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in result["device"] and "window_s" in result["device"]
    else:
        assert set(result["metrics"]) == {"step_s", "setup_s"}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] == 2 * result["attempted"] // 2 > 0


@pytest.mark.parametrize("cell", [EARLY, LATE], ids=["early", "late"])
def test_reference_agrees_with_the_plain_path(cell):
    result, compared = _run(cell)
    for name, value, _ in compared:
        assert value <= 1e-9, (name, value)
    assert result["correct"]


def _unchanged_step(port):
    # finish_timestep promotes the converged fractions; without it the
    # step returns the state it started from
    port.patch(port.evolve, "finish_timestep", lambda state: state)


def _half_the_sources(port):
    trace = port.pyramid.trace_plain

    def half(cfg, fstack, srcpos, nflux, *a, **kw):
        nflux = nflux.clone()
        nflux[1::2] = 0.0
        return trace(cfg, fstack, srcpos, nflux, *a, **kw)
    port.patch(port.pyramid, "trace_plain", half)


def _altered_rates(port):
    sweep = port.evolve.sweep_pyramid_source_batch

    def altered(*a, **kw):
        r = sweep(*a, **kw)
        return r._replace(phih=r.phih * 1.001)
    port.patch(port.evolve, "sweep_pyramid_source_batch", altered)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_the_sources,
                                   _altered_rates],
                         ids=["unchanged_step", "half_the_sources",
                              "altered_rates"])
def test_a_fault_under_the_timed_path_is_not_correct(fault):
    result, compared = _run(EARLY, fault=fault)
    assert not result["correct"], compared


def test_the_control_is_not_correct(tmp_path):
    """The reference in bfloat16, put in the port's place (the control of
    a float32 configuration), fails a limit."""
    name, over = EARLY
    cell = Cell(name, SEED, device="cpu", mesh=16, workdir=str(tmp_path),
                overrides=over)
    cell.setup()
    cell.window(0.01)
    cell.release()
    ref = cell.reference()
    nums, want, steps = cell.judged(ref)
    limits = cell.traffic["check"]["limits"]
    assert all(nums[k] <= limits[k] for k in nums)
    ctrl = cell.control(want, steps, torch.bfloat16)
    assert any(not math.isfinite(v) or v > limits[k]
               for k, v in ctrl.items()), ctrl


def test_the_warm_up_runs_the_first_step_only(tmp_path):
    """Set-up warms up on one step of a cycle; the next cycle starts
    from the initial state and runs all of its steps."""
    name, over = LATE
    cell = Cell(name, SEED, device="cpu", mesh=16, workdir=str(tmp_path),
                overrides=over)
    cell.setup()
    assert cell.probe.steps == 1 and cell.probe.stop_after is None
    assert cell.steps_per_cycle > 1
    wall, cycles, steps = cell.window(0.0)
    assert (cycles, steps) == (1, cell.steps_per_cycle)
    cell.release()


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing(
        tmp_path, capsys):
    assert run.main(["--workload", EARLY[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_the_command_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    import shutil
    import subprocess
    import sys

    from harness import spec

    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", EARLY[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        check=False)
    assert out.returncode != 0 and out.stdout == ""
