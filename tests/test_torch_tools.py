"""The port's tools against the JAX package's, on the CPU.

`tools/table_write_torch.py` against `tools/table_write.py` (TableWrite.F90's
table dump), both called in-process: the same files, byte for byte (the
port integrates the tables in numpy on the host as JAX's does), in the
default heating mode, `--isothermal` and `--quadrature`.
`tools/bench_scaling_torch.py` at mesh 16 over 1 and 2 gloo ranks in both
parallel modes against `tools/bench_scaling.py` on JAX's host devices:
the same metric name, a timing and finite positive efficiencies per world
size.  Both port tools refuse `--device cuda` without CUDA.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
# the spawned gloo ranks import bench_scaling_torch by name from here
sys.path.insert(0, TOOLS)

import bench_scaling_torch  # noqa: E402
import table_write_torch  # noqa: E402

torch.set_num_threads(1)


def _jax_tool(name):
    """tools/<name>.py (the JAX package's tool) as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(monkeypatch, name, argv):
    """The JAX tool's main() with sys.argv set; its stdout."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _jax_tool(name).main()
    return out.getvalue()


def _record(path):
    """(leading marker, payload, trailing marker) of a one-record
    Fortran unformatted file."""
    raw = open(path, "rb").read()
    head = int(np.frombuffer(raw[:4], np.int32)[0])
    tail = int(np.frombuffer(raw[-4:], np.int32)[0])
    return head, np.frombuffer(raw[4:-4], np.float64), tail


TABLE_MODES = {"heating": [], "isothermal": ["--isothermal"],
               "quadrature": ["--quadrature"]}


@pytest.mark.parametrize("mode", sorted(TABLE_MODES))
def test_table_write_matches_jax(tmp_path, monkeypatch, capsys, mode):
    extra = TABLE_MODES[mode]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    table_write_torch.main([str(port_dir), *extra, "--device", "cpu"])
    port_line = capsys.readouterr().out
    jax_line = _run_jax_main(monkeypatch, "table_write",
                             [str(jax_dir), *extra])
    assert port_line.replace(str(port_dir), "D") == \
        jax_line.replace(str(jax_dir), "D")
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    if mode == "quadrature":
        assert names == ["bb_quadrature.npz"]
        a = np.load(jax_dir / names[0])
        b = np.load(port_dir / names[0])
        assert sorted(b.files) == sorted(a.files) == sorted(
            ["sigma_hat", "A_photo", "A_heat_HI", "A_heat_HeI",
             "A_heat_HeII"])
        for k in a.files:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape
            assert b[k].shape == (33, 8), k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    else:
        kinds = ("photo", "heat") if mode == "heating" else ("photo",)
        assert names == sorted(f"bb_{k}_{t}_table.bin" for k in kinds
                               for t in ("thick", "thin"))
    for name in names:
        pb = (port_dir / name).read_bytes()
        jb = (jax_dir / name).read_bytes()
        if name.endswith(".bin"):
            head, data, tail = _record(port_dir / name)
            assert head == tail == len(pb) - 8 == 8 * data.size, name
            assert np.isfinite(data).all() and data.size > 0, name
        assert pb == jb, name


@pytest.mark.parametrize("mode", ["source", "domain"])
def test_bench_scaling_matches_jax_metric(monkeypatch, capsys, mode):
    argv = ["--mesh", "16", "--devices", "1", "2", "--mode", mode]
    out = bench_scaling_torch.main([*argv, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    jax_out = json.loads(
        _run_jax_main(monkeypatch, "bench_scaling",
                      [*argv, "--cpu"]).strip().splitlines()[-1])
    assert out["metric"] == jax_out["metric"] == (
        f"weak_scaling_efficiency_{mode}_isothermal_2dev_mesh16")
    assert out["unit"] == "fraction" and out["device"] == "cpu"
    assert sorted(out["detail"]) == sorted(jax_out["detail"]) == ["1", "2"]
    assert out["detail"]["1"]["weak_efficiency"] == 1.0
    for d in out["detail"].values():
        for k in ("seconds", "rate", "weak_efficiency"):
            assert math.isfinite(d[k]) and d[k] > 0, (k, d)
    assert out["value"] == out["detail"]["2"]["weak_efficiency"]


@pytest.mark.parametrize("tool", ["table_write", "bench_scaling"])
def test_tools_refuse_cuda_without_it(tmp_path, monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    outdir = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        if tool == "table_write":
            table_write_torch.main([str(outdir)])
        else:
            bench_scaling_torch.main(["--mesh", "16", "--devices", "1"])
    assert e.value.code not in (0, None)
    captured = capsys.readouterr()
    assert "CUDA is not available" in captured.err
    assert captured.out == "" and not outdir.exists()
