"""BENCHMARK.json against the contract, and the data found by name."""

import bench_path  # noqa: F401  (the import path; first)

import json
import re
import shutil
import subprocess
import sys

from harness import spec
from harness.cell import ranks_of, run3d_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return spec.benchmark()


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_names_units_and_metrics():
    b = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        reader = spec.metric_reader(m["name"])
        assert callable(reader.read)
    roofs = [m for m in b["per_layer"] if m["name"].endswith("_roofline")
             or "roofline" in m["name"]]
    assert all(m["unit"] == "%" for m in roofs)


def test_cells_configs_and_files():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert spec.generator(cfg["generator"]).make
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        t = spec.traffic(w["name"])
        assert t["name"] == w["name"]
        # a cell takes as many cards as Run3D has ranks
        run3d = run3d_of(spec.config(w["config"]), t)
        assert ranks_of(run3d) == w["chips"]
        assert set(t["check"]["limits"]) == {"not_finite",
            "start", "sources", "rates_first", "chem_first", "slabs_last",
            "chem_last", "budget"}
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    for name, layer in spec.layers().items():
        assert layer["kernels"] and layer["library"]


def test_a_new_workload_file_is_found_with_no_file_edited(tmp_path):
    """Copy the benchmark, add a cell by adding its traffic file and its
    entry, and find it by name from the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    w = dict(b["workloads"][0], traffic="copy", name=b["workloads"][0][
        "config"] + ".copy")
    b["workloads"].append(w)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    t = spec.traffic(b["workloads"][0]["name"])
    t["name"] = w["name"]
    (root / "benchmark" / "workloads" / f"{w['name']}.json").write_text(
        json.dumps(t))
    code = ("import sys; sys.path.insert(0, 'benchmark');"
            "from harness import spec; b = spec.benchmark();"
            f"print(spec.cell(b, {w['name']!r})['traffic'],"
            f" spec.traffic({w['name']!r})['name'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["copy", w["name"]]
