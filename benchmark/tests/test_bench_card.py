"""On the card: one cycle of every cell through the command, and its
result line.  Needs CUDA; skips without it (decided in the fixture)."""

import bench_path  # noqa: F401  (the import path; first)

import json
import subprocess
import sys
from pathlib import Path

import pytest

from harness import spec

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_one_cycle_of_each_cell(card, cell):
    import torch

    chips = spec.cell(spec.benchmark(), cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=False)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"step_s", "setup_s"}
