"""The benchmark's data, found by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells, their
configurations and the metrics; everything that belongs to one of them
lives in a file of its own under the benchmark's folder:

- ``configs/<config>.json``: the deployment, with its source, what was
  assumed and what was cut;
- ``workloads/<cell>.json``: the cell's traffic (the cycle of slices,
  the source counts, the initial state), its check sample and limits;
- ``layers/<layer>.json``: the kernel name prefixes of a layer;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(trace) -> float | None``;
- ``roofline/<kernel>.py``: the least time of a kernel's work;
- ``problems/<generator>.py``: the seeded generator a configuration
  names.

Adding a cell, a layer or a metric adds files; no file here changes.
"""

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(cell_name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{cell_name}.json")


def layers() -> dict:
    """{layer: {"kernels": [prefixes], ...}} of every layers/*.json."""
    out = {}
    for p in sorted((BENCH / "layers").glob("*.json")):
        d = load_json(p)
        out[d["layer"]] = d
    return out


def _module(path: Path, name: str):
    s = importlib.util.spec_from_file_location(name, path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def metric_reader(name: str):
    return _module(BENCH / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_"))


def roofline(kernel: str):
    return _module(BENCH / "roofline" / f"{kernel}.py",
                   "bench_roofline_" + kernel)


def generator(name: str):
    return _module(BENCH / "problems" / f"{name}.py",
                   "bench_problem_" + name)


def metrics_of(spec: dict, cell_name: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads list, and those whose list holds
    it."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
