"""What the benchmark's modules import, by whole top-level names: no JAX
anywhere, and nothing of the program in the reference."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "c2ray_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): _imports(p) & FORBIDDEN
             for p in _sources()}
    assert not {k: v for k, v in found.items() if v}
    # the port's name begins with the JAX package's: compared whole
    assert "c2ray_tpu_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        names = _imports(p)
        assert not names & (FORBIDDEN | {"c2ray_tpu_torch", "harness"}), p


def test_the_comparison_and_the_yardstick_import_nothing_of_the_program():
    for sub in ("roofline", "problems", "metrics"):
        for p in _sources(sub):
            assert "c2ray_tpu_torch" not in _imports(p), p
    assert "c2ray_tpu_torch" not in _imports(BENCH / "harness" / "check.py")
