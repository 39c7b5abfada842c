"""What a run may load: never JAX or the JAX package `repro`, and, for the
plain reference, nothing of the program either. Names are compared whole
at the top level, so the program `repro_torch` is not `repro`."""
import ast
import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT

from bench.harness import hygiene

BENCH = ROOT / "bench"
REFERENCE_ALLOWED = {"__future__", "dataclasses", "math", "numpy", "torch",
                     "bench"}


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert hygiene.forbidden(["repro_torch", "repro_torch.core.plan",
                              "numpy", "jaxtyping"]) == []
    assert hygiene.forbidden(["repro.core.plan", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not hygiene.forbidden(imported_top_levels(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert names <= REFERENCE_ALLOWED, names - REFERENCE_ALLOWED
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("bench"):
            assert node.module.startswith("bench.reference"), node.module


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT}/src",
             "REPRO_TUNE_CACHE": "off"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import bench.reference.fdk, bench.reference.phantom\n"
        "import bench.roofline.backproject")
    assert "repro_torch" not in mods
    assert not hygiene.forbidden(mods)


def test_a_whole_run_loads_no_jax(tmp_path):
    from bench_tiny import make_tree
    make_tree(tmp_path)
    mods = _modules_after(
        "from bench.harness import cell\n"
        "from bench.harness.registry import Registry\n"
        f"r = cell.run(Registry({str(tmp_path)!r}), 'rct512-device-closed', "
        "2**31 + 3, 0.3, False, device='cpu', log_fn=lambda m: None)\n"
        "assert r['correct'], r['checks']")
    assert "repro_torch" in mods
    assert not hygiene.forbidden(mods)
