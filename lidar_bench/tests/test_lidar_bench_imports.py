"""What a run may load: no JAX, no JAX package; the reference none of the port."""
from __future__ import annotations

import ast
import importlib.util
import sys
import types

from lidar_bench.harness import spec


def _run_module():
    s = importlib.util.spec_from_file_location("lidar_bench_run", spec.BENCH_DIR / "run.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    run = _run_module()
    base = set(run.forbidden_modules())
    for name in ("tloam_torch_extra", "jaxtyping", "flaxen.x", "tloam_tpux", "my.jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(run.forbidden_modules()) == base
    for name in ("tloam_tpu.models.edge", "jaxlib", "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(run.forbidden_modules()) == base | {"tloam_tpu", "jaxlib", "jax", "flax"}


def _imported_roots(path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _reference_packages() -> set[str]:
    """The packages under lidar_bench/ other than the harness and its tests:
    the frozen reference and every configuration's own piece."""
    return {d.name for d in spec.BENCH_DIR.iterdir()
            if (d / "__init__.py").is_file() and d.name not in ("harness", "tests")}


def _lidar_bench_imports(path) -> set[str]:
    """The lidar_bench packages that a file imports by absolute name."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
            [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
        out |= {n.split(".")[1] for n in names if n.startswith("lidar_bench.")}
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module == "lidar_bench":
            out |= {a.name for a in node.names}
    return out


def test_the_reference_imports_nothing_of_the_port_or_jax():
    packages = _reference_packages()
    assert "reference" in packages and len(list((spec.BENCH_DIR / "reference").glob("*.py"))) >= 12
    for c in spec.benchmark()["configs"]:
        assert spec.config(c["name"]).get("reference", "reference") in packages, c["name"]
    for pkg in sorted(packages):
        for f in sorted((spec.BENCH_DIR / pkg).rglob("*.py")):
            assert not _imported_roots(f) & {"tloam_torch", "tloam_tpu", "jax", "jaxlib", "flax"}, f
            assert "tloam_torch" not in {n.module for n in ast.walk(ast.parse(f.read_text()))
                                         if isinstance(n, ast.ImportFrom) and n.module}, f
            # of the benchmark, a piece takes only reference packages: the harness reaches the port
            assert _lidar_bench_imports(f) <= packages, f


def test_the_harness_imports_no_jax_and_the_port_only_through_programs():
    for f in sorted((spec.BENCH_DIR).rglob("*.py")):
        if "tests" in f.parts:
            continue
        roots = _imported_roots(f)
        assert not roots & {"tloam_tpu", "jax", "jaxlib", "flax"}, f
        if "tloam_torch" in roots:
            assert f.name == "programs.py", f
