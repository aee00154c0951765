"""What the benchmark's files may import and read, by whole top-level name:
``repro_torch`` is the program, ``repro`` the JAX package."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def test_sources_found():
    assert any(p.name == "run.py" for p in SOURCES)
    assert any(p.parent.name == "reference" for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {"repro_torch", "repro", "portbench"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_packages_benchmark(path):
    text = path.read_text()
    assert "BENCH_" not in text and "benchmarks/" not in text and "benchmarks." not in text


def test_the_whole_name_check_tells_repro_torch_from_repro():
    import importlib.util
    import sys
    spec = importlib.util.spec_from_file_location("portbench_run_entry", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_modules(["repro_torch", "repro_torch.core.index", "reprox",
                                  "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core.index", "jaxlib.xla_client", "flax",
                                  "jax"]) == ["flax", "jax", "jaxlib", "repro"]
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "repro"})
