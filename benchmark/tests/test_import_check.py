"""Nothing the benchmark runs may load JAX or the JAX package; names are
compared by their whole top-level part."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness.main import banned_modules

BENCH = Path(__file__).resolve().parents[1]


def test_top_level_names_are_compared_whole():
    assert banned_modules(["recondet3d_torch", "recondet3d_torch.ops.fps", "jaxtyping", "flaxen"]) == []
    assert banned_modules(["recondet3d.core", "jax.numpy", "jaxlib", "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "recondet3d"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert banned_modules(list(_imports(path))) == [], path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"recondet3d_torch", "recondet3d", "jax", "jaxlib", "flax"}, path


def test_a_run_loads_no_banned_module():
    """The harness, the program and the reference, imported as a run does."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness.main as m, benchmark.reference.model, benchmark.calibrate\n"
            "import recondet3d_torch.cli.train, recondet3d_torch.train.trainer, recondet3d_torch.utils.stage_timer\n"
            "print(m.banned_modules())" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_folder_without_the_program_gives_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the run fails and prints no result line."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.harness.main import run_cell\n"
            "print(run_cell('occ-infer-b2', 1, 0.1, False, device='cpu'))" % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "recondet3d_torch" in out.stderr and '"correct"' not in out.stdout


def test_a_rank_that_loaded_a_banned_module_exits_3():
    """Every rank's process checks itself, not rank 0's alone (a plan of no runs here)."""
    code = ("import os, sys; sys.path.insert(0, %r)\n"
            "if sys.argv[1] == 'jax':\n"
            "    import jax\n"
            "from benchmark.harness.ranks import child_main\n"
            "sys.exit(child_main({'rank': 1, 'ranks': 2, 'init_method': None, 'device': 'cpu', 'bench': %r, "
            "'plan': [], 'parent': os.getppid()}))" % (str(BENCH.parent), str(BENCH)))
    clean = subprocess.run([sys.executable, "-c", code, "none"], capture_output=True, text=True, timeout=300)
    assert clean.returncode == 0, clean.stderr[-2000:]
    loaded = subprocess.run([sys.executable, "-c", code, "jax"], capture_output=True, text=True, timeout=300)
    assert loaded.returncode == 3 and "['jax'" in loaded.stderr, loaded.stderr[-2000:]
