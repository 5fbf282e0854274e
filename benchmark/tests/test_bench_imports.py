"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
and nothing of the program in the reference and the yardstick.  Modules
are compared by their top-level name whole (``neusky_torch`` begins with
the letters of ``neusky_t...``)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import common

FILES = sorted(p for p in common.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def _top_levels(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(common.BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_top_levels(path)) & set(common.FORBIDDEN_MODULES)


YARDSTICK = [p for p in FILES if p.parts[len(common.BENCH_DIR.parts)] in ("reference", "metrics")
             or p.name in ("counts.py", "trace.py", "scene.py", "cfgjson.py")]


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(common.BENCH_DIR)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "neusky_torch" not in set(_top_levels(path))


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=common.ROOT, capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_no_program_module():
    loaded = _loaded_after("import benchmark.reference.train, benchmark.reference.view, benchmark.counts, "
                           "benchmark.trace, benchmark.scene")
    assert not loaded & {"neusky_torch", *common.FORBIDDEN_MODULES}


def test_a_cell_run_loads_no_jax():
    # the harness's modules and the program's modules a cell imports
    loaded = _loaded_after("import benchmark.run, benchmark.loops.train, benchmark.loops.view, "
                           "neusky_torch.engine.trainer, neusky_torch.viewer, neusky_torch.configs")
    assert "neusky_torch" in loaded and not loaded & set(common.FORBIDDEN_MODULES)


def test_the_run_refuses_knobs_and_a_missing_card(monkeypatch):
    from benchmark import run

    monkeypatch.setenv("NEUSKY_BF16_MAPPING", "1")
    assert run.main(["--workload", "neusky.train", "--seed", "1", "--seconds", "1"]) == 2
    monkeypatch.delenv("NEUSKY_BF16_MAPPING")
    import torch

    if not torch.cuda.is_available():
        assert run.main(["--workload", "neusky.train", "--seed", "1", "--seconds", "1"]) == 3
