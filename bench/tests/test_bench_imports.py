"""What the benchmark's processes import: never ``jax`` or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` begins with
``repro``), and the references nothing of the program at all."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from bench.tests.tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_modules(code: str) -> set[str]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.splitlines()[-1]))


PRELUDE = f"""
import sys, json, time
sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
"""
EPILOGUE = """
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def test_a_run_imports_no_jax_and_no_reference_package(tmp_path):
    """A whole tiny run in a fresh process: harness, generators, metrics,
    references, the port."""
    code = PRELUDE + f"""
from pathlib import Path
from bench import control, harness
from bench.tests.tiny import make_bench, FakeMeter
bench = make_bench(Path({str(tmp_path)!r}))
for cell in ("tiny.c2c", "tiny.real"):
    c = harness.Cell(cell, bench=bench)
    res = harness.run_cell(c, 3, 0.2, True, "cpu", time.perf_counter(),
                           meter=FakeMeter())
    assert res["correct"], res
""" + EPILOGUE
    top = _top_modules(code)
    assert "repro_torch" in top and "torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_references_import_nothing_of_the_program():
    code = PRELUDE + """
from bench.harness import BENCH, load_file_module
for path in sorted((BENCH / "configs").glob("*_ref.py")):
    load_file_module(path, "ref_" + path.stem)
""" + EPILOGUE
    top = _top_modules(code)
    assert not top & (FORBIDDEN | {"repro_torch"}), top


def test_no_source_under_bench_names_jax_or_repro():
    """Every import statement of every module under bench/, read from its
    source; the references may not name repro_torch either."""
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if path.name.endswith("_ref.py"):
            assert "repro_torch" not in names, path
