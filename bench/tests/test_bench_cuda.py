"""On the card, at each cell's own size: a short run of the program is
correct and the control (the reference at bfloat16 in the program's
place) is not.  Run on the card with

    python -m pytest -q -p no:cacheprovider -m cuda bench/tests/test_bench_cuda.py
"""
from __future__ import annotations

import json

import pytest

from bench import control
from bench.tests.tiny import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not_at_cell_size(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's own size)")
    out = control.readings(cell, 2**31 + 4242, 1, 1, 2.0)
    assert out["program"][0]["correct"], out["program"][0]["checks"]
    assert not out["control"][0]["correct"], out["control"][0]["checks"]
