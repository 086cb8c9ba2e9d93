"""The readers of the program's spans: their arithmetic on made-up spans
and a made-up trace, and the tiny cells, traced on the CPU, reporting the
three span metrics beside every metric they reported before."""
from __future__ import annotations

import json
import time

import pytest

from bench import harness
from bench.tests.tiny import CELLS, FakeMeter, make_bench
from bench.yardstick import spans
from bench.yardstick.roofline import FP32_FLOPS, HBM_BYTES_PER_S
from bench.yardstick.trace import Trace

SEED = 2**31 + 4099
SPAN_METRICS = ("plan_stage_ms", "kernel_span_roofline", "plan_host_ms")

C2C = {"kind": "c2c", "n": 1024, "rows": 1000}
R2C = {"kind": "r2c", "n": 2**20}


def _batch(t: float) -> list[tuple]:
    """One R2C-like batch opened at host time ``t`` (records in completion
    order): pack 1 ms, a four-step with two kernels of 2 and 3 ms and
    0.5 ms of its own, split 4 ms, 0.25 ms of the plan's own."""
    return [("r2c.pack", 1, t + 0.1, t + 0.2, 1e-3, {}),
            ("kernel.fft-c2c-axis1", 2, t + 0.3, t + 0.4, 2e-3, C2C),
            ("kernel.fft-c2c-t", 2, t + 0.5, t + 0.6, 3e-3, C2C),
            ("four_step", 1, t + 0.25, t + 0.7, 5.5e-3, {}),
            ("r2c.split", 1, t + 0.75, t + 0.8, 4e-3, {}),
            ("fft.plan", 0, t, t + 0.9, 10.75e-3, R2C)]


def _session(batches: int = 2, builds: int = 0) -> spans.Session:
    records = [r for i in range(batches) for r in _batch(float(i))]
    return spans.Session(spans.tree(records), builds=builds)


def test_tree_nests_by_depth_in_completion_order():
    (plan,) = spans.tree(_batch(0.0))
    assert [c.name for c in plan.children] == ["r2c.pack", "four_step",
                                               "r2c.split"]
    assert [c.name for c in plan.children[1].children] == [
        "kernel.fft-c2c-axis1", "kernel.fft-c2c-t"]
    assert plan.self_s == pytest.approx(0.25e-3)
    sess = _session(3)
    assert len(sess.plans()) == 3 and len(sess.kernels()) == 6


def test_plan_stage_ms_adds_up():
    value, extra = spans.plan_stage_ms(_session())
    assert value == pytest.approx(10.75 - 5.0)
    assert extra["stages_ms"] == pytest.approx(
        {"four_step": 0.5, "r2c.pack": 1.0, "r2c.split": 4.0})
    assert extra["unattributed_ms"] == pytest.approx(0.25)
    assert sum(extra["stages_ms"].values()) + extra["unattributed_ms"] == \
        pytest.approx(value)
    assert extra["batches"] == 2


def test_kernel_span_roofline_takes_the_larger_bound():
    value, extra = spans.kernel_span_roofline(_session())
    t_bytes = 1000 * 1024 * 16 / HBM_BYTES_PER_S
    t_ops = 1000 * 5 * 1024 * 10 / FP32_FLOPS
    assert t_bytes > t_ops and extra["binds"] == "bytes"
    assert value == pytest.approx(100 * 4 * t_bytes / 10e-3)
    assert extra["by_kernel"]["kernel.fft-c2c-t"] == \
        pytest.approx(100 * t_bytes / 3e-3)
    assert extra["timed"] == 4 and extra["uncounted"] == []


def test_kernel_work_reads_each_byte_once():
    """A real transform's FLOPs are half a complex one's; a transpose
    reads and writes its elements once; a filter-bank launch reads its
    rows and bank and writes a row for each filter."""
    assert spans.kernel_work({"kind": "r2c", "n": 1024, "rows": 1000}) == \
        (1000 * (1024 * 4 + 513 * 8), 1000 * 2.5 * 1024 * 10)
    assert spans.kernel_work({"kind": "transpose", "n": 64, "rows": 3,
                              "itemsize": 4}) == (2 * 3 * 64 * 4, 0.0)
    assert spans.kernel_work({"kind": "c2c-mul", "n": 8, "rows": 2,
                              "bank": 5}) == \
        (8 * 8 * (2 + 5 + 10), 2 * 8 * (5 * 3 + 6 * 5))
    assert spans.kernel_work({"kind": "other"}) is None
    sess = spans.Session(spans.tree(
        [("kernel.other", 0, 0.0, 1.0, 1.0, {"kind": "other"}),
         ("kernel.fft-c2c", 0, 1.0, 2.0, 1e-3, C2C)]))
    value, extra = spans.kernel_span_roofline(sess)
    assert value == pytest.approx(100 * 1000 * 1024 * 16 / HBM_BYTES_PER_S
                                  / 1e-3)
    assert extra["uncounted"] == ["kernel.other"] and extra["timed"] == 1


def test_plan_host_ms_and_idle_by_span():
    sess = _session(2, builds=3)
    # Idle gaps: inside r2c.split of batch 0, inside batch 1's plan
    # outside its stages, and between the batches.
    trace = Trace(device=[("k", 0.0, 0.76), ("k", 0.77, 0.85),
                          ("k", 0.99, 1.05), ("k", 1.055, 2.0)],
                  host=[], t0=0.0, t1=2.0)
    value, extra = spans.plan_host_ms(sess, trace)
    assert value == pytest.approx(900.0)
    assert extra["device_ms"] == pytest.approx(10.75)
    assert extra["builds"] == 3 and extra["dropped"] == 0
    assert extra["idle_ms"] == pytest.approx(
        {"r2c.split": 10.0, "outside": 140.0, "fft.plan": 5.0})


def test_untimed_batches_count_by_kind():
    """Batches the program did not time on the device count only in the
    weights: each (kind, n) weighs by its share of all traced batches."""
    def plan(t, torch_s, kind, timed=True):
        dev = (lambda s: s) if timed else (lambda s: None)
        return [("kernel.fft-c2c", 1, t, t + 0.1, dev(1e-3), C2C),
                ("fft.plan", 0, t, t + 0.2, dev(1e-3 + torch_s),
                 {"kind": kind, "n": 64})]
    records = (plan(0.0, 1e-3, "r2c") + plan(1.0, 1e-3, "r2c", False)
               + plan(2.0, 1e-3, "r2c", False) + plan(3.0, 3e-3, "c2r"))
    sess = spans.Session(spans.tree(records))
    value, extra = spans.plan_stage_ms(sess)
    assert value == pytest.approx((3 * 1.0 + 1 * 3.0) / 4)
    assert (extra["batches"], extra["timed"]) == (4, 2)
    assert spans.kernel_span_roofline(sess)[1]["timed"] == 2
    host, extra = spans.plan_host_ms(sess)
    assert host == pytest.approx(200.0)
    assert extra["device_ms"] == pytest.approx((3 * 2.0 + 1 * 4.0) / 4)


def test_no_spans_reads_none():
    empty = spans.Session([])
    assert spans.plan_stage_ms(None) is None
    assert spans.plan_stage_ms(empty) is None
    assert spans.kernel_span_roofline(empty) is None
    assert spans.plan_host_ms(empty, None) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_traced_reports_the_span_metrics(tiny, cell):
    """The tiny cells list the three metrics (``make_bench`` adds them
    where the real cells are listed) and report them beside every metric
    a copy of the benchmark without them reports."""
    spec_path = tiny.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    for m in spec["per_layer"]:
        if m["name"] in SPAN_METRICS:
            assert cell in m["workloads"]

    def run(bench):
        c = harness.Cell(cell, bench=bench)
        return harness.run_cell(c, SEED, 0.3, True, "cpu",
                                time.perf_counter(), meter=FakeMeter())

    res = run(tiny)
    assert res["correct"], res["checks"]
    for name in SPAN_METRICS:
        assert res["metrics"][name]["value"] > 0
    stages = res["metrics"]["plan_stage_ms"]
    assert sum(stages["stages_ms"].values()) + stages["unattributed_ms"] == \
        pytest.approx(stages["value"])
    assert res["metrics"]["plan_host_ms"]["builds"] == 0
    before = dict(spec, per_layer=[m for m in spec["per_layer"]
                                   if m["name"] not in SPAN_METRICS])
    spec_path.write_text(json.dumps(before))
    try:
        old = run(tiny)
    finally:
        spec_path.write_text(json.dumps(spec))
    assert set(old["metrics"]) | set(SPAN_METRICS) == set(res["metrics"])
