"""The blocked search's spans (``obs.trace.span``) on the CPU: one block
under an active tracer records ``search.block`` with its attributes, its
six stage spans in order (the matched filter, power, harmonic sum and
sift once a sub-block), the two kernel spans of the dedispersion and
harmonic-sum wrappers, each around its launch alone, with theirs, and
the sift's ``kernel.sift-select`` inside each ``search.sift``; the
same block outside any tracer records nothing and opens the shared
no-op, and its results are the traced block's."""
import pytest
import torch

from repro_torch.data.synthetic import FilterbankSpec, synthetic_filterbank
from repro_torch.obs import trace
from repro_torch.obs.ledger import LaunchLedger
from repro_torch.search import DispersionPlan, PulsarSearch, TemplateBank

SPEC = FilterbankSpec(nchan=16, ntime=2**12)
PLAN = DispersionPlan.from_spec(SPEC, n_trials=12)
BANK = TemplateBank.linear(2)
STAGES = ["search.dedisperse", "search.r2c", "search.matched_filter",
          "search.power", "search.harmonic_sum", "search.sift",
          "search.matched_filter", "search.power", "search.harmonic_sum",
          "search.sift"]


@pytest.fixture(scope="module")
def run():
    """Block 1 (trials 4-7, two sub-blocks of 2) traced, then untraced."""
    fb = torch.from_numpy(synthetic_filterbank(SPEC, (), seed=3))[None]
    search = PulsarSearch(PLAN, BANK, n_harmonics=4, dedisp_block=4,
                          fdas_block=2)
    tracer = trace.Tracer()
    ledger = LaunchLedger()
    with tracer.active(), ledger.capture():
        traced = search.block(fb, 1, keep={5})
    untraced = search.block(fb, 1, keep={5})
    return tracer, ledger, traced, untraced


def test_block_span_and_its_stages(run):
    tracer, _, _, _ = run
    roots = [s for s in tracer.spans if s.depth == 0]
    assert [s.name for s in roots] == ["search.block"]
    (block,) = roots
    assert {k: block.attrs[k] for k in ("trials", "nchan", "n", "templates",
                                        "harmonics", "device")} == {
        "trials": 4, "nchan": 16, "n": 2**12, "templates": 5,
        "harmonics": 4, "device": "cpu"}
    stages = [s.name for s in tracer.spans
              if s.depth == 1 and s.parent == "search.block"]
    assert stages == STAGES
    r2c = [s for s in tracer.spans if s.name == "fft.plan"]
    assert [s.parent for s in r2c] == ["search.r2c"]
    assert all(s.device_s is not None and s.device_s >= 0
               for s in tracer.spans)


def test_kernel_spans_wrap_the_launches(run):
    tracer, ledger, _, _ = run
    dedisp = [s for s in tracer.spans if s.name == "kernel.dedisperse"]
    hsum = [s for s in tracer.spans if s.name == "kernel.harmonic-sum-plane"]
    assert [s.parent for s in dedisp] == ["search.dedisperse"]
    assert [s.parent for s in hsum] == ["search.harmonic_sum"] * 2
    (d,) = dedisp
    assert {k: d.attrs[k] for k in ("rows", "nchan", "n", "trials")} == {
        "rows": 1, "nchan": 16, "n": 2**12, "trials": 4}
    for h in hsum:
        assert {k: h.attrs[k] for k in ("rows", "n", "harmonics")} == {
            "rows": 2 * 5, "n": 2**11 + 1, "harmonics": 4}
    counts = ledger.counts()
    assert counts["dedisperse"] == len(dedisp)
    assert counts["harmonic-sum-plane"] == len(hsum)


def test_sift_select_span_inside_each_sift(run):
    """One ``kernel.sift-select`` a sub-block, inside its ``search.sift``:
    the first with no floor, the second with the first's full pool's
    weakest cell; each sub-block's 2 x 5 x 2049 cells fit the select
    kernel's buffer, so it takes one topk and records no launch."""
    tracer, ledger, _, _ = run
    select = [s for s in tracer.spans if s.name == "kernel.sift-select"]
    assert [s.parent for s in select] == ["search.sift"] * 2
    assert [{k: s.attrs[k] for k in ("rows", "cells", "pool", "floor")}
            for s in select] == [
        {"rows": 1, "cells": 2 * 5 * 2049, "pool": 64, "floor": floor}
        for floor in (False, True)]
    assert all(s.attrs["device"] == "cpu" for s in select)
    assert "sift-select" not in ledger.counts()


def test_untraced_block_records_nothing_and_computes_the_same(run):
    tracer, _, traced, untraced = run
    spans = len(tracer.spans)
    assert not trace.tracing()
    assert trace.span("search.block") is trace.span("kernel.dedisperse")
    assert len(tracer.spans) == spans
    for a, b in zip(traced, untraced):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert traced.kept == untraced.kept == [5]
    assert torch.equal(traced.pool.vals, untraced.pool.vals)
    assert traced.sift.tolist() == untraced.sift.tolist() == [[0, 0, 0]]
