"""The port's SLO plane (``repro_torch.serving.slo``) against
``repro.serving.slo``: admission decisions on scripted pending lists (cold
and warm cache entries, per-kind SLOs, every action), ``SLOPolicy.evaluate``
scorecards, and the rung names — the bottom rung is ``pure-torch`` where
the reference's is ``pure-jax``, at the same integer."""
import numpy as np
import pytest

from test_torch_parity import rand_complex
from repro.core.hardware import TESLA_V100 as REF_V100
from repro.serving import cache as ref_cache
from repro.serving import request as ref_request
from repro.serving import slo as ref_slo
from repro_torch.core.hardware import TESLA_V100
from repro_torch.serving import cache as port_cache
from repro_torch.serving import request as port_request
from repro_torch.serving import slo as port_slo

BATCH_BYTES = 2e9


def _stream(seed: int, n: int) -> list[tuple[np.ndarray, dict]]:
    """A seeded mixed pending list: C2C and R2C at three lengths, 2-D and
    FDAS requests, with rows 1..4."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = int(rng.integers(1, 5))
        pick = int(rng.integers(0, 6))
        if pick == 4:
            out.append((rand_complex(i, (rows, 32, 32)), {"ndim": 2}))
        elif pick == 5:
            out.append((rng.standard_normal((1, 1024)).astype(np.float32),
                        {"kind": "fdas", "templates": 3}))
        else:
            n_pts = (256, 512, 1024, 512)[pick]
            x = rand_complex(i, (rows, n_pts))
            out.append((x.real.copy(), {"transform": "r2c"}) if pick == 3
                       else (x, {}))
    return out


def _policies(mod):
    return [
        mod.SLOPolicy(default=mod.SLO(deadline_s=2e-6)),
        mod.SLOPolicy(default=mod.SLO(deadline_s=5e-7, degrade_at=0.5,
                                      degrade_hard_at=1.5, shed_at=3.0)),
        mod.SLOPolicy(default=mod.SLO(max_queue_transforms=20),
                      per_kind={"fdas": mod.SLO(deadline_s=1e-9),
                                "fft": mod.SLO(deadline_s=1e-6,
                                               max_queue_transforms=30)}),
        mod.SLOPolicy(default=mod.SLO(deadline_s=1e-6, degrade_hard_at=None,
                                      shed_at=None)),
    ]


def _decide(pkg, policy_index, stream, warm):
    if pkg == "ref":
        req_mod, slo_mod, cache_mod, dev = ref_request, ref_slo, ref_cache, \
            REF_V100
    else:
        req_mod, slo_mod, cache_mod, dev = port_request, port_slo, \
            port_cache, TESLA_V100
    cache = cache_mod.PlanSweepCache(dev, batch_bytes=BATCH_BYTES)
    reqs = [req_mod.FFTRequest(x=x, **kw) for x, kw in stream]
    for r in reqs[:warm]:                     # warm entries: cached sweeps
        if r.kind == "fft":
            cache.entry(r.shape_key(dev.name))
    ctl = slo_mod.AdmissionController(_policies(slo_mod)[policy_index], dev)
    decisions = ctl.decide(reqs, cache)
    assert [d.request for d in decisions] == reqs
    return ([(d.action, d.rung, d.reason) for d in decisions],
            (ctl.admitted, ctl.degraded, ctl.shed))


@pytest.mark.parametrize("policy_index", range(4))
@pytest.mark.parametrize("seed,warm", [(0, 0), (1, 6)])
def test_admission_decisions_are_the_references(policy_index, seed, warm):
    stream = _stream(seed, 40)
    port = _decide("port", policy_index, stream, warm)
    ref = _decide("ref", policy_index, stream, warm)
    assert port == ref


def test_scripted_decisions_reach_every_action():
    stream = _stream(0, 40)
    actions = set()
    for i in range(4):
        decisions, _ = _decide("port", i, stream, 0)
        actions |= {(a, r, why) for a, r, why in decisions}
    reasons = {why for _, _, why in actions}
    assert {"admission:backlog", "admission:backlog-hard",
            "admission:deadline", "admission:queue-full", None} <= reasons
    assert (port_slo.DEGRADE, port_slo.RUNG_PURE_TORCH,
            "admission:backlog-hard") in actions


def _receipts(req_mod, stream):
    """Receipts with seeded latencies and energies, served at every rung,
    retried, and shed (which evaluate() leaves out)."""
    rng = np.random.default_rng(5)
    out = []
    for i, (x, kw) in enumerate(stream):
        req = req_mod.FFTRequest(x=x, **kw)
        if i % 9 == 4:
            out.append(req_mod.RequestReceipt.make_shed(
                req, "admission:deadline", 1.0))
            continue
        e = float(rng.uniform(1e-5, 1e-3))
        out.append(req_mod.RequestReceipt(
            request=req, batch_id=i // 3, worker=i % 2,
            queue_latency=float(rng.exponential(0.01)),
            service_latency=float(rng.exponential(0.02)),
            clock_mhz=1000.0, modelled_time_s=1e-3, energy_j=e,
            boost_energy_j=1.3 * e, rung=i % 3, retries=int(i % 5 == 0)))
    return out


@pytest.mark.parametrize("budgets", [
    {}, {"p99_latency_s": 0.05, "max_j_per_transform": 2e-4},
    {"p99_latency_s": 1.0, "max_j_per_transform": 1.0}])
def test_evaluate_scorecards_are_the_references(budgets):
    stream = _stream(2, 60)
    port = port_slo.SLOPolicy(default=port_slo.SLO(**budgets)).evaluate(
        _receipts(port_request, stream))
    ref = ref_slo.SLOPolicy(default=ref_slo.SLO(**budgets)).evaluate(
        _receipts(ref_request, stream))
    assert port == ref
    assert set(port) == {"fft", "fdas"}
    assert sum(v["degraded"] for v in port.values()) > 0


def test_rung_names():
    assert port_slo.RUNG_NAMES == ("tuned-dvfs", "boost-heuristic",
                                   "pure-torch")
    assert (port_slo.RUNG_TUNED_DVFS, port_slo.RUNG_BOOST_HEURISTIC,
            port_slo.RUNG_PURE_TORCH) == (ref_slo.RUNG_TUNED_DVFS,
                                          ref_slo.RUNG_BOOST_HEURISTIC,
                                          ref_slo.RUNG_PURE_JAX)
    assert [port_slo.rung_name(r) for r in (-1, 0, 1, 2, 7)] == \
        ["tuned-dvfs", "tuned-dvfs", "boost-heuristic", "pure-torch",
         "pure-torch"]
    for kind in ("fft", "fdas", "pulsar"):
        assert port_slo.max_rung_for_kind(kind) == \
            ref_slo.max_rung_for_kind(kind)
