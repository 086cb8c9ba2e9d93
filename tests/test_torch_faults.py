"""The port's robustness layer on the CPU: the claims of
``tests/test_faults.py`` — fault injection, breakers, retries, admission
control, the degradation ladder and the every-request-gets-a-receipt
invariant — on ``repro_torch.serving.FFTService`` with
``devices=[torch.device("cpu")] * n`` and the paper's Tesla V100 model,
plus parity of the fault plane with ``repro.runtime.faults``: generated
plans, retry delays, a scripted breaker trajectory, and the flight
recorder snapshot a ``FaultError`` takes."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.runtime.faults as ref_faults
from test_torch_parity import assert_close, rand_complex
from repro_torch.core.hardware import TESLA_V100
from repro_torch.fft import plan as plan_mod
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.faults import (CLOSED, CRASH_PROCESS,
                                        FAIL_CLOCK_LOCK, FAIL_PLAN_BUILD,
                                        HALF_OPEN, KILL_DEVICE, KILL_HOST,
                                        OPEN, STALL_WORKER, CircuitBreaker,
                                        ClockLockError, DeviceLostError,
                                        DrainDeadlineError, FaultEvent,
                                        FaultPlan, HostLostError,
                                        PlanBuildError, ProcessCrashError,
                                        RetryPolicy, WorkerStalledError)
from repro_torch.serving import (RUNG_BOOST_HEURISTIC, RUNG_PURE_TORCH, SLO,
                                 FFTService, SLOPolicy, max_rung_for_kind)

CPU = torch.device("cpu")
RTOL = 1e-5


class FakeTimer:
    """Deterministic clock: advances ``dt`` per call (0 = frozen)."""

    def __init__(self, dt=0.0, t0=0.0):
        self.t = t0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def advance(self, dt):
        self.t += dt


def service(n_workers=2, timer=None, **kw):
    return FFTService(TESLA_V100, devices=[CPU] * n_workers,
                      timer=timer if timer is not None else FakeTimer(),
                      **kw)


def _events(plan):
    return [dataclasses.astuple(ev) for ev in plan.events]


# ---------------------------------------------------------------------------
# FaultPlan / RetryPolicy / CircuitBreaker units, and their parity
# ---------------------------------------------------------------------------

def test_fault_events_fire_exactly_once():
    plan = FaultPlan([FaultEvent(KILL_DEVICE, batch_id=3),
                      FaultEvent(KILL_DEVICE)])
    assert plan.take(KILL_DEVICE, batch_id=1) is not None   # wildcard event
    assert plan.take(KILL_DEVICE, batch_id=3) is not None
    assert plan.take(KILL_DEVICE, batch_id=3) is None       # one-shot
    assert plan.pending() == 0 and plan.fired_count(KILL_DEVICE) == 2


def test_fault_event_worker_constraint():
    plan = FaultPlan([FaultEvent(STALL_WORKER, worker=1, duration=0.5)])
    assert plan.take(STALL_WORKER, batch_id=0, worker=0) is None
    ev = plan.take(STALL_WORKER, batch_id=0, worker=1)
    assert ev is not None and ev.duration == 0.5
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent("melt-down")


def test_fault_plan_generation_is_seed_deterministic():
    a = FaultPlan.generate(seed=7, n_batches=200)
    b = FaultPlan.generate(seed=7, n_batches=200)
    assert a.events == b.events
    kinds = {ev.kind for ev in a.events}
    assert {KILL_DEVICE, FAIL_CLOCK_LOCK, STALL_WORKER} <= kinds


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("seams", [False, True])
def test_generated_plan_is_the_references(seed, seams):
    kw = dict(n_batches=300, kill_rate=0.02, plan_fail_rate=0.01,
              stall_duration_s=0.03)
    if seams:
        kw.update(crash_arrivals=(100, 7, 2048),
                  host_kill_batches=(5, 40))
    port = FaultPlan.generate(seed, **kw)
    ref = ref_faults.FaultPlan.generate(seed, **kw)
    assert _events(port) == _events(ref) and port.seed == ref.seed
    if seams:
        assert port.pending(CRASH_PROCESS) == 3
        assert port.pending(KILL_HOST) == 2
    # the seams append after the draws: the seamless plan is a prefix
    assert _events(port)[:len(FaultPlan.generate(seed, **{
        k: v for k, v in kw.items()
        if k not in ("crash_arrivals", "host_kill_batches")}).events)] == \
        _events(FaultPlan.generate(seed, n_batches=300, kill_rate=0.02,
                                   plan_fail_rate=0.01,
                                   stall_duration_s=0.03))


def test_drop_consumed_is_the_references():
    kw = dict(n_batches=60, crash_arrivals=(10, 30), host_kill_batches=(20,))
    port, ref = FaultPlan.generate(3, **kw), ref_faults.FaultPlan.generate(
        3, **kw)
    assert port.drop_consumed(batch_before=25, arrival_before=11) == \
        ref.drop_consumed(batch_before=25, arrival_before=11)
    assert _events(port) == _events(ref)


def test_retry_backoff_is_deterministic_and_bounded():
    pol = RetryPolicy(max_retries=3, base_delay_s=0.01, max_delay_s=0.05)
    d = [pol.delay(a, token=42) for a in (1, 2, 3)]
    assert d == [pol.delay(a, token=42) for a in (1, 2, 3)]
    assert d != [pol.delay(a, token=43) for a in (1, 2, 3)]  # per-work jitter
    for attempt, delay in enumerate(d, start=1):
        raw = min(0.01 * 2.0 ** (attempt - 1), 0.05)
        assert 0.5 * raw <= delay < 1.5 * raw
    with pytest.raises(ValueError, match="1-based"):
        pol.delay(0)


def test_retry_delays_are_the_references():
    for seed in range(3):
        port = RetryPolicy(max_retries=4, base_delay_s=0.002, seed=seed)
        ref = ref_faults.RetryPolicy(max_retries=4, base_delay_s=0.002,
                                     seed=seed)
        for token in (0, 1, 17, 2**40):
            assert [port.delay(a, token) for a in range(1, 8)] == \
                [ref.delay(a, token) for a in range(1, 8)]


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(failure_threshold=2, cooldown_s=1.0)
    assert br.state == CLOSED and br.allow(0.0)
    br.record_failure(0.0)
    assert br.state == CLOSED                     # below threshold
    br.record_failure(0.1)
    assert br.state == OPEN and br.opens == 1
    assert not br.allow(0.5)                      # cooling down
    assert br.would_allow(1.2) and br.state == OPEN   # pure peek
    assert br.allow(1.2) and br.state == HALF_OPEN and br.probes == 1
    assert not br.allow(1.3)                      # one probe in flight
    br.record_failure(1.4)                        # probe failed
    assert br.state == OPEN and br.opens == 2
    assert br.allow(2.5)                          # second probe
    br.record_success()
    assert br.state == CLOSED and br.allow(2.6)


def test_scripted_breaker_trajectory_is_the_references():
    """A worker's life as the service drives it: each tick may trip the
    breaker (a host loss), else asks it for admission and, when admitted,
    reports a seeded success or failure; both breakers move in lockstep."""
    rng = np.random.default_rng(11)
    port = CircuitBreaker(failure_threshold=3, cooldown_s=0.4)
    ref = ref_faults.CircuitBreaker(failure_threshold=3, cooldown_s=0.4)
    now = 0.0
    for _ in range(600):
        now += float(rng.exponential(0.05))
        trip, fail = rng.random() < 0.02, rng.random() < 0.4
        assert port.would_allow(now) == ref.would_allow(now)
        if trip:
            port.trip(now)
            ref.trip(now)
            continue
        admitted = port.allow(now)
        assert admitted == ref.allow(now)
        if admitted:
            if fail:
                port.record_failure(now)
                ref.record_failure(now)
            else:
                port.record_success()
                ref.record_success()
        assert (port.state, port.failures, port.opened_at, port.opens,
                port.probes) == (ref.state, ref.failures, ref.opened_at,
                                 ref.opens, ref.probes)
    assert port.opens > 3 and port.probes > 3


@pytest.mark.parametrize("make_error", [
    lambda: DeviceLostError(1),
    lambda: HostLostError(1, 0, (0, 1)),
    lambda: ClockLockError("nvml lock refused"),
    lambda: PlanBuildError("no plan for shape"),
    lambda: WorkerStalledError(2, 0.5),
    lambda: ProcessCrashError(17),
    lambda: DrainDeadlineError(1.0, ["stuck-key"]),
], ids=["device-lost", "host-lost", "clock-lock", "plan-build",
        "worker-stalled", "process-crash", "drain-deadline"])
def test_fault_error_snapshots_the_ports_flight_recorder(make_error):
    tr = Tracer(timer=FakeTimer(dt=1.0))
    with tr.span("batch", worker=0):
        pass
    err = make_error()                 # construction triggers the snapshot
    assert len(tr.flight.snapshots) == 1
    snap = tr.flight.snapshots[0]
    assert snap.error_type == type(err).__name__
    assert snap.message == str(err)
    assert [s.name for s in snap.spans[0]] == ["batch"]
    ref_err = {"DeviceLostError": lambda: ref_faults.DeviceLostError(1),
               "ProcessCrashError": lambda: ref_faults.ProcessCrashError(17),
               "DrainDeadlineError": lambda: ref_faults.DrainDeadlineError(
                   1.0, ["stuck-key"])}.get(type(err).__name__)
    if ref_err is not None:
        assert str(err) == str(ref_err())


def test_host_topology_is_the_references():
    from repro_torch.runtime.faults import HostTopology
    for n, per in ((4, 2), (5, 2), (3, 1)):
        port, ref = HostTopology(n, per), ref_faults.HostTopology(n, per)
        assert port.n_hosts == ref.n_hosts
        assert [port.host_of(w) for w in range(n)] == \
            [ref.host_of(w) for w in range(n)]
        assert [port.workers_of(h) for h in range(port.n_hosts)] == \
            [ref.workers_of(h) for h in range(ref.n_hosts)]
    with pytest.raises(ValueError):
        HostTopology(0)


# ---------------------------------------------------------------------------
# device lost mid-batch -> retried elsewhere, no request lost
# ---------------------------------------------------------------------------

def test_device_lost_mid_batch_is_retried_no_request_lost():
    plan = FaultPlan([FaultEvent(KILL_DEVICE, batch_id=0)])
    svc = service(n_workers=2, fault_plan=plan)
    reqs = [svc.submit(rand_complex(i, (2, 256))) for i in range(3)]
    receipts = svc.drain()
    assert len(receipts) == len(reqs)             # exactly one receipt each
    assert all(r.status == "served" for r in receipts)
    assert all(r.outcome == "retried" and r.retries == 1 for r in receipts)
    assert plan.fired_count(KILL_DEVICE) == 1
    assert all(r.worker == 1 for r in receipts)   # the other slot ran it
    assert_close(receipts[0].result, np.fft.fft(reqs[0].x, axis=-1), RTOL)
    rep = svc.report()
    assert rep.retried == 3 and rep.availability == 1.0


def test_retries_exhausted_sheds_with_receipts():
    plan = FaultPlan([FaultEvent(KILL_DEVICE, batch_id=0)] * 3)
    svc = service(n_workers=2, fault_plan=plan)   # default max_retries=2
    reqs = [svc.submit(rand_complex(i, (1, 256))) for i in range(2)]
    receipts = svc.drain()
    assert len(receipts) == len(reqs)
    assert all(r.status == "shed" and r.outcome == "shed" for r in receipts)
    assert all(r.reason == "fault:retries-exhausted" for r in receipts)
    rep = svc.report()
    assert rep.shed == 2 and rep.fault_shed == 2
    assert rep.availability == 0.0
    ok = svc.submit(rand_complex(5, (1, 256)))
    (r,) = svc.drain()
    assert r.status == "served" and svc.receipt(ok) is r


# ---------------------------------------------------------------------------
# clock-lock failure -> boost, not crash; plan-build failure -> rung 1
# ---------------------------------------------------------------------------

def test_failed_clock_lock_degrades_to_boost():
    plan = FaultPlan([FaultEvent(FAIL_CLOCK_LOCK, batch_id=0)])
    svc = service(n_workers=1, fault_plan=plan)
    svc.submit(rand_complex(0, (2, 512)))
    (r,) = svc.drain()
    assert r.status == "served"
    assert r.rung == RUNG_BOOST_HEURISTIC and r.rung_name == "boost-heuristic"
    assert r.reason == "fault:clock-lock-failed"
    assert r.clock_mhz == pytest.approx(TESLA_V100.f_max)
    assert svc.clock.lock_count == 0              # the lock was never taken
    svc.submit(rand_complex(1, (2, 512)))
    (r2,) = svc.drain()
    assert r2.rung == 0 and r2.reason is None
    assert svc.clock.lock_count == 1


def test_plan_build_failure_walks_down_the_ladder():
    plan = FaultPlan([FaultEvent(FAIL_PLAN_BUILD, batch_id=0)])
    svc = service(n_workers=1, fault_plan=plan)
    req = svc.submit(rand_complex(0, (2, 512)))
    (r,) = svc.drain()
    assert r.status == "served" and r.rung == RUNG_BOOST_HEURISTIC
    assert r.reason == "fault:plan-build-failed"
    assert svc.cache.stats.degraded_builds == 1
    assert svc.cache.stats.sweeps == 0
    assert [rec.kernel for rec in r.launches] == ["fft-c2c"]   # rung 1 runs
    assert_close(r.result, np.fft.fft(req.x, axis=-1), RTOL)   # kernels


def test_plan_build_error_is_never_caught_by_the_ladder():
    """A plan build that raises (not an injected FAIL_PLAN_BUILD event)
    propagates through drain(): the request is re-queued, not walked down
    to rung 1 and not receipted."""
    svc = service(n_workers=1)

    def failing(key):
        raise PlanBuildError(f"no tuned plan for {key.n}")

    svc.cache.entry = failing
    req = svc.submit(rand_complex(0, (1, 256)))
    with pytest.raises(PlanBuildError, match="no tuned plan for 256"):
        svc.drain()
    assert svc.receipt(req) is None and svc._pending == [req]
    assert svc.cache.stats.degraded_builds == 0


def test_kernel_error_is_never_caught_by_the_ladder(monkeypatch):
    """A kernel that raises propagates through drain(): no rung catches it
    and carries on elsewhere; the request is re-queued, not receipted."""
    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(plan_mod, "_kernel_fft", broken)
    svc = service(n_workers=2)
    req = svc.submit(rand_complex(0, (1, 256)))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        svc.drain()
    assert svc.receipt(req) is None and svc._pending == [req]
    assert svc.redistributions == 0 and svc.report().shed == 0


# ---------------------------------------------------------------------------
# stalls, redistribution, drain deadline, breakers
# ---------------------------------------------------------------------------

def test_stalled_worker_work_is_redistributed():
    plan = FaultPlan([FaultEvent(STALL_WORKER, batch_id=0, duration=1e9)])
    svc = service(n_workers=2, fault_plan=plan)
    reqs = [svc.submit(rand_complex(i, (1, 256))) for i in range(2)]
    receipts = svc.drain()
    assert len(receipts) == len(reqs)
    assert all(r.status == "served" for r in receipts)
    assert svc.stalls_honoured == 1
    assert svc.redistributions >= 1
    assert all(r.worker == 1 for r in receipts)   # worker 0 is wedged


def test_drain_deadline_surfaces_stuck_shape():
    plan = FaultPlan([FaultEvent(STALL_WORKER, batch_id=0, duration=1e9)])
    svc = service(n_workers=1, timer=FakeTimer(dt=1.0), fault_plan=plan)
    svc.submit(rand_complex(0, (1, 256)))
    with pytest.raises(DrainDeadlineError) as err:
        svc.drain(deadline_s=25.0)
    assert err.value.deadline_s == 25.0
    assert [k.n for k in err.value.stuck] == [256]
    assert len(svc._pending) == 1                 # re-queued, not dropped


def test_breaker_quarantines_then_readmits_after_probe():
    timer = FakeTimer(dt=0.0, t0=1.0)             # frozen; advanced by hand
    plan = FaultPlan([FaultEvent(KILL_DEVICE, batch_id=0, worker=0)])
    svc = service(n_workers=2, timer=timer, fault_plan=plan,
                  breaker_threshold=1, breaker_cooldown_s=10.0)
    svc.submit(rand_complex(0, (1, 256)))
    (r,) = svc.drain()                            # kill -> open -> retried
    assert r.retries == 1 and svc.breakers[0].state == OPEN
    svc.submit(rand_complex(1, (1, 256)))
    (r2,) = svc.drain()
    assert r2.worker == 1 and svc.breakers[0].state == OPEN
    timer.advance(60.0)
    svc.submit(rand_complex(2, (1, 256)))
    (r3,) = svc.drain()
    assert r3.worker == 0 and r3.status == "served"
    assert svc.breakers[0].state == CLOSED
    assert svc.breakers[0].probes == 1
    assert svc.report().breaker_opens == 1


# ---------------------------------------------------------------------------
# admission control and the degradation ladder
# ---------------------------------------------------------------------------

def test_queue_depth_cap_sheds_with_receipts():
    policy = SLOPolicy(default=SLO(max_queue_transforms=4))
    svc = service(n_workers=1, slo=policy)
    reqs = [svc.submit(rand_complex(i, (2, 256))) for i in range(3)]
    receipts = svc.drain()
    assert len(receipts) == 3
    by_req = {r.request.request_id: r for r in receipts}
    assert by_req[reqs[0].request_id].status == "served"
    assert by_req[reqs[1].request_id].status == "served"
    shed = by_req[reqs[2].request_id]
    assert shed.status == "shed" and shed.reason == "admission:queue-full"
    assert shed.i_ef_boost == 1.0 and shed.energy_error_frac is None
    rep = svc.report()
    assert rep.shed == 1 and rep.fault_shed == 0
    assert rep.availability == 1.0                # admission sheds excluded


def test_backlog_pressure_degrades_to_boost_heuristic():
    policy = SLOPolicy(default=SLO(deadline_s=1.0, degrade_at=0.0,
                                   degrade_hard_at=None, shed_at=None))
    svc = service(n_workers=1, slo=policy)
    svc.submit(rand_complex(0, (2, 512)))
    (r,) = svc.drain()
    assert r.status == "served" and r.rung == RUNG_BOOST_HEURISTIC
    assert r.reason == "admission:backlog"
    assert r.clock_mhz == pytest.approx(TESLA_V100.f_max)
    assert svc.cache.stats.sweeps == 0            # sweep skipped entirely
    assert svc.cache.stats.degraded_builds == 1


@pytest.mark.parametrize("shape,ndim,transform", [
    ((2, 4096), 1, "c2c"), ((3, 2**15), 1, "c2c"), ((2, 1024), 1, "r2c"),
    ((2, 32, 64), 2, "c2c")],
    ids=["stockham", "four-step", "r2c", "2d"])
def test_hard_pressure_reaches_pure_torch_rung(monkeypatch, shape, ndim,
                                               transform):
    """Rung 2 launches no hand-written kernel: every kernel hook of
    repro_torch.fft.plan counts its calls, and none is called."""
    calls = []
    for name in [n for n in vars(plan_mod) if n.startswith("_kernel_")]:
        if name == "_kernel_overrides":
            continue
        orig = getattr(plan_mod, name)

        def counting(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(plan_mod, name, counting)
    policy = SLOPolicy(default=SLO(deadline_s=1.0, degrade_at=0.0,
                                   degrade_hard_at=0.0, shed_at=None))
    svc = service(n_workers=1, slo=policy)
    x = rand_complex(3, shape)
    if transform == "r2c":
        x = x.real.copy()
    req = svc.submit(x, ndim=ndim, transform=transform)
    mark = len(svc.ledger.records)
    (r,) = svc.drain()
    assert r.rung == RUNG_PURE_TORCH and r.rung_name == "pure-torch"
    assert r.reason == "admission:backlog-hard"
    assert calls == []                            # zero kernel launches
    assert len(svc.ledger.records) == mark        # and none recorded
    axes = tuple(range(-ndim, 0))
    ref = (np.fft.rfftn(x, axes=axes) if transform == "r2c"
           else np.fft.fftn(x, axes=axes))
    assert_close(r.result, ref, 2e-5)
    # the same shape at rung 0 goes back through the kernels
    svc.slo = svc.admission = None
    svc.submit(x, ndim=ndim, transform=transform)
    svc.drain()
    assert calls


@pytest.mark.cuda
def test_hard_pressure_on_the_card_keeps_the_kernels():
    """On a card slot rung 2 runs the boost heuristic plan's kernels (a
    tensor on the card never leaves them), receipted as rung 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    from repro_torch.kernels.fft import fft_kernel as K
    policy = SLOPolicy(default=SLO(deadline_s=1.0, degrade_at=0.0,
                                   degrade_hard_at=0.0, shed_at=None))
    svc = FFTService(TESLA_V100, devices=[torch.device("cuda", 0)],
                     slo=policy)
    x = rand_complex(3, (2, 4096))
    svc.submit(x)
    K.reset_launches()
    (r,) = svc.drain()
    assert r.rung == RUNG_PURE_TORCH and r.reason == "admission:backlog-hard"
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"fft_c2c": 1}
    assert_close(r.result.cpu(), np.fft.fft(x, axis=-1), RTOL)


def test_deadline_pressure_sheds():
    policy = SLOPolicy(default=SLO(deadline_s=1e-12))
    svc = service(n_workers=1, slo=policy)
    req = svc.submit(rand_complex(0, (2, 256)))
    (r,) = svc.drain()
    assert r.status == "shed" and r.reason == "admission:deadline"
    assert svc.receipt(req) is r
    assert svc.admission.shed == 1


def test_science_kinds_cap_at_boost_heuristic():
    assert max_rung_for_kind("fft") == RUNG_PURE_TORCH
    assert max_rung_for_kind("fdas") == RUNG_BOOST_HEURISTIC
    assert max_rung_for_kind("pulsar") == RUNG_BOOST_HEURISTIC


def test_degraded_pulsar_build_sweeps_nothing():
    """The degraded pulsar entry prices every stage at boost: no clock-grid
    sweep anywhere on its build path."""
    def no_sweep(*a, **kw):
        raise AssertionError("degraded build swept")

    svc = FFTService(TESLA_V100, devices=[CPU], sweep_fn=no_sweep)
    req = svc.submit(np.zeros((1, 16, 64), np.float32), kind="pulsar",
                     dm_trials=2, templates=3, n_harmonics=2)
    entry = svc.cache.degraded_entry(req.shape_key(TESLA_V100.name))
    assert svc.cache.stats.degraded_builds == 1
    assert svc.cache.stats.sweeps == 0
    assert all(s.f == TESLA_V100.f_max for s in entry.stages.stages)
    assert entry.sweep.points == [entry.sweep.boost]


# ---------------------------------------------------------------------------
# reproducibility: same fault-plan seed => same outcomes
# ---------------------------------------------------------------------------

def _chaos_outcomes(seed):
    svc = service(n_workers=2,
                  fault_plan=FaultPlan.generate(
                      seed, n_batches=8, kill_rate=0.2, clock_fail_rate=0.2,
                      plan_fail_rate=0.2, stall_rate=0.1,
                      stall_duration_s=0.0),
                  timer=FakeTimer(dt=1e-4))
    out = []
    for wave in range(8):
        for i in range(2):
            svc.submit(rand_complex(wave * 2 + i, (1, 256)))
        out.extend((r.outcome, r.rung, r.reason) for r in svc.drain())
    return out


def test_same_fault_seed_reproduces_outcomes():
    a = _chaos_outcomes(5)
    assert a == _chaos_outcomes(5)
    assert any(o != ("served", 0, None) for o in a)


# ---------------------------------------------------------------------------
# observability of the robust service (tests/test_obs.py's serving checks)
# ---------------------------------------------------------------------------

def _observed_service():
    from repro_torch.power import FleetTelemetry
    timer = FakeTimer(dt=1e-4)
    tracer = Tracer(timer=timer)
    plan = FaultPlan([FaultEvent(KILL_DEVICE, batch_id=1)])
    svc = FFTService(
        TESLA_V100, devices=[CPU, CPU], timer=timer, tracer=tracer,
        fault_plan=plan,
        telemetry=FleetTelemetry.for_serving(TESLA_V100, seed=7,
                                             noise_frac=0.0))
    for i in range(4):
        svc.submit(rand_complex(i, (2, 64)))
        svc.drain()
    return svc, tracer


def test_service_spans_snapshots_and_metrics_text():
    import json
    import os
    svc, tracer = _observed_service()
    execs = [s for s in tracer.spans if s.name == "execute"]
    assert len(execs) == 4 and all(s.parent == "batch" for s in execs)
    assert all(s.attrs["kind"] == "fft" and s.attrs["rung"] == 0
               for s in execs)
    # the kill fired inside the batch span: the flight recorder kept it
    (snap,) = tracer.flight.snapshots
    assert snap.error_type == "DeviceLostError"
    assert [s.name for s in snap.open_spans] == ["batch"]
    for r in svc.receipts:
        assert [rec.kernel for rec in r.launches] == ["fft-c2c"]
        assert r.measured_energy_j is not None
        assert abs(r.energy_error_frac) < 0.5
    rep = svc.report()
    assert rep.drift is not None and rep.drift["observations"] == 4
    assert rep.telemetry["reads"] == 4 and rep.retried == 1
    text = svc.metrics_text()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCH_obs.json")) as f:
        series = set(json.load(f)["metrics_series"])
    names = {line.split("{")[0].split(" ")[0]
             for line in text.splitlines() if not line.startswith("#")}
    assert series <= names, series - names
    for line in ("repro_requests_served_total 4", "repro_availability 1",
                 "repro_dispatch_workers 2", "repro_breaker_opens 0"):
        assert line in text, line
