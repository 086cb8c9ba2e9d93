"""The robust service against the reference's: one mixed stream of about
200 requests (C2C 256 and 512, R2C 512 and one (2, 64, 64) rank-2 shape)
through ``repro.serving.FFTService`` on four CPU worker slots and
``repro_torch.serving.FFTService`` on ``[torch.device("cpu")] * 4``, each
with the same fake-timer script, the same seeded ``FaultPlan`` (every
serving fault kind, two ``CRASH_PROCESS`` arrivals and a ``KILL_HOST``),
the same ``SLOPolicy``, simulated telemetry with the same seed and the
paper's Tesla V100 model.  Both harnesses crash at the same arrivals,
snapshot after every wave and recover from their journals.

They must write byte-identical journal segments and snapshots, give equal
outcome digests, replay recovered receipts equal field by field, and end
with equal ``ServiceReport`` fields; the port's results are within 2e-5 of
``np.fft``."""
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import jax
from test_torch_parity import fresh_signatures, rand_complex
import repro.core.hardware as ref_hw
import repro.power as ref_power
import repro.runtime.faults as ref_faults
import repro.runtime.journal as ref_journal
import repro.serving as ref_serving
import repro_torch.core.hardware as port_hw
import repro_torch.power as port_power
import repro_torch.runtime.faults as port_faults
import repro_torch.runtime.journal as port_journal
import repro_torch.serving as port_serving

N_REQUESTS = 200
WAVES = (5, 40)
SEED = 2
CRASH_ARRIVALS = (70, 140)
HOST_KILL_BATCHES = (9,)
RTOL = 2e-5
RECEIPT_FIELDS = ("status", "reason", "rung", "retries", "batch_id",
                  "worker", "clock_mhz", "modelled_time_s", "energy_j",
                  "boost_energy_j", "measured_energy_j", "realtime_margin",
                  "recovered", "incarnation")


def _pool():
    rng = np.random.default_rng(SEED)
    return {
        "fft": {(n, b): rand_complex(10 * n + b, (b, n))
                for n in (256, 512) for b in (1, 2, 3)},
        "r2c": {b: rng.standard_normal((b, 512)).astype(np.float32)
                for b in (1, 2)},
        "fft2": rand_complex(7, (2, 64, 64)),
    }


def _payload(i, pool):
    if i % 53 == 17:
        return pool["fft2"], {"ndim": 2}
    if i % 7 == 3:
        return pool["r2c"][1 + i % 2], {"transform": "r2c"}
    return pool["fft"][((256, 512)[i % 2], 1 + i % 3)], {}


def _waves():
    """Alternating short and long waves: the short ones drain at rung 0,
    the long ones build the backlog that degrades and sheds."""
    start, k = 0, 0
    while start < N_REQUESTS:
        stop = min(start + WAVES[k % len(WAVES)], N_REQUESTS)
        yield start, stop
        start, k = stop, k + 1


class TickTimer:
    """The shared fake-timer script: 0.1 ms a reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-4
        return self.t


PACKAGES = {
    "ref": dict(hw=ref_hw, power=ref_power, faults=ref_faults,
                journal=ref_journal, serving=ref_serving,
                devices=lambda: [jax.devices("cpu")[0]] * 4),
    "port": dict(hw=port_hw, power=port_power, faults=port_faults,
                 journal=port_journal, serving=port_serving,
                 devices=lambda: [torch.device("cpu")] * 4),
}


def _run(pkg: str, jdir: str):
    """The crash-and-recover harness of benchmarks/run.py's recovery
    target, at this stream's size; returns what the test compares."""
    p = PACKAGES[pkg]
    faults, serving = p["faults"], p["serving"]
    v100 = p["hw"].TESLA_V100
    pool = _pool()
    timer = TickTimer()
    topology = faults.HostTopology(4, devices_per_host=2)

    def make_plan():
        return faults.FaultPlan.generate(
            SEED, n_batches=120, kill_rate=0.05, clock_fail_rate=0.05,
            plan_fail_rate=0.03, stall_rate=0.03, stall_duration_s=0.002,
            crash_arrivals=CRASH_ARRIVALS,
            host_kill_batches=HOST_KILL_BATCHES)

    def build(plan, recover_from=None):
        kwargs = dict(
            device_spec=v100, devices=p["devices"](), timer=timer,
            keep_results=True,
            slo=serving.SLOPolicy(default=serving.SLO(
                deadline_s=8e-7, degrade_at=0.4, degrade_hard_at=0.7,
                shed_at=1.0)),
            fault_plan=plan, drain_deadline_s=300.0, topology=topology,
            telemetry=p["power"].FleetTelemetry.for_serving(
                v100, seed=SEED, fault_plan=plan))
        if recover_from is not None:
            return serving.FFTService.recover(
                recover_from,
                payload_fn=lambda ref, meta: _payload(ref, pool)[0],
                **kwargs)
        return serving.FFTService(journal=p["journal"].RequestJournal(jdir),
                                  **kwargs)

    outcomes, recovered, live, fired = {}, [], [], {}
    host_kills = 0
    plan = make_plan()
    svc = build(plan)

    def absorb(svc, plan):
        nonlocal host_kills
        host_kills += svc.host_kills
        for ev in plan.fired:
            fired[ev.kind] = fired.get(ev.kind, 0) + 1

    def collect(receipts):
        for r in receipts:
            key = r.request.payload_ref
            t = (r.request.kind, r.outcome, r.rung, r.reason)
            if r.recovered:
                recovered.append(tuple(getattr(r, f)
                                       for f in RECEIPT_FIELDS))
                assert outcomes.setdefault(key, t) == t   # bit-identical
            else:
                assert key not in outcomes                # never twice
                outcomes[key] = t
                live.append(r)

    for start, stop in _waves():
        for i in range(start, stop):
            if plan.take(faults.CRASH_PROCESS, arrival=i) is not None:
                absorb(svc, plan)
                svc.journal.crash()
                plan = make_plan()
                svc = build(plan, recover_from=jdir)
                plan.drop_consumed(batch_before=svc._next_batch_id,
                                   arrival_before=i + 1)
                collect(svc.recovered_receipts)
            x, kw = _payload(i, pool)
            svc.submit(x, payload_ref=i, **kw)
        collect(svc.drain())
        svc.snapshot()
    absorb(svc, plan)
    report = svc.report()
    svc.journal.close()
    h = hashlib.blake2b(digest_size=16)
    for i in range(N_REQUESTS):
        t = outcomes.get(i)
        h.update(f"{t[0]}:{t[1]}:{t[2]}:{t[3]}".encode()
                 if t is not None else b"MISSING")
    return dict(digest=h.hexdigest(), outcomes=outcomes, recovered=recovered,
                live=live, report=report, fired=fired,
                incarnation=svc.journal.incarnation, host_kills=host_kills)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    fresh_signatures()
    out = {}
    for pkg in PACKAGES:
        jdir = str(tmp_path_factory.mktemp(pkg) / "journal")
        out[pkg] = (jdir, _run(pkg, jdir))
    return out


def test_journals_are_byte_identical(runs):
    (ref_dir, _), (port_dir, _) = runs["ref"], runs["port"]
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    assert sum(n.startswith("seg-") for n in names) == 3   # 3 incarnations
    assert sum(n.startswith("snap-") for n in names) >= 8
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            assert f.read() == want, name


def test_outcome_digests_are_equal_and_nothing_is_lost(runs):
    ref, port = runs["ref"][1], runs["port"][1]
    assert port["digest"] == ref["digest"]
    assert port["outcomes"] == ref["outcomes"]
    assert sorted(port["outcomes"]) == list(range(N_REQUESTS))
    assert port["incarnation"] == ref["incarnation"] == "i3"
    # the stream is not trivial: every serving fault kind fired, the host
    # kill and both crashes among them, sensor faults too, and every rung
    # and outcome occurs
    assert port["fired"] == ref["fired"]
    assert {"kill-device", "kill-host", "fail-clock-lock",
            "fail-plan-build", "stall-worker", "sensor-dropout",
            "sensor-spike", "crash-process"} <= set(port["fired"])
    kinds = {(o, r) for _, o, r, _ in port["outcomes"].values()}
    assert {("served", 0), ("served", 1), ("served", 2), ("retried", 0),
            ("retried", 2), ("shed", 0)} <= kinds
    audit = port_serving.ReplayResult(retain=0)
    _, stats = port_journal.read_journal(runs["port"][0], sink=audit.feed)
    assert stats.invalid == 0 and audit.open_admits == []
    assert audit.admits_total == audit.terminals_total == N_REQUESTS
    assert audit.duplicate_terminals == 0


def test_recovered_receipts_are_equal_field_by_field(runs):
    ref, port = runs["ref"][1], runs["port"][1]
    assert len(port["recovered"]) > 0
    assert port["recovered"] == ref["recovered"]


def test_live_receipts_and_reports_are_equal(runs):
    ref, port = runs["ref"][1], runs["port"][1]
    assert [tuple(getattr(r, f) for f in RECEIPT_FIELDS)
            for r in port["live"]] == \
        [tuple(getattr(r, f) for f in RECEIPT_FIELDS) for r in ref["live"]]
    rep_ref, rep_port = ref["report"], port["report"]
    for field in dataclasses.fields(rep_port):
        got, want = (getattr(rep_port, field.name),
                     getattr(rep_ref, field.name))
        if field.name == "cache":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, field.name
    assert rep_port.availability == rep_ref.availability
    assert port["host_kills"] == ref["host_kills"] == 1


def test_served_results_match_numpy(runs):
    pool = _pool()
    checked = 0
    for r in runs["port"][1]["live"]:
        if r.status != "served":
            continue
        x, kw = _payload(r.request.payload_ref, pool)
        if kw.get("ndim") == 2:
            want = np.fft.fft2(x)
        elif kw.get("transform") == "r2c":
            want = np.fft.rfft(x)
        else:
            want = np.fft.fft(x)
        got = r.result.numpy()
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
        checked += 1
    assert checked > 100
