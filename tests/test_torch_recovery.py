"""The port's crash recovery on the CPU (``repro_torch.serving.recovery``
and ``repro_torch.runtime.journal``): the claims of
``tests/test_recovery.py`` — exactly-once receipts, bit-identical replay,
snapshot/restore of durable service state, host-level fault domains and
the FaultPlan arrival seam — on ``devices=[torch.device("cpu")] * n`` and
the paper's Tesla V100 model.  The reference-vs-port service parity test
is in ``test_torch_recovery_parity.py``."""
import numpy as np
import pytest
import torch

from test_torch_parity import rand_complex as _rand
from repro_torch.core.hardware import TESLA_V100
from repro_torch.obs.ledger import launches_digest
from repro_torch.power import FleetTelemetry
from repro_torch.power.governor import PowerGovernor
from repro_torch.runtime.faults import (KILL_HOST, OPEN, FaultEvent,
                                        FaultPlan, HostTopology)
from repro_torch.runtime.journal import (ADMIT, SERVED, SHED, JournalRecord,
                                         RequestJournal, read_journal)
from repro_torch.runtime.journal import OPEN as J_OPEN
from repro_torch.serving import FFTService, ReplayResult, replay_journal
from repro_torch.serving.recovery import (ServiceSnapshot, governor_state,
                                          restore_governor)

CPU = torch.device("cpu")


class FakeTimer:
    def __init__(self, dt=0.0, t0=0.0):
        self.t = t0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


PAYLOADS = {i: _rand(100 + i, (2, 256)) for i in range(8)}


def payload_fn(ref, meta):
    return PAYLOADS[ref]


def service(journal=None, n_workers=2, **kw):
    return FFTService(TESLA_V100, devices=[CPU] * n_workers,
                      timer=FakeTimer(), keep_results=False,
                      journal=journal, **kw)


def recover(journal_dir, n_workers=2, **kw):
    kw.setdefault("payload_fn", payload_fn)
    return FFTService.recover(journal_dir, devices=[CPU] * n_workers,
                              timer=FakeTimer(), keep_results=False, **kw)


def submit_refs(svc, refs):
    for i in refs:
        svc.submit(PAYLOADS[i], payload_ref=i)


# ---------------------------------------------------------------------------
# exactly-once receipts across a crash
# ---------------------------------------------------------------------------

def test_exactly_once_receipts_across_crash(tmp_path):
    jdir = str(tmp_path / "j")
    svc = service(RequestJournal(jdir))
    submit_refs(svc, range(4))
    first = svc.drain()
    assert len(first) == 4
    svc.snapshot()
    submit_refs(svc, range(4, 6))        # admitted, never drained
    svc.journal.crash()                  # kill -9 mid-wave

    svc2 = recover(jdir)
    # Terminated work replays; in-flight work re-enqueues.
    assert len(svc2.recovered_receipts) == 4
    assert all(r.recovered and r.incarnation == "i2"
               for r in svc2.recovered_receipts)
    assert svc2.replay.admits_total == 6
    assert [req.jseq for req in svc2._pending] == svc2.replay.open_admits
    assert len(svc2._pending) == 2
    second = svc2.drain()
    assert len(second) == 2
    assert {r.request.payload_ref for r in second} == {4, 5}
    svc2.journal.close()

    # The durable log proves it: 6 admits, 6 terminals, no dups, no opens.
    audit = ReplayResult(retain=0)
    _, stats = read_journal(jdir, sink=audit.feed)
    assert stats.invalid == 0
    assert audit.admits_total == 6 and audit.terminals_total == 6
    assert audit.open_admits == [] and audit.duplicate_terminals == 0
    assert audit.duplicate_rate == 0.0


def test_replayed_receipts_bit_identical(tmp_path):
    jdir = str(tmp_path / "j")
    svc = service(RequestJournal(jdir))
    submit_refs(svc, range(4))
    originals = {r.request.payload_ref: r for r in svc.drain()}
    svc.snapshot()
    svc.journal.crash()

    svc2 = recover(jdir)
    assert len(svc2.recovered_receipts) == 4
    for rep in svc2.recovered_receipts:
        orig = originals[rep.request.payload_ref]
        for f in ("status", "reason", "rung", "retries", "batch_id",
                  "worker", "clock_mhz", "modelled_time_s", "energy_j",
                  "boost_energy_j", "realtime_margin"):
            assert getattr(rep, f) == getattr(orig, f), f
        assert rep.launches == orig.launches       # ledger-replayed
        assert rep.recovered and not orig.recovered
        # receipt_for_seq finds the replayed receipt by durable identity.
        assert svc2.receipt_for_seq(orig.request.jseq) is rep
    svc2.journal.close()


def test_recovery_without_payload_fn_sheds_explicitly(tmp_path):
    jdir = str(tmp_path / "j")
    svc = service(RequestJournal(jdir))
    submit_refs(svc, range(2))
    svc.journal.crash()
    svc2 = recover(jdir, payload_fn=None)
    sheds = [r for r in svc2.receipts
             if r.reason == "recovery:payload-unresolvable"]
    assert len(sheds) == 2 and all(r.status == "shed" for r in sheds)
    assert svc2._pending == []
    svc2.journal.close()
    # Those sheds are terminal records too — exactly-once still holds.
    audit = ReplayResult(retain=0)
    read_journal(jdir, sink=audit.feed)
    assert audit.terminals_total == 2 and audit.open_admits == []


def test_double_crash_replays_once_per_request(tmp_path):
    jdir = str(tmp_path / "j")
    svc = service(RequestJournal(jdir))
    submit_refs(svc, range(2))
    svc.drain()
    svc.snapshot()
    svc.journal.crash()
    svc2 = recover(jdir)
    submit_refs(svc2, range(2, 4))
    svc2.drain()
    svc2.journal.crash()                 # crash again before a snapshot
    svc3 = recover(jdir)
    assert svc3.journal.incarnation == "i3"
    assert len(svc3.recovered_receipts) == 4
    refs = sorted(r.request.payload_ref for r in svc3.recovered_receipts)
    assert refs == [0, 1, 2, 3]
    svc3.journal.close()
    audit = ReplayResult(retain=0)
    read_journal(jdir, sink=audit.feed)
    assert audit.admits_total == audit.terminals_total == 4
    assert audit.duplicate_terminals == 0 and audit.incarnations == 3


# ---------------------------------------------------------------------------
# warm-cache recovery reproduces the uncrashed launches digest
# ---------------------------------------------------------------------------

def test_recovered_service_matches_uncrashed_launches_digest(tmp_path):
    def run(crash):
        jdir = str(tmp_path / ("crash" if crash else "clean"))
        svc = service(RequestJournal(jdir))
        submit_refs(svc, range(4))
        receipts = list(svc.drain())
        if crash:
            svc.snapshot()
            svc.journal.crash()
            svc = recover(jdir)
            assert svc.cache.stats.plan_builds > 0   # warm rebuild ran
        submit_refs(svc, range(4, 8))
        receipts += svc.drain()
        svc.journal.close()
        receipts.sort(key=lambda r: r.request.payload_ref)
        return launches_digest(r.launches for r in receipts), receipts

    d_clean, r_clean = run(crash=False)
    d_crash, r_crash = run(crash=True)
    assert d_clean == d_crash
    for a, b in zip(r_clean, r_crash):
        assert (a.status, a.rung, a.reason) == (b.status, b.rung, b.reason)


# ---------------------------------------------------------------------------
# snapshot / restore of durable state
# ---------------------------------------------------------------------------

def test_snapshot_restores_breakers_drift_metrics_and_cache(tmp_path):
    jdir = str(tmp_path / "j")
    tele = FleetTelemetry.for_serving(TESLA_V100, seed=0)
    svc = service(RequestJournal(jdir), telemetry=tele)
    submit_refs(svc, range(3))
    svc.drain()
    br = svc._breaker(1)
    br.state = OPEN
    br.failures = 2
    br.opened_at = 1.5
    br.opens = 3
    dog = tele.watchdog(0)
    dog.health = "degraded"
    dog.unhealthy_entries = 7
    svc.snapshot()
    svc.journal.crash()

    tele2 = FleetTelemetry.for_serving(TESLA_V100, seed=0)
    svc2 = recover(jdir, telemetry=tele2)
    br2 = svc2.breakers[1]
    assert (br2.state, br2.failures, br2.opened_at, br2.opens) == \
        (OPEN, 2, 1.5, 3)
    assert tele2.watchdog(0).health == "degraded"
    assert tele2.watchdog(0).unhealthy_entries == 7
    assert svc2.drift.observations == svc.drift.observations
    # Warm cache: the snapshotted shape keys were rebuilt eagerly.
    assert {k for k, _ in svc2.cache._entries} == \
        {k for k, _ in svc.cache._entries}
    assert svc2.cache.stats.hits == svc.cache.stats.hits
    assert svc2.metrics.render() == svc.metrics.render()
    svc2.journal.close()


def test_governor_state_roundtrip():
    gov = PowerGovernor(TESLA_V100, target_w=100.0,
                        fallback_mhz=TESLA_V100.f_min)
    gov.step(140.0)
    gov.step(None, healthy=False)
    st = governor_state(gov)
    gov2 = PowerGovernor(TESLA_V100, target_w=50.0,
                         fallback_mhz=TESLA_V100.f_min)
    restore_governor(gov2, st)
    for f in ("f_mhz", "integral_w", "mode", "ticks", "moves",
              "fallback_engagements", "target_w"):
        assert getattr(gov2, f) == getattr(gov, f), f


def test_snapshot_requires_journal():
    svc = service(journal=None)
    with pytest.raises(ValueError, match="journal"):
        svc.snapshot()


# ---------------------------------------------------------------------------
# host-level fault domains
# ---------------------------------------------------------------------------

def test_host_topology_partitions_workers():
    topo = HostTopology(8, devices_per_host=4)
    assert topo.n_hosts == 2
    assert topo.host_of(3) == 0 and topo.host_of(4) == 1
    assert topo.workers_of(1) == (4, 5, 6, 7)


def test_host_kill_trips_whole_domain_and_clears_rings(tmp_path):
    topo = HostTopology(4, devices_per_host=2)
    tele = FleetTelemetry.for_serving(TESLA_V100, seed=0)
    plan = FaultPlan([FaultEvent(KILL_HOST)])
    svc = service(n_workers=4, topology=topo, telemetry=tele,
                  fault_plan=plan, sleep_fn=lambda s: None)
    submit_refs(svc, range(4))
    receipts = svc.drain()
    assert svc.host_kills == 1
    assert len(receipts) == 4                    # every request receipted
    # Both workers of the lost host were quarantined at once (breakers
    # tripped straight to open), not one-by-one via failure counting.
    tripped = [w for w, br in svc.breakers.items() if br.opens >= 1]
    assert len(tripped) == 2
    assert topo.host_of(tripped[0]) == topo.host_of(tripped[1])
    # Their telemetry rings were wiped but remember what they had seen.
    for w in tripped:
        ring = tele.rings.get(w)
        if ring is not None and ring.pushed:
            assert len(ring) == 0


def test_host_kill_exhausted_retries_shed_with_host_reason(tmp_path):
    # Three hosts so each retry lands on a live domain: with the frozen
    # FakeTimer a tripped breaker never cools down, so the shed must be
    # reached through three HostLostError catches (attempts 1..3 >
    # max_retries=2), never through the breaker-blocked bounce.
    topo = HostTopology(6, devices_per_host=2)
    plan = FaultPlan([FaultEvent(KILL_HOST),
                      FaultEvent(KILL_HOST), FaultEvent(KILL_HOST)])
    svc = service(n_workers=6, topology=topo, fault_plan=plan,
                  sleep_fn=lambda s: None)
    submit_refs(svc, range(2))
    receipts = svc.drain()
    assert svc.host_kills == 3
    assert all(r.status == "shed" and r.reason == "fault:host-lost"
               for r in receipts)
    assert len(receipts) == 2


# ---------------------------------------------------------------------------
# FaultPlan arrival seam (crash events do not perturb the seeded draws)
# ---------------------------------------------------------------------------

def test_fault_plan_arrival_seam_bit_identical():
    base = FaultPlan.generate(11, n_batches=50)
    seamed = FaultPlan.generate(11, n_batches=50,
                                crash_arrivals=(10, 20),
                                host_kill_batches=(7,))
    extras = [e for e in seamed.events
              if e.kind in ("crash-process", "kill-host")
              and (e.arrival in (10, 20) or e.batch_id == 7)]
    assert len(extras) == 3
    trimmed = [e for e in seamed.events if e not in extras]
    assert [(e.kind, e.batch_id, e.worker, e.arrival) for e in trimmed] \
        == [(e.kind, e.batch_id, e.worker, e.arrival) for e in base.events]


def test_fault_plan_take_by_arrival():
    plan = FaultPlan.generate(0, n_batches=4, crash_arrivals=(5,))
    assert plan.take("crash-process", arrival=4) is None
    assert plan.take("crash-process", arrival=5) is not None
    assert plan.take("crash-process", arrival=5) is None    # one-shot


# ---------------------------------------------------------------------------
# ReplayResult folding (dedup, windows, guarded ratios)
# ---------------------------------------------------------------------------

def term(seq, rseq, status="served", reason=None, rtype=SERVED):
    return JournalRecord(seq=seq, type=rtype,
                         data={"rseq": rseq, "status": status,
                               "reason": reason})


def test_replay_dedup_first_terminal_wins():
    recs = [
        JournalRecord(0, J_OPEN, {"incarnation": "i1"}),
        JournalRecord(1, ADMIT, {"payload_ref": 0}),
        JournalRecord(2, ADMIT, {"payload_ref": 1}),
        term(3, 1, status="served"),
        term(4, 1, status="shed", reason="fault:host-lost", rtype=SHED),
        term(5, 99),                     # terminal for an unknown admit
        term(6, 2, status="shed", reason="fault:host-lost", rtype=SHED),
    ]
    rep = replay_journal(recs)
    assert rep.admits_total == 2 and rep.terminals_total == 2
    assert rep.duplicate_terminals == 1
    assert rep.terminals[1]["status"] == "served"    # first one won
    assert rep.open_admits == []
    assert rep.served == 1 and rep.fault_shed == 1
    assert rep.availability == 0.5
    assert rep.duplicate_rate == pytest.approx(1 / 3)
    assert rep.incarnations == 1


def test_replay_retain_window_keeps_newest():
    recs = [JournalRecord(i, ADMIT, {"payload_ref": i}) for i in range(5)]
    recs += [term(5 + i, i) for i in range(5)]
    rep = replay_journal(recs, retain=2)
    assert rep.terminals_total == 5
    assert sorted(rep.terminals) == [3, 4]           # newest two payloads
    zero = replay_journal(recs, retain=0)
    assert zero.terminals == {} and zero.terminals_total == 5


def test_empty_journal_guarded_conventions():
    rep = ReplayResult()
    assert rep.availability == 1.0
    assert rep.duplicate_rate == 0.0
    assert rep.open_admits == []


def test_replay_tracks_open_admits_in_admit_order():
    recs = [JournalRecord(i, ADMIT, {"payload_ref": i}) for i in range(4)]
    recs.append(term(4, 1))
    rep = replay_journal(recs)
    assert rep.open_admits == [0, 2, 3]
    assert rep.open_admit_data[2]["payload_ref"] == 2
