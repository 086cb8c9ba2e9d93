"""Crash recovery for the serving layer: snapshot, replay, re-enqueue (the
counterpart of ``repro.serving.recovery``; its snapshots and journal
records are the reference's, field for field).

``repro_torch.runtime.journal`` gives the service a durable record of every
request's lifecycle (admit -> assign -> served/shed); this module turns
that record back into a *live* service after a process crash:

  snapshot   :class:`ServiceSnapshot` serialises the durable part of a
             running service — plan/sweep cache keys (+ the tuned configs
             they resolved to), circuit-breaker states, telemetry-watchdog
             health, drift-detector EWMAs, metrics counters, and
             optionally per-device power-governor state — into a JSON
             dict the journal persists atomically.
  replay     :func:`replay_journal` folds validated journal records into
             per-request state: which admits exist, which terminated,
             which terminal record came first (duplicates are counted,
             never replayed — the *first* durable terminal record is the
             receipt, full stop).
  recover    :func:`recover_service` (surfaced as
             ``FFTService.recover``) rebuilds a service: restore the
             snapshot, re-warm the plan cache, reconstruct a receipt for
             every already-terminated request (bit-identical
             ``status``/``reason``/``rung``, stamped ``recovered=True``
             with the new incarnation id) and re-enqueue every request
             that was admitted but never receipted.

Exactly-once receipts across any number of crashes follow from two
rules: (1) a request's durable identity is its journal admit seq
(``FFTRequest.jseq``), assigned once, write-ahead, and (2) a terminal
record is only appended *before* the in-memory receipt is stored, so a
request either has its terminal record (replayed, never re-executed) or
does not (re-enqueued, executed, terminated once).  Execution between
those two points is at-least-once — exactly like any WAL database —
but receipts, the client-visible outcome, are exactly-once.

Replayed-receipt accounting (``ReplayResult.availability`` /
``duplicate_rate``) follows the one documented zero-denominator
convention, :func:`repro_torch.core.energy.guarded_ratio`: an empty journal is
availability 1.0 and duplicate rate 0.0, never NaN.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

from repro_torch.core.energy import guarded_ratio
from repro_torch.runtime.journal import (ADMIT, ASSIGN, OPEN, TERMINAL_TYPES,
                                   JournalRecord, RequestJournal)
from repro_torch.serving.request import RequestReceipt, ShapeKey

__all__ = ["ReplayResult", "RecoveredRequest", "ServiceSnapshot",
           "replay_journal", "recover_service"]


# --------------------------------------------------------------------------- #
# journal record payloads (built by FFTService, parsed here)
# --------------------------------------------------------------------------- #

def admit_record(req) -> dict:
    """The JSON-safe admit payload for one request (the durable metadata
    a recovering process needs to rebuild the request, minus the payload
    itself, which ``payload_ref`` points back to)."""
    return {
        "kind": req.kind, "precision": req.precision,
        "transform": req.transform, "ndim": req.ndim,
        "templates": req.templates, "segment": req.segment,
        "dm_trials": req.dm_trials, "n_harmonics": req.n_harmonics,
        "latency_budget": req.latency_budget,
        "batch": req.batch, "shape": list(req.shape),
        "payload_ref": req.payload_ref,
    }


def key_to_dict(key: ShapeKey) -> dict:
    d = dataclasses.asdict(key)
    d["shape"] = list(d["shape"])
    return d


def key_from_dict(d: dict) -> ShapeKey:
    d = dict(d)
    d["shape"] = tuple(d["shape"])
    return ShapeKey(**d)


def terminal_record(receipt: RequestReceipt, key: ShapeKey | None) -> dict:
    """The JSON-safe terminal payload: everything needed to replay the
    receipt bit-identically minus what cannot survive a crash (results,
    wall-clock latencies)."""
    req = receipt.request
    return {
        "rseq": req.jseq,
        "status": receipt.status, "rung": receipt.rung,
        "retries": receipt.retries, "reason": receipt.reason,
        "batch_id": receipt.batch_id, "worker": receipt.worker,
        "clock_mhz": receipt.clock_mhz,
        "modelled_time_s": receipt.modelled_time_s,
        "energy_j": receipt.energy_j,
        "boost_energy_j": receipt.boost_energy_j,
        "measured_energy_j": receipt.measured_energy_j,
        "realtime_margin": receipt.realtime_margin,
        "kind": req.kind, "precision": req.precision,
        "batch": req.batch, "n": req.n, "shape": list(req.shape),
        "payload_ref": req.payload_ref,
        "key": None if key is None else key_to_dict(key),
    }


# --------------------------------------------------------------------------- #
# replay
# --------------------------------------------------------------------------- #

class ReplayResult:
    """Per-request state folded incrementally from journal records.

    Built to stream: feed it records one at a time (it is the natural
    ``record_sink`` for :class:`repro_torch.runtime.journal.RequestJournal`)
    and memory stays bounded no matter how long the history is —

      open_admit_data   admit payloads for requests with NO terminal yet
                        (bounded by in-flight depth, not history);
                        insertion-ordered, so iteration is admit order.
      terminals         the last ``retain`` terminal payloads (FIFO;
                        ``retain=None`` keeps all — small journals and
                        tests — ``retain=0`` keeps counts only, which is
                        what the 10^6-record end-of-run audit uses).
      admitted          every admitted seq (ints only; the dedup ground
                        truth for the exactly-once check).

    Deduplication happens here: only the FIRST terminal record for an
    admit seq counts (``duplicate_terminals`` tallies the rest), so no
    matter how many times a crashing service re-executed a request, its
    replayed receipt is the one the journal durably promised first.
    """

    def __init__(self, *, retain: int | None = None):
        self.retain = retain
        self.open_admit_data: dict[int, dict] = {}
        self.terminals: dict[int, dict] = {}
        self.admitted: set[int] = set()
        self.admits_total = 0
        self.terminals_total = 0
        self.duplicate_terminals = 0    # extra terminal records for a seq
        #                                 (first one wins; rest ignored)
        self.served = 0
        self.fault_shed = 0             # shed with a fault:* reason
        self.next_batch_id = 0          # 1 + highest assigned batch id
        self.incarnations = 0           # OPEN records seen

    def feed(self, rec: JournalRecord) -> None:
        """Fold one validated record."""
        if rec.type == OPEN:
            self.incarnations += 1
        elif rec.type == ADMIT:
            self.admitted.add(rec.seq)
            self.open_admit_data[rec.seq] = rec.data
            self.admits_total += 1
        elif rec.type == ASSIGN:
            bid = rec.data.get("batch_id")
            if isinstance(bid, int):
                self.next_batch_id = max(self.next_batch_id, bid + 1)
        elif rec.type in TERMINAL_TYPES:
            rseq = rec.data.get("rseq")
            if rseq not in self.admitted:
                return                       # terminal for unknown admit
            if rseq not in self.open_admit_data:
                self.duplicate_terminals += 1
                return
            del self.open_admit_data[rseq]
            self.terminals_total += 1
            if rec.data.get("status") == "served":
                self.served += 1
            elif str(rec.data.get("reason") or "").startswith("fault:"):
                self.fault_shed += 1
            if self.retain is None or self.retain > 0:
                self.terminals[rseq] = rec.data
                if self.retain is not None \
                        and len(self.terminals) > self.retain:
                    self.terminals.pop(next(iter(self.terminals)))

    @property
    def open_admits(self) -> list[int]:
        """Admit seqs with no terminal record, in admit order — the
        requests that were in flight when the process died."""
        return list(self.open_admit_data)

    # Replayed-receipt accounting (guarded_ratio conventions: an empty
    # journal made no promises and broke none).

    @property
    def availability(self) -> float:
        """Served / (served + fault-shed) over replayed terminals;
        admission sheds excluded, empty journal => 1.0."""
        return guarded_ratio(self.served, self.served + self.fault_shed,
                             on_zero=1.0)

    @property
    def duplicate_rate(self) -> float:
        """Duplicate terminal records / total terminal records written;
        empty journal => 0.0."""
        total = self.terminals_total + self.duplicate_terminals
        return guarded_ratio(self.duplicate_terminals, total, on_zero=0.0)


def replay_journal(records: Iterable[JournalRecord], *,
                   retain: int | None = None) -> ReplayResult:
    """Fold validated records into per-request lifecycle state.

    Convenience wrapper over :meth:`ReplayResult.feed` for callers that
    already hold the records; streaming callers pass ``ReplayResult.feed``
    as a ``record_sink`` / ``read_journal`` sink instead.
    """
    out = ReplayResult(retain=retain)
    for rec in records:
        out.feed(rec)
    return out


# --------------------------------------------------------------------------- #
# replayed receipts
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class RecoveredRequest:
    """A payload-less stand-in for a request whose receipt is replayed.

    Already-terminated requests do not need their arrays again — only
    the metadata receipts and reports read.  Quacks like
    :class:`repro_torch.serving.request.FFTRequest` where receipts care.
    """

    kind: str
    precision: str
    batch: int
    n: int
    shape: tuple
    jseq: int
    payload_ref: Any = None
    request_id: int = -1
    t_enqueue: float = 0.0


def receipt_from_terminal(term: dict, *, ledger=None,
                          incarnation: str = "") -> RequestReceipt:
    """Rebuild one receipt from its journaled terminal record.

    ``status``/``reason``/``rung``/``retries`` are bit-identical to the
    receipt the previous incarnation issued.  Launch signatures are
    replayed from the process-wide ledger store when the batch's shape
    key was journaled (see repro_torch.obs.ledger).
    """
    req = RecoveredRequest(
        kind=term["kind"], precision=term["precision"],
        batch=term["batch"], n=term["n"], shape=tuple(term["shape"]),
        jseq=term["rseq"], payload_ref=term.get("payload_ref"))
    launches: list = []
    if ledger is not None and term.get("key") is not None \
            and term["status"] == "served":
        launches = ledger.signature(key_from_dict(term["key"]))
    return RequestReceipt(
        request=req,
        batch_id=term["batch_id"], worker=term["worker"],
        queue_latency=0.0, service_latency=0.0,
        clock_mhz=term["clock_mhz"],
        modelled_time_s=term["modelled_time_s"],
        energy_j=term["energy_j"],
        boost_energy_j=term["boost_energy_j"],
        measured_energy_j=term["measured_energy_j"],
        realtime_margin=term["realtime_margin"],
        status=term["status"], rung=term["rung"],
        retries=term["retries"], reason=term["reason"],
        launches=list(launches),
        recovered=True, incarnation=incarnation)


# --------------------------------------------------------------------------- #
# snapshot / restore of durable service state
# --------------------------------------------------------------------------- #

def _breaker_state(br) -> dict:
    return {"state": br.state, "failures": br.failures,
            "opened_at": br.opened_at, "opens": br.opens,
            "probes": br.probes}


def _restore_breaker(br, st: dict) -> None:
    br.state = st["state"]
    br.failures = int(st["failures"])
    br.opened_at = st["opened_at"]
    br.opens = int(st["opens"])
    br.probes = int(st["probes"])


def _watchdog_state(dog) -> dict:
    base = dog.baseline
    return {"health": dog.health, "bad": dog._bad, "good": dog._good,
            "counts": dict(dog.counts),
            "unhealthy_entries": dog.unhealthy_entries,
            "baseline": (None if base is None else
                         {"device_index": base.device_index,
                          "t": base.t, "power_w": base.power_w})}


def _restore_watchdog(dog, st: dict) -> None:
    from repro_torch.power.sampler import PowerReading
    dog.health = st["health"]
    dog._bad = int(st["bad"])
    dog._good = int(st["good"])
    dog.counts.update({k: int(v) for k, v in st["counts"].items()})
    dog.unhealthy_entries = int(st["unhealthy_entries"])
    b = st["baseline"]
    dog.baseline = None if b is None else PowerReading(
        device_index=int(b["device_index"]), t=float(b["t"]),
        power_w=float(b["power_w"]))


def governor_state(gov) -> dict:
    """Serialise one :class:`repro_torch.power.governor.PowerGovernor`."""
    return {"f_mhz": gov.f_mhz, "integral_w": gov.integral_w,
            "mode": gov.mode, "ticks": gov.ticks, "moves": gov.moves,
            "fallback_engagements": gov.fallback_engagements,
            "target_w": gov.target_w}


def restore_governor(gov, st: dict) -> None:
    gov.f_mhz = float(st["f_mhz"])
    gov.integral_w = float(st["integral_w"])
    gov.mode = st["mode"]
    gov.ticks = int(st["ticks"])
    gov.moves = int(st["moves"])
    gov.fallback_engagements = int(st["fallback_engagements"])
    gov.target_w = float(st["target_w"])


def _drift_state(drift) -> dict:
    states = []
    for key, st in drift.states.items():
        kind, shape, clock = key
        states.append({"key": [kind, list(shape), clock],
                       "ewma": st.ewma, "n": st.n,
                       "last_error": st.last_error})
    return {"observations": drift.observations, "states": states}


def _restore_drift(drift, st: dict) -> None:
    from repro_torch.obs.drift import DriftState
    drift.observations = int(st["observations"])
    for item in st["states"]:
        kind, shape, clock = item["key"]
        drift.states[(kind, tuple(shape), clock)] = DriftState(
            ewma=float(item["ewma"]), n=int(item["n"]),
            last_error=float(item["last_error"]))


def _metrics_state(registry) -> dict:
    from repro_torch.obs.metrics import Counter, Gauge, Histogram
    counters, gauges, histograms = {}, {}, {}
    for name, m in registry._metrics.items():
        if isinstance(m, Counter):
            counters[name] = {"value": m.value, "help": m.help}
        elif isinstance(m, Gauge):
            gauges[name] = {"value": m.value, "help": m.help}
        elif isinstance(m, Histogram):
            histograms[name] = {"bounds": list(m.bounds),
                                "counts": list(m.counts), "help": m.help}
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


def _restore_metrics(registry, st: dict) -> None:
    for name, c in st["counters"].items():
        registry.counter(name, c["help"]).value = int(c["value"])
    for name, g in st["gauges"].items():
        registry.gauge(name, g["help"]).set(g["value"])
    for name, h in st["histograms"].items():
        hist = registry.histogram(name, h["help"],
                                  buckets=tuple(h["bounds"]))
        hist.counts = [int(c) for c in h["counts"]]


class ServiceSnapshot:
    """Capture/restore the durable state of a running ``FFTService``."""

    @staticmethod
    def capture(service, *, governors: dict | None = None) -> dict:
        """A JSON-safe dict of everything worth surviving a crash.

        ``governors`` optionally maps names to
        :class:`repro_torch.power.governor.PowerGovernor` instances managed
        alongside the service (the service itself does not own one).
        """
        cache_keys = []
        seen = set()
        for (key, _cfg), entry in service.cache._entries.items():
            if key in seen:
                continue
            seen.add(key)
            cache_keys.append({"key": key_to_dict(key),
                               "config": repr(_cfg)})
        stats = service.cache.stats
        return {
            "cache": {
                "keys": cache_keys,
                "stats": {f: getattr(stats, f) for f in
                          ("hits", "misses", "plan_builds", "sweeps",
                           "degraded_builds")},
            },
            "breakers": {str(w): _breaker_state(br)
                         for w, br in sorted(service.breakers.items())},
            "watchdogs": ({} if service.telemetry is None else
                          {str(i): _watchdog_state(dog) for i, dog in
                           sorted(service.telemetry.watchdogs.items())}),
            "drift": _drift_state(service.drift),
            "metrics": _metrics_state(service.metrics),
            "governors": ({} if not governors else
                          {name: governor_state(g)
                           for name, g in sorted(governors.items())}),
            "next_batch_id": service._next_batch_id,
        }

    @staticmethod
    def restore(service, state: dict, *, governors: dict | None = None,
                warm_cache: bool = True) -> None:
        """Apply a captured snapshot onto a freshly built service.

        ``warm_cache=True`` eagerly rebuilds a cache entry for every
        snapshotted shape key — plans and sweeps are deterministic
        functions of (key, tuned config), so the rebuilt entries match
        the crashed incarnation's, and serving resumes warm.
        """
        for item in state["cache"]["keys"]:
            key = key_from_dict(item["key"])
            if warm_cache:
                service.cache.entry(key)
        # Cache stats: the snapshot counters describe the *previous*
        # incarnation's traffic; restoring after the warm rebuild keeps
        # them from double-counting the rebuild's misses.
        for f, v in state["cache"]["stats"].items():
            setattr(service.cache.stats, f, int(v))
        for w, st in state["breakers"].items():
            _restore_breaker(service._breaker(int(w)), st)
        if service.telemetry is not None:
            for i, st in state["watchdogs"].items():
                _restore_watchdog(service.telemetry.watchdog(int(i)), st)
        _restore_drift(service.drift, state["drift"])
        _restore_metrics(service.metrics, state["metrics"])
        if governors:
            for name, gov in governors.items():
                if name in state["governors"]:
                    restore_governor(gov, state["governors"][name])
        service._next_batch_id = max(service._next_batch_id,
                                     int(state["next_batch_id"]))


# --------------------------------------------------------------------------- #
# recover
# --------------------------------------------------------------------------- #

def recover_service(
    journal_dir: str,
    *,
    payload_fn: Callable[[Any, dict], Any] | None = None,
    governors: dict | None = None,
    warm_cache: bool = True,
    journal_kwargs: dict | None = None,
    retain_receipts: int | None = None,
    **service_kwargs,
):
    """Rebuild a live ``FFTService`` from its journal directory.

    1. open the journal (replays + validates what is on disk, mints the
       next incarnation id, continues seq numbering in a new segment);
    2. restore the newest valid snapshot (breakers, watchdog health,
       drift EWMAs, metrics counters, cache keys — re-warmed — and the
       batch-id high-water mark);
    3. replay request lifecycles: every admitted-and-terminated request
       gets its receipt reconstructed bit-identically (status/reason/
       rung), stamped ``recovered=True`` + the new incarnation id, and
       exposed via ``service.recovered_receipts`` /
       ``service.receipt_for_seq``;
    4. re-enqueue every request admitted but never receipted, in admit
       order, resolving payloads through ``payload_fn(payload_ref,
       admit_meta)`` (a numpy array or a tensor, handed to the request as
       it is).  Without a ``payload_fn`` such requests terminate
       in a ``shed`` receipt (reason ``recovery:payload-unresolvable``)
       — explicitly accounted, never silently dropped.

    ``service_kwargs`` are forwarded to the ``FFTService`` constructor
    (device spec, SLO policy, fault plan, telemetry, ...).

    Replay streams (the journal's ``record_sink`` seam), so recovery
    memory is bounded by in-flight depth plus ``retain_receipts`` — not
    by journal length.  ``retain_receipts`` caps how many already-
    terminated requests get their receipts reconstructed (newest kept,
    mirroring the live service's own receipt-retention policy); it
    defaults to the service's ``max_retained_receipts`` when that is
    passed, else unbounded.  Older terminals stay durable in the journal
    either way — only eager reconstruction is windowed.
    """
    from repro_torch.serving.request import FFTRequest
    from repro_torch.serving.service import FFTService

    if retain_receipts is None:
        retain_receipts = service_kwargs.get("max_retained_receipts")
    replay = ReplayResult(retain=retain_receipts)
    journal = RequestJournal(journal_dir, record_sink=replay.feed,
                             **(journal_kwargs or {}))
    snap = journal.load_snapshot()

    service = FFTService(journal=journal, **service_kwargs)
    if snap is not None:
        ServiceSnapshot.restore(service, snap["state"],
                                governors=governors, warm_cache=warm_cache)
    service._next_batch_id = max(service._next_batch_id,
                                 replay.next_batch_id)
    service.replay = replay

    # Replayed receipts: bit-identical outcomes for already-terminated
    # work, in journal (terminal-record) order, newest `retain` of them.
    for rseq, term in replay.terminals.items():
        receipt = receipt_from_terminal(term, ledger=service.ledger,
                                        incarnation=journal.incarnation)
        service.recovered_receipts.append(receipt)
        service._remember_seq(rseq, receipt)

    # Re-enqueue in-flight work (admitted, never receipted), admit order.
    now = service._timer()
    for rseq in replay.open_admits:
        meta = replay.open_admit_data[rseq]
        if payload_fn is None:
            n = 1
            for d in meta["shape"]:
                n *= int(d)
            stub = RecoveredRequest(
                kind=meta["kind"], precision=meta["precision"],
                batch=meta["batch"], n=n,
                shape=tuple(meta["shape"]), jseq=rseq,
                payload_ref=meta.get("payload_ref"),
                request_id=-(rseq + 1))      # unique, never collides with
            #                                  live process-local ids
            service._store(RequestReceipt.make_shed(
                stub, "recovery:payload-unresolvable", now))
            continue
        req = FFTRequest(
            x=payload_fn(meta.get("payload_ref"), meta),
            precision=meta["precision"], kind=meta["kind"],
            latency_budget=meta["latency_budget"],
            n_harmonics=meta["n_harmonics"],
            transform=meta["transform"], ndim=meta["ndim"],
            templates=meta["templates"], segment=meta["segment"],
            dm_trials=meta["dm_trials"])
        req.t_enqueue = now
        req.jseq = rseq                      # keep the durable identity
        req.payload_ref = meta.get("payload_ref")
        service._pending.append(req)
    return service
