"""Serving-side fault-injection plane: deterministic fault plans,
per-device circuit breakers and jittered-backoff retry policies (the
counterpart of ``repro.runtime.faults``; numpy and plain Python, so
``FaultPlan.generate`` draws the same events from the same seed).

``repro_torch.runtime.fault`` injects *training-loop* failures by step index
(:class:`SimulatedFailure`).  This module generalises the idea for the
serving runtime: a :class:`FaultPlan` is a deterministic, seed-generated
schedule of one-shot fault events keyed on the serving layer's own
deterministic identifiers (batch ids, worker slots) —

  kill-device       the device executing a batch dies mid-batch
  fail-clock-lock   the DVFS lock acquisition (ClockController.locked)
                    fails; the batch must degrade to boost, not crash
  fail-plan-build   the tuned plan/sweep build for a shape fails; the
                    service walks down the degradation ladder
  stall-worker      a worker wedges for ``duration`` seconds; its queued
                    work must be redistributed
  sensor-dropout    a device's power-sensor read fails (NaN reading);
                    the telemetry watchdog must classify it, and the
                    power governor must never act on it
  sensor-spike      the power sensor returns an impossible value (far
                    outside the TDP envelope — a wedged I2C transaction)
  sensor-stale      the power sensor keeps replaying an old reading with
                    a frozen timestamp (the sampling daemon died)
  kill-host         a whole simulated host (:class:`HostTopology` fault
                    domain) dies: every co-hosted device, its breakers
                    and its telemetry rings go down together
  crash-process     the serving process itself dies; only the
                    write-ahead journal (repro_torch.runtime.journal) survives
                    — recovery is ``FFTService.recover``'s job, not an
                    in-process handler's

Because events are keyed on batch ids (assigned in deterministic FIFO
order by ``FFTService.drain``) rather than wall-clock time, a chaos run
with the same fault-plan seed reproduces the exact same set of
kill/degrade/shed outcomes — the bit-reproducibility the chaos benchmark
gates on.  On real hardware the same exception types are raised by the
CUDA runtime / NVML instead of the plan; everything downstream
(breakers, retries, the degradation ladder) is identical.

Barbosa et al. (2016) frame SKA power management as a *monitored,
failure-aware control problem*; the circuit breaker here is that control
loop's actuator: a device that keeps failing is quarantined (open), then
probed after a cooldown (half-open) and re-admitted only on a successful
probe (closed).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.runtime.fault import SimulatedFailure

#: Fault kinds a plan can schedule.
KILL_DEVICE = "kill-device"
FAIL_CLOCK_LOCK = "fail-clock-lock"
FAIL_PLAN_BUILD = "fail-plan-build"
STALL_WORKER = "stall-worker"
SENSOR_DROPOUT = "sensor-dropout"
SENSOR_SPIKE = "sensor-spike"
SENSOR_STALE = "sensor-stale"
KILL_HOST = "kill-host"          # a whole host (fault domain) dies
CRASH_PROCESS = "crash-process"  # the serving process itself dies

FAULT_KINDS = (KILL_DEVICE, FAIL_CLOCK_LOCK, FAIL_PLAN_BUILD, STALL_WORKER,
               SENSOR_DROPOUT, SENSOR_SPIKE, SENSOR_STALE, KILL_HOST,
               CRASH_PROCESS)

#: The telemetry-plane subset (consumed by repro_torch.power samplers, not by
#: the serving execution path).
SENSOR_KINDS = (SENSOR_DROPOUT, SENSOR_SPIKE, SENSOR_STALE)


def _notify_obs(exc: BaseException) -> None:
    """Snapshot live flight recorders (repro_torch.obs.trace) for ``exc``.

    Imported lazily so the fault plane stays importable without the
    observability package and never pays for it when no tracer exists.
    """
    try:
        from repro_torch.obs.trace import notify_fault
    except ImportError:                      # pragma: no cover
        return
    notify_fault(exc)


class FaultError(SimulatedFailure):
    """Base class for injected serving faults (a SimulatedFailure kin).

    Constructing any subclass notifies the observability plane, so every
    live tracer's flight recorder snapshots its last-N spans at the
    moment of failure (the postmortem record).
    """

    def __init__(self, *args):
        super().__init__(*args)
        _notify_obs(self)


class DeviceLostError(FaultError):
    """The device executing a batch died mid-batch."""

    def __init__(self, worker: int, detail: str = ""):
        self.worker = worker
        super().__init__(f"device behind worker {worker} lost{detail}")


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Devices grouped into simulated hosts (the fault domains).

    ``devices_per_host`` consecutive worker slots share one host: one
    power feed, one PCIe/NIC complex, one telemetry daemon.  A host-level
    fault (:class:`HostLostError`) therefore takes down every device in
    the group together — their breakers trip as a unit and their
    telemetry rings are wiped, exactly what a real node loss does.  The
    default (1 device per host) makes every device its own fault domain.
    """

    n_workers: int
    devices_per_host: int = 1

    def __post_init__(self):
        if self.n_workers < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"need n_workers >= 1 and devices_per_host >= 1, got "
                f"{self.n_workers}/{self.devices_per_host}")

    @property
    def n_hosts(self) -> int:
        return -(-self.n_workers // self.devices_per_host)

    def host_of(self, worker: int) -> int:
        if not 0 <= worker < self.n_workers:
            raise ValueError(f"worker {worker} outside fleet of "
                             f"{self.n_workers}")
        return worker // self.devices_per_host

    def workers_of(self, host: int) -> tuple[int, ...]:
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} outside {self.n_hosts} hosts")
        lo = host * self.devices_per_host
        return tuple(range(lo, min(lo + self.devices_per_host,
                                   self.n_workers)))


class HostLostError(DeviceLostError):
    """The whole host behind ``worker`` died (all its devices with it).

    Subclasses :class:`DeviceLostError` — for the executing batch a host
    loss *is* a device loss — but handlers that know the topology catch
    it first and quarantine every co-hosted device together.
    """

    def __init__(self, worker: int, host: int, workers: tuple[int, ...]):
        self.host = host
        self.workers = tuple(workers)
        super().__init__(worker,
                         detail=f" with host {host} (workers "
                                f"{list(self.workers)})")


class ProcessCrashError(FaultError):
    """The serving process itself dies (kill -9, OOM, power cut).

    No in-process handler can catch a real one — the chaos harness
    *simulates* it by abandoning the live service object mid-stream and
    rebuilding from the write-ahead journal
    (``FFTService.recover``, repro_torch.serving.recovery).
    """

    def __init__(self, arrival: int | None = None):
        self.arrival = arrival
        super().__init__(
            f"process crash injected at journal seq {arrival}")


class ClockLockError(FaultError):
    """The DVFS clock-lock acquisition failed (NVML/driver error)."""


class PlanBuildError(FaultError):
    """A plan or sweep build failed for a shape."""


class WorkerStalledError(FaultError):
    """A worker is wedged; its queued work needs redistribution."""

    def __init__(self, worker: int, duration: float):
        self.worker = worker
        self.duration = duration
        super().__init__(f"worker {worker} stalled for {duration:g}s")


class DrainDeadlineError(RuntimeError):
    """drain() exceeded its deadline with work still stuck in queues.

    ``stuck`` names the shape keys of the batches that never executed —
    the first one is the batch a wedged worker is sitting on.
    """

    def __init__(self, deadline_s: float, stuck: list):
        self.deadline_s = deadline_s
        self.stuck = list(stuck)
        first = self.stuck[0] if self.stuck else None
        super().__init__(
            f"drain() exceeded its {deadline_s:g}s deadline with "
            f"{len(self.stuck)} batch(es) stuck; first stuck shape: {first}")
        _notify_obs(self)


@dataclasses.dataclass
class FaultEvent:
    """One scheduled one-shot fault.

    ``batch_id``/``worker``/``arrival`` are match constraints: a ``None``
    field matches anything.  ``arrival`` keys on the *journal sequence
    number* of a request (``FFTRequest.jseq``, assigned at admit by
    repro_torch.runtime.journal) — the seam that lets plans target a point in
    the arrival stream rather than only the batch ids the FIFO
    coalescer happens to assign.  ``duration`` only applies to stalls.
    """

    kind: str
    batch_id: int | None = None
    worker: int | None = None
    duration: float = 0.0
    arrival: int | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}")

    def matches(self, batch_id: int | None, worker: int | None,
                arrival: int | None = None) -> bool:
        if self.batch_id is not None and self.batch_id != batch_id:
            return False
        if self.worker is not None and self.worker != worker:
            return False
        if self.arrival is not None and self.arrival != arrival:
            return False
        return True


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of one-shot fault events.

    ``take(kind, ...)`` pops (and returns) the first still-pending event
    of ``kind`` matching the given identifiers, or None — so each event
    fires exactly once, in a deterministic order.  ``fired`` keeps the
    consumed events for receipts/diagnostics.
    """

    events: list[FaultEvent] = dataclasses.field(default_factory=list)
    seed: int | None = None

    def __post_init__(self):
        self.fired: list[FaultEvent] = []

    def take(self, kind: str, *, batch_id: int | None = None,
             worker: int | None = None,
             arrival: int | None = None) -> FaultEvent | None:
        for i, ev in enumerate(self.events):
            if ev.kind == kind and ev.matches(batch_id, worker, arrival):
                self.fired.append(self.events.pop(i))
                return self.fired[-1]
        return None

    def pending(self, kind: str | None = None) -> int:
        return sum(1 for ev in self.events
                   if kind is None or ev.kind == kind)

    def fired_count(self, kind: str | None = None) -> int:
        return sum(1 for ev in self.fired
                   if kind is None or ev.kind == kind)

    def drop_consumed(self, *, batch_before: int | None = None,
                      arrival_before: int | None = None) -> int:
        """Discard events a *previous incarnation* already consumed.

        After a process crash the recovering harness regenerates the same
        seeded plan, then drops every event pinned to a batch id below
        the journal-restored ``_next_batch_id`` (all earlier batches were
        polled for every kind, so their pinned events fired before the
        crash) or to an arrival seq already admitted.  Returns the number
        dropped.  Dropped events are *not* added to ``fired`` — they
        fired in another incarnation's plan object; callers that need
        cross-incarnation fired totals sum per-incarnation counts.
        """
        def consumed(ev: FaultEvent) -> bool:
            if (batch_before is not None and ev.batch_id is not None
                    and ev.batch_id < batch_before):
                return True
            return (arrival_before is not None and ev.arrival is not None
                    and ev.arrival < arrival_before)

        before = len(self.events)
        self.events = [ev for ev in self.events if not consumed(ev)]
        return before - len(self.events)

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_batches: int,
        kill_rate: float = 0.01,
        clock_fail_rate: float = 0.01,
        plan_fail_rate: float = 0.005,
        stall_rate: float = 0.005,
        stall_duration_s: float = 0.02,
        sensor_dropout_rate: float = 0.01,
        sensor_spike_rate: float = 0.01,
        sensor_stale_rate: float = 0.005,
        ensure_one_of_each: bool = True,
        crash_arrivals: tuple = (),
        host_kill_batches: tuple = (),
    ) -> "FaultPlan":
        """A seed-deterministic plan over ``n_batches`` batch ids.

        Each batch id draws each fault kind independently at its rate;
        ``ensure_one_of_each`` additionally pins one of each execution
        fault (kill, clock-lock failure, stall) — and, when the run is
        long enough, one of each telemetry sensor fault — onto the
        earliest batch ids so even tiny runs satisfy the chaos harness's
        non-trivial-plan requirement.

        ``crash_arrivals`` / ``host_kill_batches`` pin CRASH_PROCESS
        events on journal arrival seqs and KILL_HOST events on batch ids.
        Both are appended *after* the per-batch draws without consuming
        the RNG stream, so the default (empty) plan is bit-identical to
        what this function generated before the seams existed.
        """
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        pinned = 0
        if ensure_one_of_each and n_batches >= 3:
            events.append(FaultEvent(KILL_DEVICE, batch_id=0))
            events.append(FaultEvent(FAIL_CLOCK_LOCK, batch_id=1))
            events.append(FaultEvent(STALL_WORKER, batch_id=2,
                                     duration=stall_duration_s))
            pinned = 3
            if n_batches >= 6:
                events.append(FaultEvent(SENSOR_DROPOUT, batch_id=3))
                events.append(FaultEvent(SENSOR_SPIKE, batch_id=4))
                events.append(FaultEvent(SENSOR_STALE, batch_id=5))
                pinned = 6
        rates = (kill_rate, clock_fail_rate, plan_fail_rate, stall_rate,
                 sensor_dropout_rate, sensor_spike_rate, sensor_stale_rate)
        kinds = (KILL_DEVICE, FAIL_CLOCK_LOCK, FAIL_PLAN_BUILD,
                 STALL_WORKER, SENSOR_DROPOUT, SENSOR_SPIKE, SENSOR_STALE)
        draws = rng.random((n_batches, len(kinds)))
        for b in range(pinned, n_batches):
            for col, (kind, rate) in enumerate(zip(kinds, rates)):
                if draws[b, col] < rate:
                    duration = stall_duration_s if kind == STALL_WORKER \
                        else 0.0
                    events.append(FaultEvent(kind, batch_id=b,
                                             duration=duration))
        for a in crash_arrivals:
            events.append(FaultEvent(CRASH_PROCESS, arrival=int(a)))
        for b in host_kill_batches:
            events.append(FaultEvent(KILL_HOST, batch_id=int(b)))
        return cls(events=events, seed=seed)


@dataclasses.dataclass
class RetryPolicy:
    """Retry-with-jittered-backoff, deterministically.

    The jitter is a pure function of (seed, token, attempt) — a hash, not
    a shared RNG — so concurrent retries for different batches never
    perturb each other's delays and a re-run reproduces them exactly.
    Delays follow capped exponential backoff with +/-50% jitter.
    """

    max_retries: int = 2
    base_delay_s: float = 0.001
    max_delay_s: float = 0.1
    seed: int = 0

    def delay(self, attempt: int, token: int = 0) -> float:
        """Backoff before retry ``attempt`` (1-based) of work ``token``."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        raw = min(self.base_delay_s * 2.0 ** (attempt - 1), self.max_delay_s)
        h = hashlib.blake2b(
            f"{self.seed}:{token}:{attempt}".encode(), digest_size=8)
        frac = int.from_bytes(h.digest(), "big") / 2.0 ** 64
        return raw * (0.5 + frac)              # in [0.5, 1.5) * raw


# Circuit-breaker states.
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


@dataclasses.dataclass
class CircuitBreaker:
    """Per-device circuit breaker: quarantine after repeated failures,
    probe after a cooldown, re-admit only on a successful probe.

      closed     traffic flows; failures count against the threshold
      open       quarantined; no traffic until ``cooldown_s`` elapses
      half-open  one probe admitted; success -> closed, failure -> open

    Timestamps come from the caller's timer so tests and the chaos
    harness can drive the state machine with fake clocks.
    """

    failure_threshold: int = 2
    cooldown_s: float = 0.05

    def __post_init__(self):
        self.state = CLOSED
        self.failures = 0               # consecutive failures while closed
        self.opened_at: float | None = None
        self.opens = 0                  # times the breaker tripped
        self.probes = 0                 # half-open probes admitted

    def allow(self, now: float) -> bool:
        """May this device receive work at time ``now``?"""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.opened_at is not None and \
                    now - self.opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
                self.probes += 1
                return True             # the single probe
            return False
        # half-open: the probe is in flight; no further traffic until it
        # reports back.
        return False

    def would_allow(self, now: float) -> bool:
        """Like :meth:`allow` but pure — no state transition, no probe.

        Used when *choosing* a redistribution target, so that scanning
        candidate workers never consumes a quarantined device's single
        half-open probe allowance.
        """
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            return (self.opened_at is not None
                    and now - self.opened_at >= self.cooldown_s)
        return False

    def record_failure(self, now: float) -> None:
        if self.state == HALF_OPEN:
            self.state = OPEN           # failed probe: quarantine again
            self.opened_at = now
            self.opens += 1
            return
        self.failures += 1
        if self.failures >= self.failure_threshold:
            self.state = OPEN
            self.opened_at = now
            self.opens += 1

    def record_success(self) -> None:
        self.state = CLOSED
        self.failures = 0
        self.opened_at = None

    def trip(self, now: float) -> None:
        """Quarantine immediately, bypassing the failure count.

        Host-level faults (:class:`HostLostError`) kill every device in
        the fault domain at once; devices that were not even executing
        have no failures to count, they are simply *gone* until the host
        returns — modelled as an immediate open with the usual cooldown
        playing the reboot time.  Idempotent while already open.
        """
        if self.state != OPEN:
            self.state = OPEN
            self.opens += 1
        self.opened_at = now
        self.failures = 0
