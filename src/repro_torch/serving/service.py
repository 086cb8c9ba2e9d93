"""The energy-aware streaming FFT service, on the card.

The counterpart of ``repro.serving.service`` for ``KIND_FFT`` requests
(1-D and N-D, C2C and R2C), ``KIND_FDAS`` requests (the acceleration
search, answered with its packed candidates) and ``KIND_PULSAR`` requests
(the end-to-end pulsar search, answered with its sifted candidates, with
per-stage DVFS shares and the real-time margin on each receipt).  Request
lifecycle:

  enqueue      submit() stamps arrival time and parks the request (and,
               with a journal, logs its admit record write-ahead)
  admit        with an ``slo`` policy, the admission controller sheds or
               degrades requests on modelled backlog before anything runs
  batch        drain() coalesces pending requests into Eq. 6-sized batches
  plan-cache   each batch's shape hits the plan + sweep cache (one plan
               — 1-D, N-D plan graph or FDAS search — and one DVFS sweep
               per distinct shape, ever)
  clock-plan   the batch's operating point is selected from the cached
               sweep under the strictest per-request real-time budget
  execute      the batch is stacked on the device the work-stealing
               dispatcher assigned (numpy payloads on the host, then one
               copy; tensor payloads on that device) and transformed there
               with the clock locked (ClockController)
  account      every request gets a receipt: queue/service latency
               (measured) and energy at the locked vs boost clock
               (modelled, Eqs. 3-4), plus measured energy with telemetry

The energy numbers come from the analytic DVFS model of ``device_spec``
(default: the paper's Tesla V100).  An optional ``telemetry`` bundle
(``repro_torch.power.FleetTelemetry``; on the card with an
``NvmlPowerSampler``) takes one watchdog-classified power sample per
executed batch, and receipts carry ``measured_energy_j`` priced at the
measured power when the reading is fresh, at the model otherwise.

Robustness (``serving.slo`` + ``runtime.faults``): an optional ``slo``
policy turns drain() into admission-controlled serving — every rejected
or pressure-degraded request still terminates in a receipt stating why.
An optional ``fault_plan`` injects deterministic serving faults; the
service answers with per-worker circuit breakers, jittered-backoff
retries, work redistribution through the work-stealing queue, and the
graceful-degradation ladder (tuned-dvfs -> boost-heuristic ->
pure-torch).  Rung 2 is entered only by an admission decision; it runs
the pure-torch engine on CPU slots, and on a card slot the boost
heuristic plan's kernels, since a tensor on the card never leaves the
kernels.  A kernel or a plan build that raises is never caught here: it
propagates through drain(), which re-queues the unserved requests.  With a ``journal``
(``runtime.journal.RequestJournal``) every admit, assign and terminal
transition is logged write-ahead, and :meth:`FFTService.recover` rebuilds
a crashed service from it (``serving.recovery``).

With a ``mesh`` (``repro_torch.fft.distributed.make_mesh``, a ``data``
axis) the service has one worker on the mesh's first device, and every
plain-FFT batch of more than one row below rung 2 is split over the
mesh's ``data`` axis (``batch_parallel_fft`` with the entry's plan), each
shard running the plan's kernels on its own device; rung 2 never shards.

The timer is called at the same points and in the same order as the
reference's, so one shared fake timer gives both services the same
readings.  The reference's power-of-two row padding (``bucket_batches``)
is left out, since eager torch has no compiled shapes to reuse.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.energy import guarded_ratio
from repro_torch.core.hardware import TESLA_V100, DeviceSpec
from repro_torch.core.power_model import PowerModel
from repro_torch.core.scheduler import ClockController
from repro_torch.fft.distributed import Mesh, batch_parallel_fft
from repro_torch.fft.plan import kernels_disabled
from repro_torch.obs.drift import DriftDetector
from repro_torch.obs.ledger import LaunchLedger
from repro_torch.obs.metrics import MetricsRegistry, latency_summary
from repro_torch.runtime import journal as wal
from repro_torch.runtime.faults import (FAIL_CLOCK_LOCK, FAIL_PLAN_BUILD,
                                        KILL_DEVICE, KILL_HOST, STALL_WORKER,
                                        CircuitBreaker, DeviceLostError,
                                        FaultPlan, HostLostError,
                                        HostTopology, RetryPolicy)
from repro_torch.serving.batcher import Batch, coalesce
from repro_torch.serving.cache import CacheEntry, CacheStats, PlanSweepCache
from repro_torch.serving.dispatch import Dispatcher
from repro_torch.serving.recovery import (ServiceSnapshot, admit_record,
                                          recover_service, terminal_record)
from repro_torch.serving.request import (KIND_FFT, FFTRequest,
                                         RequestReceipt, StageReceipt)
from repro_torch.serving.slo import (RUNG_BOOST_HEURISTIC, RUNG_PURE_TORCH,
                                     RUNG_TUNED_DVFS, SHED,
                                     AdmissionController, SLOPolicy,
                                     max_rung_for_kind)

_EXEC_DTYPE = {"fp16": np.complex64, "fp32": np.complex64,
               "fp64": np.complex128}
# Real execution dtypes for R2C payloads — stacking them as complex would
# double the device bytes and forfeit the R2C saving the receipts report.
_REAL_EXEC_DTYPE = {"fp16": np.float32, "fp32": np.float32,
                    "fp64": np.float64}
_TORCH_DTYPE = {np.complex64: torch.complex64, np.complex128: torch.complex128,
                np.float32: torch.float32, np.float64: torch.float64}


@dataclasses.dataclass(frozen=True)
class ServiceReport:
    """Service-level summary over every receipt issued so far."""

    n_requests: int
    n_transforms: int
    n_batches: int
    wall_s: float                  # wall time spent executing batches
    energy_j: float                # modelled energy at the locked clocks
    boost_energy_j: float          # same work at boost (the GPU default)
    p50_latency_s: float
    p99_latency_s: float
    mean_latency_s: float
    cache: CacheStats
    steals: int
    clock_locks: int
    # --- robustness (zero on a fault-free, SLO-less service) --------------
    shed: int = 0                  # terminal shed receipts (all reasons)
    fault_shed: int = 0            # shed with a fault:* reason
    degraded: int = 0              # served at rung > 0
    retried: int = 0               # served after >= 1 lost execution
    redistributions: int = 0       # batches pushed away from a sick worker
    breaker_opens: int = 0         # circuit-breaker quarantines
    slo: dict | None = None        # SLOPolicy.evaluate() scorecard
    # --- power telemetry, zero/None when unmetered ------------------------
    measured_energy_j: float = 0.0  # watchdog-fresh measured J (model-filled
    #                                 for non-fresh samples: never freewheels)
    telemetry: dict | None = None   # FleetTelemetry.summary()
    # --- observability, None when no drift observation was made -----------
    drift: dict | None = None       # DriftDetector.summary()

    # Zero-denominator edges follow repro_torch.core.energy.guarded_ratio.

    @property
    def availability(self) -> float:
        """Served / (served + fault-shed).  Admission sheds are excluded:
        refusing work the SLO says cannot be served on time is the
        contract working, not the service failing.  An empty report is
        availability 1.0 (no demand, nothing unserved)."""
        return guarded_ratio(self.n_requests,
                             self.n_requests + self.fault_shed, on_zero=1.0)

    @property
    def joules_per_transform(self) -> float:
        return guarded_ratio(self.energy_j, self.n_transforms, on_zero=0.0)

    @property
    def i_ef(self) -> float:
        """Service-level Eq. 7 (identical work => energy ratio)."""
        return guarded_ratio(self.boost_energy_j, self.energy_j, on_zero=1.0)

    @property
    def throughput_tps(self) -> float:
        return guarded_ratio(self.n_transforms, self.wall_s, on_zero=0.0)


class FFTService:
    """Batched, cached, clock-locked FFT serving on torch devices.

    ``devices`` defaults to every CUDA device and raises when there is
    none; pass ``[torch.device("cpu")] * n`` to serve on the CPU
    explicitly (the kernels' plain versions).  Worker slots may repeat a
    device (``[cuda:0] * 4``).  ``mesh`` (optional) shards plain-FFT
    batches over the mesh's ``data`` axis instead of placing them whole.
    ``coalesce_requests=False`` disables batching (every request executes
    alone).
    """

    def __init__(
        self,
        device_spec: DeviceSpec = TESLA_V100,
        *,
        batch_bytes: float | None = None,
        time_budget: float | None = 0.10,
        devices: Sequence[Any] | None = None,
        mesh: Mesh | None = None,
        coalesce_requests: bool = True,
        keep_results: bool = True,
        max_retained_receipts: int | None = None,
        plan_fn=None,
        sweep_fn=None,
        power_model: PowerModel | None = None,
        timer=time.monotonic,
        slo: SLOPolicy | None = None,
        fault_plan: FaultPlan | None = None,
        retry_policy: RetryPolicy | None = None,
        breaker_threshold: int = 2,
        breaker_cooldown_s: float = 0.05,
        drain_deadline_s: float | None = None,
        sleep_fn: Callable[[float], None] | None = None,
        telemetry=None,
        tracer=None,
        metrics: MetricsRegistry | None = None,
        ledger: LaunchLedger | None = None,
        drift: DriftDetector | None = None,
        journal=None,
        topology: HostTopology | None = None,
    ):
        self.device_spec = device_spec
        # Default batch budget: an eighth of device memory, capped at the
        # paper's ~2 GB measurement batches (Sec. 4).
        self.batch_bytes = (batch_bytes if batch_bytes is not None
                            else min(2e9, device_spec.memory_bytes / 8))
        self.time_budget = time_budget
        self.mesh = mesh
        self.coalesce_requests = coalesce_requests
        self.keep_results = keep_results
        # Receipts pin request payloads and outputs; past the cap the
        # oldest receipts are evicted and report() summarises the retained
        # window.
        self.max_retained_receipts = max_retained_receipts
        self._timer = timer
        kwargs = {}
        if plan_fn is not None:
            kwargs["plan_fn"] = plan_fn
        if sweep_fn is not None:
            kwargs["sweep_fn"] = sweep_fn
        self.cache = PlanSweepCache(device_spec, batch_bytes=self.batch_bytes,
                                    power_model=power_model, **kwargs)
        self.clock = ClockController(
            device_spec, timer=timer,
            max_events=(None if max_retained_receipts is None
                        else 2 * max_retained_receipts))
        # With a mesh the whole mesh executes each batch, so one worker.
        self.dispatcher = Dispatcher(
            [mesh.devices[0]] if mesh is not None else devices)
        self._pending: list[FFTRequest] = []
        self._receipts: dict[int, RequestReceipt] = {}
        self._next_batch_id = 0
        # --- robustness state ---------------------------------------------
        self.slo = slo
        self.admission = (AdmissionController(slo, device_spec)
                          if slo is not None else None)
        self.faults = fault_plan
        self.retry = retry_policy if retry_policy is not None else RetryPolicy()
        self.drain_deadline_s = drain_deadline_s
        # Backoff sleeps are computed deterministically but not slept by
        # default — the cooperative drain loop would only block itself.
        self._sleep = sleep_fn if sleep_fn is not None else (lambda s: None)
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self.breakers: dict[int, CircuitBreaker] = {}
        self._stalled_until: dict[int, float] = {}
        self._attempts: dict[int, int] = {}      # batch_id -> lost executions
        self._forced: dict[int, tuple[int, str]] = {}  # req_id -> rung, why
        self.redistributions = 0
        self.stalls_honoured = 0
        # --- power telemetry (optional) -----------------------------------
        self.telemetry = telemetry
        # --- observability ------------------------------------------------
        # The launch ledger is always on; a receipt's launches are its
        # shape's first captured signature (repro_torch.obs.ledger).
        # Tracing is opt-in via tracer= (repro_torch.obs.Tracer).
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.ledger = ledger if ledger is not None else LaunchLedger()
        self.drift = drift if drift is not None else DriftDetector()
        # --- crash consistency (optional) ---------------------------------
        # The journal seq of a request's admit record is its durable
        # identity (FFTRequest.jseq); see repro_torch.serving.recovery.
        self.journal = journal
        # Host fault domains (a KILL_HOST event takes the whole group down
        # together); None means every worker is its own host.
        self.topology = topology
        self._by_seq: dict[int, RequestReceipt] = {}
        self.recovered_receipts: list[RequestReceipt] = []
        self.replay = None              # ReplayResult set by recover()
        self.host_kills = 0

    # ------------------------------------------------------------------ #
    # enqueue
    # ------------------------------------------------------------------ #

    def submit(self, x: Any, *, precision: str = "fp32",
               kind: str = KIND_FFT, latency_budget: float | None = None,
               n_harmonics: int = 32, transform: str = "c2c", ndim: int = 1,
               templates: int = 16, segment: int = 0,
               dm_trials: int = 16, payload_ref: Any = None) -> FFTRequest:
        """Enqueue one request (a (batch, *shape) or (*shape,) array or
        tensor).

        ``transform="r2c"`` serves real payloads through the R2C plan —
        half the energy per transform at the same length (Eq. 5/6).
        ``ndim=2`` serves 2-D transforms through the N-D plan graph (one
        fused kernel pass per pow2 axis), with their own plan + sweep
        cache entries.  ``kind="fdas"`` runs the acceleration search
        (``repro_torch.search``) on real time series; ``templates`` sizes
        the bank and ``segment`` pins the overlap-save FFT length (0 =
        cost-model auto-selection), and both are part of the cache key.
        The result of an FDAS request is its (batch, k, 3) candidates.
        ``kind="pulsar"`` runs the end-to-end pulsar search
        (``repro_torch.search.pipeline``) on (batch, nchan, ntime) or
        (nchan, ntime) filterbanks: ``dm_trials`` sizes the dedispersion
        grid, ``templates``/``n_harmonics`` the bank and the harmonic
        ladder, and all three join the cache key; the result is the
        (batch, k, 5) sifted candidates, and the receipt carries per-stage
        DVFS shares (clock, modelled J) and the real-time margin.
        ``payload_ref`` is the caller's JSON-safe token for re-resolving
        the payload after a crash (journaled with the admit record).  The
        request's receipt becomes available after the next drain():
        ``service.receipt(request)``.
        """
        req = FFTRequest(x=x, precision=precision, kind=kind,
                         latency_budget=latency_budget,
                         n_harmonics=n_harmonics, transform=transform,
                         ndim=ndim, templates=templates, segment=segment,
                         dm_trials=dm_trials)
        req.t_enqueue = self._timer()
        req.payload_ref = payload_ref
        if self.journal is not None:
            # Write-ahead: the admit record is durable (and its seq is the
            # request's crash-stable identity) before the service takes
            # the request.  Payloads themselves are not journaled.
            req.jseq = self.journal.append(wal.ADMIT, admit_record(req))
        self._pending.append(req)
        return req

    def receipt(self, request: FFTRequest) -> RequestReceipt | None:
        return self._receipts.get(request.request_id)

    def receipt_for_seq(self, jseq: int) -> RequestReceipt | None:
        """The receipt for a journal admit seq (survives recovery, where
        process-local request ids reset but journal seqs never do)."""
        return self._by_seq.get(jseq)

    def _remember_seq(self, jseq: int | None, receipt: RequestReceipt) -> None:
        if jseq is None:
            return
        cap = self.max_retained_receipts
        if (cap is not None and jseq not in self._by_seq
                and len(self._by_seq) >= cap):
            self._by_seq.pop(next(iter(self._by_seq)))      # oldest
        self._by_seq[jseq] = receipt

    @property
    def receipts(self) -> list[RequestReceipt]:
        return [self._receipts[k] for k in sorted(self._receipts)]

    # ------------------------------------------------------------------ #
    # batch -> plan-cache -> clock-plan -> execute -> account
    # ------------------------------------------------------------------ #

    def drain(self, *, deadline_s: float | None = None
              ) -> list[RequestReceipt]:
        """Serve every pending request; returns their receipts in order.

        With an ``slo`` policy the admission controller runs first: shed
        requests terminate immediately in a ``status="shed"`` receipt
        (with the reason), pressure-degraded ones carry their forced
        rung into execution.  ``deadline_s`` (default: the service's
        ``drain_deadline_s``) bounds the drain loop on the service timer,
        so a wedged worker surfaces a DrainDeadlineError naming the stuck
        shapes instead of looping forever.

        If a batch fails mid-cycle, already-served requests keep their
        receipts and every unserved request is re-queued for the next
        drain before the error propagates.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return []
        deadline = (deadline_s if deadline_s is not None
                    else self.drain_deadline_s)
        serve = pending
        if self.admission is not None:
            serve = []
            for d in self.admission.decide(pending, self.cache):
                if d.action == SHED:
                    self._store(RequestReceipt.make_shed(
                        d.request, d.reason, self._timer()))
                else:
                    if d.rung > RUNG_TUNED_DVFS:
                        self._forced[d.request.request_id] = (d.rung, d.reason)
                    serve.append(d.request)
        try:
            if serve:
                if self.coalesce_requests:
                    batches = coalesce(serve,
                                       device_name=self.device_spec.name,
                                       batch_bytes=self.batch_bytes,
                                       start_id=self._next_batch_id)
                else:
                    batches = [
                        Batch(self._next_batch_id + i,
                              r.shape_key(self.device_spec.name), [r])
                        for i, r in enumerate(serve)
                    ]
                self._next_batch_id += len(batches)
                if self.journal is not None:
                    for batch in batches:
                        self.journal.append(wal.ASSIGN, {
                            "batch_id": batch.batch_id,
                            "rseqs": [r.jseq for r in batch.requests]})
                for batch in batches:
                    self.dispatcher.submit(batch)
                self.dispatcher.drain(self._execute, timer=self._timer,
                                      deadline_s=deadline)
        except BaseException:
            self.dispatcher.clear()          # drop stale queued batches
            unserved = [r for r in serve
                        if r.request_id not in self._receipts]
            self._pending = unserved + self._pending
            raise
        finally:
            for r in serve:
                self._forced.pop(r.request_id, None)
        return [self._receipts[r.request_id] for r in pending
                if r.request_id in self._receipts]   # cap may have evicted

    def _stack(self, batch: Batch, device: torch.device) -> torch.Tensor:
        """The batch's payloads as one (rows, *shape) tensor on ``device``
        at the execution dtype.  Numpy payloads are stacked on the host
        and copied once; tensor payloads are stacked on ``device`` and
        never visit the host.  R2C payloads execute real; FDAS time series
        and pulsar filterbanks execute real in float32, as the
        reference's."""
        key = batch.key
        real = key.transform == "r2c" or key.kind != KIND_FFT
        if key.kind != KIND_FFT:
            dtype = np.float32
        else:
            dtype = (_REAL_EXEC_DTYPE if real else _EXEC_DTYPE)[key.precision]
        shape = key.shape or (key.n,)
        xs = [r.x for r in batch.requests]
        if not any(isinstance(x, torch.Tensor) for x in xs):
            rows = [np.asarray(x).reshape(-1, *shape) for x in xs]
            x = np.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]
            if real:
                x = x.real
            return torch.from_numpy(
                np.ascontiguousarray(x, dtype=dtype)).to(device)
        rows = [torch.as_tensor(x, device=device).reshape(-1, *shape)
                for x in xs]
        x = torch.cat(rows) if len(rows) > 1 else rows[0]
        if real and x.is_complex():
            x = x.real
        return x.to(_TORCH_DTYPE[dtype]).resolve_conj().contiguous()

    def _effective_budget(self, batch: Batch) -> float | None:
        """Strictest real-time budget across the batch's requests.

        Budget-less requests fall back to the service default, so a loose
        explicit budget on one request can never relax the guarantee owed
        to a coalesced neighbour; None (from a request AND the default)
        means unconstrained.
        """
        budgets = [self.time_budget if r.latency_budget is None
                   else r.latency_budget for r in batch.requests]
        constrained = [b for b in budgets if b is not None]
        return min(constrained) if constrained else None

    # ------------------------------------------------------------------ #
    # fault handling
    # ------------------------------------------------------------------ #

    def _breaker(self, worker: int) -> CircuitBreaker:
        br = self.breakers.get(worker)
        if br is None:
            br = CircuitBreaker(failure_threshold=self._breaker_threshold,
                                cooldown_s=self._breaker_cooldown_s)
            self.breakers[worker] = br
        return br

    def _peek_blocked(self, worker: int, now: float) -> bool:
        """Is ``worker`` stalled or quarantined?  Pure — no probe consumed."""
        if self._stalled_until.get(worker, 0.0) > now:
            return True
        br = self.breakers.get(worker)
        return br is not None and not br.would_allow(now)

    def _reassign(self, batch: Batch, *, exclude, now: float) -> None:
        """Push ``batch`` back onto the healthiest other worker's queue.

        ``exclude`` is one worker index or an iterable of them (a host
        fault domain).  When the exclusion covers every worker the batch
        still has to land somewhere — it goes back to the excluded set
        and waits out the breaker cooldowns there.
        """
        excluded = ({exclude} if isinstance(exclude, int) else set(exclude))
        others = [w for w in range(self.dispatcher.queue.n_workers)
                  if w not in excluded]
        healthy = [w for w in others if not self._peek_blocked(w, now)]
        self.dispatcher.queue.push_least_loaded(
            batch, allowed=healthy or others or sorted(excluded))
        self.redistributions += 1

    def _batch_rung(self, batch: Batch) -> tuple[int, list[str]]:
        """The admission-forced rung of the batch: the deepest rung forced
        on any member, capped at what the kind supports."""
        rung, reasons = RUNG_TUNED_DVFS, []
        for r in batch.requests:
            forced = self._forced.get(r.request_id)
            if forced is None:
                continue
            rung = max(rung, forced[0])
            if forced[1] not in reasons:
                reasons.append(forced[1])
        return min(rung, max_rung_for_kind(batch.key.kind)), reasons

    def _span(self, name: str, **attrs):
        """A tracer span when tracing is on, else a free nullcontext."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **attrs)

    def _execute(self, batch: Batch, worker: int,
                 device: torch.device) -> None:
        """Fault-aware execution wrapper around :meth:`_execute_batch`.

        Blocked workers (stalled or breaker-open) hand the batch to a
        healthy peer; an injected stall marks the worker and redistributes;
        a lost device trips the breaker and retries the batch elsewhere
        under the retry policy, shedding with ``fault:retries-exhausted``
        receipts only when it is spent.  Any other exception propagates.
        """
        now = self._timer()
        if self._stalled_until.get(worker, 0.0) > now:
            self._reassign(batch, exclude=worker, now=now)
            return
        if not self._breaker(worker).allow(now):
            self._reassign(batch, exclude=worker, now=now)
            return
        if self.faults is not None:
            ev = self.faults.take(STALL_WORKER, batch_id=batch.batch_id,
                                  worker=worker)
            if ev is not None:
                self.stalls_honoured += 1
                self._stalled_until[worker] = now + ev.duration
                self._reassign(batch, exclude=worker, now=now)
                return
        try:
            self._execute_batch(batch, worker, device)
        except HostLostError as e:
            # The whole fault domain died: every worker on the host is
            # quarantined at once and its telemetry rings are wiped; the
            # batch then follows the retry/redistribute/shed ladder with
            # the whole domain excluded.
            now = self._timer()
            self.host_kills += 1
            for w in e.workers:
                self._breaker(w).trip(now)
                if self.telemetry is not None:
                    ring = self.telemetry.rings.get(w)
                    if ring is not None:
                        ring.clear()
            attempts = self._attempts.get(batch.batch_id, 0) + 1
            self._attempts[batch.batch_id] = attempts
            if attempts > self.retry.max_retries:
                self._attempts.pop(batch.batch_id, None)
                for req in batch.requests:
                    self._store(RequestReceipt.make_shed(
                        req, "fault:host-lost", now))
                return
            self._sleep(self.retry.delay(attempts, token=batch.batch_id))
            self._reassign(batch, exclude=e.workers, now=now)
        except DeviceLostError:
            now = self._timer()
            self._breaker(worker).record_failure(now)
            attempts = self._attempts.get(batch.batch_id, 0) + 1
            self._attempts[batch.batch_id] = attempts
            if attempts > self.retry.max_retries:
                self._attempts.pop(batch.batch_id, None)
                for req in batch.requests:
                    self._store(RequestReceipt.make_shed(
                        req, "fault:retries-exhausted", now))
                return
            self._sleep(self.retry.delay(attempts, token=batch.batch_id))
            self._reassign(batch, exclude=worker, now=now)
        else:
            self._breaker(worker).record_success()

    def _execute_batch(self, batch: Batch, worker: int,
                       device: torch.device) -> None:
        rung, reasons = self._batch_rung(batch)
        if (self.faults is not None
                and self.faults.take(FAIL_PLAN_BUILD, batch_id=batch.batch_id,
                                     worker=worker)):
            rung = max(rung, RUNG_BOOST_HEURISTIC)
            reasons.append("fault:plan-build-failed")
        entry = (self.cache.entry(batch.key) if rung == RUNG_TUNED_DVFS
                 else self.cache.degraded_entry(batch.key))
        point = (entry.point_for(self._effective_budget(batch))
                 if rung == RUNG_TUNED_DVFS else entry.sweep.boost)
        # Rung 0 locks at the sweep optimum; degraded rungs still lock, at
        # boost — clock control is independent of which compute path
        # runs, so a lock failure is observable on every rung.
        lock_f = point.f
        if lock_f is not None and self.faults is not None \
                and self.faults.take(FAIL_CLOCK_LOCK, batch_id=batch.batch_id,
                                     worker=worker):
            # The clock lock could not be acquired: run unlocked at the
            # device's boost default.  At rung 0 the tuned plan is kept —
            # only the clock guarantee is lost.
            if rung == RUNG_TUNED_DVFS:
                rung = RUNG_BOOST_HEURISTIC
                point = entry.sweep.boost
            reasons.append("fault:clock-lock-failed")
            lock_f = None
        # The service latency covers the batch's assembly on the device,
        # its transform and the wait for the card.
        t_start = self._timer()
        ctx = (self.clock.locked(lock_f) if lock_f is not None
               else contextlib.nullcontext())
        with self._span("batch", batch_id=batch.batch_id, worker=worker,
                        kind=batch.key.kind,
                        shape=batch.key.shape or (batch.key.n,),
                        rung=rung, clock_mhz=point.f):
            with ctx:
                # Injected kills fire mid-batch: after the lock and
                # dispatch decisions, before results exist.  A host kill
                # takes the worker's whole fault domain with it.
                if (self.faults is not None
                        and self.faults.take(KILL_HOST,
                                             batch_id=batch.batch_id,
                                             worker=worker)):
                    topo = self.topology or HostTopology(
                        self.dispatcher.queue.n_workers)
                    host = topo.host_of(worker)
                    raise HostLostError(worker, host,
                                        topo.workers_of(host))
                if (self.faults is not None
                        and self.faults.take(KILL_DEVICE,
                                             batch_id=batch.batch_id,
                                             worker=worker)):
                    raise DeviceLostError(worker)
                x = self._stack(batch, device)
                with self._span("execute"), \
                        self.ledger.capture(key=batch.key):
                    if (self.mesh is not None
                            and batch.key.kind == KIND_FFT
                            and x.shape[0] > 1 and rung < RUNG_PURE_TORCH):
                        y = batch_parallel_fft(x, self.mesh,
                                               fft_fn=entry.plan)
                    elif (rung >= RUNG_PURE_TORCH
                            and batch.key.kind == KIND_FFT
                            and device.type == "cpu"):
                        # The pure-torch engine on CPU slots only: a batch
                        # on the card keeps the boost heuristic plan's
                        # kernels at rung 2 (receipted as rung 2).
                        with kernels_disabled():
                            y = entry.fn(x)
                    else:
                        y = entry.fn(x)
                    # The launches return before the card is done:
                    # without the sync, service_latency would time only
                    # the launch.  A sharded batch ran on every device.
                    for dev in (self.mesh.unique_devices()
                                if self.mesh is not None else (device,)):
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
        t_done = self._timer()
        self._account(batch, worker, entry, point, y, t_start, t_done,
                      rung=rung, reason="; ".join(reasons) or None)

    def _store(self, receipt: RequestReceipt, *, key=None) -> None:
        jseq = receipt.request.jseq
        if self.journal is not None and jseq is not None:
            # Durability point: the terminal record hits the journal
            # BEFORE the in-memory receipt exists, so a crash can lose an
            # execution (at-least-once) but never a receipt.  ``key`` (the
            # batch's shape key) lets recovery replay the launch signature.
            receipt.incarnation = self.journal.incarnation
            rtype = wal.SERVED if receipt.status == "served" else wal.SHED
            self.journal.append(rtype, terminal_record(receipt, key))
            self._remember_seq(jseq, receipt)
        if (self.max_retained_receipts is not None
                and len(self._receipts) >= self.max_retained_receipts):
            self._receipts.pop(next(iter(self._receipts)))  # oldest
        self._receipts[receipt.request.request_id] = receipt
        # Terminal-receipt metrics: counters live beyond receipt retention.
        if receipt.status == "served":
            self.metrics.counter(
                "repro_requests_served_total",
                "requests served (any rung, incl. after retries)").inc()
            self.metrics.histogram(
                "repro_request_latency_seconds",
                "end-to-end (queue + service) request latency").observe(
                    receipt.latency)
            if receipt.rung > RUNG_TUNED_DVFS:
                self.metrics.counter(
                    "repro_requests_degraded_total",
                    "requests served below the tuned-DVFS rung").inc()
        else:
            self.metrics.counter(
                "repro_requests_shed_total",
                "requests terminated without execution").inc()

    def _account(self, batch: Batch, worker: int, entry: CacheEntry, point,
                 y: torch.Tensor, t_start: float, t_done: float,
                 rung: int = RUNG_TUNED_DVFS,
                 reason: str | None = None) -> None:
        per_time, per_energy = entry.per_transform(point)
        _, per_boost = entry.per_transform(entry.sweep.boost)
        retries = self._attempts.pop(batch.batch_id, 0)
        # One telemetry sample per executed batch, at the clock it locked.
        # Watchdog-fresh readings price the batch at measured power; any
        # other label falls back to the modelled energy.
        measured_w = None
        if self.telemetry is not None:
            tr = self.telemetry.read(
                worker, t_done, token=batch.batch_id, f_mhz=point.f,
                u_core=entry.profile.core_utilisation(self.device_spec),
                u_mem=entry.profile.mem_utilisation(self.device_spec))
            measured_w = tr.measured_w
        if measured_w is not None:
            # Model-drift loop: one per-transform modelled-vs-measured
            # observation per metered batch, keyed on (kind, shape, clock).
            self.drift.observe(
                (batch.key.kind, batch.key.shape or (batch.key.n,),
                 point.f),
                modelled=per_energy, measured=measured_w * per_time)
        launches = self.ledger.signature(batch.key)
        offset = 0
        for req in batch.requests:
            rows = req.batch
            result = y[offset:offset + rows] if self.keep_results else None
            offset += rows
            stages = None
            if entry.stages is not None:
                # Pipeline entries: scale the modelled batch's per-stage
                # plan (clock + J/stage) to this request's row share.
                share = rows / max(entry.n_fft_model, 1)
                stages = [StageReceipt(name=s.name, clock_mhz=s.f,
                                       time_s=s.time * share,
                                       energy_j=s.energy * share)
                          for s in entry.stages.stages]
            self._store(RequestReceipt(
                request=req,
                batch_id=batch.batch_id,
                worker=worker,
                queue_latency=max(t_start - req.t_enqueue, 0.0),
                service_latency=t_done - t_start,
                clock_mhz=point.f,
                modelled_time_s=per_time * rows,
                energy_j=per_energy * rows,
                boost_energy_j=per_boost * rows,
                measured_energy_j=(
                    None if self.telemetry is None
                    else (measured_w * per_time * rows
                          if measured_w is not None
                          else per_energy * rows)),
                result=result,
                stages=stages,
                realtime_margin=entry.realtime_margin,
                rung=rung,
                retries=retries,
                reason=reason,
                launches=list(launches),
            ), key=batch.key)

    # ------------------------------------------------------------------ #
    # crash consistency
    # ------------------------------------------------------------------ #

    def snapshot(self, *, governors: dict | None = None) -> str:
        """Persist the durable service state to the attached journal.

        Captures the plan/sweep cache keys, breaker and watchdog health,
        drift EWMAs, metrics counters and the batch-id high-water mark
        (plus any caller-managed power ``governors``) as an atomic
        snapshot; recovery replays only the journal records written
        after it.  Returns the snapshot path.
        """
        if self.journal is None:
            raise ValueError("snapshot() requires a journal-attached "
                             "service (pass journal= to the constructor)")
        return self.journal.write_snapshot(
            ServiceSnapshot.capture(self, governors=governors))

    @classmethod
    def recover(cls, journal_dir: str, **kwargs) -> "FFTService":
        """Rebuild a service from a journal directory after a crash.

        See :func:`repro_torch.serving.recovery.recover_service` —
        replayed receipts land in ``recovered_receipts`` (and
        ``receipt_for_seq``), in-flight admits are re-enqueued via
        ``payload_fn``, and the replay accounting is on ``.replay``.
        """
        return recover_service(journal_dir, **kwargs)

    # ------------------------------------------------------------------ #
    # service-level reporting
    # ------------------------------------------------------------------ #

    def report(self) -> ServiceReport:
        receipts = self.receipts
        served = [r for r in receipts if r.status == "served"]
        shed = [r for r in receipts if r.status == "shed"]
        fault_shed = sum(1 for r in shed
                         if (r.reason or "").startswith("fault:"))
        lat = latency_summary(r.latency for r in served)
        # One wall-time contribution per batch (receipts in a batch share
        # the batch's service latency), over the retained window.
        batch_wall = {r.batch_id: r.service_latency for r in served}
        return ServiceReport(
            n_requests=len(served),
            n_transforms=sum(r.request.batch for r in served),
            n_batches=len(batch_wall),
            wall_s=sum(batch_wall.values()),
            energy_j=sum(r.energy_j for r in served),
            boost_energy_j=sum(r.boost_energy_j for r in served),
            p50_latency_s=lat.p50,
            p99_latency_s=lat.p99,
            mean_latency_s=lat.mean,
            cache=self.cache.stats,
            steals=self.dispatcher.steals,
            clock_locks=self.clock.lock_count,
            shed=len(shed),
            fault_shed=fault_shed,
            degraded=sum(1 for r in served if r.rung > RUNG_TUNED_DVFS),
            retried=sum(1 for r in served if r.retries > 0),
            redistributions=self.redistributions,
            breaker_opens=sum(b.opens for b in self.breakers.values()),
            slo=self.slo.evaluate(receipts) if self.slo is not None else None,
            measured_energy_j=sum(r.measured_energy_j or 0.0 for r in served),
            telemetry=(self.telemetry.summary()
                       if self.telemetry is not None else None),
            drift=(self.drift.summary()
                   if self.drift.observations else None),
        )

    def fill_metrics(self) -> MetricsRegistry:
        """Refresh the registry from the current report and subsystem
        counters; returns the registry (render with ``.render()``).

        Terminal-receipt counters and the latency histogram accrue live
        in :meth:`_store`; everything gauge-like is refreshed here in one
        deterministic pass.
        """
        m = self.metrics
        rep = self.report()
        h = m.histogram("repro_request_latency_seconds",
                        "end-to-end (queue + service) request latency")
        m.gauge("repro_request_latency_p50_seconds",
                "histogram-derived median latency").set(h.quantile(0.50))
        m.gauge("repro_request_latency_p99_seconds",
                "histogram-derived tail latency").set(h.quantile(0.99))
        m.gauge("repro_availability",
                "served / (served + fault-shed)").set(rep.availability)
        m.gauge("repro_energy_joules",
                "modelled energy at the locked clocks").set(rep.energy_j)
        m.gauge("repro_measured_energy_joules",
                "telemetry-priced energy (fresh samples)").set(
                    rep.measured_energy_j)
        m.gauge("repro_i_ef", "service-level Eq. 7 efficiency increase"
                ).set(rep.i_ef)
        m.gauge("repro_clock_locks", "DVFS clock locks taken").set(
            rep.clock_locks)
        m.gauge("repro_breaker_opens", "circuit-breaker quarantines").set(
            rep.breaker_opens)
        m.gauge("repro_redistributions",
                "batches pushed away from sick workers").set(
                    rep.redistributions)
        m.gauge("repro_kernel_launches_recorded",
                "ledger records captured").set(len(self.ledger.records))
        self.cache.stats.fill_metrics(m)
        self.dispatcher.fill_metrics(m)
        if self.telemetry is not None:
            self.telemetry.fill_metrics(m)
        self.drift.fill_metrics(m)
        return m

    def metrics_text(self) -> str:
        """One Prometheus-style exposition of the whole service."""
        return self.fill_metrics().render()
