"""The energy-aware streaming FFT service, on the card.

The counterpart of ``repro.serving.service`` for ``KIND_FFT`` requests
(1-D and N-D, C2C and R2C), ``KIND_FDAS`` requests (the acceleration
search, answered with its packed candidates) and ``KIND_PULSAR`` requests
(the end-to-end pulsar search, answered with its sifted candidates, with
per-stage DVFS shares and the real-time margin on each receipt).  Request
lifecycle:

  enqueue      submit() stamps arrival time and parks the request
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
               (modelled, Eqs. 3-4)

The energy numbers come from the analytic DVFS model of ``device_spec``
(default: the paper's Tesla V100; the port has no model of the H100 yet).
The reference's SLO admission, fault injection, degradation ladder,
power telemetry, tracing, metrics, drift detection, journal and mesh
sharding arrive with later slices of the port: their arguments are not
parameters here yet.  So does the degraded (sweep-free) pulsar build.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.energy import guarded_ratio
from repro_torch.core.hardware import TESLA_V100, DeviceSpec
from repro_torch.core.scheduler import ClockController
from repro_torch.obs.ledger import LaunchLedger
from repro_torch.obs.metrics import latency_summary
from repro_torch.serving.batcher import Batch, coalesce
from repro_torch.serving.cache import CacheEntry, CacheStats, PlanSweepCache
from repro_torch.serving.dispatch import Dispatcher
from repro_torch.serving.request import (KIND_FFT, FFTRequest,
                                         RequestReceipt, StageReceipt)

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

    # Zero-denominator edges follow repro_torch.core.energy.guarded_ratio.

    @property
    def availability(self) -> float:
        """Served / (served + fault-shed); this slice sheds nothing, and an
        empty report is availability 1.0 (no demand, nothing unserved)."""
        return guarded_ratio(self.n_requests, self.n_requests, on_zero=1.0)

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
    none; pass ``[torch.device("cpu")]`` to serve on the CPU explicitly
    (the kernels' plain versions).  A batch runs on its coalesced rows as
    they are: eager torch has no compiled shapes to reuse, so the
    reference's power-of-two row padding is left out.
    """

    def __init__(
        self,
        device_spec: DeviceSpec = TESLA_V100,
        *,
        batch_bytes: float | None = None,
        time_budget: float | None = 0.10,
        devices: Sequence[Any] | None = None,
        max_retained_receipts: int | None = None,
        plan_fn=None,
        sweep_fn=None,
        timer=time.monotonic,
    ):
        self.device_spec = device_spec
        # Default batch budget: an eighth of device memory, capped at the
        # paper's ~2 GB measurement batches (Sec. 4).
        self.batch_bytes = (batch_bytes if batch_bytes is not None
                            else min(2e9, device_spec.memory_bytes / 8))
        self.time_budget = time_budget
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
                                    **kwargs)
        self.clock = ClockController(
            device_spec, timer=timer,
            max_events=(None if max_retained_receipts is None
                        else 2 * max_retained_receipts))
        self.dispatcher = Dispatcher(devices)
        # The launch ledger is always on; a receipt's launches are its
        # shape's first captured signature (repro_torch.obs.ledger).
        self.ledger = LaunchLedger()
        self._pending: list[FFTRequest] = []
        self._receipts: dict[int, RequestReceipt] = {}
        self._next_batch_id = 0

    # ------------------------------------------------------------------ #
    # enqueue
    # ------------------------------------------------------------------ #

    def submit(self, x: Any, *, precision: str = "fp32",
               kind: str = KIND_FFT, latency_budget: float | None = None,
               n_harmonics: int = 32, transform: str = "c2c", ndim: int = 1,
               templates: int = 16, segment: int = 0,
               dm_trials: int = 16) -> FFTRequest:
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
        DVFS shares (clock, modelled J) and the real-time margin.  The
        request's receipt becomes available after the next drain():
        ``service.receipt(request)``.
        """
        req = FFTRequest(x=x, precision=precision, kind=kind,
                         latency_budget=latency_budget,
                         n_harmonics=n_harmonics, transform=transform,
                         ndim=ndim, templates=templates, segment=segment,
                         dm_trials=dm_trials)
        req.t_enqueue = self._timer()
        self._pending.append(req)
        return req

    def receipt(self, request: FFTRequest) -> RequestReceipt | None:
        return self._receipts.get(request.request_id)

    @property
    def receipts(self) -> list[RequestReceipt]:
        return [self._receipts[k] for k in sorted(self._receipts)]

    # ------------------------------------------------------------------ #
    # batch -> plan-cache -> clock-plan -> execute -> account
    # ------------------------------------------------------------------ #

    def drain(self) -> list[RequestReceipt]:
        """Serve every pending request; returns their receipts in order.

        If a batch fails mid-cycle, already-served requests keep their
        receipts and every unserved request is re-queued for the next
        drain before the error propagates.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return []
        try:
            batches = coalesce(pending, device_name=self.device_spec.name,
                               batch_bytes=self.batch_bytes,
                               start_id=self._next_batch_id)
            self._next_batch_id += len(batches)
            for batch in batches:
                self.dispatcher.submit(batch)
            self.dispatcher.drain(self._execute_batch)
        except BaseException:
            self.dispatcher.clear()          # drop stale queued batches
            unserved = [r for r in pending
                        if r.request_id not in self._receipts]
            self._pending = unserved + self._pending
            raise
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

    def _execute_batch(self, batch: Batch, worker: int,
                       device: torch.device) -> None:
        entry = self.cache.entry(batch.key)
        point = entry.point_for(self._effective_budget(batch))
        # The service latency covers the batch's assembly on the device,
        # its transform and the wait for the card.
        t_start = self._timer()
        x = self._stack(batch, device)
        with self.clock.locked(point.f), \
                self.ledger.capture(key=batch.key):
            y = entry.fn(x)
            if device.type == "cuda":
                # The launches return before the card is done: without the
                # sync, service_latency would time only the launch.
                torch.cuda.synchronize(device)
        t_done = self._timer()
        self._account(batch, worker, entry, point, y, t_start, t_done)

    def _store(self, receipt: RequestReceipt) -> None:
        if (self.max_retained_receipts is not None
                and len(self._receipts) >= self.max_retained_receipts):
            self._receipts.pop(next(iter(self._receipts)))  # oldest
        self._receipts[receipt.request.request_id] = receipt

    def _account(self, batch: Batch, worker: int, entry: CacheEntry, point,
                 y: torch.Tensor, t_start: float, t_done: float) -> None:
        per_time, per_energy = entry.per_transform(point)
        _, per_boost = entry.per_transform(entry.sweep.boost)
        launches = self.ledger.signature(batch.key)
        offset = 0
        for req in batch.requests:
            rows = req.batch
            result = y[offset:offset + rows]
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
                result=result,
                stages=stages,
                realtime_margin=entry.realtime_margin,
                launches=list(launches),
            ))

    # ------------------------------------------------------------------ #
    # service-level reporting
    # ------------------------------------------------------------------ #

    def report(self) -> ServiceReport:
        served = self.receipts
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
        )
