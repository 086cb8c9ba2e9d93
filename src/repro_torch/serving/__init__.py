"""repro_torch.serving — the energy-aware FFT service on the card.

  request    FFTRequest / RequestReceipt / ShapeKey
  batcher    Eq. 6 memory-bounded request coalescing
  cache      plan + DVFS-sweep cache, one entry per shape, and the
             sweep-free rung-1 entries of the degradation ladder
  dispatch   work-stealing dispatch over torch devices (worker slots)
  slo        per-kind SLO budgets, admission control / load shedding and
             the graceful-degradation ladder
  service    FFTService: the request lifecycle and its receipts
  recovery   crash recovery from the write-ahead request journal:
             snapshot/restore, journal replay, exactly-once receipts

The counterpart of ``repro.serving`` for FFT requests (1-D and N-D, C2C
and R2C), FDAS requests and pulsar-search requests.  The degradation
ladder's bottom rung is the pure-torch engine (``RUNG_PURE_TORCH``, the
reference's ``RUNG_PURE_JAX``).
"""
from repro_torch.serving.batcher import Batch, coalesce
from repro_torch.serving.cache import CacheEntry, CacheStats, PlanSweepCache
from repro_torch.serving.dispatch import Dispatcher
from repro_torch.serving.recovery import (RecoveredRequest, ReplayResult,
                                          ServiceSnapshot, recover_service,
                                          replay_journal)
from repro_torch.serving.request import (KIND_FDAS, KIND_FFT, KIND_PULSAR,
                                         FFTRequest, RequestReceipt,
                                         ShapeKey, StageReceipt)
from repro_torch.serving.service import FFTService, ServiceReport
from repro_torch.serving.slo import (RUNG_BOOST_HEURISTIC, RUNG_PURE_TORCH,
                                     RUNG_TUNED_DVFS, SLO,
                                     AdmissionController, AdmissionDecision,
                                     SLOPolicy, max_rung_for_kind, rung_name)

__all__ = [
    "AdmissionController", "AdmissionDecision", "Batch", "CacheEntry",
    "CacheStats", "Dispatcher", "FFTRequest", "FFTService", "KIND_FDAS",
    "KIND_FFT", "KIND_PULSAR", "PlanSweepCache", "RecoveredRequest",
    "ReplayResult", "RequestReceipt", "RUNG_BOOST_HEURISTIC",
    "RUNG_PURE_TORCH", "RUNG_TUNED_DVFS", "SLO", "SLOPolicy",
    "ServiceReport", "ServiceSnapshot", "ShapeKey", "StageReceipt",
    "coalesce", "max_rung_for_kind", "recover_service", "replay_journal",
    "rung_name",
]
