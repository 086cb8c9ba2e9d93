"""repro_torch.serving — the energy-aware FFT service on the card.

  request    FFTRequest / RequestReceipt / ShapeKey
  batcher    Eq. 6 memory-bounded request coalescing
  cache      plan + DVFS-sweep cache, one entry per shape
  dispatch   work-stealing dispatch over torch devices
  service    FFTService: the request lifecycle and its receipts

The counterpart of ``repro.serving`` for FFT requests (1-D and N-D, C2C
and R2C), FDAS requests and pulsar-search requests; see
:mod:`repro_torch.serving.service` for what later slices add.
"""
from repro_torch.serving.batcher import Batch, coalesce
from repro_torch.serving.cache import CacheEntry, CacheStats, PlanSweepCache
from repro_torch.serving.dispatch import Dispatcher
from repro_torch.serving.request import (KIND_FDAS, KIND_FFT, KIND_PULSAR,
                                         FFTRequest, RequestReceipt,
                                         ShapeKey, StageReceipt)
from repro_torch.serving.service import FFTService, ServiceReport

__all__ = ["Batch", "CacheEntry", "CacheStats", "Dispatcher", "FFTRequest",
           "FFTService", "KIND_FDAS", "KIND_FFT", "KIND_PULSAR",
           "PlanSweepCache", "RequestReceipt", "ServiceReport", "ShapeKey",
           "StageReceipt", "coalesce"]
