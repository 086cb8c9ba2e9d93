"""Request and receipt types for the energy-aware FFT service.

The counterpart of ``repro.serving.request`` for the requests the port
serves: ``KIND_FFT`` (1-D and N-D, C2C and R2C), ``KIND_FDAS`` (the
acceleration search) and ``KIND_PULSAR`` (the end-to-end pulsar search,
whose receipts carry per-stage DVFS shares and the real-time margin).  A
request is a batch of same-shape transforms
submitted by one client; a receipt is everything the paper would report
about serving it: which clock it ran at, its modelled energy (Eqs. 3-4),
and its measured queue + service latency.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.workloads import COMPLEX_BYTES
from repro_torch.fft.radix import is_pow2

_REQUEST_IDS = itertools.count()

#: Request kinds the service understands.
KIND_FFT = "fft"            # batched 1-D or N-D transforms
KIND_PULSAR = "pulsar"      # end-to-end pulsar search (search.pipeline)
KIND_FDAS = "fdas"          # Fourier-domain acceleration search


@dataclasses.dataclass(frozen=True)
class ShapeKey:
    """Cache key: one plan + one frequency sweep per distinct value.

    The latency budget is deliberately NOT part of the key: budgets only
    re-select a point from the cached sweep
    (``SweepResult.optimal_under_budget``).  ``shape`` is () for 1-D
    transforms and the transform-axes lengths otherwise, so a 2-D key and
    a 1-D key of the same total points are distinct entries; ``n`` is
    always the total points per transform.  FDAS keys carry the bank size
    and the overlap-save segment (0 = auto); pulsar keys the filterbank
    shape, the DM-grid size, the bank size and the harmonic count.
    """

    kind: str
    n: int
    precision: str
    n_harmonics: int = 0            # pulsar requests only; 0 otherwise
    device: str = ""
    transform: str = "c2c"          # "c2c" | "r2c": distinct plans + sweeps
    shape: tuple[int, ...] = ()     # N-D transform-axes lengths; () for 1-D
    templates: int = 0              # fdas/pulsar: acceleration-bank size
    segment: int = 0                # fdas: overlap-save nfft (0 = auto)
    dm_trials: int = 0              # pulsar: dedispersion DM-grid size

    @property
    def last_axis(self) -> int:
        """The axis length R2C packing applies to (the last transform axis)."""
        return self.shape[-1] if self.shape else self.n

    @property
    def elem_bytes(self) -> int:
        """Per-point device bytes of this shape's payload: real (half) for
        pow2 R2C along the last transform axis and for pulsar filterbanks,
        complex otherwise (non-pow2 r2c runs the full C2C plan).  In
        lockstep with ``core.workloads.FFTCase.elem_bytes`` and
        ``PulsarCase.sample_bytes``."""
        full = COMPLEX_BYTES[self.precision]
        if self.kind == KIND_PULSAR:
            return full // 2
        if self.transform == "r2c" and is_pow2(self.last_axis):
            return full // 2
        return full


@dataclasses.dataclass
class FFTRequest:
    """One client submission: ``x`` rows are independent transforms.

    ``x`` is a numpy array or torch tensor: (batch, *shape) or (*shape,)
    with ``ndim`` transform axes (1 for the paper's 1-D workload, 2+ for
    N-D transforms through the plan graph).  FDAS requests carry real
    (batch, n) time series and the bank size ``templates``; pulsar
    requests carry (batch, nchan, ntime) or (nchan, ntime) filterbanks,
    the DM-grid size ``dm_trials``, ``templates`` and ``n_harmonics``.
    """

    x: Any
    precision: str = "fp32"
    kind: str = KIND_FFT
    latency_budget: float | None = None  # max tolerable slowdown vs boost
    n_harmonics: int = 32                # pulsar kind only
    transform: str = "c2c"               # "c2c" or "r2c" (real payloads)
    ndim: int = 1                        # transform rank
    templates: int = 16                  # fdas/pulsar: bank size
    segment: int = 0                     # fdas kind only: nfft (0 = auto)
    dm_trials: int = 16                  # pulsar kind only: DM-grid size
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_REQUEST_IDS))
    t_enqueue: float = 0.0               # stamped by the service

    def __post_init__(self):
        if not isinstance(self.x, (np.ndarray, torch.Tensor)):
            self.x = np.asarray(self.x)
        if self.precision not in COMPLEX_BYTES:
            raise ValueError(
                f"unknown precision {self.precision!r}; "
                f"have {sorted(COMPLEX_BYTES)}")
        if self.kind not in (KIND_FFT, KIND_PULSAR, KIND_FDAS):
            raise ValueError(f"unknown request kind {self.kind!r}")
        if self.kind in (KIND_FDAS, KIND_PULSAR) and self.templates < 1:
            raise ValueError(
                f"{self.kind} requests need templates >= 1, "
                f"got {self.templates}")
        if self.transform not in ("c2c", "r2c"):
            raise ValueError(f"unknown transform {self.transform!r}; "
                             "have ('c2c', 'r2c')")
        if self.kind == KIND_PULSAR:
            # Pulsar payloads are rank-2 filterbanks (nchan, ntime); the
            # transform rank is implied, not caller-chosen.
            if self.dm_trials < 1:
                raise ValueError(
                    f"pulsar requests need dm_trials >= 1, "
                    f"got {self.dm_trials}")
            self.ndim = 2
        if self.ndim < 1:
            raise ValueError(f"transform rank must be >= 1, got {self.ndim}")
        if self.ndim > 1 and self.kind not in (KIND_FFT, KIND_PULSAR):
            raise ValueError("N-D payloads are FFT requests only")
        # Reject malformed payloads at submit time so one bad request can
        # never poison a whole serving cycle.
        if (self.x.ndim not in (self.ndim, self.ndim + 1)
                or any(d < 1 for d in self.x.shape)):
            raise ValueError(
                f"rank-{self.ndim} payload must be (batch, *shape) or "
                f"(*shape,) with positive dims; "
                f"got shape {tuple(self.x.shape)}")

    @property
    def shape(self) -> tuple[int, ...]:
        """Transform-axes lengths (the trailing ``ndim`` payload dims)."""
        return tuple(int(d) for d in self.x.shape[-self.ndim:])

    @property
    def n(self) -> int:
        """Total points per transform (product over the transform axes)."""
        return math.prod(self.shape)

    @property
    def batch(self) -> int:
        """Number of independent transforms in this request."""
        return int(self.x.shape[0]) if self.x.ndim == self.ndim + 1 else 1

    @property
    def bytes(self) -> int:
        """Device bytes of the request payload at its precision (half for
        pow2 R2C payloads, which execute as real arrays)."""
        return self.batch * self.n * self.shape_key("").elem_bytes

    def shape_key(self, device_name: str) -> ShapeKey:
        """FDAS keys carry (n, segment, templates): distinct banks or
        segment lengths plan and sweep separately.  Pulsar keys carry the
        whole pipeline configuration — filterbank shape, DM-grid size,
        bank size, harmonic count — and pin the inner R2C as
        ``transform``."""
        fdas = self.kind == KIND_FDAS
        pulsar = self.kind == KIND_PULSAR
        return ShapeKey(
            kind=self.kind, n=self.n, precision=self.precision,
            n_harmonics=self.n_harmonics if pulsar else 0,
            device=device_name,
            transform="r2c" if pulsar else self.transform,
            shape=self.shape if self.ndim > 1 else (),
            templates=self.templates if (fdas or pulsar) else 0,
            segment=self.segment if fdas else 0,
            dm_trials=self.dm_trials if pulsar else 0)


@dataclasses.dataclass(frozen=True)
class StageReceipt:
    """One pipeline stage's share of a request: the clock the per-stage
    DVFS plan locks it to and its modelled time/energy share."""

    name: str                   # "dedisp" | "fdas" | "harmonic-sum" | "sift"
    clock_mhz: float            # the stage's locked clock
    time_s: float               # modelled stage time of this share
    energy_j: float             # modelled stage energy of this share


@dataclasses.dataclass
class RequestReceipt:
    """Per-request accounting, filled in when the batch executes."""

    request: FFTRequest
    batch_id: int
    worker: int
    # --- latency (measured wall clock, seconds) --------------------------
    queue_latency: float        # enqueue -> batch execution start
    service_latency: float      # execution start -> results on the device
    # --- energy/clock (analytic model, paper Eqs. 3-4 + Sec. 5.3) --------
    clock_mhz: float            # the locked clock the batch ran at
    modelled_time_s: float      # model-predicted execution time of this share
    energy_j: float             # model-predicted energy of this share
    boost_energy_j: float       # same share executed at the boost clock
    result: Any = None          # transform output (None if not retained)
    # --- pulsar-pipeline requests only -----------------------------------
    stages: list[StageReceipt] | None = None   # per-stage clock + J shares
    realtime_margin: float | None = None       # S = t_acquire / t_process
    # --- kernel launch ledger (repro_torch.obs.ledger) ---------------------
    # The launch signature of this request's shape: one LaunchRecord per
    # kernel launch of the first batch of the shape the process served.
    launches: list = dataclasses.field(default_factory=list)

    @property
    def latency(self) -> float:
        return self.queue_latency + self.service_latency
