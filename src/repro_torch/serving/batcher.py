"""Request coalescing: group compatible requests into memory-bounded
batches (a copy of ``repro.serving.batcher``).

The paper's Eq. (6), N_FFT = M_GB / (N * B), sizes a batch by how many
length-N transforms fit a memory budget.  Pending requests are grouped by
shape key, kept in FIFO arrival order, and split whenever the accumulated
transform count would exceed the Eq. 6 budget.  A single request larger
than the budget is never split; it becomes a batch of its own.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.energy import ffts_per_batch
from repro_torch.serving.request import FFTRequest, ShapeKey


@dataclasses.dataclass
class Batch:
    """One executable unit: same-shape requests fused into a single call."""

    batch_id: int
    key: ShapeKey
    requests: list[FFTRequest]

    @property
    def n_transforms(self) -> int:
        return sum(r.batch for r in self.requests)

    @property
    def bytes(self) -> int:
        """Payload footprint at the batch's executed precision (real for
        pow2 r2c payloads, complex otherwise)."""
        return self.n_transforms * self.key.n * self.key.elem_bytes

    @property
    def latency_budget(self) -> float | None:
        """Strictest (smallest) per-request budget governs the whole batch."""
        budgets = [r.latency_budget for r in self.requests
                   if r.latency_budget is not None]
        return min(budgets) if budgets else None


def coalesce(
    pending: list[FFTRequest],
    *,
    device_name: str,
    batch_bytes: float,
    start_id: int = 0,
) -> list[Batch]:
    """Coalesce ``pending`` (arrival order) into memory-bounded batches."""
    groups: dict[ShapeKey, list[FFTRequest]] = {}
    for req in pending:
        groups.setdefault(req.shape_key(device_name), []).append(req)

    batches: list[Batch] = []
    next_id = start_id
    for key, reqs in groups.items():
        # Eq. 6 cap at the bytes the batch will actually occupy: pow2 r2c
        # payloads execute as real arrays, so twice as many fit.
        cap = ffts_per_batch(batch_bytes, key.n, key.elem_bytes)
        current: list[FFTRequest] = []
        count = 0
        for req in reqs:
            if current and count + req.batch > cap:
                batches.append(Batch(next_id, key, current))
                next_id += 1
                current, count = [], 0
            current.append(req)
            count += req.batch
        if current:
            batches.append(Batch(next_id, key, current))
            next_id += 1
    return batches
