"""Batch dispatch across devices via a work-stealing queue (the
counterpart of ``repro.serving.dispatch``).

Batches land on the least-loaded device queue at submit time; during the
drain loop each device pops its own queue FIFO and, when empty, steals
the freshest batch from the longest queue (repro_torch.runtime.workqueue).
Batch-parallel work needs no collectives, only load balance (the paper's
Sec. 2.3).  The dispatcher is cooperative: round-robin ticks on one host.
The reference's drain deadline belongs to the robustness plane, which a
later slice of the port brings.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.runtime.workqueue import WorkStealingQueue
from repro_torch.serving.batcher import Batch


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none (the service
    never falls back to the CPU by itself)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "no CUDA device: the service runs on the card; pass "
            "devices=[torch.device('cpu')] to serve on the CPU explicitly")
    return [torch.device("cuda", i) for i in range(count)]


class Dispatcher:
    """Work-stealing executor over torch devices (default: every CUDA
    device)."""

    def __init__(self, devices: Sequence[torch.device] | None = None):
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else cuda_devices())
        self.queue = WorkStealingQueue(len(self.devices))

    @property
    def steals(self) -> int:
        return self.queue.steals

    def submit(self, batch: Batch) -> int:
        """Queue a batch on the least-loaded device; returns the worker."""
        return self.queue.push_least_loaded(batch)

    def clear(self) -> list[Batch]:
        """Remove and return every queued batch (failure recovery)."""
        return self.queue.clear()

    def drain(self, execute: Callable[[Batch, int, torch.device], None]
              ) -> int:
        """Run every queued batch; returns the number executed.

        ``execute(batch, worker, device)`` is called once per batch, on the
        worker that actually ran it (owner or thief).
        """
        executed = 0
        while self.queue.pending():
            for worker in range(self.queue.n_workers):
                batch = self.queue.pop(worker)
                if batch is None:
                    continue
                execute(batch, worker, self.devices[worker])
                executed += 1
        return executed
