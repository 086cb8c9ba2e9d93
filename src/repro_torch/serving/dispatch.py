"""Batch dispatch across devices via a work-stealing queue (the
counterpart of ``repro.serving.dispatch``).

Batches land on the least-loaded device queue at submit time; during the
drain loop each device pops its own queue FIFO and, when empty, steals
the freshest batch from the longest queue (repro_torch.runtime.workqueue).
Batch-parallel work needs no collectives, only load balance (the paper's
Sec. 2.3).  The dispatcher is cooperative: round-robin ticks on one host.  Several
worker slots may name the same device (``[cuda:0] * 4``): the breakers,
redistribution and retries of the robust service then run on one card.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.runtime.faults import DrainDeadlineError
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

    def fill_metrics(self, registry) -> None:
        """Publish dispatch counters into a MetricsRegistry."""
        registry.gauge("repro_dispatch_workers",
                       "worker slots (devices)").set(
                           self.queue.n_workers)
        registry.gauge("repro_dispatch_steals",
                       "batches stolen by idle workers").set(self.steals)

    def drain(
        self,
        execute: Callable[[Batch, int, torch.device], None],
        *,
        timer: Callable[[], float] | None = None,
        deadline_s: float | None = None,
    ) -> int:
        """Run every queued batch; returns the number executed.

        ``execute(batch, worker, device)`` is called once per batch, on the
        worker that actually ran it (owner or thief).  ``execute`` may
        re-queue a batch instead of running it (fault redistribution), so
        with ``deadline_s`` set (seconds on ``timer``'s clock, measured
        from drain start) a wedged worker surfaces a
        :class:`~repro_torch.runtime.faults.DrainDeadlineError` naming the
        stuck batches' shape keys instead of looping forever.
        """
        executed = 0
        t0 = timer() if timer is not None and deadline_s is not None else 0.0
        while self.queue.pending():
            if (deadline_s is not None and timer is not None
                    and timer() - t0 > deadline_s):
                raise DrainDeadlineError(
                    deadline_s, [b.key for b in self.queue.items()])
            for worker in range(self.queue.n_workers):
                batch = self.queue.pop(worker)
                if batch is None:
                    continue
                execute(batch, worker, self.devices[worker])
                executed += 1
        return executed
