"""Work-stealing queue for multi-device dispatch (a copy of
``repro.runtime.workqueue``).

The serving layer places coalesced FFT batches on per-device queues; an
idle device steals from the back of the longest queue (owners pop FIFO
from the front, thieves take LIFO from the back, so stolen work is the
freshest item).  The queue is cooperative and deterministic: the serving
drain loop drives workers round-robin on one host.
"""
from __future__ import annotations

import collections
from typing import Any


class WorkStealingQueue:
    """Per-worker deques with steal-from-longest balancing."""

    def __init__(self, n_workers: int):
        if n_workers < 1:
            raise ValueError("need at least one worker")
        self._queues: list[collections.deque] = [
            collections.deque() for _ in range(n_workers)
        ]
        self.steals = 0
        self.pushes = 0

    @property
    def n_workers(self) -> int:
        return len(self._queues)

    def push(self, worker: int, item: Any) -> None:
        """Enqueue ``item`` on ``worker``'s own queue (back)."""
        self._queues[worker].append(item)
        self.pushes += 1

    def push_least_loaded(self, item: Any,
                          allowed: list[int] | None = None) -> int:
        """Enqueue on the currently shortest queue; returns the worker.

        ``allowed`` restricts the candidate workers; an empty/None
        ``allowed`` considers every worker.
        """
        candidates = list(allowed) if allowed else range(self.n_workers)
        worker = min(candidates, key=lambda w: len(self._queues[w]))
        self.push(worker, item)
        return worker

    def pop(self, worker: int) -> Any | None:
        """Owner pop: FIFO from own queue, else steal from the longest.

        Returns None when no work is available anywhere.
        """
        own = self._queues[worker]
        if own:
            return own.popleft()
        victim = max(range(self.n_workers), key=lambda w: len(self._queues[w]))
        if self._queues[victim]:
            self.steals += 1
            return self._queues[victim].pop()      # thief takes the back
        return None

    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    def items(self) -> list[Any]:
        """Every queued item (in worker order), without removing them."""
        return [item for q in self._queues for item in q]

    def clear(self) -> list[Any]:
        """Remove and return every queued item (in worker order)."""
        items: list[Any] = []
        for q in self._queues:
            items.extend(q)
            q.clear()
        return items

    def lengths(self) -> list[int]:
        return [len(q) for q in self._queues]
