"""Fault-tolerant training driver: checkpoint/restart + straggler handling
(the counterpart of ``repro.runtime.fault``; numpy and plain Python).

The driver wraps a train loop with:
  * periodic checkpoints (every ``ckpt_every`` steps),
  * failure detection — in tests failures are injected via
    :class:`SimulatedFailure` (step-indexed); on a real cluster the same
    hook is wired to the torch.distributed heartbeat / store errors,
  * restart-from-latest on failure, re-running at most ``ckpt_every``
    steps (exactly-once side effects are the data pipeline's job: batch i
    is a pure function of i, see repro_torch.data.synthetic),
  * straggler mitigation: per-step wall-times feed an EWMA; hosts slower
    than ``straggler_factor`` x median get their data shards reassigned
    (deterministic work-stealing — shard mapping is pure function of
    (step, host set), no coordination state).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.runtime.checkpoint import CheckpointManager


class SimulatedFailure(RuntimeError):
    """Injected node failure (step-indexed) for CPU-side testing."""


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    factor: float = 1.5
    alpha: float = 0.3
    shards_per_host: int = 1

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)

    def observe(self, host_times: np.ndarray) -> list[int]:
        """Update EWMA; return hosts flagged as stragglers."""
        self.ewma = np.where(self.ewma == 0, host_times,
                             (1 - self.alpha) * self.ewma
                             + self.alpha * host_times)
        med = float(np.median(self.ewma))
        return [h for h in range(self.n_hosts)
                if self.ewma[h] > self.factor * med]

    def shard_assignment(self, step: int, excluded: list[int]
                         ) -> dict[int, list[int]]:
        """Deterministic shard->host map with stragglers' load halved.

        Host ``h`` owns shards ``[h * shards_per_host, (h+1) *
        shards_per_host)``.  Shards of flagged hosts are split
        half-and-half: the straggler keeps the first ceil(half) (it is
        slow, not dead) and the fastest *non-flagged* host this step takes
        the rest.  The map is a pure function of (EWMA state, excluded),
        so every host computes the same reassignment with no coordination.
        """
        spH = self.shards_per_host
        assign = {h: [h * spH + i for i in range(spH)]
                  for h in range(self.n_hosts)}
        if not excluded:
            return assign
        healthy = [h for h in range(self.n_hosts) if h not in excluded]
        if not healthy:
            return assign                 # everyone is slow: nobody to help
        fastest = min(healthy, key=lambda h: (self.ewma[h], h))
        for h in excluded:
            shards = assign[h]
            keep = len(shards) - len(shards) // 2
            assign[h], moved = shards[:keep], shards[keep:]
            assign[fastest] = assign[fastest] + moved
        return assign


@dataclasses.dataclass
class FaultTolerantDriver:
    train_step: Callable[..., tuple[Any, dict]]
    state: Any
    data_iter_fn: Callable[[int], tuple]   # step -> (inputs, labels)
    ckpt: CheckpointManager
    ckpt_every: int = 10
    max_restarts: int = 3
    fail_at: dict[int, int] | None = None  # step -> host that "dies"
    # Injectable monotonic clock (the serving layer's timer= idiom), so
    # fault-path wall metrics are deterministic under a FakeTimer.
    timer: Callable[[], float] = time.monotonic

    def run(self, n_steps: int, *, start_step: int = 0):
        """Run to n_steps, surviving injected failures via restore."""
        metrics_log = []
        restarts = 0
        step = start_step
        while step < n_steps:
            try:
                if self.fail_at and step in self.fail_at:
                    failed_host = self.fail_at.pop(step)
                    raise SimulatedFailure(
                        f"host {failed_host} lost at step {step}")
                inputs, labels = self.data_iter_fn(step)
                t0 = self.timer()
                self.state, metrics = self.train_step(self.state, inputs,
                                                      labels)
                metrics["wall"] = self.timer() - t0
                metrics["step"] = step
                metrics_log.append(metrics)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, self.state)
            except SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is not None:
                    self.state = self.ckpt.restore(self.state, latest)
                    step = latest
                else:
                    step = start_step
                # Drop metrics from rolled-back steps: they re-run after
                # the restore, and each step must appear exactly once.
                metrics_log = [m for m in metrics_log if m["step"] < step]
        # final checkpoint
        self.ckpt.save(step, self.state)
        return self.state, metrics_log, restarts
