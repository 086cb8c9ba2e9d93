"""Shared warm-up/repeat timing — one methodology for tuner and checks.

The counterpart of ``repro.tune.timing``: warm-up calls first (the first
launch of a shape plans it and loads its kernel), then ``repeats`` timed
calls reduced with ``reduce`` (default ``min``; pass
``statistics.median``/``mean`` for other conventions).  It returns
seconds per call.

How a call is timed:

  * no ``timer``, tensors on CUDA: a pair of CUDA events on the current
    stream around each call, then a synchronise (device time of the call,
    host gaps inside it included);
  * a ``timer`` (tests feed a fake clock for determinism): that timer
    around the call, followed by ``torch.cuda.synchronize()`` when CUDA
    is in use;
  * no ``timer``, tensors on the CPU: ``time.perf_counter``.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def time_fn(fn: Callable, *args, repeats: int = 5, warmup: int = 2,
            reduce: Callable[[Sequence[float]], float] = min,
            timer: Callable[[], float] | None = None) -> float:
    """Seconds per call of ``fn(*args)`` after warm-up."""
    cuda = _on_cuda(args)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warmup):
        fn(*args)
    sync()
    samples = []
    for _ in range(max(repeats, 1)):
        if cuda and timer is None:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) / 1e3)
            continue
        clock = timer or time.perf_counter
        t0 = clock()
        fn(*args)
        sync()
        samples.append(clock() - t0)
    return reduce(samples)
