"""Batches of 1-D FFTs, each about the configuration's ``batch_bytes``
of input, run round robin over the traffic's ``batches`` and dispatched
ahead: the host waits only for the batch ``in_flight`` places back, never
for the card to drain.

Traffic keys: ``batches`` (a list of ``{"kind": "c2c"|"r2c"|"c2r",
"n": length}``), ``in_flight``.  The rows of a batch are
``batch_bytes // (input bytes a row)``, counting a real length's rows by
its real points, so that a C2R batch transforms the spectra of its R2C
partner's rows.  The inputs are made on the device from the seed: one
complex batch a C2C length, one real batch a real length, and for C2R
that batch's spectrum (``torch.fft.rfft``, made by the benchmark).

The window checks one round of outputs, drawn from the seed, against
the configuration's reference: every row of every length and kind.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from bench.record import Check, TraceWindow, Unit, Window
from bench.yardstick.roofline import COMPLEX64, FLOAT32


@dataclasses.dataclass
class State:
    device: torch.device
    keys: list[tuple[str, int]]
    rows: dict
    inputs: dict
    in_flight: int
    keep_round: int


def rows_of(cfg: dict, kind: str, n: int) -> int:
    per_row = n * (COMPLEX64 if kind == "c2c" else FLOAT32)
    return int(cfg["batch_bytes"] // per_row)


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keys = [(b["kind"], int(b["n"])) for b in traffic["batches"]]
    rows = {key: rows_of(cfg, *key) for key in keys}
    inputs, real = {}, {}
    for kind, n in keys:
        if kind == "c2c":
            inputs[kind, n] = torch.randn(rows[kind, n], n, generator=gen,
                                          device=device, dtype=torch.complex64)
            continue
        if n not in real:
            real[n] = torch.randn(rows[kind, n], n, generator=gen,
                                  device=device, dtype=torch.float32)
        inputs[kind, n] = (real[n] if kind == "r2c"
                           else torch.fft.rfft(real[n], dim=-1))
    del real
    rng = np.random.default_rng(seed)
    return State(device=torch.device(device), keys=keys, rows=rows,
                 inputs=inputs, in_flight=int(traffic["in_flight"]),
                 keep_round=int(rng.integers(1, 4)))


def program(cfg: dict, traffic: dict, state: State):
    """The port's plans: {(kind, n): callable}."""
    from repro_torch.fft.plan import plan_for_length
    return {key: plan_for_length(key[1], key[0]) for key in state.keys}


def control(cfg: dict, traffic: dict, state: State, ref):
    """The reference at the next precision below, in the program's place."""
    return {key: (lambda x, k=key: ref.control(k[0], k[1], x))
            for key in state.keys}


def warm(system, state: State) -> None:
    """Two rounds of every shape, then wait: the plans, their launch
    set-up and the allocator's blocks are made before the window."""
    for _ in range(2):
        for key in state.keys:
            system[key](state.inputs[key])
    _sync(state.device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _unit(state: State, key, now: float) -> Unit:
    kind, n = key
    rows = state.rows[key]
    x = state.inputs[key]
    return Unit(kind=kind, n=n, rows=rows, points=rows * n,
                in_bytes=x.numel() * x.element_size(), t_start=now)


def window(system, state: State, seconds: float, trace: TraceWindow | None
           ) -> Window:
    cuda = state.device.type == "cuda"
    ring = collections.deque()
    units: list[Unit] = []
    kept = {}
    _sync(state.device)
    t0 = time.perf_counter()
    i = 0
    while True:
        key = state.keys[i % len(state.keys)]
        y = system[key](state.inputs[key])
        if i // len(state.keys) == state.keep_round:
            kept[key] = y
        del y
        units.append(_unit(state, key, time.perf_counter()))
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ring.append(ev)
            if len(ring) > state.in_flight:
                ring.popleft().synchronize()
        i += 1
        if i % len(state.keys):
            continue
        elapsed = time.perf_counter() - t0
        if trace is not None:
            trace.at(elapsed, units)
        if (elapsed >= seconds and i // len(state.keys) > state.keep_round
                and (trace is None or trace.done)):
            break
    _sync(state.device)
    t1 = time.perf_counter()
    return Window(t0=t0, t1=t1, units=units, kept=kept,
                  trace=trace.trace if trace is not None else None)


def check(ref, cfg: dict, traffic: dict, state: State, win: Window,
          limits: dict) -> list[Check]:
    out = []
    for kind, n in state.keys:
        name = f"{kind}_{n}_err"
        y = win.kept.get((kind, n))
        value = (float("inf") if y is None else
                 ref.rel_err(kind, n, state.inputs[kind, n], y))
        out.append(Check(name, value, limits[name]))
    win.kept["failed"] = sum(not c.ok for c in out)
    return out
