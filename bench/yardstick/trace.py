"""The profiler's view of a traced sub-window, and its arithmetic.

Copied from ``chip_smoke.py:device_breakdown`` and made the benchmark's
own: device operations are classified by symbol into the port's CUDA
kernels (``repro_torch/csrc``) and everything else ("torch"), and a spin
kernel opens each profile.  Late in a long process the profiler once lost
the kernels that started in a profile's first milliseconds; the spin keeps
the card busy for about 50 ms first, and only what starts after it ends
is counted.

Busy time is the union of the device intervals, never their sum: two
streams, or a profiler's rounding, can overlap them.
"""
from __future__ import annotations

import dataclasses
import heapq
import re

#: The __global__ functions of the port's kernels (csrc/*.cu): a device
#: operation whose name holds one of them is the port's.
PORT_SYMBOLS = ("fft_c2c_regs_kernel", "fft_c2c_t_regs_kernel",
                "fft_c2c_axis1_regs_kernel", "fft_r2c_regs_kernel",
                "fft_c2r_regs_kernel", "fft_r2c_t_regs_kernel",
                "fft_c2c_mul_kernel", "transpose_kernel",
                "dedisperse_kernel", "harmonic_sum_plane_kernel",
                "harmonic_sum_kernel", "power_spectrum_stats_kernel")
#: Clock cycles of the opening spin kernel (about 50 ms at 1.98 GHz).
SPIN_CYCLES = 100_000_000
SPIN_NAME = "spin_kernel"

_ANON = "(anonymous namespace)"
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*_kernel")


def _bare(name: str) -> str:
    """A device operation's name without a leading ``void`` and with each
    anonymous namespace written ``{anon}``."""
    name = name[5:] if name.startswith("void ") else name
    return name.replace(_ANON, "{anon}")


def port_kernel(name: str) -> str | None:
    """The port kernel a device operation belongs to, or None (torch).

    A known symbol, or any kernel of the global namespace or of a file's
    anonymous namespace whose name ends in ``_kernel`` — which is how
    every kernel under ``csrc/`` is named, and no kernel of ATen (under
    ``at::``), cub or a CUDA library is: a kernel that a later change adds
    to ``csrc`` is still counted as the port's."""
    for symbol in PORT_SYMBOLS:
        if symbol in name:
            return symbol
    bare = _bare(name)
    bare = bare[len("{anon}::"):] if bare.startswith("{anon}::") else bare
    head = bare.split("(")[0].split("<")[0]
    return head if _IDENT.fullmatch(head) else None


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without its argument list, cut to
    ``width`` characters."""
    return _bare(name).split("(")[0][:width]


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_seconds(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


@dataclasses.dataclass
class Trace:
    """Device operations and host ops of one traced sub-window (seconds on
    the profiler's clock), and the units of work the window ran."""

    device: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    t0: float                       # the spin kernel's end
    t1: float                       # the last device operation's end
    units: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return union_seconds((a, b) for _, a, b in self.device)

    def device_s(self, select=lambda name: True) -> float:
        """Summed device time of the operations ``select`` keeps."""
        return sum(b - a for name, a, b in self.device if select(name))

    def idle_gaps(self) -> list[tuple[float, float]]:
        busy = union((a, b) for _, a, b in self.device)
        return [(x[1], y[0]) for x, y in zip(busy, busy[1:]) if y[0] > x[1]]

    def host_during(self, gaps) -> list[str]:
        """What the host was doing in each of the sorted, disjoint ``gaps``:
        the shortest host op that covers half of the gap, else the one
        that covers most of it (one sweep over the host ops)."""
        host = sorted(self.host, key=lambda ev: ev[1])
        active: list[tuple[float, float, str]] = []     # (end, start, name)
        labels, i = [], 0
        for a, b in gaps:
            while i < len(host) and host[i][1] < b:
                name, s, e = host[i]
                heapq.heappush(active, (e, s, name))
                i += 1
            while active and active[0][0] <= a:
                heapq.heappop(active)
            best, best_len, covering = None, 0.0, []
            for e, s, name in active:
                overlap = min(e, b) - max(s, a)
                if overlap >= 0.5 * (b - a):
                    covering.append((e - s, name))
                if overlap > best_len:
                    best, best_len = name, overlap
            labels.append(min(covering)[1] if covering
                          else best or "host (no profiled op)")
        return labels

    def breakdown(self, top: int = 10) -> dict:
        ops: dict[str, float] = {}
        for name, a, b in self.device:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (b - a)
        gaps: dict[str, float] = {}
        idle = self.idle_gaps()
        for (a, b), key in zip(idle, self.host_during(idle)):
            gaps[key] = gaps.get(key, 0.0) + (b - a)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(ops)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


def traced_units(trace: Trace | None, kinds) -> list:
    """The traced sub-window's units of the given kinds (none untraced)."""
    return [u for u in trace.units if u.kind in kinds] if trace else []


def idle_share(trace: Trace | None, kinds) -> float | None:
    """1 - (union of the device intervals) / (the sub-window) [%], where
    the sub-window ran units of ``kinds``; else None."""
    if not traced_units(trace, kinds) or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def torch_ms_a_unit(trace: Trace | None, kinds) -> float | None:
    """Device ms a traced unit of ``kinds`` spends in kernels that are not
    the port's CUDA kernels; None where none was traced."""
    units = traced_units(trace, kinds)
    if not units:
        return None
    return trace.device_s(lambda n: port_kernel(n) is None) / len(units) * 1e3


def from_events(events, units) -> Trace:
    """A :class:`Trace` from ``(name, is_device, start_s, end_s)`` events:
    the device operations that start after the spin kernel ends, and the
    host ops in the same span."""
    device = [(n, a, b) for n, dev, a, b in events if dev]
    spins = [b for n, a, b in device if SPIN_NAME in n]
    t0 = max(spins) if spins else min((a for _, a, _ in device), default=0.0)
    device = [(n, a, b) for n, a, b in device
              if a >= t0 and SPIN_NAME not in n]
    t1 = max((b for _, _, b in device), default=t0)
    host = [(n, a, b) for n, dev, a, b in events
            if not dev and b > t0 and a < t1]
    return Trace(device=device, host=host, t0=t0, t1=t1, units=list(units))


class Profiled:
    """``torch.profiler`` over a sub-window of a run: :meth:`begin` starts
    it and launches the spin kernel; :meth:`end` synchronises, stops it and
    returns the :class:`Trace` of the units the caller ran in between."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda._sleep(SPIN_CYCLES)

    def end(self, units) -> Trace:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        # The raw kineto events: building the profiler's event tree
        # (``prof.events()``) takes minutes for a few 10^5 events.
        cpu = torch.autograd.DeviceType.CPU
        events = [(ev.name(), ev.device_type() != cpu, ev.start_ns() / 1e9,
                   (ev.start_ns() + ev.duration_ns()) / 1e9)
                  for ev in self.prof.profiler.kineto_results.events()]
        self.prof = None
        return from_events(events, units)
