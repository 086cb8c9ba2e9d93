"""The program's spans in a traced sub-window, and their arithmetic.

While a ``torch.profiler`` records, the port records spans inside its FFT
plan (``repro_torch.obs.trace``): ``fft.plan`` around a batch, a span
for each torch stage of the plan (``r2c.pack``, ``r2c.split``,
``c2r.merge``, ``c2r.unpack``, ``inverse.conj_in``, ``inverse.conj_out``,
``inverse.scale``, ``four_step``) and ``kernel.<ledger name>`` around
each kernel launch.  Each span has its host interval on the profiler's
clock (``CLOCK_REALTIME`` seconds, as the trace's events), its device
time (CUDA events; the host duration on the CPU), and a kernel span the
transforms of its launch (``kind``, ``n``, ``rows``), from which
:func:`kernel_work` counts its least work here, as ``roofline.fft_work``
counts a unit's.  The program times the device for one tree of spans in
a period for each kind of batch (a timing event costs the device time);
the others have host times alone (``device_s`` None), and a device
figure a batch weighs each (kind, n) by its share of all traced batches.

Where the spans open and close, the attributes they carry and the
program's timing period are part of these metrics' yardstick: a change
that moves them is no gain on them.

:func:`session` reads the last profiler session after the window's
synchronise; each reader of ``metrics/`` is one call into a function
here.  A program without spans, or a session without them, gives None.
"""
from __future__ import annotations

import collections
import dataclasses
import math

from bench.yardstick.roofline import COMPLEX64, FFT_KINDS, bound_s, fft_work

PLAN = "fft.plan"
KERNEL = "kernel."
OUTSIDE = "outside"
UNATTRIBUTED = "unattributed"
KERNELS = "kernels"


@dataclasses.dataclass(eq=False)
class Node:
    """A span with the spans it enclosed (equal only to itself)."""

    name: str
    t0: float                   # host open [s, profiler clock]
    t1: float                   # host close
    device_s: float | None      # None: the device was not timed
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    @property
    def kernel(self) -> bool:
        return self.name.startswith(KERNEL)

    @property
    def self_s(self) -> float:
        """Device time outside its children."""
        return self.device_s - sum(c.device_s for c in self.children)


@dataclasses.dataclass
class Session:
    roots: list[Node]
    builds: int = 0             # plans and tables built in the session
    dropped: int = 0            # spans the session dropped (oldest first)

    def walk(self, stop=lambda node: False):
        """Every node, parents first; below a node ``stop`` keeps, none."""
        todo = list(reversed(self.roots))
        while todo:
            node = todo.pop()
            yield node
            if not stop(node):
                todo.extend(reversed(node.children))

    def plans(self) -> list[Node]:
        """The outermost plan spans: one a batch."""
        return [n for n in self.walk(lambda n: n.name == PLAN)
                if n.name == PLAN]

    def kernels(self) -> list[Node]:
        return [n for n in self.walk(lambda n: n.kernel) if n.kernel]


def tree(records) -> list[Node]:
    """Roots of the span tree from ``(name, depth, t0, t1, device_s, attrs)``
    records in completion order (a span completes after the spans it
    encloses)."""
    done: list[tuple[int, Node]] = []       # completed, awaiting a parent
    for name, depth, t0, t1, device_s, attrs in records:
        node = Node(name, t0, t1, device_s, dict(attrs))
        while done and done[-1][0] > depth:
            node.children.append(done.pop()[1])
        node.children.reverse()
        done.append((depth, node))
    return [node for _, node in done]


def session() -> Session | None:
    """The last profiler session's spans, or None (a program without
    spans, no session, or a session that recorded none)."""
    try:
        from repro_torch.obs.trace import profiler_spans
    except ImportError:
        return None
    tracer = profiler_spans()
    if tracer is None or not tracer.spans:
        return None
    roots = tree((s.name, s.depth, s.t_start, s.t_start + s.duration,
                  s.device_s, s.attrs) for s in tracer.spans)
    return Session(roots, sum(tracer.builds.values()), tracer.dropped)


def plan_split(plan: Node) -> dict[str, float]:
    """A timed plan's device seconds: each stage's own (outside its
    children), the plan's own outside every stage (``unattributed``) and
    its kernels' (``kernels``)."""
    out = {UNATTRIBUTED: plan.self_s}
    for node in Session(plan.children).walk(lambda n: n.kernel):
        key, t = ((KERNELS, node.device_s) if node.kernel
                  else (node.name, node.self_s))
        out[key] = out.get(key, 0.0) + t
    return out


def per_batch(plans: list[Node], value) -> tuple[dict[str, float], int]:
    """The mean a batch of ``value(plan)`` (a dict of seconds) over the
    device-timed plans, each (kind, n) weighed by its share of all the
    plans; and how many were timed."""
    key = lambda p: (p.attrs.get("kind"), p.attrs.get("n"))  # noqa: E731
    counts = collections.Counter(key(p) for p in plans)
    timed = collections.defaultdict(list)
    for p in plans:
        if p.device_s is not None:
            timed[key(p)].append(value(p))
    total = sum(counts[k] for k in timed)
    out: dict[str, float] = {}
    for k, values in timed.items():
        w = counts[k] / total / len(values)
        for v in values:
            for name, t in v.items():
                out[name] = out.get(name, 0.0) + w * t
    return out, sum(len(v) for v in timed.values())


def plan_stage_ms(sess: Session | None):
    """Device ms a batch in the plan outside its kernels, and its split:
    each stage's ms a batch (its device time outside its children) and
    the plan's own outside every stage (``unattributed_ms``), which add
    up to it."""
    plans = sess.plans() if sess is not None else []
    split, timed = per_batch(plans, plan_split)
    if not timed:
        return None
    split.pop(KERNELS, None)
    unattributed = split.pop(UNATTRIBUTED)
    return 1e3 * (unattributed + sum(split.values())), {
        "stages_ms": {k: v * 1e3 for k, v in sorted(split.items())},
        "unattributed_ms": unattributed * 1e3, "batches": len(plans),
        "timed": timed}


def kernel_work(attrs: dict) -> tuple[float, float] | None:
    """(bytes, FLOPs) a kernel span's launch needs, each input byte read
    and each output byte written once, from its ``kind``, ``n`` and
    ``rows``; None for a kind not counted here."""
    kind, n, rows = attrs.get("kind"), attrs.get("n", 0), attrs.get("rows", 0)
    if kind in FFT_KINDS:
        return fft_work(kind, n, rows) if n > 1 else (0.0, 0.0)
    if kind == "transpose":                 # rows matrices of n elements
        return 2.0 * rows * n * attrs["itemsize"], 0.0
    if kind == "c2c-mul":                   # FFT(x) * bank[t], t = bank
        t = attrs["bank"]
        return (COMPLEX64 * n * (rows + t + rows * t),
                rows * n * (5.0 * math.log2(n) + 6.0 * t))
    return None


def kernel_span_roofline(sess: Session | None):
    """The kernel spans' summed least time over their summed device time
    [%], with the same share for each kernel and which bounds bind."""
    kernels = ([k for k in sess.kernels() if k.device_s is not None]
               if sess is not None else [])
    uncounted = sorted({k.name for k in kernels
                        if kernel_work(k.attrs) is None})
    kernels = [k for k in kernels if kernel_work(k.attrs) is not None]
    device = sum(k.device_s for k in kernels)
    if device <= 0:
        return None
    bound: dict[str, float] = {}
    spent: dict[str, float] = {}
    binds = set()
    for k in kernels:
        t, b = bound_s(*kernel_work(k.attrs))
        binds.add(b)
        bound[k.name] = bound.get(k.name, 0.0) + t
        spent[k.name] = spent.get(k.name, 0.0) + k.device_s
    share = {name: 100.0 * bound[name] / spent[name]
             for name in sorted(spent) if spent[name] > 0}
    return 100.0 * sum(bound.values()) / device, {
        "binds": "+".join(sorted(binds)), "by_kernel": share,
        "timed": len(kernels), "uncounted": uncounted}


def idle_by_span(sess: Session, gaps) -> dict[str, float]:
    """Seconds of the device-idle ``gaps`` by the innermost span open on
    the host at each gap's midpoint (``outside`` where none was)."""
    marks = []
    for i, node in enumerate(sess.walk()):
        marks.append((node.t0, 1, i, node))
        marks.append((node.t1, 0, i, node))
    marks.sort(key=lambda m: m[:3])
    out: dict[str, float] = {}
    stack: list[Node] = []
    j = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while j < len(marks) and marks[j][0] <= mid:
            _, opens, _, node = marks[j]
            if opens:
                stack.append(node)
            elif node in stack:
                stack.remove(node)
            j += 1
        key = stack[-1].name if stack else OUTSIDE
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def plan_host_ms(sess: Session | None, trace=None):
    """Host ms a batch in the plan (Python, dispatch and launches), with
    the same spans' device ms, the session's builds, and the trace's
    device-idle ms by the span the host was in."""
    plans = sess.plans() if sess is not None else []
    if not plans:
        return None
    device, timed = per_batch(plans, lambda p: {"device": p.device_s})
    extra = {"device_ms": device["device"] * 1e3 if timed else None,
             "builds": sess.builds, "dropped": sess.dropped}
    if trace is not None:
        extra["idle_ms"] = {k: v * 1e3 for k, v in sorted(
            idle_by_span(sess, trace.idle_gaps()).items())}
    return sum(p.t1 - p.t0 for p in plans) * 1e3 / len(plans), extra
