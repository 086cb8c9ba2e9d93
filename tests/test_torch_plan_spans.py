"""The FFT plan's spans under a CPU profiler: the span tree of the long
real plans, the kernel spans against the launch ledger's records,
the shared clock (each span's host interval encloses the profiler events
of the ATen ops it ran), no span in the profiler's own events, outputs
unchanged, and one session for each profiler start.

The tests run ``torch.autograd.profiler.profile`` (kineto), whose start
and stop are those of ``torch.profiler.profile`` without the seconds the
latter's first start spends importing ``torch.distributed``; the
benchmark's tests run the latter."""
import pytest
import torch
from torch.autograd.profiler import profile

from repro_torch.fft import plan as port_plan
from repro_torch.fft.plan import plan_for_length
from repro_torch.obs import trace
from repro_torch.obs.ledger import LaunchLedger

N = 2**15                   # N/2 = 2^14 > MAX_SINGLE_PASS: the long route

#: (depth, name, parent) in completion order, one real plan call each.
R2C_TREE = [(1, "r2c.pack", "fft.plan"),
            (2, "kernel.fft-c2c-axis1", "four_step"),
            (2, "kernel.fft-c2c-t", "four_step"),
            (1, "four_step", "fft.plan"),
            (1, "kernel.fft-r2c-split", "fft.plan"),
            (0, "fft.plan", None)]
C2R_TREE = [(1, "kernel.fft-c2r-merge", "fft.plan"),
            (2, "kernel.fft-c2c-axis1", "four_step"),
            (2, "kernel.fft-c2c-t", "four_step"),
            (1, "four_step", "fft.plan"),
            (1, "c2r.unpack", "fft.plan"),
            (0, "fft.plan", None)]
#: An ATen op each stage must have run inside its span (the split and
#: merge kernels' plain versions on the CPU among them).
STAGE_OPS = {"r2c.pack": "aten::view_as_complex",
             "kernel.fft-r2c-split": "aten::flip",
             "kernel.fft-c2r-merge": "aten::flip",
             "c2r.unpack": "aten::view_as_real"}
#: (kind, n, rows) of each kernel span: the four-step's 128-point passes
#: over 2 rows of 128, the split and merge over the 2 rows of length N.
KERNEL_ATTRS = {"kernel.fft-c2c-axis1": ("c2c", 128, 2 * 128),
                "kernel.fft-c2c-t": ("c2c", 128, 2 * 128),
                "kernel.fft-r2c-split": ("r2c-split", N, 2),
                "kernel.fft-c2r-merge": ("c2r-merge", N, 2)}


@pytest.fixture(scope="module")
def run():
    """One R2C and one C2R call on 2 rows, warm, spans off and then under
    a CPU profiler with a launch ledger capturing."""
    x = torch.randn(2, N, generator=torch.Generator().manual_seed(3))
    r2c, c2r = plan_for_length(N, "r2c"), plan_for_length(N, "c2r")
    off = (r2c(x), c2r(r2c(x)))
    ledger = LaunchLedger()
    with profile(use_kineto=True) as prof, ledger.capture():
        y = r2c(x)
        on = (y, c2r(y))
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.kineto_results.events()]
    return dict(off=off, on=on, ledger=ledger, events=events,
                session=trace.profiler_spans())


def test_plan_span_tree(run):
    spans = list(run["session"].spans)
    assert [(s.depth, s.name, s.parent) for s in spans] == \
        R2C_TREE + C2R_TREE
    plans = [s for s in spans if s.name == "fft.plan"]
    assert [(p.attrs["kind"], p.attrs["n"], p.attrs["rows"],
             p.attrs["algorithm"], p.attrs["device"]) for p in plans] == \
        [("r2c", N, 2, "four-step", "cpu"),
         ("c2r", N, 2, "four-step", "cpu")]
    for s in spans:
        if s.name.startswith("kernel."):
            assert (s.attrs["kind"], s.attrs["n"], s.attrs["rows"]) == \
                KERNEL_ATTRS[s.name]
        else:                          # stages inherit the plan's attrs
            assert s.attrs["kind"] in ("r2c", "c2r") and s.attrs["n"] == N
        assert s.device_s == s.duration   # a CPU span's device time
    assert run["session"].builds == {} and run["session"].dropped == 0


def test_kernel_spans_are_the_ledgers_launches(run):
    """One kernel span a recorded launch, in order, whose transforms are
    the ones the ledger's bytes count: a complex point read and written a
    C2C pass; N/2 points and N/2+1 bins a row of the split or merge."""
    kernels = [s for s in run["session"].spans
               if s.name.startswith("kernel.")]
    records = run["ledger"].records
    assert [s.name for s in kernels] == \
        ["kernel." + r.kernel for r in records]
    for s, r in zip(kernels, records):
        n, rows = s.attrs["n"], s.attrs["rows"]
        assert r.bytes_moved == (16 * n * rows if s.attrs["kind"] == "c2c"
                                 else 8 * rows * (n + 1))


def test_spans_share_the_profilers_clock(run):
    """Each span's host interval encloses every ATen op that started in
    it, and each stage span holds its own op: the span clock and the
    profiler's host events are one clock."""
    ops = [ev for ev in run["events"] if ev[0].startswith("aten::")]
    for s in run["session"].spans:
        a, b = s.t_start * 1e9, (s.t_start + s.duration) * 1e9
        inside = [(name, t0, t1) for name, t0, t1 in ops if a <= t0 <= b]
        assert inside, s.name
        assert all(t1 <= b for _, _, t1 in inside), s.name
        if s.name in STAGE_OPS:
            assert STAGE_OPS[s.name] in {name for name, _, _ in inside}


def test_no_profiler_event_carries_a_span_name(run):
    names = {s.name for s in run["session"].spans}
    assert not [ev for ev in run["events"]
                if any(name in ev[0] for name in names)]


def test_outputs_are_equal_with_spans_on_and_off(run):
    for on, off in zip(run["on"], run["off"]):
        assert torch.equal(on, off)


def test_each_profiler_start_opens_a_session(run):
    first = trace.profiler_spans()
    plan = plan_for_length(16)
    plan(torch.ones(3, 16, dtype=torch.complex64))
    with profile(use_kineto=True):
        assert trace.tracing()
        plan(torch.ones(3, 16, dtype=torch.complex64))
    assert not trace.tracing()
    second = trace.profiler_spans()
    assert second is not first and second is not run["session"]
    assert [s.name for s in second.spans] == ["kernel.fft-c2c", "fft.plan"]
    plan(torch.ones(3, 16, dtype=torch.complex64))   # off: not recorded
    assert len(second.spans) == 2


def test_builds_count_a_table_made_again():
    tracer = trace.Tracer()
    with tracer.active():
        port_plan._four_step_twiddle(3, 5, torch.device("cpu"),
                                     inverse=False)
        port_plan._four_step_twiddle(3, 5, torch.device("cpu"),
                                     inverse=False)
    assert tracer.builds == {"four_step_twiddle": 1}
