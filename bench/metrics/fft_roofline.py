"""fft_roofline: the traced batches' least time on the card (each input
byte read and each output byte written once at 3.35 TB/s, or their
radix-2 FLOPs at 67 TFLOP/s, the larger) over all the device time the
profiler gives them: every kernel of the batch, the port's and torch's
[%]."""

from bench.yardstick.roofline import FFT_KINDS, bound_s, fft_work
from bench.yardstick.trace import traced_units


def read(run):
    trace = run.window.trace
    units = traced_units(trace, FFT_KINDS)
    device = trace.device_s() if units else 0.0
    if device <= 0:
        return None
    bounds = [bound_s(*fft_work(u.kind, u.n, u.rows)) for u in units]
    binds = sorted({b for _, b in bounds})
    return 100.0 * sum(t for t, _ in bounds) / device, {"binds": "+".join(binds)}
