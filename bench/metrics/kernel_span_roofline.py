"""kernel_span_roofline: the port's kernel launches apart from the plan's
torch passes: over the traced ``kernel.*`` spans, the sum of each one's
least time (each input byte read and each output byte written once at
3.35 TB/s, or 5 n log2 n FLOPs a transform, half for real, at 67
TFLOP/s, the larger, counted from the launch's transforms as
``fft_roofline`` counts a batch's) over the sum of its CUDA-event time.
Extras: which bounds bind, the same share for each kernel, the spans
timed, the kernels of a kind not counted [%]."""

from bench.yardstick.spans import kernel_span_roofline, session


def read(run):
    return kernel_span_roofline(session())
