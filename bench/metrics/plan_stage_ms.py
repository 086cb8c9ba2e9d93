"""plan_stage_ms: device ms a traced batch spends in its FFT plan outside
the port's kernels, measured by the program's own spans (``fft.plan``'s
CUDA-event time less its ``kernel.*`` spans'): the plan's torch passes
where they run, beside ``plan_torch_ms``'s view from the profiler.
Extras: each stage span's ms a batch and the plan's ms outside every
stage (``unattributed_ms``) [ms]."""

from bench.yardstick.spans import plan_stage_ms, session


def read(run):
    return plan_stage_ms(session())
