"""plan_torch_ms: device time a traced batch spends in kernels that are
not the port's CUDA kernels (torch's split, merge, pack and copies of the
plan layer) [ms]."""

from bench.yardstick.roofline import FFT_KINDS
from bench.yardstick.trace import torch_ms_a_unit


def read(run):
    return torch_ms_a_unit(run.window.trace, FFT_KINDS)
