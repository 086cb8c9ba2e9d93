"""search_torch_ms: device ms a traced block of DM trials spends in
kernels that are not the port's CUDA kernels (torch's padding, copies,
power plane, reductions and the sift's top-k) [ms]."""

from bench.yardstick.search import KIND
from bench.yardstick.trace import torch_ms_a_unit


def read(run):
    return torch_ms_a_unit(run.window.trace, (KIND,))
