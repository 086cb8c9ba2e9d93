"""Exact selection of a statistic plane's strongest cells (the sift's
pool), with the count over its threshold.

  sift_kernel  the CUDA launch (``csrc/sift.cu``) and its plain torch twin
  ops          public wrapper (route, guards, span, ledger)
"""
from repro_torch.kernels.sift.ops import sift_select

__all__ = ["sift_select"]
