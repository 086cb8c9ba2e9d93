"""Fused |X|^2 + row mean/variance (one pass over the spectrum).

  spectrum_kernel  the CUDA launch (``csrc/spectrum.cu``) and its plain
                   torch twin
  ops              public wrapper (guards, ledger, std)
  ref              torch oracle
"""
from repro_torch.kernels.spectrum.ops import power_spectrum_stats_kernel

__all__ = ["power_spectrum_stats_kernel"]
