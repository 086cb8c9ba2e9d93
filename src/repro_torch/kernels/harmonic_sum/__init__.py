"""Harmonic summing (the doubling ladder of pulsar searches).

  harmonic_sum_kernel  the CUDA launches (``csrc/harmonic_sum.cu``) and
                       their plain torch twins
  ops                  public wrappers (guards, ledger)
  ref                  gather-based torch oracles
"""
from repro_torch.kernels.harmonic_sum.ops import (harmonic_sum_kernel,
                                                  harmonic_sum_plane)
from repro_torch.kernels.harmonic_sum.ref import (harmonic_sum_plane_ref,
                                                  harmonic_sum_ref)

__all__ = ["harmonic_sum_kernel", "harmonic_sum_plane",
           "harmonic_sum_plane_ref", "harmonic_sum_ref"]
