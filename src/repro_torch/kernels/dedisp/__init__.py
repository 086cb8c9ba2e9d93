"""Brute-force incoherent dedispersion (many-DM shift-and-sum).

  dedisp_kernel  the CUDA launch (``csrc/dedisp.cu``) and its plain torch
                 twin
  ops            public wrapper (guards, device delay table, ledger)
  ref            gather-based torch oracle the tests assert against
"""
from repro_torch.kernels.dedisp.ops import dedisperse_kernel
from repro_torch.kernels.dedisp.ref import dedisperse_ref

__all__ = ["dedisperse_kernel", "dedisperse_ref"]
