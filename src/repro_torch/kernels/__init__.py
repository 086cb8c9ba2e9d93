"""Hand-written Hopper kernels for the pipeline's compute hot-spots.

Each kernel package holds:
  <name>.py   the CUDA launch (through ctypes) and its plain torch version
  ops.py      public wrapper (dtype plumbing, launch ledger)
  ref.py      torch.fft oracle the tests and the chip check assert against

The CUDA C++ sources live in ``repro_torch/csrc`` and are compiled on
first use (:mod:`repro_torch.kernels.common`).

Kernels so far:
  fft           fused-stage Stockham FFT, whole transforms resident in
                shared memory: C2C (single pass, four-step column pass,
                transposed-write row pass, and the filter-bank multiply
                epilogue), packed R2C/C2R (the Hermitian split or merge
                in shared memory; R2C also with a transposed write), and
                the plan graph's tiled transpose
"""
