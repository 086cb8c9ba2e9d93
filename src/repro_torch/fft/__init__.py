"""The port's FFT substrate (1-D C2C, R2C and C2R so far).

  radix        mixed-radix schedules + memoised twiddle tables (numpy)
  stockham     batched mixed-radix Stockham FFT in pure torch (C2C, and
               packed R2C/C2R)
  bluestein    arbitrary-length FFT via chirp-z (paper Sec. 2.1)
  plan         per-length algorithm choice + CUDA kernel routing

Import the submodules directly (``from repro_torch.fft.plan import
plan_for_length``).  This package imports nothing eagerly: the kernel
wrappers import ``repro_torch.fft.radix``, and the planner imports the
kernel wrappers, so an eager import here would be circular.
"""
