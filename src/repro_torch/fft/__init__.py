"""The port's FFT substrate.

  radix        mixed-radix schedules + memoised twiddle tables (numpy)
  stockham     batched mixed-radix Stockham FFT in pure torch (C2C, and
               packed R2C/C2R)
  bluestein    arbitrary-length FFT via chirp-z (paper Sec. 2.1)
  plan         per-length algorithm choice + CUDA kernel routing
  plan_nd      N-D plan-graph compiler: fused transpose-write passes
  multidim     fft2 / rfft2 / fftn / rfftn over the plan graph
  convolve     batched overlap-save segmented FFT convolution (filter
               banks as fused multiply epilogues, cached filter spectra)
  distributed  batch-parallel and pencil/four-step FFTs over a
               single-controller device mesh
  pipeline     the paper's Sec. 5.3 demonstration pipeline (plain torch
               around the planned FFT) and its per-stage cost model

The names below resolve on first use (``repro_torch.fft.fft2``, ...), or
import the submodules directly.  ``plan_nd`` is not among them: it names
the submodule (``from repro_torch.fft.plan_nd import plan_nd``).  Nothing
is imported eagerly: the kernel
wrappers import ``repro_torch.fft.radix``, and the planner imports the
kernel wrappers, so an eager import here would be circular.
"""
import importlib

_EXPORTS = {
    "fft2": "multidim", "rfft2": "multidim", "fftn": "multidim",
    "rfftn": "multidim",
    "FFTPlan": "plan", "plan_for_length": "plan",
    "plan_with_config": "plan", "pow2_fft": "plan", "fft_mul": "plan",
    "NDPlan": "plan_nd",
    "ConvPlan": "convolve", "conv_plan": "convolve",
    "overlap_save_conv": "convolve", "select_nfft": "convolve",
    "bluestein_fft": "bluestein",
    "pulsar_pipeline": "pipeline",
    "Mesh": "distributed", "ShardedTensor": "distributed",
    "make_mesh": "distributed", "shard": "distributed",
    "pad_rows": "distributed", "batch_parallel_fft": "distributed",
    "pencil_fft": "distributed", "untranspose_ref": "distributed",
    "assemble_rfft_pencil": "distributed",
    "pencil_collective_bytes": "distributed",
    "pencil_exchange_bytes": "distributed",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
