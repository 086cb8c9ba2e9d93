"""repro_torch — the PyTorch/CUDA port of the ``repro`` FFT/DVFS system.

Same subpackage layout as the JAX reference (``repro.X.Y`` ->
``repro_torch.X.Y``); imports torch and numpy, never JAX and never
``repro``.  Hand-written Hopper kernels (``csrc``) replace the
reference's Pallas TPU kernels; each has a plain torch twin that runs on
CPU tensors.

Ported so far: planned batched 1-D C2C FFTs (single pass, four-step,
Bluestein), real-input R2C/C2R FFTs, the N-D plan graph
(``repro_torch.fft.fft2``/``rfft2``/``fftn``/``rfftn``), the
overlap-save FDAS acceleration search and the pulsar search
(``repro_torch.search``) on the CUDA kernels, priced by the paper's DVFS
model (``repro_torch.core``) and served with per-request energy receipts
by ``repro_torch.serving.FFTService``; the power plane, the autotuner,
the robust service and the distributed FFT; and the model zoo's serving
path (``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.launch.serve``), in plain torch ops as the reference's
models are plain ``jnp``.
"""
