"""Hand-written Hopper kernels for the pipeline's compute hot-spots.

Each kernel package holds:
  <name>.py   the CUDA launch (through ctypes) and its plain torch version
  ops.py      public wrapper (dtype plumbing, launch ledger)
  ref.py      torch oracle the tests and the chip check assert against

The CUDA C++ sources live in ``repro_torch/csrc`` and are compiled on
first use (:mod:`repro_torch.kernels.common`).

Kernels (every TPU kernel of the reference has its counterpart):
  fft           fused-stage Stockham FFT, whole transforms resident in
                shared memory: C2C (single pass, four-step column pass,
                transposed-write row pass, and the filter-bank multiply
                epilogue), packed R2C/C2R (the Hermitian split or merge
                in shared memory; R2C also with a transposed write), and
                the plan graph's tiled transpose
  dedisp        brute-force many-DM dedispersion (shift-and-sum over a
                device delay table); ledger ``dedisperse``
  harmonic_sum  the doubling harmonic ladder, written out
                (``harmonic-sum``) or normalised and max-reduced in the
                kernel for the pipeline (``harmonic-sum-plane``)
  spectrum      fused |X|^2 + row mean/variance in one pass
                (``power-spectrum-stats``)
  sift          the sift's exact selection of a plane's strongest cells,
                with the count over its threshold in the same read
                (``sift-select``; no TPU kernel: the reference pools with
                one ``lax.top_k``, and ``torch.topk`` is its oracle)

Each ledger name records once per wrapper call (the port runs eagerly;
the reference records once per ``jax.jit`` trace), with the reference's
``bytes_moved`` formula over the batch itself, not a padded batch.
"""
