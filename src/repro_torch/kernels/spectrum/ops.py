"""Public wrapper for the fused spectrum kernel.

The counterpart of ``repro.kernels.spectrum.ops``: its guard, ledger name
(``power-spectrum-stats``), logical shape and ``bytes_moved`` formula over
the batch itself (the reference counts its padded batch).  ``grid`` and
``tile`` count rows: one a row, the whole row a tile (the kernel cuts each
row into ``spectrum_kernel.segments``, a block each).  The spectrum stays
interleaved complex64 (the reference splits re/im planes); real input is
cast to complex64, as the reference's wrapper does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.fft.stockham import _as_tensor
from repro_torch.kernels.spectrum.spectrum_kernel import power_spectrum_stats
from repro_torch.obs.ledger import record_launch


def power_spectrum_stats_kernel(x):
    """Complex spectra (..., N) -> (power (..., N), mean (...,), std
    (...,))."""
    x = _as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex64)
    lead, n = x.shape[:-1], x.shape[-1]
    if n == 0:
        raise ValueError("power_spectrum_stats_kernel needs a non-empty "
                         f"trailing axis, got shape {tuple(x.shape)}")
    b = math.prod(lead)
    x2 = x.to(torch.complex64).resolve_conj().reshape(b, n).contiguous()
    p, mean, var = power_spectrum_stats(x2)
    record_launch("power-spectrum-stats", grid=(b,), tile=(1, n),
                  bytes_moved=4 * b * (3 * n + 2), shape=(b, n))
    std = torch.sqrt(torch.clamp_min(var, 0.0))
    return p.reshape(*lead, n), mean.reshape(lead), std.reshape(lead)
