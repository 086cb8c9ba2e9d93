"""Public wrappers for the harmonic-sum kernels.

The counterparts of ``repro.kernels.harmonic_sum.ops``: two entry points
share one guarded input path, with the reference's guards (each a
``ValueError`` with its message), ledger names (``harmonic-sum-plane``,
``harmonic-sum``), logical shapes and ``bytes_moved`` formulas over the
batch itself (the reference counts its padded batch).  ``grid`` and
``tile`` describe the CUDA launch: thread blocks, and (rows, bins) per
block (the plane's depend on ``n_harmonics``; the ladder's are
``LADDER_BINS``).

* :func:`harmonic_sum_kernel` — the demo ladder: (..., N) power spectra
  to the full (..., LEVELS, N) doubling ladder.
* :func:`harmonic_sum_plane` — the pipeline stage: the same ladder
  normalised and max-reduced in the kernel, returning only the (..., N)
  best detection statistic and its int32 rung.

The plane's launch runs in a span ``kernel.harmonic-sum-plane``
(``obs.trace.span``) with attributes ``rows``, ``n`` and ``harmonics``.

Edge cases, as the reference's: ``n_harmonics=1`` is a single-rung
ladder (the demo returns the input, the plane z_1 = P - 1 at rung 0); an
empty trailing axis and complex input raise ``ValueError``.
"""
from __future__ import annotations

import importlib
import math

import torch

from repro_torch.fft.stockham import _as_tensor
from repro_torch.obs.ledger import record_launch
from repro_torch.obs.trace import span

# The package exports the function ``harmonic_sum_kernel`` under the name of
# this module, as the reference's does; the module is reached by its path.
K = importlib.import_module(
    "repro_torch.kernels.harmonic_sum.harmonic_sum_kernel")


def _checked_power(power, n_harmonics: int, fn_name: str) -> torch.Tensor:
    """Shared shape/dtype guards -> the (..., N) float32 power tensor."""
    if n_harmonics < 1 or n_harmonics & (n_harmonics - 1):
        raise ValueError(
            f"n_harmonics must be a power of two, got {n_harmonics}")
    power = _as_tensor(power)
    if power.is_complex():
        raise ValueError(
            f"{fn_name} takes real power (|X|**2), got complex dtype "
            f"{str(power.dtype).removeprefix('torch.')} with shape "
            f"{tuple(power.shape)}")
    if power.ndim < 1 or power.shape[-1] == 0:
        raise ValueError(
            f"{fn_name} needs a non-empty trailing axis, got shape "
            f"{tuple(power.shape)}")
    return power.to(torch.float32)


def _rows(power: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """(contiguous (B, N) view of the power, B, N)."""
    n = power.shape[-1]
    b = math.prod(power.shape[:-1])
    return power.reshape(b, n).contiguous(), b, n


def harmonic_sum_kernel(power, n_harmonics: int = 32) -> torch.Tensor:
    """(..., N) power spectra -> (..., LEVELS, N) harmonic-sum ladder."""
    power = _checked_power(power, n_harmonics, "harmonic_sum_kernel")
    p2, b, n = _rows(power)
    out = K.harmonic_sum(p2, n_harmonics)
    record_launch("harmonic-sum",
                  grid=(K.plane_blocks(b, n, K.LADDER_BINS),),
                  tile=(1, K.LADDER_BINS),
                  bytes_moved=4 * b * n * (1 + out.shape[-2]),
                  shape=(b, n))
    return out.reshape(*power.shape[:-1], out.shape[-2], n)


def harmonic_sum_plane(power, n_harmonics: int = 8
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) power plane -> ((..., N) statistic, (..., N) int32 level).

    The statistic is  max_h (S_h - h) / sqrt(h)  over the doubling ladder
    h = 1, 2, ..., n_harmonics, valid for planes normalised to per-bin
    mean 1 under the null (the FDAS power plane); ``level`` is log2(h) of
    the winning rung (earliest wins ties).
    """
    power = _checked_power(power, n_harmonics, "harmonic_sum_plane")
    p2, b, n = _rows(power)
    with span("kernel.harmonic-sum-plane", p2, rows=b, n=n,
              harmonics=n_harmonics):
        stat, lev = K.harmonic_sum_plane(p2, n_harmonics)
    bins = K.plane_bins(n_harmonics)
    record_launch("harmonic-sum-plane", grid=(K.plane_blocks(b, n, bins),),
                  tile=(1, bins), bytes_moved=12 * b * n, shape=(b, n))
    lead = power.shape[:-1]
    return stat.reshape(*lead, n), lev.reshape(*lead, n)
