"""Bluestein (chirp-z) FFT for arbitrary lengths — paper Sec. 2.1.

The counterpart of ``repro.fft.bluestein``: one length-N DFT becomes two
power-of-two FFTs of length M >= 2N-1 plus pointwise chirp multiplies.
The chirp and the filter's spectrum ``fb = FFT(b)`` are computed once per
(length, direction) with numpy (complex128) — bit-identical to the
reference's — and copied to the device once per (length, direction,
device, dtype).  The two remaining FFTs route through
:func:`repro_torch.fft.plan.pow2_fft`, so they run the CUDA kernels like
every other plan's passes.  The port runs eagerly; nothing is traced.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.fft.radix import next_pow2
from repro_torch.fft.stockham import _as_complex


@functools.lru_cache(maxsize=None)
def _chirp_factors(n: int, inverse: bool
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(chirp, fb): the length-N chirp and the FFT of the chirp filter."""
    m = next_pow2(2 * n - 1)
    sign = 1.0 if inverse else -1.0
    k = np.arange(n)
    # exp(sign * i*pi*k^2/n); k^2 mod 2n keeps the argument small & exact.
    chirp = np.exp(sign * 1j * np.pi * ((k * k) % (2 * n)) / n)
    b = np.zeros(m, np.complex128)
    b[:n] = np.conj(chirp)
    b[m - n + 1:] = np.conj(chirp)[1:][::-1]
    return chirp, np.fft.fft(b)


@functools.lru_cache(maxsize=None)
def _device_factors(n: int, inverse: bool, device: torch.device,
                    dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    chirp, fb = _chirp_factors(n, inverse)
    return (torch.from_numpy(chirp).to(device=device, dtype=dtype),
            torch.from_numpy(fb).to(device=device, dtype=dtype))


def bluestein_fft(x, *, inverse: bool = False, config=None) -> torch.Tensor:
    """C2C DFT of arbitrary length along the last axis via chirp-z.

    ``config`` (a :class:`repro_torch.tune.KernelConfig`) rides into the
    two inner pow2 FFTs.
    """
    from repro_torch.fft.plan import pow2_fft     # lazy: avoids import cycle

    x = _as_complex(x)
    n = x.shape[-1]
    m = next_pow2(2 * n - 1)
    chirp, fb = _device_factors(n, inverse, x.device, x.dtype)
    a = torch.zeros((*x.shape[:-1], m), dtype=x.dtype, device=x.device)
    a[..., :n] = x * chirp
    fa = pow2_fft(a, config=config)
    conv = pow2_fft(fa * fb, inverse=True, config=config)
    out = conv[..., :n] * chirp
    if inverse:
        out = out / n
    return out
