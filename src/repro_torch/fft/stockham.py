"""Batched mixed-radix Stockham autosort FFT in pure torch.

The counterpart of ``repro.fft.stockham``'s C2C engine: the transform
carries a (L, M) factorisation of the length where the L axis accumulates
already-decided output digits in natural order, so every stage is slices,
elementwise ops and a reshape — no bit-reversal gather.

The decimation-in-frequency radix-r step for one length-M transform
(h = M/r, x_p = x[p*h:(p+1)*h], omega_r = exp(-2*pi*i/r)):

  out[r*t + k] = F_h( (sum_p x_p * omega_r^{p*k}) * w^{k*j} )[t]
  w = exp(-2*pi*i/M)

This engine runs on any device and in the input's precision (complex64
or complex128).  It is what :func:`repro_torch.fft.plan.kernels_disabled`
selects; the plans' default route is the CUDA kernels.  Twiddles come
from :mod:`repro_torch.fft.radix` and are copied to the device once per
(length, schedule, direction, device, dtype).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.fft.radix import (DEFAULT_RADICES, dft_matrix,
                                   radix_schedule, stage_twiddles)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _as_complex(x) -> torch.Tensor:
    """A complex tensor on the input's device (numpy input goes to CUDA);
    real input becomes complex64."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=torch.device("cuda"))
    if not x.is_complex():
        x = x.to(torch.complex64)
    return x


@functools.lru_cache(maxsize=None)
def _device_twiddles(n: int, radices: tuple[int, ...], inverse: bool,
                     device: torch.device, dtype: torch.dtype
                     ) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(t).to(device=device, dtype=dtype)
                 for t in stage_twiddles(n, radices, inverse))


def _stockham_pow2(x: torch.Tensor, *, inverse: bool = False,
                   radices: tuple[int, ...] = DEFAULT_RADICES
                   ) -> torch.Tensor:
    """Mixed-radix Stockham FFT along the last axis (power-of-two length)."""
    n = x.shape[-1]
    if not _is_pow2(n):
        raise ValueError(f"Stockham engine needs a power-of-two length, "
                         f"got {n}")
    if n == 1:
        return x
    batch = x.shape[:-1]
    y = x.reshape(*batch, 1, n)                     # (..., L=1, M=n)
    l, m = 1, n
    schedule = radix_schedule(n, radices)
    tables = _device_twiddles(n, tuple(radices), inverse, x.device, x.dtype)
    for r, tw in zip(schedule, tables):
        h = m // r
        dft = dft_matrix(r, inverse)
        parts = [y[..., p * h:(p + 1) * h] for p in range(r)]
        outs = []
        for k in range(r):
            acc = parts[0]                          # dft[0, k] == 1
            for p in range(1, r):
                acc = acc + parts[p] * complex(dft[p, k])
            if k:
                acc = acc * tw[k - 1]
            outs.append(acc)
        # Branch k is the LEAST significant undecided digit -> stack the
        # branches *before* L so the combined index is k * L + l.
        y = torch.stack(outs, dim=-3).reshape(*batch, r * l, h)
        l, m = r * l, h
    out = y.reshape(*batch, n)
    if inverse:
        out = out / n
    return out


def _along_axis(fn, x: torch.Tensor, axis: int) -> torch.Tensor:
    if axis != -1 and axis != x.ndim - 1:
        return torch.movedim(fn(torch.movedim(x, axis, -1)), -1, axis)
    return fn(x)


def fft(x, axis: int = -1) -> torch.Tensor:
    """Forward C2C FFT along ``axis``; power-of-two lengths only.

    Non-power-of-two lengths are handled by :mod:`repro_torch.fft.bluestein`
    (wired together in :mod:`repro_torch.fft.plan`).
    """
    return _along_axis(_stockham_pow2, _as_complex(x), axis)


def ifft(x, axis: int = -1) -> torch.Tensor:
    """Inverse C2C FFT along ``axis`` (normalised by 1/N)."""
    return _along_axis(functools.partial(_stockham_pow2, inverse=True),
                       _as_complex(x), axis)
