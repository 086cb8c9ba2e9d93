"""Batched mixed-radix Stockham autosort FFT in pure torch.

The counterpart of ``repro.fft.stockham``'s C2C engine: the transform
carries a (L, M) factorisation of the length where the L axis accumulates
already-decided output digits in natural order, so every stage is slices,
elementwise ops and a reshape — no bit-reversal gather.

The decimation-in-frequency radix-r step for one length-M transform
(h = M/r, x_p = x[p*h:(p+1)*h], omega_r = exp(-2*pi*i/r)):

  out[r*t + k] = F_h( (sum_p x_p * omega_r^{p*k}) * w^{k*j} )[t]
  w = exp(-2*pi*i/M)

R2C packs N real points into an N/2 complex FFT plus an O(N) split pass;
C2R is the exact inverse (merge + N/2 inverse FFT + interleave).

This engine runs on any device and in the input's precision (complex64
or complex128).  It is what :func:`repro_torch.fft.plan.kernels_disabled`
selects; the plans' default route is the CUDA kernels.  Twiddles come
from :mod:`repro_torch.fft.radix` and are copied to the device once per
(length, schedule, direction, device, dtype).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.fft.radix import (DEFAULT_RADICES, dft_matrix, is_pow2,
                                   radix_schedule, rfft_split_twiddles,
                                   stage_twiddles)
from repro_torch.obs.trace import count_build


def _as_tensor(x) -> torch.Tensor:
    """A tensor on the input's device; numpy input goes to CUDA."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=torch.device("cuda"))
    return x


def _as_complex(x) -> torch.Tensor:
    """A complex tensor on the input's device (numpy input goes to CUDA);
    real input becomes complex64."""
    x = _as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex64)
    return x


def _as_real(x) -> torch.Tensor:
    """A real tensor on the input's device (numpy input goes to CUDA); the
    real part of complex input."""
    x = _as_tensor(x)
    return x.real if x.is_complex() else x


@functools.lru_cache(maxsize=None)
def _device_twiddles(n: int, radices: tuple[int, ...], inverse: bool,
                     device: torch.device, dtype: torch.dtype
                     ) -> tuple[torch.Tensor, ...]:
    count_build("device_twiddles")
    return tuple(torch.from_numpy(t).to(device=device, dtype=dtype)
                 for t in stage_twiddles(n, radices, inverse))


def _stockham_pow2(x: torch.Tensor, *, inverse: bool = False,
                   radices: tuple[int, ...] = DEFAULT_RADICES
                   ) -> torch.Tensor:
    """Mixed-radix Stockham FFT along the last axis (power-of-two length)."""
    n = x.shape[-1]
    if not is_pow2(n):
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


# ---------------------------------------------------------------------------
# R2C / C2R building blocks (shared with repro_torch.fft.plan's routed paths)
# ---------------------------------------------------------------------------

def _pack_real(x: torch.Tensor) -> torch.Tensor:
    """(..., N) real -> (..., N/2) complex: z[j] = x[2j] + i*x[2j+1].

    A view of a contiguous input (``view_as_complex`` of the (N/2, 2)
    reshape): the same numbers as the reference's ``lax.complex`` of the
    two strided planes, with no copy.  A view needs an even storage
    offset, so an input at an odd one is copied first.
    """
    x = x.contiguous()
    if x.storage_offset() % 2:
        x = x.clone()
    return torch.view_as_complex(x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2))


def _unpack_real(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_real`."""
    return torch.view_as_real(z.contiguous()).reshape(
        *z.shape[:-1], 2 * z.shape[-1])


@functools.lru_cache(maxsize=None)
def _split_factors(n: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """W[k] = exp(-2*pi*i*k/n), k = 0..n/2, on the device."""
    count_build("split_factors")
    return torch.from_numpy(rfft_split_twiddles(n)).to(device=device,
                                                        dtype=dtype)


def _rfft_split(Z: torch.Tensor, n: int) -> torch.Tensor:
    """Post-pass of the packed R2C: (..., N/2) -> (..., N/2+1) spectrum."""
    Zf = torch.cat([Z, Z[..., :1]], dim=-1)          # wrap Z[m] = Z[0]
    Zr = torch.conj_physical(Zf.flip(-1))            # conj(Z[m-k])
    w = _split_factors(n, Z.device, Z.dtype)
    return 0.5 * (Zf + Zr) - 0.5j * w * (Zf - Zr)


def _irfft_merge(X: torch.Tensor, n: int) -> torch.Tensor:
    """Pre-pass of the packed C2R: (..., N/2+1) -> (..., N/2) packed Z."""
    m = n // 2
    Xr = torch.conj_physical(X.flip(-1))             # conj(X[m-k])
    ze = (0.5 * (X + Xr))[..., :m]
    wc = torch.conj_physical(_split_factors(n, X.device, X.dtype))
    zo = (0.5 * wc * (X - Xr))[..., :m]
    return ze + 1j * zo


def _rfft_pow2(x: torch.Tensor, *,
               radices: tuple[int, ...] = DEFAULT_RADICES) -> torch.Tensor:
    """R2C FFT along the last axis: (..., N) real -> (..., N/2+1) complex."""
    n = x.shape[-1]
    if not (is_pow2(n) and n >= 2):
        raise ValueError(f"R2C engine needs a power-of-two length >= 2, "
                         f"got {n}")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    z = _pack_real(x)
    return _rfft_split(_stockham_pow2(z, radices=radices), n)


def _irfft_pow2(X: torch.Tensor, *,
                radices: tuple[int, ...] = DEFAULT_RADICES) -> torch.Tensor:
    """C2R inverse: (..., N/2+1) half-spectrum -> (..., N) real (1/N norm)."""
    m = X.shape[-1] - 1
    n = 2 * m
    if not (m >= 1 and is_pow2(n)):
        raise ValueError(f"C2R engine needs N/2+1 bins of a power-of-two "
                         f"N >= 2, got {m + 1}")
    z = _stockham_pow2(_irfft_merge(_as_complex(X), n), inverse=True,
                       radices=radices)
    return _unpack_real(z)


# ---------------------------------------------------------------------------
# Public pure-torch API
# ---------------------------------------------------------------------------

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


def rfft(x, axis: int = -1) -> torch.Tensor:
    """R2C FFT of real input along ``axis``; pow2 lengths, N/2+1 bins out."""
    return _along_axis(_rfft_pow2, _as_real(x), axis)


def irfft(x, axis: int = -1) -> torch.Tensor:
    """C2R inverse of :func:`rfft` along ``axis`` (1/N normalised)."""
    return _along_axis(_irfft_pow2, _as_complex(x), axis)


#: The reference module's own name for the power-of-two test.
_is_pow2 = is_pow2


def fft_flop_count(n: int, batch: int = 1) -> float:
    """5 N log2 N per transform — the paper's Eq. (5) accounting."""
    return 5.0 * n * math.log2(n) * batch
