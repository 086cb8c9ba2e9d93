"""``torch.fft`` oracles for the FFT kernels (tests and the chip check
only; the port never calls them on its own path)."""
from __future__ import annotations

import torch


def fft_ref(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """C2C reference along the last axis (1/N-normalised inverse)."""
    x = x.to(torch.complex64)
    return torch.fft.ifft(x) if inverse else torch.fft.fft(x)


def rfft_ref(x: torch.Tensor) -> torch.Tensor:
    """R2C reference along the last axis: (..., N) real -> (..., N/2+1)."""
    return torch.fft.rfft(x.to(torch.float32))


def irfft_ref(x: torch.Tensor) -> torch.Tensor:
    """C2R reference along the last axis: (..., N/2+1) -> (..., N) real
    (1/N).  It ignores the imaginary parts of bins 0 and N/2, so it
    matches the kernels only on a true half-spectrum."""
    x = x.to(torch.complex64)
    return torch.fft.irfft(x, n=2 * (x.shape[-1] - 1))
