"""``torch.fft`` oracles for the FFT kernels (tests and the chip check
only; the port never calls them on its own path)."""
from __future__ import annotations

import torch


def fft_ref(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """C2C reference along the last axis (1/N-normalised inverse)."""
    x = x.to(torch.complex64)
    return torch.fft.ifft(x) if inverse else torch.fft.fft(x)
