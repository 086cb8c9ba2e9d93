"""Plain reference of the ``paper_fft_2gb`` deployment: batched FFTs.

``torch.fft`` in float64 (complex128), in blocks of rows so that it fits
beside the program's outputs, is the reference; :func:`control` is the
same transform put in the program's place at the next precision below
the configuration's float32: bfloat16 operands and results (each
component rounded to bfloat16, the transform itself in float32).
Imports nothing of the program.
"""
from __future__ import annotations

import torch

#: Rows a block: about 0.5 GB of complex128 at the longest rows timed.
BLOCK_ELEMS = 2**25


def _rows(x: torch.Tensor) -> int:
    return max(BLOCK_ELEMS // x.shape[-1], 1)


def _apply(kind: str, n: int, x: torch.Tensor) -> torch.Tensor:
    if kind == "c2c":
        return torch.fft.fft(x, dim=-1)
    if kind == "r2c":
        return torch.fft.rfft(x, dim=-1)
    if kind == "c2r":
        return torch.fft.irfft(x, n=n, dim=-1)
    raise ValueError(f"unknown transform kind {kind!r}")


def reference(kind: str, n: int, x: torch.Tensor) -> torch.Tensor:
    """The float64 transform of ``x`` (rows along the last dimension)."""
    wide = torch.complex128 if x.is_complex() else torch.float64
    return _apply(kind, n, x.to(wide))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.complex(_bf16(t.real), _bf16(t.imag))
    return t.to(torch.bfloat16).to(torch.float32)


def control(kind: str, n: int, x: torch.Tensor) -> torch.Tensor:
    """The transform at bfloat16 precision, in the program's dtypes."""
    return torch.cat([_bf16(_apply(kind, n, _bf16(b)))
                      for b in torch.split(x, _rows(x))])


def rel_err(kind: str, n: int, x: torch.Tensor, y: torch.Tensor) -> float:
    """max |y - ref| / max |ref| over every row, ref the float64
    transform of ``x``."""
    worst, scale = 0.0, 0.0
    for xb, yb in zip(torch.split(x, _rows(x)), torch.split(y, _rows(x))):
        ref = reference(kind, n, xb)
        worst = max(worst, (yb.to(ref.dtype) - ref).abs().max().item())
        scale = max(scale, ref.abs().max().item())
        del ref
    return worst / max(scale, 1e-300)
