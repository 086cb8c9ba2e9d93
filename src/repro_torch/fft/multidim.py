"""Multi-dimensional FFTs — the paper's Eq. (2), compiled as plan graphs.

The counterpart of ``repro.fft.multidim``: the 2-D (and higher) DFT
factorises into 1-D DFTs along each axis, and every transform routes
through :mod:`repro_torch.fft.plan_nd`, where the hand-off transpose
rides the FFT kernel's write (one pass per pow2 axis in all), and only
non-pow2 (Bluestein) axes pay an explicit tiled-transpose node.

Public API mirrors ``torch.fft``/``numpy.fft``: fft2 / rfft2 / fftn /
rfftn, with ``axes=`` supported by moving the transform axes to the
trailing positions first (a real copy only when they are not already
there: the kernels take contiguous input).  Numpy input goes to the card.
"""
from __future__ import annotations

import torch

from repro_torch.fft.plan_nd import plan_nd
from repro_torch.fft.stockham import _as_tensor


def _run(x, axes: tuple[int, ...], kind: str) -> torch.Tensor:
    x = _as_tensor(x)
    axes = tuple(a % x.ndim for a in axes)
    if len(set(axes)) != len(axes):
        if kind == "r2c":
            # np.fft.rfftn's repeated-axes behaviour is a zero-padding
            # accident of its s= bookkeeping; reject rather than imitate.
            raise ValueError(f"repeated axes {axes} in a real transform")
        # numpy fftn semantics: a repeated axis is transformed repeatedly;
        # compile each occurrence as its own single-axis plan.
        for ax in axes:
            x = _run(x, (ax,), "c2c")
        return x
    trailing = tuple(range(x.ndim - len(axes), x.ndim))
    moved = axes != trailing
    if moved:
        x = torch.movedim(x, axes, trailing).contiguous()
    y = plan_nd(tuple(x.shape[-len(axes):]), kind)(x)
    if moved:
        y = torch.movedim(y, trailing, axes)
    return y


def fft2(x, axes: tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """2-D C2C FFT over ``axes`` — two fused kernel passes at pow2 shapes."""
    return _run(x, axes, "c2c")


def rfft2(x, axes: tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """2-D FFT of real input: R2C along ``axes[1]``, C2C along ``axes[0]``
    (``n // 2 + 1`` bins along ``axes[1]``, as ``torch.fft.rfft2``).  The
    R2C pass runs the Hermitian split and the hand-off transpose in one
    fused kernel pass."""
    return _run(x, axes, "r2c")


def fftn(x, axes: tuple[int, ...] | None = None) -> torch.Tensor:
    """N-D C2C FFT over ``axes`` (default: all) — one fused pass per pow2
    axis; the axis cycle restores the original order for free."""
    x = _as_tensor(x)
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    return _run(x, axes, "c2c")


def rfftn(x, axes: tuple[int, ...] | None = None) -> torch.Tensor:
    """N-D FFT of real input: R2C on the last of ``axes``, C2C on the rest
    (the ``numpy.fft.rfftn`` convention)."""
    x = _as_tensor(x)
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    return _run(x, axes, "r2c")
