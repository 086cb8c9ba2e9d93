"""Harmonic summing: the CUDA launches and their plain torch twins.

Both functions build the doubling ladder S_h[k] = sum_{j <= h} P[j * k]
(0 for j * k >= N), h = 1, 2, 4, ..., H, over the last axis of a (B, N)
float32 power tensor:

  harmonic_sum_plane  -> ((B, N) best statistic, (B, N) int32 rung): each
                         rung normalised to z_h = (S_h - h) * (1/sqrt(h))
                         and max-reduced, the earliest rung winning ties
  harmonic_sum        -> (B, L, N), every rung written (L = log2 H + 1)

A CPU tensor runs the plain version; a CUDA tensor launches the kernel of
``repro_torch/csrc/harmonic_sum.cu`` (its header says which TPU kernels
they replace, what bounds them and what their design does about that) and
raises if the launch fails.  The plain versions add the rungs in the
kernels' (and the reference's) order, decimation by decimation.
``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels.common import load_library

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"harmonic_sum_plane": 0, "harmonic_sum": 0}

#: Bins per thread block (one thread a bin).
BINS_PER_BLOCK = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def levels(n_harmonics: int) -> int:
    """Rungs of the ladder up to ``n_harmonics`` (a power of two)."""
    return int(math.log2(n_harmonics)) + 1


def blocks(batch: int, n: int) -> int:
    return batch * -(-n // BINS_PER_BLOCK)


@functools.lru_cache(maxsize=None)
def rung_scales(n_levels: int) -> np.ndarray:
    """float32 of the double 1/sqrt(h) for each rung, as the reference
    multiplies by it."""
    return np.array([1.0 / math.sqrt(2 ** lev) for lev in range(n_levels)],
                    np.float32)


def _decimated(p: torch.Tensor, j: int) -> torch.Tensor:
    """P[:, ::j] zero-padded back to (B, N)."""
    n = p.shape[-1]
    q = p[:, ::j]
    return torch.nn.functional.pad(q, (0, n - q.shape[-1]))


def _rungs(p: torch.Tensor, n_harmonics: int):
    """Yield (rung, S_h) for h = 1, 2, 4, ..., n_harmonics."""
    acc = p
    yield 0, acc
    h = 1
    for lev in range(1, levels(n_harmonics)):
        h *= 2
        for j in range(h // 2 + 1, h + 1):
            acc = acc + _decimated(p, j)
        yield lev, acc


def harmonic_sum_plane_plain(p: torch.Tensor, n_harmonics: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`harmonic_sum_plane`."""
    scales = rung_scales(levels(n_harmonics))
    best = p - 1.0                                  # z_1 = S_1 - 1
    best_lev = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    for lev, acc in _rungs(p, n_harmonics):
        if lev == 0:
            continue
        z = (acc - float(2 ** lev)) * float(scales[lev])
        better = z > best
        best = torch.where(better, z, best)
        best_lev = torch.where(better, lev, best_lev)
    return best, best_lev


def harmonic_sum_plain(p: torch.Tensor, n_harmonics: int) -> torch.Tensor:
    """Plain torch version of :func:`harmonic_sum`."""
    return torch.stack([acc for _, acc in _rungs(p, n_harmonics)], dim=1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("harmonic_sum")
    lib.repro_hsum_error_string.argtypes = [ctypes.c_int]
    lib.repro_hsum_error_string.restype = ctypes.c_char_p
    _P = ctypes.c_void_p
    lib.repro_harmonic_sum_plane.argtypes = [
        _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P]
    lib.repro_harmonic_sum_plane.restype = ctypes.c_int
    lib.repro_harmonic_sum.argtypes = [
        _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
    lib.repro_harmonic_sum.restype = ctypes.c_int
    return lib


def _check(p: torch.Tensor, n_harmonics: int, what: str) -> None:
    if p.dtype != torch.float32 or p.ndim != 2 or not p.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 2-D float32 tensor, "
                         f"got {tuple(p.shape)} {p.dtype}")
    if n_harmonics < 1 or n_harmonics & (n_harmonics - 1):
        raise ValueError(
            f"n_harmonics must be a power of two, got {n_harmonics}")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {p.device}")


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _library().repro_hsum_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")
    LAUNCHES[name] += 1


def harmonic_sum_plane(p: torch.Tensor, n_harmonics: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) float32 power -> ((B, N) statistic, (B, N) int32 rung)."""
    _check(p, n_harmonics, "harmonic_sum_plane")
    if p.device.type == "cpu":
        return harmonic_sum_plane_plain(p, n_harmonics)
    b, n = p.shape
    stat = torch.empty_like(p)
    lev = torch.empty(p.shape, dtype=torch.int32, device=p.device)
    if p.numel() == 0:
        return stat, lev
    scales = rung_scales(levels(n_harmonics))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _library().repro_harmonic_sum_plane(
            p.data_ptr(), stat.data_ptr(), lev.data_ptr(), b, n, len(scales),
            scales.ctypes.data, stream)
    _raise_on(err, "harmonic_sum_plane")
    return stat, lev


def harmonic_sum(p: torch.Tensor, n_harmonics: int) -> torch.Tensor:
    """(B, N) float32 power -> (B, L, N) ladder, L = log2 H + 1."""
    _check(p, n_harmonics, "harmonic_sum")
    if p.device.type == "cpu":
        return harmonic_sum_plain(p, n_harmonics)
    b, n = p.shape
    n_levels = levels(n_harmonics)
    out = torch.empty((b, n_levels, n), dtype=torch.float32, device=p.device)
    if p.numel() == 0:
        return out
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _library().repro_harmonic_sum(p.data_ptr(), out.data_ptr(), b,
                                            n, n_levels, stream)
    _raise_on(err, "harmonic_sum")
    return out
