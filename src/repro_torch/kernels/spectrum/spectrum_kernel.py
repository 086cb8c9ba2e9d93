"""Fused power spectrum and row statistics: the CUDA launch and its plain
torch twin.

``power_spectrum_stats`` takes a (B, N) complex64 spectrum and returns
p = (re^2 + im^2) / N (B, N), the row mean of p (B,) and its variance
E[p^2] - mean^2 (B,), all float32.  A CPU tensor runs
:func:`power_spectrum_stats_plain`; a CUDA tensor launches the kernel of
``repro_torch/csrc/spectrum.cu`` (its header says which TPU kernel it
replaces, what bounds it and what its design does about that) and raises
if the launch fails.  ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import load_library

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"power_spectrum_stats": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def power_spectrum_stats_plain(x: torch.Tensor):
    """Plain torch version of :func:`power_spectrum_stats`."""
    n = x.shape[-1]
    v = torch.view_as_real(x)
    p = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) / n
    mean = p.mean(dim=-1)
    return p, mean, (p * p).mean(dim=-1) - mean * mean


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("spectrum")
    lib.repro_spectrum_error_string.argtypes = [ctypes.c_int]
    lib.repro_spectrum_error_string.restype = ctypes.c_char_p
    _P = ctypes.c_void_p
    lib.repro_power_spectrum_stats.argtypes = [
        _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
    lib.repro_power_spectrum_stats.restype = ctypes.c_int
    return lib


def power_spectrum_stats(x: torch.Tensor):
    """(B, N) complex64 -> (power (B, N), mean (B,), variance (B,))."""
    if x.dtype != torch.complex64 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"power_spectrum_stats takes a contiguous 2-D "
                         f"complex64 tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return power_spectrum_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"power_spectrum_stats: no kernel for device "
                         f"{x.device}")
    b, n = x.shape
    p = torch.empty((b, n), dtype=torch.float32, device=x.device)
    mean = torch.empty((b,), dtype=torch.float32, device=x.device)
    var = torch.empty((b,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return p, mean, var
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_power_spectrum_stats(
            x.data_ptr(), p.data_ptr(), mean.data_ptr(), var.data_ptr(), b,
            n, stream)
    if err:
        msg = lib.repro_spectrum_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel power_spectrum_stats failed to "
                           f"launch: {msg}")
    LAUNCHES["power_spectrum_stats"] += 1
    return p, mean, var
