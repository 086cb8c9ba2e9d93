"""Brute-force dedispersion: the CUDA launch and its plain torch twin.

``dedisperse`` takes (B, C, N) float32 filterbanks and a (D, C) int32
delay table on the same device and returns the (B, D, N) dedispersed
series,

  out[b, d, t] = sum_c fb[b, c, t + delay[d, c]]   (0 past N),

summed over channels in index order.  A CPU tensor runs
:func:`dedisperse_plain`; a CUDA tensor launches the kernel of
``repro_torch/csrc/dedisp.cu`` (its header says which TPU kernel it
replaces, what bounds it and what its design does about that) and raises
if the launch fails.  ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import load_library

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"dedisperse": 0}

#: DM trials per thread block (one warp each) and samples per block.
TRIALS_PER_BLOCK = 8
SAMPLES_PER_BLOCK = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def blocks(batch: int, ndm: int, n: int) -> int:
    """Thread blocks of one launch."""
    return (batch * -(-ndm // TRIALS_PER_BLOCK)
            * -(-n // SAMPLES_PER_BLOCK))


def dedisperse_plain(fb: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`dedisperse`: the same sums in the same
    channel order, one gather of every DM trial per channel."""
    b, nchan, n = fb.shape
    ndm = delays.shape[0]
    # Zero past N: a row padded with N zeros covers every delay < N.
    padded = torch.nn.functional.pad(fb, (0, n))
    t = torch.arange(n, device=fb.device)
    out = torch.zeros((b, ndm, n), dtype=fb.dtype, device=fb.device)
    for c in range(nchan):
        idx = (delays[:, c].to(torch.long)[:, None] + t).reshape(-1)
        out += padded[:, c, idx].reshape(b, ndm, n)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("dedisp")
    lib.repro_dedisp_error_string.argtypes = [ctypes.c_int]
    lib.repro_dedisp_error_string.restype = ctypes.c_char_p
    lib.repro_dedisperse.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_dedisperse.restype = ctypes.c_int
    return lib


def dedisperse(fb: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """(B, C, N) float32 + (D, C) int32 delays in [0, N) on the same device
    -> (B, D, N) float32.  The caller validates the delays' range."""
    if fb.dtype != torch.float32 or fb.ndim != 3 or not fb.is_contiguous():
        raise ValueError(f"dedisperse takes a contiguous 3-D float32 "
                         f"tensor, got {tuple(fb.shape)} {fb.dtype}")
    b, nchan, n = fb.shape
    if (delays.dtype != torch.int32 or delays.ndim != 2
            or delays.shape[1] != nchan or delays.shape[0] < 1
            or not delays.is_contiguous() or delays.device != fb.device):
        raise ValueError(f"delays must be a contiguous int32 (D, {nchan}) "
                         f"tensor on {fb.device}, got "
                         f"{tuple(delays.shape)} {delays.dtype} on "
                         f"{delays.device}")
    if fb.device.type == "cpu":
        return dedisperse_plain(fb, delays)
    if fb.device.type != "cuda":
        raise ValueError(f"dedisperse: no kernel for device {fb.device}")
    ndm = delays.shape[0]
    out = torch.empty((b, ndm, n), dtype=torch.float32, device=fb.device)
    if fb.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(fb.device):
        stream = torch.cuda.current_stream(fb.device).cuda_stream
        err = lib.repro_dedisperse(fb.data_ptr(), delays.data_ptr(),
                                   out.data_ptr(), b, nchan, n, ndm, stream)
    if err:
        msg = lib.repro_dedisp_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel dedisperse failed to launch: {msg}")
    LAUNCHES["dedisperse"] += 1
    return out
