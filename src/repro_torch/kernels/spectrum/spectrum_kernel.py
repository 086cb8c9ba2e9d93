"""Fused power spectrum and row statistics: the CUDA launch and its plain
torch twin.

``power_spectrum_stats`` takes a (B, N) complex64 spectrum and returns
p = (re^2 + im^2) / N (B, N), the row mean of p (B,) and its variance
E[p^2] - mean^2 (B,), all float32.  A CPU tensor runs
:func:`power_spectrum_stats_plain`; a CUDA tensor launches the kernel of
``repro_torch/csrc/spectrum.cu`` (its header says which TPU kernel it
replaces, what bounds it and what its design does about that) and raises
if the launch fails.  ``LAUNCHES`` counts kernel launches only.

The kernel cuts each row into segments, one block each (:func:`segments`,
:func:`segment_bounds`), so that the grid fills the card whatever the
batch.  Each block's sums of p and p^2 (double) go to a workspace, and the
row's last block to finish, told by a per-row ticket, combines them in a
fixed order.  The wrapper owns both: a fresh workspace a call, and a
ticket array per device and stream that the kernel leaves at zero.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import load_library

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"power_spectrum_stats": 0}

#: Threads of a block; a block streams one segment of a row.
THREADS = 256
#: Waves of blocks the grid aims at, where its rows are long enough: the
#: fastest of ``chip_smoke.py``'s sweep at (32, 2**20) on an H100 (two
#: waves leave a tail that a third wave only partly fills); and the fewest
#: bins a segment takes (one a thread) unless its row is shorter.
WAVES = 8
MIN_SEGMENT = THREADS
#: Blocks of one wave on an H100 SXM: 132 SMs x the 6 blocks an SM holds
#: (the kernel's 40 registers a thread, as ``nvcc`` compiles it for
#: sm_90a).  On the card the wrapper asks the card.
H100_WAVE = 132 * 6

#: The kernel's ticket arrays: (device index, stream) -> int32 tensor of
#: at least a batch's rows, all 0 between launches.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def segments(batch: int, n: int, wave: int = H100_WAVE,
             count: int | None = None) -> tuple[int, int]:
    """(segments a row, bins a segment) for (B, N) rows: about enough
    segments that B of them fill WAVES waves of ``wave`` blocks, none but
    the last shorter than MIN_SEGMENT bins (a row shorter than that is
    one segment); ``count`` asks for about that many instead (the chip
    check's sweep).  Segments of ceil(N / count) bins, the last one
    shorter where that does not divide N."""
    if count is None:
        count = min(-(-WAVES * wave // batch), n // MIN_SEGMENT)
    seg = -(-n // max(1, min(count, n)))
    return -(-n // seg), seg


def segment_bounds(n: int, count: int, seg: int) -> list[range]:
    """The bins of each segment of a row, in the kernel's order."""
    return [range(s * seg, min(n, (s + 1) * seg)) for s in range(count)]


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
        _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P]
    lib.repro_power_spectrum_stats.restype = ctypes.c_int
    lib.repro_power_spectrum_stats_blocks_per_sm.argtypes = []
    lib.repro_power_spectrum_stats_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def _wave(index: int) -> int:
    """Blocks of the kernel that card ``index`` holds at once."""
    with torch.cuda.device(index):
        per_sm = _library().repro_power_spectrum_stats_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError("power_spectrum_stats: the occupancy query of "
                           "its kernel failed")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(device: torch.device, stream: int, batch: int) -> torch.Tensor:
    """The ticket array of (device, stream), grown to ``batch`` rows."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < batch:
        t = _TICKETS[key] = torch.zeros(batch, dtype=torch.int32,
                                        device=device)
    return t


def power_spectrum_stats(x: torch.Tensor, count: int | None = None):
    """(B, N) complex64 -> (power (B, N), mean (B,), variance (B,)).
    ``count`` overrides the segments a row of :func:`segments` (the chip
    check's sweep)."""
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
    s, seg = segments(b, n, _wave(x.device.index), count)
    partial = torch.empty((b, s, 2), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets = _tickets(x.device, stream, b)
        err = lib.repro_power_spectrum_stats(
            x.data_ptr(), p.data_ptr(), mean.data_ptr(), var.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), b, n, s, seg, stream)
    if err:
        msg = lib.repro_spectrum_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel power_spectrum_stats failed to "
                           f"launch: {msg}")
    LAUNCHES["power_spectrum_stats"] += 1
    return p, mean, var
