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

A block of the kernel takes 128 samples and 64 DM trials and stages,
channel by channel, the filterbank window its trials read in shared
memory, ``chunk`` channels a step.  :func:`staged_table` prepares what it
reads beside the filterbank: per trial group and channel the smallest and
largest delay and each trial's shift from the smallest (the CPU tests
emulate the kernel from it).  :func:`dedisperse` makes it once per table
tensor and keeps it while the tensor lives unchanged.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels.common import MAX_SHARED_BYTES, load_library

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"dedisperse": 0}

#: A block: 8 warps, each thread 4 samples (t, t + 32, ...) of 8 trials.
WARPS = 8
SAMPLES_PER_BLOCK = 32 * 4
TRIALS_PER_BLOCK = WARPS * 8
#: Channels staged a step in the wrapper's launches, and the most a launch
#: may take (the chip check also times fewer: a run-time argument).
CHUNK = 32


def stage_bytes(span_cap: int, chunk: int = CHUNK) -> int:
    """Bytes of one stage buffer: the chunk's shifts, (lo, hi) pairs and
    windows of 128 + ``span_cap`` values, rounded up to 16
    (``csrc/dedisp.cu``'s)."""
    raw = chunk * (4 * TRIALS_PER_BLOCK + 8
                   + 4 * (SAMPLES_PER_BLOCK + span_cap))
    return (raw + 15) & ~15


def shared_bytes(span_cap: int, chunk: int = CHUNK) -> int:
    return 2 * stage_bytes(span_cap, chunk)


#: The widest span of delays in one channel of a trial group that is
#: staged in shared memory: two buffers of CHUNK windows fill a block's
#: 227 KB.  A wider channel is read from global memory.
SPAN_MAX = ((MAX_SHARED_BYTES // 2 // 16 * 16 // CHUNK
             - 4 * TRIALS_PER_BLOCK - 8) // 4 - SAMPLES_PER_BLOCK)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def blocks(batch: int, ndm: int, n: int) -> int:
    """Thread blocks of one launch."""
    return (batch * -(-ndm // TRIALS_PER_BLOCK)
            * -(-n // SAMPLES_PER_BLOCK))


class StagedTable(NamedTuple):
    """What the kernel reads beside the filterbank, for trial groups of
    DB = 64 trials: G = ceil(D / DB) groups, the last padded with copies
    of the last trial."""
    shifts: torch.Tensor   # (G, C, DB) int32: delay - lo of the channel
    lohi: torch.Tensor     # (G, C, 2) int32: smallest, largest delay
    span_cap: int          # the widest staged span (<= SPAN_MAX)


def staged_table(delays: torch.Tensor) -> StagedTable:
    """The (D, C) int32 table's :class:`StagedTable`, on the table's
    device."""
    ndm, nchan = delays.shape
    per = TRIALS_PER_BLOCK
    groups = -(-ndm // per)
    pad = groups * per - ndm
    full = torch.cat([delays, delays[-1:].expand(pad, nchan)]) if pad \
        else delays
    full = full.reshape(groups, per, nchan)
    lo, hi = full.amin(dim=1), full.amax(dim=1)
    shifts = (full - lo[:, None, :]).transpose(1, 2).contiguous()
    spans = hi - lo
    narrow = spans[spans <= SPAN_MAX]
    span_cap = int(narrow.max()) if narrow.numel() else 0
    return StagedTable(shifts.to(torch.int32),
                       torch.stack([lo, hi], dim=-1).to(torch.int32)
                       .contiguous(), span_cap)


#: Staged tables by delay-table tensor: (the tensor's version, table).
_STAGED: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _staged(delays: torch.Tensor) -> StagedTable:
    """:func:`staged_table` of ``delays``, made once while the tensor lives
    and is not written to."""
    hit = _STAGED.get(delays)
    if hit is not None and hit[0] == delays._version:
        return hit[1]
    staged = staged_table(delays)
    _STAGED[delays] = (delays._version, staged)
    return staged


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
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.repro_dedisperse.argtypes = [
        _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P]
    lib.repro_dedisperse.restype = ctypes.c_int
    lib.repro_dedisperse_blocks_per_sm.argtypes = [_I, _I]
    lib.repro_dedisperse_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(span_cap: int, chunk: int = CHUNK) -> int:
    """Blocks that one SM of the current card holds."""
    return _library().repro_dedisperse_blocks_per_sm(chunk, span_cap)


def dedisperse(fb: torch.Tensor, delays: torch.Tensor,
               chunk: int = CHUNK) -> torch.Tensor:
    """(B, C, N) float32 + (D, C) int32 delays in [0, N) on the same device
    -> (B, D, N) float32.  The caller validates the delays' range.
    ``chunk`` (1 to CHUNK) sets the channels staged a step (the chip
    check's sweep)."""
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
    if not 1 <= chunk <= CHUNK:
        raise ValueError(f"dedisperse stages 1 to {CHUNK} channels a step, "
                         f"got {chunk}")
    if fb.device.type == "cpu":
        return dedisperse_plain(fb, delays)
    if fb.device.type != "cuda":
        raise ValueError(f"dedisperse: no kernel for device {fb.device}")
    ndm = delays.shape[0]
    out = torch.empty((b, ndm, n), dtype=torch.float32, device=fb.device)
    if fb.numel() == 0:
        return out
    staged = _staged(delays)
    lib = _library()
    with torch.cuda.device(fb.device):
        stream = torch.cuda.current_stream(fb.device).cuda_stream
        err = lib.repro_dedisperse(
            fb.data_ptr(), staged.shifts.data_ptr(), staged.lohi.data_ptr(),
            out.data_ptr(), b, nchan, n, ndm, chunk, staged.span_cap, stream)
    if err:
        msg = lib.repro_dedisp_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel dedisperse failed to launch: {msg}")
    LAUNCHES["dedisperse"] += 1
    return out
