"""Exact selection of a statistic plane's strongest cells: the CUDA launch
and its plain torch twin.

``select`` takes a (R, M) float32 statistic and the matching (R, M) int32
harmonic level on one device, a ``pool`` size, an optional (R,) float32
``floor`` and an optional ``threshold``, and returns, for each row, the
``min(pool, M)`` strongest cells in descending order as (value, index in
the row, level), with the cells at or above the threshold counted.  Where
a floor is given, only the cells at or above it are promised; padding
(value -inf, index -1, level -1) may stand in for the rest of the row's
strongest.  A pool whose weakest value is the floor, merged with the
result, is then the pool of both
(:func:`repro_torch.search.sift.merge_pools`).

``select`` checks its inputs and launches ``repro_torch/csrc/sift.cu``
on a CUDA tensor (its header says what bounds it and what its design
does about that), which reads the plane once or twice and leaves at most
:func:`capacity_for` cells a row to one ``torch.topk``, and raises if the
launch fails.  :func:`select_plain` is its plain twin (``torch.topk`` and
a chunked count, any device, the floor ignored); the wrapper
(:mod:`repro_torch.kernels.sift.ops`) chooses between them.
``LAUNCHES`` counts kernel launches only.

The kernels keep their state on the card: a zeroed workspace a call, of
``WORKSPACE_WORDS`` int64 words a row, whose first ``STATE_WORDS`` hold
the row's counters; :class:`Selected` hands three of them back as
``counts``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.common import load_library

#: Launches since the last :func:`reset_launches`.
LAUNCHES = {"sift_select": 0}

#: Threads of a block (``csrc/sift.cu``'s kThreads) and the float4 loads
#: each has in flight (kUnroll).
THREADS = 512
UNROLL = 4
#: Bins of the first histogram (the key's top 12 bits) and of each of the
#: two refinements (10 bits more each).
BINS = 1 << 12
REFINE_BINS = 1 << 10
#: A row's workspace: its state, then the three histograms (int64 words).
STATE_WORDS = 16
WORKSPACE_WORDS = STATE_WORDS + BINS + 2 * REFINE_BINS
#: Words of the state: the count over the threshold, and the cells left in
#: the buffer, the refinement reads and the reads of the plane.
OVER_WORD = 0
COUNT_WORDS = slice(12, 15)
#: Entries of the buffer a row, at least: 4 MB a row (float32 value, int64
#: index, int32 level).  A sub-block's cells over a full pool's weakest fit
#: in it unless a pulsar's cloud covers them.
CAPACITY = 1 << 18
#: Waves of blocks the grid of a read aims at, where the rows are long
#: enough.
WAVES = 4
#: An H100's SMs x the blocks of the first read an SM holds (16 KB of
#: shared memory and 512 threads a block); on the card the wrapper asks.
H100_WAVE = 132 * 3
#: Cells :func:`count_over` compares at once: a sum over a boolean plane
#: widens it to an int64 copy first (8 bytes a cell).
COUNT_CELLS = 1 << 27


class Selected(NamedTuple):
    """A row's strongest cells and the counters of their selection."""

    vals: torch.Tensor         # (R, k) float32, descending (padding -inf)
    idx: torch.Tensor          # (R, k) int64: index in the row (padding -1)
    level: torch.Tensor        # (R, k) int32 (padding -1)
    over: torch.Tensor | None  # (R,) int64: cells >= threshold, or None
    # (R, 3) int64: cells left in the buffer, refinement reads, reads of
    # the plane (all 0 on the plain version)
    counts: torch.Tensor


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def capacity_for(pool: int) -> int:
    """Buffer entries a row for a pool of ``pool`` cells."""
    return max(CAPACITY, 4 * pool)


def count_over(stat: torch.Tensor, threshold: float) -> torch.Tensor:
    """(R,) int64 cells of a (R, M) plane at or above the threshold, a few
    rows' worth of cells at a time."""
    rows, m = stat.shape
    step = max(1, COUNT_CELLS // rows)
    return sum((stat[:, lo:lo + step] >= threshold).sum(dim=-1)
               for lo in range(0, m, step))


def select_plain(stat: torch.Tensor, level: torch.Tensor, pool: int,
                 threshold: float | None = None) -> Selected:
    """Plain torch version of :func:`select`: one ``torch.topk`` over every
    cell, and the count."""
    rows, m = stat.shape
    vals, idx = torch.topk(stat, min(pool, m), dim=-1)
    lev = torch.gather(level, -1, idx).to(torch.int32)
    over = None if threshold is None else count_over(stat, threshold)
    counts = torch.zeros((rows, 3), dtype=torch.int64, device=stat.device)
    return Selected(vals, idx, lev, over, counts)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("sift")
    lib.repro_sift_error_string.argtypes = [ctypes.c_int]
    lib.repro_sift_error_string.restype = ctypes.c_char_p
    _P = ctypes.c_void_p
    lib.repro_sift_select.argtypes = [
        _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        _P, _P, _P, _P, _P]
    lib.repro_sift_select.restype = ctypes.c_int
    lib.repro_sift_blocks_per_sm.argtypes = []
    lib.repro_sift_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def _wave(index: int) -> int:
    """Blocks of the first read that card ``index`` holds at once."""
    with torch.cuda.device(index):
        per_sm = _library().repro_sift_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError("sift_select: the occupancy query of its kernel "
                           "failed")
    props = torch.cuda.get_device_properties(index)
    return per_sm * props.multi_processor_count


def chunks(rows: int, m: int, wave: int = H100_WAVE) -> int:
    """Blocks a row of each read: about WAVES waves over the rows, none
    with less than one round of loads (THREADS x UNROLL float4s)."""
    loads = -(-(m // 4) // (THREADS * UNROLL))
    return max(1, min(-(-WAVES * wave // rows), loads))


def select(stat: torch.Tensor, level: torch.Tensor, pool: int,
           floor: torch.Tensor | None = None,
           threshold: float | None = None) -> Selected:
    """(R, M) float32 statistic and int32 level on the card -> the rows'
    strongest ``min(pool, M)`` cells (module docstring)."""
    if (stat.dtype != torch.float32 or stat.ndim != 2
            or not stat.is_contiguous()):
        raise ValueError(f"sift select takes a contiguous 2-D float32 "
                         f"statistic, got {tuple(stat.shape)} {stat.dtype}")
    if (level.dtype != torch.int32 or level.shape != stat.shape
            or not level.is_contiguous() or level.device != stat.device):
        raise ValueError(f"sift select takes a contiguous int32 level of the "
                         f"statistic's shape and device, got "
                         f"{tuple(level.shape)} {level.dtype} {level.device}")
    rows, m = stat.shape
    if pool < 1 or m < 1 or rows < 1:
        raise ValueError(f"sift select needs pool >= 1 and a non-empty "
                         f"plane, got pool={pool}, shape {tuple(stat.shape)}")
    if floor is not None and (floor.dtype != torch.float32
                              or floor.shape != (rows,)
                              or floor.device != stat.device):
        raise ValueError(f"sift select takes a ({rows},) float32 floor on "
                         f"the statistic's device, got {tuple(floor.shape)} "
                         f"{floor.dtype} {floor.device}")
    if stat.device.type != "cuda":
        raise ValueError(f"sift select: no kernel for device {stat.device}")
    if rows > 65535:
        raise ValueError(f"sift select takes at most 65535 rows, got {rows}")
    dev = stat.device
    capacity = capacity_for(pool)
    ws = torch.zeros((rows, WORKSPACE_WORDS), dtype=torch.int64, device=dev)
    vals = torch.empty((rows, capacity), dtype=torch.float32, device=dev)
    idx = torch.empty((rows, capacity), dtype=torch.int64, device=dev)
    lev = torch.empty((rows, capacity), dtype=torch.int32, device=dev)
    floor = None if floor is None else floor.contiguous()
    lib = _library()
    count = threshold is not None
    # The threshold in float32, as torch compares a float32 plane with it.
    thr = ctypes.c_float(float(threshold) if count else 0.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_sift_select(
            stat.data_ptr(), level.data_ptr(),
            None if floor is None else floor.data_ptr(), rows, m, thr,
            int(count), pool, capacity, chunks(rows, m, _wave(dev.index)),
            ws.data_ptr(), vals.data_ptr(), idx.data_ptr(), lev.data_ptr(),
            stream)
    if err:
        msg = lib.repro_sift_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel sift_select failed to launch: {msg}")
    LAUNCHES["sift_select"] += 1
    filled = ws[:, COUNT_WORDS][:, :1]
    valid = torch.arange(capacity, device=dev) < filled
    top, sel = torch.topk(torch.where(valid, vals, -torch.inf),
                          min(pool, m), dim=-1)
    # Slots past the row's kept cells hold stale or unwritten entries.
    pad = ~torch.gather(valid, -1, sel)
    return Selected(top, torch.gather(idx, -1, sel).masked_fill(pad, -1),
                    torch.gather(lev, -1, sel).masked_fill(pad, -1),
                    ws[:, OVER_WORD] if count else None, ws[:, COUNT_WORDS])
