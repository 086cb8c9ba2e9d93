"""Public wrapper for the dedispersion kernel.

The counterpart of ``repro.kernels.dedisp.ops.dedisperse_kernel``, with
its guards (each a ``ValueError`` with the reference's message), its
ledger name (``dedisperse``), logical shape and ``bytes_moved`` formula
over the batch itself (the reference counts its padded batch).  ``grid``
and ``tile`` describe the CUDA launch: thread blocks, and (DM trials,
samples) per block.

The reference unrolls the (D, C) delay table at trace time.  Here it is
an int32 array on the filterbank's device, built once per table and
device: a table given as the tuple of tuples of a ``DispersionPlan`` is
cached on the identity of that tuple (hashing a (128, 1024) table on
every call would cost more than the launch), together with its range, so
the guards read the cached extremes; the kernel keeps its staged table
(per trial group and channel the delays' span) beside the cached tensor.
:func:`prepare_table` makes both ahead of a table's first launch.

Each launch runs in a span ``kernel.dedisperse`` (``obs.trace.span``)
with attributes ``rows`` (filterbanks), ``nchan``, ``n`` and ``trials``.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch

from repro_torch.fft.stockham import _as_tensor
from repro_torch.kernels.dedisp import dedisp_kernel
from repro_torch.obs.ledger import record_launch
from repro_torch.obs.trace import span

#: Device tables of tuple delay tables: (id(table), device) -> (table,
#: tensor, min, max); the tuple is held so that its id stays unique.
_DEVICE_TABLES: collections.OrderedDict = collections.OrderedDict()
#: Tables kept: a survey pointing's grid of 2048 trials searched in blocks
#: of 32 cycles through 64, and a cycle longer than the cache would miss
#: (and copy a table to the card, waiting for it) at every block.
_MAX_TABLES = 256


def _as_array(delays) -> np.ndarray:
    """A (D, C) integer table as numpy, with the reference's guards."""
    arr = np.asarray(delays.cpu() if isinstance(delays, torch.Tensor)
                     else delays)
    if arr.ndim != 2:
        raise ValueError(
            f"delays must be a (n_dm, nchan) table, got shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"delays must be integer samples, got dtype {arr.dtype}; round "
            f"with FilterbankSpec.delay_samples / DispersionPlan")
    return arr


def _device_table(delays, arr: np.ndarray | None, device: torch.device):
    """(int32 (D, C) tensor on ``device``, min delay, max delay) of the
    table ``delays``; ``arr`` is its array, None for a tuple table."""
    if arr is None:
        key = (id(delays), str(device))
        hit = _DEVICE_TABLES.get(key)
        if hit is not None and hit[0] is delays:
            _DEVICE_TABLES.move_to_end(key)
            return hit[1:]
        arr = _as_array(delays or np.zeros((0, 0), np.int64))
    lo = int(arr.min()) if arr.size else 0
    hi = int(arr.max()) if arr.size else 0
    if lo < -2**31 or hi >= 2**31:
        raise ValueError(f"delays [{lo}, {hi}] do not fit int32 samples")
    table = torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(device)
    if isinstance(delays, tuple):
        _DEVICE_TABLES[key] = (delays, table, lo, hi)
        while len(_DEVICE_TABLES) > _MAX_TABLES:
            _DEVICE_TABLES.popitem(last=False)
    return table, lo, hi


def prepare_table(delays: tuple, device: torch.device) -> None:
    """Copy a tuple table to ``device`` (and on a card make its staged
    form) ahead of its first launch, which then waits for nothing."""
    table, _, _ = _device_table(delays, None, device)
    if device.type == "cuda":
        dedisp_kernel._staged(table)


def dedisperse_kernel(fb, delays) -> torch.Tensor:
    """(..., C, N) filterbanks -> (..., D, N) dedispersed time series.

    ``delays`` is a (D, C) integer-sample table (rows = DM trials): a
    tuple of tuples (as ``DispersionPlan.delays``), a numpy array or a
    tensor.  Numpy input goes to the card.
    """
    # The table's rank and dtype are checked first, as the reference does.
    arr = None if isinstance(delays, tuple) else _as_array(delays)
    if getattr(fb, "ndim", 0) < 2:
        raise ValueError(
            f"dedisperse_kernel needs (..., nchan, ntime) input, got shape "
            f"{tuple(getattr(fb, 'shape', ()))}")
    fb = _as_tensor(fb)
    if fb.is_complex():
        raise ValueError(
            f"filterbank data must be real, got dtype "
            f"{str(fb.dtype).removeprefix('torch.')}")
    fb = fb.to(torch.float32)
    *lead, nchan, n = fb.shape
    if nchan == 0 or n == 0:
        raise ValueError(
            f"dedisperse_kernel needs non-empty channel/time axes, got "
            f"shape {tuple(fb.shape)}")
    table, lo, hi = _device_table(delays, arr, fb.device)
    ndm = table.shape[0]
    if ndm and table.shape[1] != nchan:
        raise ValueError(
            f"delay table covers {table.shape[1]} channels; filterbank has "
            f"{nchan} (shape {tuple(fb.shape)})")
    if not ndm:
        raise ValueError("delay table has no DM trials")
    if lo < 0 or hi >= n:
        arr = table.cpu().numpy()
        trial, ch = np.argwhere((arr < 0) | (arr >= n))[0]
        raise ValueError(
            f"delay {arr[trial, ch]} of trial {trial} outside "
            f"[0, ntime={n}); clip the DM grid to the block length")
    b = math.prod(lead)
    fb = fb.reshape(b, nchan, n).contiguous()
    with span("kernel.dedisperse", fb, rows=b, nchan=nchan, n=n, trials=ndm):
        out = dedisp_kernel.dedisperse(fb, table)
    record_launch("dedisperse", grid=(dedisp_kernel.blocks(b, ndm, n),),
                  tile=(dedisp_kernel.TRIALS_PER_BLOCK,
                        dedisp_kernel.SAMPLES_PER_BLOCK),
                  bytes_moved=4 * b * n * (nchan + ndm),
                  shape=(b, nchan, n))
    return out.reshape(*lead, ndm, n)
