"""Public wrapper for the sift's select kernel.

:func:`sift_select` pools a (R, M) statistic plane's strongest cells for
:mod:`repro_torch.search.sift` and :class:`repro_torch.search.PulsarSearch`,
and counts the cells over the sift's threshold in the same read.  The
one route: a CPU tensor, or a row that fits in the kernel's buffer
(``sift_kernel.capacity_for(pool)`` cells, as the serving cache's small
volumes do), takes the plain twin (one ``torch.topk`` and the count); a
longer row on the card launches the kernel (:func:`sift_kernel.select`,
which takes float32 alone).  The reference has no such kernel (it pools
with one ``lax.top_k``), so the ledger name ``sift-select`` is the port's
own.  It records once a call whose row outgrows the buffer, on any
device, as the other wrappers record their kernel on the CPU too, with
the plane's first read and the buffer the kernel writes as
``bytes_moved``.

The selection runs in a span ``kernel.sift-select`` (``obs.trace.span``)
with attributes ``rows``, ``cells``, ``pool`` and ``floor`` (whether a
running floor was given).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sift import sift_kernel as K
from repro_torch.obs.ledger import record_launch
from repro_torch.obs.trace import span


def sift_select(stat: torch.Tensor, level: torch.Tensor, pool: int, *,
                floor: torch.Tensor | None = None,
                threshold: float | None = None) -> K.Selected:
    """The strongest ``min(pool, M)`` cells of each row of a (R, M) float32
    plane, with their int32 levels and the count over ``threshold``
    (``sift_kernel.select``'s contract: below a ``floor`` the cells are not
    promised)."""
    if stat.ndim != 2 or stat.shape != level.shape:
        raise ValueError(f"sift_select takes (rows, cells) planes of one "
                         f"shape, got {tuple(stat.shape)} and "
                         f"{tuple(level.shape)}")
    if pool < 1:
        raise ValueError(f"sift_select needs pool >= 1, got {pool}")
    rows, m = stat.shape
    capacity = K.capacity_for(pool)
    kernel = m > capacity
    with span("kernel.sift-select", stat, rows=rows, cells=m, pool=pool,
              floor=floor is not None):
        if kernel and stat.device.type != "cpu":
            out = K.select(stat.contiguous(),
                           level.to(torch.int32).contiguous(), pool, floor,
                           threshold)
        else:
            out = K.select_plain(stat, level, pool, threshold)
    if not kernel:
        return out
    chunk = K.chunks(rows, m)
    record_launch("sift-select", grid=(chunk * rows,),
                  tile=(1, -(-m // chunk)),
                  bytes_moved=4 * rows * m + 16 * rows * capacity,
                  shape=(rows, m))
    return out
