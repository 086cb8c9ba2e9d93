"""Candidate sifting/clustering — the pipeline's last stage (the
counterpart of ``repro.search.sift``).

The raw detection-statistic volume (dm, template, bin) fires a cloud of
cells around every real pulsar: neighbouring DM trials share most of the
signal, neighbouring bins catch spectral leakage, and the harmonic
ladder lights multiples of the spin frequency.  Sifting collapses each
cloud to its strongest cell:

  1. pool the top-``pool`` cells of the volume (one ``torch.topk``, or on
     the card, where the volume outgrows the select kernel's buffer, the
     kernel and a ``torch.topk`` over what it keeps),
  2. suppress any pooled cell that a *stronger* cell within ``dm_tol``
     DM trials dominates — either bin-adjacent (|Δbin| <= bin_tol) or
     harmonically related (bin_j ~ m * bin_i up to ``max_harmonic``),
  3. keep the top-``max_candidates`` survivors above ``threshold``.

A grid searched in blocks of DM trials pools each block's cells
(:func:`pool_cells`), merges the pools (:func:`merge_pools`) and runs
steps 2 and 3 once on the merged pool (:func:`sift_pool`): the dedupe
then sees DM neighbours across the blocks' boundaries, and the result is
the one-volume sift's.

Everything is fixed-shape; padding entries are (-1, -1, -1, -1, 0) like
:class:`repro_torch.search.fdas.Candidates`.  ``torch.topk`` may order
equal statistics differently from ``lax.top_k``; a tie between pooled
cells is broken by the lower flat index, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.sift import sift_select

#: Pooled cells whose absorptions :func:`sift_pool` weighs at once.
_SIFT_ROWS = 512


class CandidatePool(NamedTuple):
    """The strongest cells of the volume searched so far (step 1), with
    flat indices over the whole (D, T, N) grid, so that pools of blocks of
    DM trials merge (:func:`merge_pools`) and sift as one volume."""

    vals: torch.Tensor         # (batch, p) f32 — detection statistic
    idx: torch.Tensor          # (batch, p) int64 — flat (dm, template, bin)
    level: torch.Tensor        # (batch, p) int32 — winning harmonic level


class SiftedCandidates(NamedTuple):
    """Top candidates per filterbank, deduped; -1/0 past the last one."""

    dm: torch.Tensor           # (..., k) int32 — DM trial index
    template: torch.Tensor     # (..., k) int32 — index into bank.drifts
    bin: torch.Tensor          # (..., k) int32 — Fourier bin
    level: torch.Tensor        # (..., k) int32 — winning harmonic level
    snr: torch.Tensor          # (..., k) f32 — detection statistic


def sift_candidates(
    stat: torch.Tensor,
    level: torch.Tensor,
    *,
    threshold: float = 25.0,
    max_candidates: int = 16,
    pool: int = 64,
    dm_tol: int = 1,
    bin_tol: int = 1,
    max_harmonic: int = 8,
) -> SiftedCandidates:
    """Threshold + cluster + top-k over a (..., D, T, N) statistic volume.

    ``level`` is the matching (..., D, T, N) harmonic-level plane from
    :func:`repro_torch.kernels.harmonic_sum.harmonic_sum_plane`.  The
    default ``threshold`` is sized for ~10^6-cell volumes: the per-cell
    null is ~N(0,1)-ish sub-exponential, so the expected null maximum sits
    near ln(cells) ~ 14 and 25 leaves a wide false-positive margin;
    :func:`sift_threshold` gives one for a volume and a false-alarm rate.
    """
    if stat.ndim < 3:
        raise ValueError(
            f"sift needs a (..., dm, template, bin) volume, got shape "
            f"{tuple(stat.shape)}")
    if stat.shape != level.shape:
        raise ValueError(
            f"stat/level shapes differ: {tuple(stat.shape)} vs "
            f"{tuple(level.shape)}")
    d, t, nb = stat.shape[-3:]
    lead = stat.shape[:-3]
    batch = math.prod(lead)
    cells, _, _ = pool_cells(stat.reshape(batch, d, t, nb),
                             level.reshape(batch, d, t, nb), pool)
    return sift_pool(cells, (t, nb), lead, threshold=threshold,
                     max_candidates=max_candidates, dm_tol=dm_tol,
                     bin_tol=bin_tol, max_harmonic=max_harmonic)


def pool_cells(stat: torch.Tensor, level: torch.Tensor, pool: int,
               first: int = 0, *, floor: torch.Tensor | None = None,
               threshold: float | None = None,
               ) -> tuple[CandidatePool, torch.Tensor | None, torch.Tensor]:
    """The top-``pool`` cells of a (batch, d, T, N) sub-volume whose first
    DM trial is trial ``first`` of the grid
    (:func:`repro_torch.kernels.sift.sift_select`), with its (batch,)
    count of cells at or above ``threshold`` (None without one) and its
    (batch, 3) counters (``sift_kernel.Selected.counts``).  Below a (batch,)
    ``floor`` (a full running pool's weakest value) the cells are not
    promised: padding stands in for them."""
    batch, d, t, nb = stat.shape
    sel = sift_select(stat.reshape(batch, -1), level.reshape(batch, -1),
                      pool, floor=floor, threshold=threshold)
    return (CandidatePool(sel.vals, sel.idx + first * t * nb, sel.level),
            sel.over, sel.counts)


def merge_pools(a: CandidatePool | None, b: CandidatePool,
                pool: int) -> CandidatePool:
    """The top-``pool`` cells of two pools of one grid: those of the whole
    volume the two sub-volumes cover, as :func:`pool_cells` of it would
    give them (up to the order of equal statistics)."""
    if a is None:
        return b
    vals = torch.cat([a.vals, b.vals], dim=-1)
    top, sel = torch.topk(vals, min(pool, vals.shape[-1]), dim=-1)
    return CandidatePool(top, torch.gather(torch.cat([a.idx, b.idx], -1),
                                           -1, sel),
                         torch.gather(torch.cat([a.level, b.level], -1),
                                      -1, sel))


def sift_pool(cells: CandidatePool, plane: tuple[int, int],
              lead: tuple[int, ...] = (), *, threshold: float = 25.0,
              max_candidates: int = 16, dm_tol: int = 1, bin_tol: int = 1,
              max_harmonic: int = 8) -> SiftedCandidates:
    """Steps 2 and 3 on a pool of a grid's cells: ``plane`` is the grid's
    (templates, bins), ``lead`` the candidates' leading shape."""
    vals, idx = cells.vals, cells.idx
    t, nb = plane
    p = vals.shape[-1]
    dmi = (idx // (t * nb)).to(torch.int32)
    ti = ((idx // nb) % t).to(torch.int32)
    bi = (idx % nb).to(torch.int32)
    lev = cells.level
    above = vals >= threshold

    # Pairwise (batch, i, j): does pooled cell i dominate and absorb j?
    # Rows of i a chunk at a time, so that a pool of thousands of cells
    # needs (chunk x p x max_harmonic) of memory, not (p x p x ...).
    ms = torch.arange(1, max_harmonic + 1, device=vals.device)
    absorbed = torch.zeros_like(above)
    for lo in range(0, p, _SIFT_ROWS):
        i = slice(lo, lo + _SIFT_ROWS)
        vi, vj = vals[:, i, None], vals[:, None, :]
        stronger = (vi > vj) | ((vi == vj)
                                & (idx[:, i, None] < idx[:, None, :]))
        close_dm = (dmi[:, i, None] - dmi[:, None, :]).abs() <= dm_tol
        # m = 1 is bin adjacency.
        bi_i = bi[:, i, None, None]
        bi_j = bi[:, None, :, None]
        related = (((bi_j - ms * bi_i).abs() <= ms * bin_tol)
                   | ((bi_i - ms * bi_j).abs() <= ms * bin_tol)).any(dim=-1)
        absorbed |= (stronger & close_dm & related
                     & above[:, i, None]).any(dim=-2)     # any i absorbs j
    keep = above & ~absorbed

    k = min(max_candidates, p)
    score = torch.where(keep, vals, -math.inf)
    top, sel = torch.topk(score, k, dim=-1)              # (batch, k)
    kept = top > -math.inf

    def _take(a, fill):
        return torch.where(kept, torch.gather(a, -1, sel),
                           fill).reshape(*lead, k)

    return SiftedCandidates(
        dm=_take(dmi, -1),
        template=_take(ti, -1),
        bin=_take(bi, -1),
        level=_take(lev, -1),
        snr=_take(vals, 0.0),
    )


def sift_threshold(cells: float, false_alarms: float,
                   n_harmonics: int = 8) -> float:
    """The statistic a noise cell passes ``false_alarms`` times in a
    volume of ``cells`` cells: x solving

        cells * sum_h P(S_h >= h + x sqrt(h)) = false_alarms

    over the ladder h = 1, 2, 4, ..., ``n_harmonics``, where S_h, the sum
    of h powers of a plane normalised to mean 1, is Gamma(h, 1) under the
    null (each power chi^2(2)/2).  The sum over the rungs bounds the
    chance that a cell's best rung passes (a union bound), and the cells
    are counted as independent, which neighbouring templates, bins and DM
    trials are not: both err towards a higher threshold.  For a
    ~7.3e11-cell pointing and 0.01 false alarms it is near
    ln(cells / false_alarms) - 1."""
    if cells < 1 or false_alarms <= 0:
        raise ValueError(f"need cells >= 1 and false_alarms > 0, got "
                         f"{cells}, {false_alarms}")
    if n_harmonics < 1 or n_harmonics & (n_harmonics - 1):
        raise ValueError(
            f"n_harmonics must be a power of two, got {n_harmonics}")
    rungs = [2 ** i for i in range(n_harmonics.bit_length())]

    def log_tail(x: float) -> float:
        """ln of sum_h P(S_h >= h + x sqrt(h))."""
        logs = []
        for h in rungs:
            s = max(h + x * math.sqrt(h), 0.0)
            # P(Gamma(h, 1) >= s) = exp(-s) sum_{k<h} s^k / k!
            terms = [k * math.log(s) - math.lgamma(k + 1) if s > 0
                     else (0.0 if k == 0 else -math.inf) for k in range(h)]
            top = max(terms)
            logs.append(-s + top + math.log(sum(math.exp(v - top)
                                                for v in terms)))
        top = max(logs)
        return top + math.log(sum(math.exp(v - top) for v in logs))

    goal = math.log(false_alarms / cells)
    lo, hi = 0.0, 1.0
    while log_tail(hi) > goal:
        hi *= 2.0
    if log_tail(lo) <= goal:
        return lo
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if log_tail(mid) > goal else (lo, mid)
    return hi
