"""Candidate sifting/clustering — the pipeline's last stage (the
counterpart of ``repro.search.sift``).

The raw detection-statistic volume (dm, template, bin) fires a cloud of
cells around every real pulsar: neighbouring DM trials share most of the
signal, neighbouring bins catch spectral leakage, and the harmonic
ladder lights multiples of the spin frequency.  Sifting collapses each
cloud to its strongest cell:

  1. pool the top-``pool`` cells of the volume (one ``torch.topk``),
  2. suppress any pooled cell that a *stronger* cell within ``dm_tol``
     DM trials dominates — either bin-adjacent (|Δbin| <= bin_tol) or
     harmonically related (bin_j ~ m * bin_i up to ``max_harmonic``),
  3. keep the top-``max_candidates`` survivors above ``threshold``.

Everything is fixed-shape; padding entries are (-1, -1, -1, -1, 0) like
:class:`repro_torch.search.fdas.Candidates`.  ``torch.topk`` may order
equal statistics differently from ``lax.top_k``; a tie between pooled
cells is broken by the lower flat index, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


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
    near ln(cells) ~ 14 and 25 leaves a wide false-positive margin.
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
    m = d * t * nb
    batch = math.prod(lead)
    s = stat.reshape(batch, m)
    lv = level.reshape(batch, m)

    p = min(pool, m)
    vals, idx = torch.topk(s, p, dim=-1)                 # (batch, p)
    dmi = (idx // (t * nb)).to(torch.int32)
    ti = ((idx // nb) % t).to(torch.int32)
    bi = (idx % nb).to(torch.int32)
    lev = torch.gather(lv, -1, idx).to(torch.int32)
    above = vals >= threshold

    # Pairwise (batch, i, j): does pooled cell i dominate and absorb j?
    vi, vj = vals[:, :, None], vals[:, None, :]
    stronger = (vi > vj) | ((vi == vj) & (idx[:, :, None] < idx[:, None, :]))
    close_dm = (dmi[:, :, None] - dmi[:, None, :]).abs() <= dm_tol
    # m = 1 is bin adjacency.
    ms = torch.arange(1, max_harmonic + 1, device=stat.device)
    bi_i = bi[:, :, None, None]
    bi_j = bi[:, None, :, None]
    related = (((bi_j - ms * bi_i).abs() <= ms * bin_tol)
               | ((bi_i - ms * bi_j).abs() <= ms * bin_tol)).any(dim=-1)
    absorbed = (stronger & close_dm & related
                & above[:, :, None]).any(dim=-2)         # any i absorbs j
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
