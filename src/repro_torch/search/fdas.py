"""Fourier-Domain Acceleration Search on the overlap-save engine.

The counterpart of ``repro.search.fdas``: the binary-pulsar search of
White, Adámek & Armour ("Cutting the cost of pulsar astronomy", 2022),
downstream of the paper's Sec. 5.3 pipeline.  A dedispersed time series is
FFT'd once (R2C), its complex half-spectrum is matched-filtered by a bank
of acceleration templates (:mod:`repro_torch.search.templates`), and
candidates are read off the (template, bin) power plane.

Execution path — every FFT pass runs a hand-written kernel on the card:

  series (batch, n) real
    │  R2C plan (fft_r2c, or the four-step pair past 2**14)
  spectrum (batch, n/2+1) complex
    │  overlap-save segments; the forward FFT carries the whole bank
    │  multiply as its epilogue (fft_c2c_mul); one batched inverse launch
    │  (fft_c2c) over the T product planes
  inverse segments (batch, nseg, T, nfft) complex
    │  the valid runs' |·|² / σ² written in place in one pass (the
    │  complex matched-filter plane is never assembled)
  power plane  ──  threshold + top-k  ──>  candidates

The reference jits ``fdas_search`` with the bank as a static argument;
the port runs it eagerly, and the bank stays hashable because the filter
spectra are cached on its ``key``.  Candidates come from ``torch.topk``,
which may order equal powers differently from ``lax.top_k``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.fft.convolve import (conv_plan, overlap_save_conv,
                                     overlap_save_segments, segments_power)
from repro_torch.fft.plan import plan_for_length
from repro_torch.fft.stockham import _as_tensor
from repro_torch.search.templates import TemplateBank


class Candidates(NamedTuple):
    """Top candidates per series, threshold applied.

    ``template``/``bin`` are -1 (and power 0) past the last candidate
    exceeding the threshold, so the tensors are fixed-shape.
    """

    template: torch.Tensor     # (batch, k) int32 — index into bank.drifts
    bin: torch.Tensor          # (batch, k) int32 — Fourier bin
    power: torch.Tensor        # (batch, k) f32 — normalised matched power


class FDASResult(NamedTuple):
    """Everything one search produced."""

    power: torch.Tensor        # (batch, T, nbins) normalised power plane
    candidates: Candidates
    sigma2: torch.Tensor       # (batch, 1, 1) spectrum noise power


def matched_filter_plane(spectrum, bank: TemplateBank, *,
                         nfft: int | None = None) -> torch.Tensor:
    """Correlate complex spectra (..., nbins) with every bank template.

    Returns (..., T, nbins): element [t, b] is the spectrum correlated
    against the drift-``bank.drifts[t]`` response centred on bin ``b``.
    The full-convolution offset of the matched taps is trimmed here, so
    bin indices line up with the input spectrum's.
    """
    nbins = spectrum.shape[-1]
    conv = overlap_save_conv(spectrum, bank.time_domain(), nfft=nfft,
                             cache_key=bank.key)
    return conv[..., bank.offset:bank.offset + nbins]


def power_plane(mf: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """Normalised matched-filter power: |y|² over the noise power.

    With unit-energy templates and a white spectrum of per-bin power
    ``sigma2``, the plane is ~chi²(2)/2 distributed under the null, so a
    threshold of ~6-8 is a few-sigma cut.
    """
    p = mf.real ** 2 + mf.imag ** 2
    return p / torch.clamp_min(sigma2, 1e-30)


def matched_filter_segments(spectrum, bank: TemplateBank, *,
                            nfft: int | None = None):
    """:func:`matched_filter_plane` before its valid runs are assembled:
    the overlap-save inverse planes and their plan
    (:func:`~repro_torch.fft.convolve.overlap_save_segments`), which
    :func:`segments_power_plane` turns into the power plane."""
    return overlap_save_segments(spectrum, bank.time_domain(), nfft=nfft,
                                 cache_key=bank.key)


def segments_power_plane(segments, bank: TemplateBank, nbins: int,
                         sigma2: torch.Tensor) -> torch.Tensor:
    """``power_plane(matched_filter_plane(...), sigma2)`` from
    :func:`matched_filter_segments`' planes, which it consumes: one pass
    from the segments' valid runs to the (..., T, nbins) power plane, the
    complex plane never assembled (at a survey's 2^22 bins and 85
    templates that plane is 2.85 GB a series).  Bit for bit the same."""
    y, plan = segments
    return segments_power(y, plan, bank.offset, nbins, sigma2)


def extract_candidates(power: torch.Tensor, *, threshold: float = 8.0,
                       max_candidates: int = 16) -> Candidates:
    """Threshold + top-k over the (..., T, nbins) plane; entries below the
    threshold are masked to (-1, -1, 0)."""
    t, nbins = power.shape[-2:]
    flat = power.reshape(*power.shape[:-2], t * nbins)
    k = min(max_candidates, t * nbins)
    vals, idx = torch.topk(flat, k, dim=-1)
    keep = vals >= threshold
    return Candidates(
        template=torch.where(keep, (idx // nbins).to(torch.int32), -1),
        bin=torch.where(keep, (idx % nbins).to(torch.int32), -1),
        power=torch.where(keep, vals, 0.0),
    )


def fdas_search(x, bank: TemplateBank, *, threshold: float = 8.0,
                max_candidates: int = 16,
                nfft: int | None = None) -> FDASResult:
    """End-to-end acceleration search on dedispersed series (batch, n).

    Chains R2C plan -> template convolution (fused multiply epilogue) ->
    normalised power -> candidate extraction.  ``nfft`` pins the
    overlap-save segment length (None = cost-model auto-selection); the
    serving layer keys its cache on it and on the bank.  Numpy input goes
    to the card.
    """
    x = torch.atleast_2d(_as_tensor(x))
    if x.is_complex():
        x = x.real
    x = x.to(torch.float32)
    n = x.shape[-1]
    # Mean-subtract so the DC bin carries no baseline power.
    x = x - x.mean(dim=-1, keepdim=True)
    spectrum = plan_for_length(n, "r2c")(x)
    # Noise power per bin (the DC bin is zero after mean subtraction).
    sigma2 = (spectrum.real ** 2 + spectrum.imag ** 2).mean(
        dim=-1, keepdim=True)[..., None]
    power = segments_power_plane(
        matched_filter_segments(spectrum, bank, nfft=nfft), bank,
        spectrum.shape[-1], sigma2)
    cands = extract_candidates(power, threshold=threshold,
                               max_candidates=max_candidates)
    return FDASResult(power=power, candidates=cands, sigma2=sigma2)


def fdas_conv_plan(n: int, bank: TemplateBank, nfft: int = 0):
    """The overlap-save plan a search over length-``n`` series executes
    (the convolution runs over the n//2+1-bin half-spectrum)."""
    return conv_plan(n // 2 + 1, bank.taps, bank.n_templates, nfft)


def serving_candidates(result: FDASResult) -> torch.Tensor:
    """Candidates packed as one (batch, k, 3) float32 tensor for receipts.

    Columns: template index, bin, normalised power (-1/-1/0 padding) — a
    plain tensor so the serving layer's per-request row slicing works
    unchanged.
    """
    c = result.candidates
    return torch.stack([c.template.to(torch.float32),
                        c.bin.to(torch.float32), c.power], dim=-1)
