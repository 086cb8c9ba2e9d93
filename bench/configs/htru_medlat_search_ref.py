"""Plain reference of the ``htru_medlat_search`` deployment: a copy of
the port's plain float64 search (``src/repro_torch/search/reference.py``,
which ``bench/tests`` holds it to), with the check's arithmetic and the
control below it.

A plain float64 pulsar search: the oracle of the blocked search.

The same search as :mod:`repro_torch.search.pipeline`, written with plain
``torch`` operations in float64 and imported from nothing of the port
(no kernel, plan, template bank or sift of ``repro_torch``, no JAX): a
fault in any of those shows against it.  Every function takes tensors on
any device and computes there.

  delay_table       a DM grid's trials and integer delays, from the
                    cold-plasma law and the band computed here
  dedisperse        shift and sum with the given integer delays, zero
                    past the end of the series
  spectrum          mean-subtracted R2C by ``torch.fft.rfft`` (an oracle)
  response          the template taps, from the chirp's DFT summed here
  matched_filter    a direct FFT convolution of the whole spectrum with
                    each template
  harmonic_sum      the doubling ladder, normalised, best rung kept
  sift              pool, DM-adjacency and harmonic dedupe, top-k
  trial_planes      one trial's (power, stat, level), templates in blocks
  search            a grid, in blocks of trials

Departures from the published FDAS (Ransom, Eigenbrode & Middleditch
2002, AJ 124, 1788), shared with the port:

* the response of drift z is the DFT of exp(i pi z tau^2) summed at
  ``oversample`` = 4096 points of tau in [0, 1), not the Fresnel-integral
  closed form (an error of order z^2 / oversample);
* templates are spaced one bin of drift apart and their window holds
  ``taps`` bins centred on the tone's starting bin; powers are read at
  integer bins only (no interbinning or Fourier interpolation);
* the spectrum is normalised by its mean power over every bin, not by a
  running median (the data are white);
* the harmonic sum adds the powers of bins j k, j <= h, along the same
  template's row (not the template of drift j z) on the doubling ladder
  h = 1, 2, 4, ..., and scores a cell (S_h - h) / sqrt(h), the Gaussian
  approximation of the Gamma(h, 1) sum, keeping the best rung;
* the sift is a top-``pool`` of the volume, deduped across ``dm_tol``
  neighbouring trials by bin adjacency or harmonic relation, then the
  top ``max_candidates`` above the threshold (no PRESTO ``sifting``).
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64
C128 = torch.complex128
#: Points of the chirp's DFT (the port's ``templates.DEFAULT_OVERSAMPLE``).
OVERSAMPLE = 4096
#: Templates convolved at once in :func:`trial_planes`.
TEMPLATE_BLOCK = 8
#: The dispersion constant e^2 / (2 pi m_e c), s MHz^2 pc^-1 cm^3
#: (Lorimer & Kramer 2005, eq. 4.7: 4.148808 ms GHz^2).
K_DM = 4.148808e3


def delay_table(f_lo: float, f_hi: float, nchan: int, tsamp: float,
                n_trials: int, dm_step_factor: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """((D,) float64 DMs, (D, C) int64 delays in samples) of a grid of
    ``n_trials`` DM trials over a band of ``nchan`` channels from ``f_hi``
    (channel 0) down to ``f_lo`` MHz, evenly spaced, sampled every
    ``tsamp`` s.  Trial i is at i x ``dm_step_factor`` x the DM whose
    delay across the band is one sample; channel c's delay is the
    cold-plasma law's K_DM DM (f_c^-2 - f_hi^-2) s, rounded to the
    nearest sample (half to even)."""
    c = torch.arange(nchan, dtype=F64)
    f = f_hi - (f_hi - f_lo) * c / (nchan - 1)
    one_sample = tsamp / (K_DM * (f_lo ** -2 - f_hi ** -2))
    dms = torch.arange(n_trials, dtype=F64) * (dm_step_factor * one_sample)
    seconds = K_DM * dms[:, None] * (f ** -2 - f_hi ** -2)
    return dms, torch.round(seconds / tsamp).to(torch.int64)


def dedisperse(fb: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """(batch, C, N) filterbanks, (D, C) integer delays -> (batch, D, N)
    float64: out[b, d, t] = sum_c fb[b, c, t + delays[d, c]], 0 past N,
    the channels added in index order."""
    batch, nchan, n = fb.shape
    delays = delays.to("cpu", torch.int64)
    out = torch.zeros(batch, delays.shape[0], n, dtype=F64, device=fb.device)
    for d in range(delays.shape[0]):
        row = out[:, d]
        for c in range(nchan):
            k = int(delays[d, c])
            row[:, :n - k] += fb[:, c, k:].to(F64)
    return out


def spectrum(series: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) series -> ((..., N/2+1) complex128 spectrum of the
    mean-subtracted series, (..., 1) mean power a bin)."""
    x = series.to(F64)
    spec = torch.fft.rfft(x - x.mean(dim=-1, keepdim=True), dim=-1)
    return spec, (spec.abs() ** 2).mean(dim=-1, keepdim=True)


def response(z: float, taps: int, oversample: int = OVERSAMPLE,
             device=None) -> torch.Tensor:
    """(taps,) complex128 response of a tone drifting ``z`` bins, on the
    centred window u = -taps//2, ..., taps - 1 - taps//2:

        t_z[u] = (1/M) sum_{m<M} exp(i pi z (m/M)^2) exp(-2 pi i u m / M)

    summed directly (M = ``oversample``)."""
    tau = torch.arange(oversample, dtype=F64, device=device) / oversample
    u = torch.arange(taps, dtype=F64, device=device) - taps // 2
    phase = math.pi * z * tau ** 2 - 2 * math.pi * u[:, None] * tau
    return torch.polar(torch.ones_like(phase), phase).mean(dim=-1)


def matched_filter(spec: torch.Tensor, drifts, taps: int) -> torch.Tensor:
    """(..., nbins) spectrum -> (..., T, nbins) correlation with each
    drift's unit-energy response:

        y[t, b] = sum_u X[b + u] conj(t_z[u]) / ||t_z||, X = 0 off [0, nbins)

    by one FFT convolution of the whole spectrum with each template."""
    nbins = spec.shape[-1]
    size = 1 << (nbins + taps - 2).bit_length()      # >= nbins + taps - 1
    fx = torch.fft.fft(spec.to(C128), n=size, dim=-1)
    out = []
    for z in drifts:
        t = response(float(z), taps, device=spec.device)
        h = torch.flip(t.conj(), (0,)) / torch.linalg.vector_norm(t)
        full = torch.fft.ifft(fx * torch.fft.fft(h, n=size), dim=-1)
        first = taps - 1 - taps // 2
        out.append(full[..., first:first + nbins])
    return torch.stack(out, dim=-2)


def harmonic_sum(power: torch.Tensor, n_harmonics: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) power -> ((..., N) best (S_h - h)/sqrt(h) over h = 1, 2,
    4, ..., n_harmonics, (..., N) int32 log2 of its h, the earliest on a
    tie), S_h[k] = sum_{j<=h} P[j k], P = 0 past N."""
    n = power.shape[-1]
    k = torch.arange(n, device=power.device)
    total = torch.zeros_like(power, dtype=F64)
    best = level = None
    h_done = 0
    for rung in range(int(math.log2(n_harmonics)) + 1):
        h = 2 ** rung
        for j in range(h_done + 1, h + 1):
            idx = j * k
            inside = idx < n
            total[..., inside] += power[..., idx[inside]].to(F64)
        h_done = h
        z = (total - h) / math.sqrt(h)
        if best is None:
            best, level = z, torch.zeros_like(z, dtype=torch.int32)
        else:
            better = z > best
            best = torch.where(better, z, best)
            level = torch.where(better, rung, level)
    return best, level


def trial_planes(fb: torch.Tensor, delays: torch.Tensor, drifts, taps: int,
                 n_harmonics: int, template_block: int = TEMPLATE_BLOCK):
    """One trial's (power, stat, level), each (batch, T, nbins) (float64,
    float64, int32), for (batch, C, N) filterbanks and its (C,) delays;
    the templates ``template_block`` at a time."""
    spec, sigma2 = spectrum(dedisperse(fb, delays[None])[:, 0])
    powers = []
    for i in range(0, len(drifts), template_block):
        y = matched_filter(spec, drifts[i:i + template_block], taps)
        powers.append(y.abs() ** 2 / sigma2[:, None])
        del y
    power = torch.cat(powers, dim=-2)
    del powers
    stat, level = harmonic_sum(power, n_harmonics)
    return power, stat, level


def sift(stat: torch.Tensor, level: torch.Tensor, *, first: int = 0,
         threshold: float = 25.0, max_candidates: int = 16, pool: int = 64,
         dm_tol: int = 1, bin_tol: int = 1, max_harmonic: int = 8) -> list:
    """The candidates of a (D, T, N) statistic volume whose first trial is
    trial ``first`` of the grid: [(dm, template, bin, level, stat)] by
    falling statistic.  The top ``pool`` cells; a cell above the
    threshold absorbs each weaker one within ``dm_tol`` trials whose bin
    is within ``bin_tol`` of its own or of a multiple m <= ``max_harmonic``
    of it (m ``bin_tol`` for the multiple), or whose bin's multiple is
    within m ``bin_tol`` of its own (a tie goes to the lower flat index);
    the top ``max_candidates`` survivors above the threshold."""
    d, t, nb = stat.shape
    vals, idx = torch.topk(stat.reshape(-1), min(pool, stat.numel()))
    lev = level.reshape(-1)[idx]
    cells = [(float(v), int(i), int(lv)) for v, i, lv in
             zip(vals.cpu(), idx.cpu(), lev.cpu())]
    return sift_cells(cells, (t, nb), first=first, threshold=threshold,
                      max_candidates=max_candidates, dm_tol=dm_tol,
                      bin_tol=bin_tol, max_harmonic=max_harmonic)


def sift_cells(cells: list, plane: tuple[int, int], *, first: int = 0,
               threshold: float = 25.0, max_candidates: int = 16,
               dm_tol: int = 1, bin_tol: int = 1,
               max_harmonic: int = 8) -> list:
    """:func:`sift`'s dedupe and top-k on pooled (stat, flat index, level)
    cells of a volume of ``plane`` = (T, N) planes."""
    t, nb = plane
    # By falling statistic, a tie to the lower flat index: the cells
    # stronger than a cell are those before it.
    ranked = sorted(cells, key=lambda c: (-c[0], c[1]))
    out = []
    for p, (v, i, lv) in enumerate(ranked):
        if v < threshold:
            break
        dm, tb = divmod(i, t * nb)
        absorbed = False
        for _, j, _ in ranked[:p]:
            if abs(j // (t * nb) - dm) > dm_tol:
                continue
            bj = j % nb
            if any(abs(tb % nb - m * bj) <= m * bin_tol
                   or abs(bj - m * (tb % nb)) <= m * bin_tol
                   for m in range(1, max_harmonic + 1)):
                absorbed = True
                break
        if not absorbed:
            out.append((dm + first, tb // nb, tb % nb, lv, v))
    out.sort(key=lambda c: -c[4])
    return out[:max_candidates]


def search(fb: torch.Tensor, delays: torch.Tensor, drifts, taps: int, *,
           n_harmonics: int = 8, threshold: float = 25.0,
           max_candidates: int = 16, pool: int = 64, block: int = 8):
    """Search (batch, C, N) filterbanks over a (D, C) delay grid, ``block``
    trials at a time: ((batch, D, T, nbins) power, stat, level and the
    candidates of each filterbank, as :func:`sift` gives them)."""
    planes = ([], [], [])
    for lo in range(0, delays.shape[0], block):
        trials = [trial_planes(fb, delays[d], drifts, taps, n_harmonics)
                  for d in range(lo, min(lo + block, delays.shape[0]))]
        for j, part in enumerate(planes):
            part.append(torch.stack([tr[j] for tr in trials], dim=1))
    power, stat, level = (torch.cat(p, dim=1) for p in planes)
    candidates = [sift(stat[b], level[b], threshold=threshold,
                       max_candidates=max_candidates, pool=pool,
                       max_harmonic=n_harmonics)
                  for b in range(fb.shape[0])]
    return power, stat, level, candidates

# ---------------------------------------------------------------------------
# the benchmark's check and its control
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def plane_errors(planes, ref) -> tuple[float, float, int]:
    """(max |power - ref power|, max |stat - ref stat|, cells whose level
    differs) of one trial's (power, stat, level) against the reference's;
    the power and statistic are in noise units already (the power plane
    is normalised to a mean of 1)."""
    power, stat, level = planes
    return ((power.to(F64) - ref[0]).abs().max().item(),
            (stat.to(F64) - ref[1]).abs().max().item(),
            int((level != ref[2]).sum()))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).to(t.dtype)


def control_planes(fb: torch.Tensor, delays: torch.Tensor, drifts,
                   taps: int, n_harmonics: int):
    """One trial's planes at the next precision below the configuration's
    float32: the filterbank's samples and the series, the spectrum and
    the power rounded to bfloat16 where each is made, the statistic and
    the power returned in bfloat16's precision (float32), the arithmetic
    between in float64."""
    nchan, n = fb.shape[-2:]
    delays = delays.to("cpu", torch.int64)
    series = torch.zeros(fb.shape[0], n, dtype=F64, device=fb.device)
    for c in range(nchan):
        k = int(delays[c])
        series[:, :n - k] += _bf16(fb[:, c, k:]).to(F64)
    spec, sigma2 = spectrum(_bf16(series))
    spec = torch.complex(_bf16(spec.real), _bf16(spec.imag))
    powers = []
    for i in range(0, len(drifts), TEMPLATE_BLOCK):
        y = matched_filter(spec, drifts[i:i + TEMPLATE_BLOCK], taps)
        powers.append(_bf16(y.abs() ** 2 / sigma2[:, None]))
        del y
    power = torch.cat(powers, dim=-2)
    stat, level = harmonic_sum(power, n_harmonics)
    return (power.to(torch.float32), _bf16(stat).to(torch.float32), level)
