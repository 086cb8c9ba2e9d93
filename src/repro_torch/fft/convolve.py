"""Batched overlap-save segmented FFT convolution engine.

The counterpart of ``repro.fft.convolve``.  Long-signal convolution
against a bank of T short filters dominates Fourier-domain acceleration
searches (White, Adámek & Armour 2022): every dedispersed spectrum is
matched-filtered by every acceleration template.  **Overlap-save** splits
the signal into length-``nfft`` segments that overlap by ``taps - 1``
points, convolves each segment circularly in the Fourier domain, and
discards the wrapped prefix of every segment.

Three cost levers, as in the reference:

* **Segment-length auto-selection** (:func:`select_nfft`): the same cost
  model, so the port picks the same segment as the reference.
* **Cached filter spectra**: the bank's zero-padded forward FFTs are
  computed on the host with numpy (complex128) and memoised per
  (bank key, nfft), exactly as the reference does; the port also keeps
  the complex64 copy on the device per (bank key, nfft, device), like the
  Bluestein chirp cache, so a serving process copies each bank once.
* **Fused multiply epilogue**: the forward segment FFT routes through
  :func:`repro_torch.fft.plan.fft_mul`, which applies the whole (T, nfft)
  bank inside the forward kernel (``fft_c2c_mul``).  The matched-filter
  plane costs one forward pass plus ONE batched inverse launch over the T
  product planes, with no standalone multiply pass.

The segments are a ``Tensor.unfold`` window view of the front-padded
signal (the reference gathers ``xp[..., idx]``); the kernel wrapper makes
it contiguous.  ``conv_plan`` exposes the pass/traffic accounting that
``core.workloads.conv_workload`` consumes; with ``nfft=0`` it takes a
segment the autotuner chose (``repro_torch.tune.tune_segment``) before
the cost model's.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.fft.radix import (DEFAULT_RADICES, is_pow2,
                                   mixed_radix_flop_count, next_pow2)
from repro_torch.fft.stockham import _as_complex
from repro_torch.tune.context import plan_config

#: Complex bytes per point at the engine's working precision (complex64).
_ELEM = 8

#: Flop-equivalent weight of one complex point of HBM traffic in the
#: segment-selection cost (the engine is memory-bound, paper Sec. 5).
_MEM_WEIGHT = 16.0


# ---------------------------------------------------------------------------
# Segment-length selection (cost model)
# ---------------------------------------------------------------------------

def _segment_cost(nfft: int, taps: int, templates: int,
                  radices: tuple[int, ...]) -> float:
    """Modelled cost per valid output point of one overlap-save segment:
    one forward FFT feeding all T filters, then each filter's inverse FFT
    and 6-flop/point multiply, plus the forward read, the T-plane product
    write and the inverse read+write (``_MEM_WEIGHT`` flops a point)."""
    step = nfft - taps + 1
    flops = ((1 + templates) * mixed_radix_flop_count(nfft, radices)
             + 6.0 * templates * nfft)
    traffic_pts = nfft * (1.0 + 3.0 * templates)
    return (flops + _MEM_WEIGHT * traffic_pts) / step


@functools.lru_cache(maxsize=None)
def select_nfft(taps: int, n: int, templates: int = 1,
                radices: tuple[int, ...] = DEFAULT_RADICES) -> int:
    """Pick the pow2 segment length minimising modelled cost per output.

    Candidates run from the smallest segment with a useful valid region
    (``2 * taps`` rounded up) to one covering the whole padded signal,
    capped at the single-pass kernel's length when the filter allows it.
    """
    from repro_torch.fft.plan import MAX_KERNEL_N  # lazy: import cycle

    if taps < 1:
        raise ValueError(f"filter length must be >= 1, got {taps}")
    if n < 1:
        raise ValueError(f"signal length must be >= 1, got {n}")
    lo = next_pow2(max(2 * taps, 16))
    hi = max(lo, next_pow2(n + taps - 1))
    if lo <= MAX_KERNEL_N:
        # Prefer segments the fused multiply-epilogue kernel can serve;
        # only filters too long for any single-pass segment go beyond.
        hi = min(hi, MAX_KERNEL_N)
    best, best_cost = lo, float("inf")
    nfft = lo
    while nfft <= hi:
        cost = _segment_cost(nfft, taps, templates, radices)
        if cost < best_cost:
            best, best_cost = nfft, cost
        nfft *= 2
    return best


# ---------------------------------------------------------------------------
# Plan: segmentation + pass/traffic accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Accounting for one (signal length, filter bank) overlap-save plan.

    ``forward_passes``/``inverse_passes`` count HBM round trips of the
    segment batch: the fused multiply epilogue keeps the forward side at
    ONE pass regardless of T, and each template's plane pays one inverse
    pass.  ``traffic_ratio`` is direct-method bytes over overlap-save
    bytes.
    """

    n: int                      # input points per row
    taps: int                   # filter length
    templates: int              # bank size T
    nfft: int                   # segment FFT length (pow2)
    step: int                   # valid output points per segment
    n_segments: int
    out_len: int                # full linear convolution length
    forward_passes: int         # 1: fused FFT + T-filter multiply epilogue
    inverse_passes: int         # T: one inverse pass per template plane
    os_bytes: float             # overlap-save HBM bytes per row
    direct_bytes: float         # pad-to-full-length method, per row
    fused: bool = True          # segment fits the multiply-epilogue kernel

    @property
    def traffic_ratio(self) -> float:
        return self.direct_bytes / self.os_bytes

    @property
    def passes_per_template(self) -> float:
        """Amortised kernel passes each template costs (forward shared)."""
        return self.inverse_passes / self.templates + (
            self.forward_passes / self.templates)


def conv_plan(n: int, taps: int, templates: int = 1, nfft: int = 0,
              radices: tuple[int, ...] = DEFAULT_RADICES) -> ConvPlan:
    """Build (or return the memoised) overlap-save plan.

    ``nfft=0`` defers the segment length to the active tuning context
    (``repro_torch.tune``: key ``(device, (n, taps, templates), "conv")``)
    and falls back to the :func:`select_nfft` cost model when the key is
    untuned, its segment is no power of two at least ``taps`` long, or
    tuning is disabled.  An explicit ``nfft`` must be a power of two no
    shorter than the filter.
    """
    if nfft == 0:
        cfg = plan_config((n, taps, templates), "conv")
        if (cfg is not None and cfg.segment and is_pow2(cfg.segment)
                and cfg.segment >= taps):
            nfft = cfg.segment
    return _conv_plan(n, taps, templates, nfft, radices)


@functools.lru_cache(maxsize=None)
def _conv_plan(n: int, taps: int, templates: int, nfft: int,
               radices: tuple[int, ...]) -> ConvPlan:
    from repro_torch.fft.plan import (MAX_KERNEL_N,  # lazy: import cycle
                                      plan_for_length)

    if templates < 1:
        raise ValueError(f"filter bank needs >= 1 filters, got {templates}")
    if nfft == 0:
        nfft = select_nfft(taps, n, templates, radices)
    if not is_pow2(nfft):
        raise ValueError(f"segment length must be a power of two, got {nfft}")
    if nfft < taps:
        raise ValueError(
            f"filter ({taps} taps) is longer than the segment (nfft={nfft}); "
            "overlap-save needs nfft >= taps (pass nfft=0 to auto-select)")
    step = nfft - taps + 1
    out_len = n + taps - 1
    n_segments = max(math.ceil(out_len / step), 1)
    t = templates
    seg_pts = n_segments * nfft

    # Segments beyond the single-pass kernel limit cannot fuse the bank
    # multiply (plan.fft_mul runs the routed FFT + one torch multiply), so
    # the accounting charges the plan that actually executes.
    fused = nfft <= MAX_KERNEL_N
    seg_passes = plan_for_length(nfft).passes    # 1 in the fused regime
    if fused:
        forward_passes, inverse_passes = 1, t
        # Fused forward pass (read segments, write the T-plane product),
        # T inverse passes (read+write), and the assemble/trim pass.
        os_bytes = _ELEM * (seg_pts * (1 + t)
                            + 2.0 * t * seg_pts
                            + t * seg_pts + t * out_len)
    else:
        forward_passes = seg_passes + 1          # + standalone multiply
        inverse_passes = t * seg_passes
        os_bytes = _ELEM * (2.0 * seg_pts * seg_passes
                            + seg_pts * (1 + t)  # standalone multiply pass
                            + 2.0 * t * seg_pts * seg_passes
                            + t * seg_pts + t * out_len)

    # Direct method: pad to the full pow2 length M, forward FFT, a
    # STANDALONE multiply pass per bank, T inverse FFTs, trim.
    m = next_pow2(out_len)
    m_passes = plan_for_length(m).passes
    direct_bytes = _ELEM * (2.0 * m * m_passes     # forward FFT passes
                            + m * (1 + t)          # standalone multiply
                            + 2.0 * t * m * m_passes   # inverse FFT passes
                            + t * m + t * out_len)     # trim
    return ConvPlan(n=n, taps=taps, templates=t, nfft=nfft, step=step,
                    n_segments=n_segments, out_len=out_len,
                    forward_passes=forward_passes,
                    inverse_passes=inverse_passes,
                    os_bytes=os_bytes, direct_bytes=direct_bytes,
                    fused=fused)


# ---------------------------------------------------------------------------
# Filter-spectrum cache (the Bluestein pattern, per bank)
# ---------------------------------------------------------------------------

_SPECTRA_CACHE: dict[tuple, np.ndarray] = {}
_SPECTRA_BUILDS = 0            # test hook: numpy FFTs actually executed
_DEVICE_SPECTRA: dict[tuple, torch.Tensor] = {}


def cached_filter_spectra(key, filters: np.ndarray, nfft: int) -> np.ndarray:
    """(T, nfft) forward spectra of a zero-padded bank, memoised per key.

    ``key`` must uniquely identify the bank's *values* (e.g. the template
    bank's defining parameters) — the cache never hashes array contents.
    Computed on the host with numpy (complex128), as the reference does.
    """
    global _SPECTRA_BUILDS
    cache_key = (key, int(nfft))
    hit = _SPECTRA_CACHE.get(cache_key)
    if hit is not None:
        return hit
    spectra = _bank_spectra(np.asarray(filters), nfft)
    _SPECTRA_BUILDS += 1
    _SPECTRA_CACHE[cache_key] = spectra
    return spectra


def device_filter_spectra(key, filters: np.ndarray, nfft: int,
                          device: torch.device) -> torch.Tensor:
    """:func:`cached_filter_spectra` as a complex64 tensor on ``device``,
    copied there once per (key, nfft, device)."""
    cache_key = (key, int(nfft), torch.device(device))
    hit = _DEVICE_SPECTRA.get(cache_key)
    if hit is None:
        hit = torch.from_numpy(cached_filter_spectra(key, filters, nfft)).to(
            device=device, dtype=torch.complex64)
        _DEVICE_SPECTRA[cache_key] = hit
    return hit


def _bank_spectra(filters: np.ndarray, nfft: int) -> np.ndarray:
    filters = np.atleast_2d(filters)
    t, taps = filters.shape
    if taps > nfft:
        raise ValueError(
            f"filter ({taps} taps) is longer than the segment (nfft={nfft})")
    padded = np.zeros((t, nfft), np.complex128)
    padded[:, :taps] = filters
    return np.fft.fft(padded, axis=-1)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def overlap_save_segments(x, filters, *, nfft: int | None = None,
                          cache_key=None) -> tuple[torch.Tensor, ConvPlan]:
    """The inverse planes of an overlap-save convolution, before the
    valid runs are assembled: ((..., nseg, T, nfft) complex64, the plan).

    Point ``taps - 1 + j`` of segment ``s`` in template ``t``'s plane is
    point ``s * step + j`` of the full convolution with filter ``t``
    (``0 <= j < step``); the points before it are the wrapped prefix.
    ``x``, ``filters``, ``nfft`` and ``cache_key`` are
    :func:`overlap_save_conv`'s.
    """
    from repro_torch.fft import plan as _plan_mod  # lazy: import cycle

    x = _as_complex(x)
    filters_np = np.atleast_2d(np.asarray(filters))
    t, taps = filters_np.shape
    n = x.shape[-1]
    plan = conv_plan(n, taps, t, 0 if nfft is None else int(nfft))
    nfft, step, nseg = plan.nfft, plan.step, plan.n_segments

    if cache_key is not None:
        bank = device_filter_spectra(cache_key, filters_np, nfft, x.device)
    else:
        bank = torch.from_numpy(_bank_spectra(filters_np, nfft)).to(
            device=x.device, dtype=torch.complex64)

    # Segment the (taps-1)-front-padded signal into overlapping windows.
    pad_front = taps - 1
    total = (nseg - 1) * step + nfft
    xp = torch.nn.functional.pad(x, (pad_front, total - pad_front - n))
    segs = xp.unfold(-1, nfft, step)                 # (..., nseg, nfft)

    # Forward FFT + fused bank multiply: one pass, T product planes.
    prod = _plan_mod.fft_mul(segs, bank)             # (..., nseg, T, nfft)
    # One batched inverse launch over all T planes, in place (at a
    # survey's 2^22 bins and 85 templates the planes hold 3 GB a series).
    return _plan_mod.pow2_fft(prod, inverse=True, out=prod), plan


def overlap_save_conv(x, filters, *, nfft: int | None = None,
                      cache_key=None) -> torch.Tensor:
    """Full linear convolution of each row with a T-filter bank.

    ``x`` is (..., n) real or complex (numpy input goes to the card);
    ``filters`` is a (T, taps) (or (taps,)) host-side array of
    time-domain taps.  Returns the full convolution, shape
    (..., T, n + taps - 1) — row r of the output block equals
    ``numpy.convolve(x, filters[r])``.

    The forward segment FFT carries the whole bank multiply as a fused
    kernel epilogue (:func:`repro_torch.fft.plan.fft_mul`), the T product
    planes share one batched inverse launch, and the filter spectra are
    cached per (``cache_key``, nfft) when a key is given.
    """
    y, plan = overlap_save_segments(x, filters, nfft=nfft,
                                    cache_key=cache_key)
    # Discard each segment's wrapped prefix, assemble the valid runs.
    valid = y[..., plan.taps - 1:].movedim(-3, -2)   # (..., T, nseg, step)
    out = valid.reshape(*valid.shape[:-2], plan.n_segments * plan.step)
    return out[..., :plan.out_len]


def segments_power(y: torch.Tensor, plan: ConvPlan, first: int,
                   length: int, scale: torch.Tensor) -> torch.Tensor:
    """|conv[..., first:first + length]|^2 / scale, (..., T, length)
    float32, from :func:`overlap_save_segments`' planes ``y``, which it
    consumes (their valid points are squared in place).

    One pass from the segments to the result: each point's squares are
    added straight into its place in the output, with no assembled
    complex plane between.  The values are those of
    ``(c.real ** 2 + c.imag ** 2) / scale`` on the assembled convolution
    ``c``, bit for bit.  ``scale`` broadcasts against (..., 1, 1).
    """
    *lead, nseg, t, _ = y.shape
    step = plan.step
    if not 0 <= first <= first + length <= nseg * step:
        raise ValueError(f"points [{first}, {first + length}) lie outside "
                         f"the {nseg * step} the segments hold")
    sq = torch.view_as_real(y)[..., plan.taps - 1:, :]
    sq.square_()
    sq = sq.movedim(-4, -3)                  # (..., T, nseg, step, 2)
    out = torch.empty((*lead, t, length), dtype=torch.float32,
                      device=y.device)
    # Segment s covers outputs [s * step - first, (s + 1) * step - first):
    # the whole segments in one strided add, the partial ends apart.
    lo = -(-first // step)                   # first whole segment
    hi = max((first + length) // step, lo)   # past the last whole one
    if hi > lo:
        rows = out.as_strided(
            (*lead, t, hi - lo, step), (*out.stride()[:-1], step, 1),
            out.storage_offset() + lo * step - first)
        part = sq[..., lo:hi, :, :]
        torch.add(part[..., 0], part[..., 1], out=rows)
    for s in (lo - 1, hi):
        a = max(s * step - first, 0)
        b = min((s + 1) * step - first, length)
        if s < 0 or s >= nseg or b <= a:
            continue
        j = a + first - s * step
        part = sq[..., s, j:j + b - a, :]
        torch.add(part[..., 0], part[..., 1], out=out[..., a:b])
    out /= torch.clamp_min(scale, 1e-30)
    return out
