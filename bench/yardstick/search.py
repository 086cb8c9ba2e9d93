"""The search cells' yardstick: the work of a block of DM trials and the
readings of its spans.

A unit of kind ``search`` is one dedispersion block: ``rows`` DM trials
of ``n`` samples.  The work is counted from the configuration's shapes
(channels, templates, the overlap-save segment), never from the
program's ledger: each stage's input read once and its output written
once at 3.35 TB/s, and the dedispersion's adds (one a channel, trial and
sample) at 33.5e12 a second (132 SMs x 128 lanes x 1.98 GHz; float32
adds, no FMA to pair them), whichever binds.

  dedisperse      reads the (C, N) filterbank, writes d series; d C N adds
  r2c             reads d series, writes d spectra of N/2 + 1 bins
  matched_filter  reads d spectra, writes d (T, N/2 + 1) complex planes
                  (the inverse segments' valid points, left in place)
  power           reads those points, writes d float32 planes
  harmonic_sum    reads the power, writes the statistic and the level
  sift            reads the statistic

The port's kernels by name in the trace, each with its own work:
``dedisperse`` as its stage; ``fft_c2c_mul`` the forward segments, the
bank and the products of the matched filter (S segments of L points a
trial, the configuration's ``nfft``); ``fft_c2c`` their inverse, one
C2C of L points a segment and template; the four-step pair
(``fft_c2c_axis1`` and ``fft_c2c_t``, their times summed) one C2C of
N/2 points a trial; ``fft_r2c_split`` reads N/2 complex points and
writes N/2 + 1 a trial; ``harmonic_sum_plane`` as its stage.

The program's spans (``search.block`` and its ``search.*`` stages) are
read from the profiler session as ``spans.py`` reads the FFT plan's;
where they open and close is part of this yardstick.
"""
from __future__ import annotations

import math

from bench.yardstick.roofline import (COMPLEX64, FLOAT32, HBM_BYTES_PER_S,
                                      bound_s, fft_work)
from bench.yardstick.trace import port_kernel, traced_units

KIND = "search"
BLOCK = "search.block"
STAGE = "search."
#: float32 adds a second: 132 SMs x 128 lanes x 1.98 GHz.
ADDS_PER_S = 33.5e12
#: The four-step pair of the long R2C, read as one kernel.
FOUR_STEP = "fft_c2c_axis1+fft_c2c_t"
KERNELS = {"dedisperse_kernel": "dedisperse",
           "fft_c2c_mul_kernel": "fft_c2c_mul",
           "fft_c2c_regs_kernel": "fft_c2c",
           "fft_c2c_axis1_regs_kernel": FOUR_STEP,
           "fft_c2c_t_regs_kernel": FOUR_STEP,
           "fft_r2c_split_kernel": "fft_r2c_split",
           "harmonic_sum_plane_kernel": "harmonic_sum_plane"}


def shapes(cfg: dict) -> dict:
    """The configuration's channels, samples, bins, templates, taps and
    overlap-save segment (points, valid points, segments)."""
    a = cfg["assumed"]
    n = cfg["ntime"]
    nbins = n // 2 + 1
    nfft, taps = a["nfft"], a["taps"]
    step = nfft - taps + 1
    return {"nchan": cfg["nchan"], "n": n, "nbins": nbins,
            "templates": a["templates"], "nfft": nfft,
            "segments": math.ceil((nbins + taps - 1) / step)}


def _dedisperse(cfg: dict, trials: int) -> tuple[float, str]:
    """Least seconds of a block's dedispersion, and which bound binds."""
    s = shapes(cfg)
    t_bytes = FLOAT32 * s["n"] * (s["nchan"] + trials) / HBM_BYTES_PER_S
    t_adds = trials * s["nchan"] * s["n"] / ADDS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_adds else (t_adds, "operations")


def stage_bounds(cfg: dict, trials: int) -> dict[str, float]:
    """Least seconds of each stage of a block of ``trials`` trials."""
    s = shapes(cfg)
    n, nb = s["n"], s["nbins"]
    cells = trials * s["templates"] * nb
    hbm = lambda nbytes: nbytes / HBM_BYTES_PER_S  # noqa: E731
    return {
        "dedisperse": _dedisperse(cfg, trials)[0],
        "r2c": hbm(trials * (FLOAT32 * n + COMPLEX64 * nb)),
        "matched_filter": hbm(COMPLEX64 * (trials * nb + cells)),
        "power": hbm((COMPLEX64 + FLOAT32) * cells),
        "harmonic_sum": hbm(3 * FLOAT32 * cells),
        "sift": hbm(FLOAT32 * cells),
    }


def kernel_bounds(cfg: dict, trials: int) -> dict[str, float]:
    """Least seconds of each port kernel's work in a block of ``trials``
    trials."""
    s = shapes(cfg)
    n, t = s["n"], s["templates"]
    nfft, segs = s["nfft"], trials * s["segments"]
    stages = stage_bounds(cfg, trials)
    return {
        "dedisperse": stages["dedisperse"],
        "fft_c2c_mul": bound_s(COMPLEX64 * nfft * (segs + t + segs * t),
                               segs * nfft * (5.0 * math.log2(nfft)
                                              + 6.0 * t))[0],
        "fft_c2c": bound_s(*fft_work("c2c", nfft, segs * t))[0],
        FOUR_STEP: bound_s(*fft_work("c2c", n // 2, trials))[0],
        "fft_r2c_split": (trials * COMPLEX64 * (n // 2 + s["nbins"])
                          / HBM_BYTES_PER_S),
        "harmonic_sum_plane": stages["harmonic_sum"],
    }


def search_roofline(trace, cfg: dict):
    """The traced blocks' summed least time over all the device time of
    the traced sub-window [%], with the same share for each port kernel
    (its least work over its device time) and which bound binds the
    dedispersion."""
    units = traced_units(trace, (KIND,))
    device = trace.device_s() if units else 0.0
    if device <= 0:
        return None
    least = sum(sum(stage_bounds(cfg, u.rows).values()) for u in units)
    spent: dict[str, float] = {}
    for name, a, b in trace.device:
        kernel = KERNELS.get(port_kernel(name) or "")
        if kernel is not None:
            spent[kernel] = spent.get(kernel, 0.0) + (b - a)
    bounds: dict[str, float] = {}
    for u in units:
        for k, v in kernel_bounds(cfg, u.rows).items():
            bounds[k] = bounds.get(k, 0.0) + v
    by_kernel = {k: 100.0 * bounds[k] / spent[k]
                 for k in sorted(spent) if spent[k] > 0}
    return 100.0 * least / device, {
        "by_kernel": by_kernel, "blocks": len(units),
        "least_ms_a_block": 1e3 * least / len(units),
        "device_ms_a_block": 1e3 * device / len(units),
        "dedisperse_binds": _dedisperse(cfg, units[0].rows)[1]}


def _stage(name: str) -> bool:
    return name.startswith(STAGE) and name != BLOCK


def search_stage_ms(sess, run):
    """Device ms a block in the program's ``search.block`` spans, with each
    stage span's ms a block, the block's ms outside every stage
    (``unattributed_ms``), and the real-time margin: the pointing's
    seconds of sky over the grid's seconds on the card at this rate."""
    blocks = ([n for n in sess.walk(lambda n: n.name == BLOCK)
               if n.name == BLOCK] if sess is not None else [])
    timed = [b for b in blocks if b.device_s is not None]
    if not timed:
        return None
    stages: dict[str, float] = {}
    for b in timed:
        for child in b.children:
            if _stage(child.name) and child.device_s is not None:
                key = child.name[len(STAGE):]
                stages[key] = stages.get(key, 0.0) + child.device_s
    block_s = sum(b.device_s for b in timed) / len(timed)
    stages = {k: v / len(timed) for k, v in sorted(stages.items())}
    cfg, traffic = run.cfg, run.traffic
    grid_blocks = cfg["assumed"]["dm_trials"] / traffic["dedisp_block"]
    sky_s = cfg["ntime"] * cfg["tsamp_s"]
    kept = run.window.kept
    return 1e3 * block_s, {
        "stages_ms": {k: 1e3 * v for k, v in stages.items()},
        "unattributed_ms": 1e3 * (block_s - sum(stages.values())),
        "realtime_margin": sky_s / (grid_blocks * block_s),
        "blocks": len(blocks), "timed": len(timed),
        "cells_over_threshold": kept.get("over"),
        "window_blocks": kept.get("blocks")}
