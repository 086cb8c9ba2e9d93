"""Energy-aware autotuner: cost-model-pruned kernel-configuration search.

The counterpart of ``repro.tune.tuner``.  The paper finds each FFT
length's best *clock* by measurement (sweep, then argmin J/transform
under a latency bound); this module applies the same discipline to the
*software* configuration axes the clock sweep holds fixed: transforms per
CUDA block, butterfly radix schedule, the four-step ``(n1, n2)`` split,
and the overlap-save segment length.

The search is staged so measurement stays cheap:

  1. **Generate** every candidate :class:`KernelConfig` for the key
     (schedules x splits x tiles).
  2. **Prune with the cost model** (``core.workloads`` pass/traffic
     accounting + ``core.dvfs.sweep``): candidates are ranked by modelled
     boost-clock time (objective ``"time"``) or modelled J/transform at
     the DVFS-optimal clock (objective ``"energy"``) and only the top few
     survive.
  3. **Measure survivors** with :func:`repro_torch.tune.timing.time_fn`
     (CUDA events on the card), always including the heuristic config.
  4. **Score**: ``time`` = measured seconds; ``energy`` = model power at
     the workload's DVFS-optimal clock x measured seconds (J/call).
     Whatever the objective, a config that measures *slower* than the
     heuristic is rejected — the heuristic's latency is the real-time
     bound (Sec. 2.3), so the tuner may return the heuristic but can
     never regress it.

**Tiles** (``tile_b``, transforms per block of the register-pass
kernels) do not come from the reference's VMEM budget.  A tile t is a
candidate for a key when every register-pass launch of that key's plan
(:func:`plan_launches`: ``fft_c2c`` at n for one pass, ``fft_r2c`` /
``fft_c2r`` at n/2 with ``split`` for the real kernels, ``fft_c2c_axis1``
at n1 and ``fft_c2c_t`` at n2 with ``buffer`` for the four-step) accepts
it — ``fft_kernel.pass_launch`` does not raise — for t a power of two up
to the 256 threads a block.  A tile that resolves to the heuristic's
``per_block`` at every launch is excluded (it is the heuristic), and so
is one that resolves like an earlier tile.  With the default radices and
``PassLaunch.resident_blocks`` (blocks one H100 SM holds; the card's
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives the same) beside
each:

  C2C 1024       64 threads a transform: tiles 1 (12 blocks an SM) and
                 2 (6); the heuristic is 4 (3)
  C2C 8192       256 threads a transform: only the heuristic, 1 (2)
  R2C/C2R 1024   32 threads a transform at n/2 = 512: tiles 1 (24), 2
                 (12) and 4 (6); the heuristic is 8 (3)
  R2C/C2R 16384  n/2 = 8192: only the heuristic, 1 (2)
  C2C 2^20       four-step 1024 x 1024: tiles 1 (12) and 2 (6) at both
                 passes; the heuristic is 4 (3)

(The (8, 4, 2) schedules size their registers for fewer blocks: tiles 1,
2 and 4 of C2C 1024 hold 8, 4 and 2 blocks an SM.)

Results persist to the per-device :class:`~repro_torch.tune.cache.TuningCache`;
a second run replays the cached choice with **zero** measurements.
:func:`common_config` is the paper's Sec. 4 result on the software axis:
the single configuration minimising average modelled regret across every
tuned length, installable as the default for untuned shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import dvfs
from repro_torch.core.hardware import TESLA_V100, DeviceSpec
from repro_torch.core.workloads import (ConvCase, FFTCase, conv_workload,
                                        fft_workload)
from repro_torch.fft.radix import DEFAULT_RADICES, is_pow2, next_pow2
from repro_torch.tune.cache import TuneRecord, TuningCache
from repro_torch.tune.config import (HEURISTIC, SOURCE_COMMON, SOURCE_TUNED,
                                     ConfigKey, KernelConfig)
from repro_torch.tune.context import (TuningContext, set_tuning_context,
                                      use_tuning)
from repro_torch.tune.timing import time_fn

#: Butterfly schedules the engine can execute (repro_torch.fft.radix).
RADIX_CANDIDATES = ((4, 2), (2,), (8, 4, 2))

#: Survivors the measurement stage accepts per key (heuristic always rides).
DEFAULT_MEASURE_BUDGET = 5

#: Transform kinds :func:`tune_length` understands.
FFT_KINDS = ("c2c", "r2c", "c2r")

#: Points of the default measurement batch on a CUDA device: 2^25
#: complex64 points (256 MB) fill the card, where the reference's
#: ``max(2**14 // n, 8)`` rows would time the launch, not the kernel.
CUDA_BATCH_POINTS = 2**25


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One generated config plus its cost-model ranking scores."""

    config: KernelConfig
    model_time: float           # modelled boost-clock seconds per batch
    model_j: float              # modelled J/transform at the optimal clock
    opt_power_w: float          # model power at the DVFS-optimal clock


@dataclasses.dataclass
class TuneResult:
    """Outcome of one :func:`tune_length` call."""

    key: ConfigKey
    record: TuneRecord
    measurements: int           # timed executions THIS call (0 on replay)
    replayed: bool              # served from the persistent cache
    survivors: tuple[KernelConfig, ...] = ()
    walls: tuple[float, ...] = ()   # each survivor's seconds/call

    @property
    def config(self) -> KernelConfig:
        return self.record.config

    @property
    def speedup_vs_heuristic(self) -> float:
        return self.record.speedup_vs_heuristic


# ---------------------------------------------------------------------------
# Candidate generation
# ---------------------------------------------------------------------------

def _split_candidates(n: int) -> list[tuple[int, int] | None]:
    """Four-step (n1, n2) factorisations to try for a long pow2 length.

    The balanced heuristic cut is represented by None only — an explicit
    duplicate of it would be a functional clone of the heuristic that
    could "win" on timing noise.
    """
    from repro_torch.fft.plan import MAX_SINGLE_PASS, _four_step_split
    if not is_pow2(n) or n <= MAX_SINGLE_PASS:
        return [None]
    splits: list[tuple[int, int] | None] = [None]    # heuristic balanced cut
    balanced = _four_step_split(n)
    log = n.bit_length() - 1
    for k in range(max(log // 2 - 1, 1), min(log // 2 + 2, log)):
        n1 = 1 << k
        n2 = n // n1
        if (max(n1, n2) <= MAX_SINGLE_PASS and (n1, n2) != balanced
                and (n1, n2) not in splits):
            splits.append((n1, n2))
    return splits


def plan_launches(n: int, kind: str, batch: int,
                  config: KernelConfig | None = None) -> list:
    """Every register-pass launch the ``(n, kind)`` plan makes on a
    ``batch``-row operand under ``config``: ``(kernel, PassLaunch)`` pairs
    in plan order, following ``repro_torch.fft.plan``'s routing.  Raises
    ``ValueError`` where ``fft_kernel.pass_launch`` refuses the config's
    tile or schedule."""
    from repro_torch.fft.plan import (MAX_KERNEL_N, MAX_SINGLE_PASS,
                                      _resolve_split)
    from repro_torch.kernels.fft import fft_kernel
    radices = tuple(config.radices if config is not None and config.radices
                    else DEFAULT_RADICES)
    tile = config.tile_b if config is not None else None

    def launch(m, count, **flags):
        return fft_kernel.pass_launch(m, count, radices, tile, **flags)

    if kind in ("r2c", "c2r") and is_pow2(n):
        if n < 4:
            return []
        if n // 2 <= MAX_KERNEL_N:
            return [(f"fft_{kind}", launch(n // 2, batch, split=True))]
        return plan_launches(n // 2, "c2c", batch, config)
    if not is_pow2(n):                   # Bluestein: two FFTs of length m
        m = 1 << (2 * n - 2).bit_length()
        return 2 * plan_launches(m, "c2c", batch, config)
    if n <= MAX_SINGLE_PASS:
        return [("fft_c2c", launch(n, batch))] if n > 1 else []
    n1, n2 = _resolve_split(n, config)
    if n1 > MAX_KERNEL_N or n2 > MAX_KERNEL_N:
        return (plan_launches(n1, "c2c", batch * n2, config)
                + plan_launches(n2, "c2c", batch * n1, config))
    return [("fft_c2c_axis1", launch(n1, n2, buffer=True)),
            ("fft_c2c_t", launch(n2, n1, buffer=True))]


def _tile_candidates(n: int, kind: str, batch: int,
                     radices: tuple[int, ...] | None,
                     split: tuple[int, int] | None) -> list[int | None]:
    """Tiles to try: the heuristic (None) plus each power of two up to the
    block's thread limit that every launch of the plan accepts and that
    resolves to per-block counts the heuristic and no earlier tile has."""
    from repro_torch.kernels.fft import fft_kernel
    cfg = KernelConfig(radices=radices, split=split)
    seen = {tuple(l.per_block
                  for _, l in plan_launches(n, kind, batch, cfg))}
    tiles: list[int | None] = [None]
    t = 1
    while t <= fft_kernel.PASS_THREADS:
        try:
            got = tuple(l.per_block for _, l in plan_launches(
                n, kind, batch, dataclasses.replace(cfg, tile_b=t)))
        except ValueError:
            got = None
        if got is not None and got not in seen:
            seen.add(got)
            tiles.append(t)
        t *= 2
    return tiles


def generate_candidates(n: int, kind: str, batch: int) -> list[KernelConfig]:
    """The full config space for one key (heuristic config first)."""
    configs: list[KernelConfig] = [HEURISTIC]
    for radices in RADIX_CANDIDATES:
        # The default schedule IS the heuristic radix choice — normalise
        # it to None so a functionally-identical config can never "beat"
        # the heuristic on timing noise.
        rad = None if radices == DEFAULT_RADICES else radices
        plain = plan_launches(n, kind, batch, KernelConfig(radices=rad))
        for split in _split_candidates(n):
            # A split the plan never runs (a real kernel takes the whole
            # length, or the cut does not divide its inner C2C) is the
            # config without it — normalised likewise.
            if split is not None and plan_launches(
                    n, kind, batch,
                    KernelConfig(radices=rad, split=split)) == plain:
                split = None
            for tile in _tile_candidates(n, kind, batch, rad, split):
                cfg = KernelConfig(tile_b=tile, radices=rad, split=split,
                                   source=SOURCE_TUNED)
                if cfg.is_heuristic or cfg in configs:
                    continue
                configs.append(cfg)
    return configs


def _segment_candidates(n: int, taps: int) -> list[int]:
    """Pow2 overlap-save segment lengths bracketing the signal.

    Mirrors :func:`repro_torch.fft.convolve.select_nfft`'s bounds: the
    kernel cap only applies when some single-pass segment can hold the
    filter at all — longer filters fall through to multi-pass segments
    instead of producing an empty candidate list.
    """
    from repro_torch.fft.plan import MAX_KERNEL_N
    lo = next_pow2(max(2 * taps, 16))
    hi = max(lo, next_pow2(n + taps - 1))
    if lo <= MAX_KERNEL_N:
        hi = min(hi, MAX_KERNEL_N)
    out = []
    nfft = lo
    while nfft <= hi:
        out.append(nfft)
        nfft *= 2
    return out


# ---------------------------------------------------------------------------
# Cost-model pruning
# ---------------------------------------------------------------------------

def _model_candidate(cfg: KernelConfig, n: int, kind: str,
                     model_device: DeviceSpec) -> Candidate:
    """Rank one config with the analytic pass/traffic model + DVFS sweep."""
    case = FFTCase(n=n, transform=kind if kind in FFT_KINDS else "c2c",
                   radices=cfg.radices or DEFAULT_RADICES)
    res = dvfs.sweep(fft_workload(case, model_device), model_device)
    per = dvfs.energy_per_transform(res, case.n_fft)
    return Candidate(config=cfg, model_time=res.boost.time,
                     model_j=per["optimal_j"], opt_power_w=res.optimal.power)


def prune_candidates(configs: Sequence[KernelConfig], n: int, kind: str,
                     model_device: DeviceSpec, objective: str,
                     budget: int) -> list[Candidate]:
    """Keep the ``budget`` model-best candidates; the heuristic always
    survives (it anchors the never-regress guarantee)."""
    ranked = [_model_candidate(c, n, kind, model_device) for c in configs]
    score = (lambda c: c.model_time) if objective == "time" \
        else (lambda c: c.model_j)
    head, tail = ranked[0], sorted(ranked[1:], key=score)
    return [head] + tail[:max(budget - 1, 1)]


# ---------------------------------------------------------------------------
# Measurement + choice
# ---------------------------------------------------------------------------

def _measure_device(device: torch.device | None) -> torch.device:
    """The device survivors are timed on: ``device``, else the current
    CUDA device; never the CPU unless asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tune_length measures on a CUDA device and none is present; "
            "pass device=torch.device('cpu') to time the plain versions")
    return torch.device("cuda", torch.cuda.current_device())


def _fft_executable(n: int, kind: str, cfg: KernelConfig) -> Callable:
    from repro_torch.fft.plan import plan_with_config
    return plan_with_config(n, kind, cfg).fn


def _fft_operand(n: int, kind: str, batch: int,
                 device: torch.device) -> torch.Tensor:
    """The measurement operand, from a generator on ``device`` seeded 0:
    real rows (r2c), a half-spectrum with real DC and Nyquist bins (c2r,
    so ``torch.fft.irfft`` computes the same function), or complex rows."""
    gen = torch.Generator(device=device).manual_seed(0)
    if kind == "r2c":
        return torch.randn(batch, n, generator=gen, device=device)
    width = n // 2 + 1 if kind == "c2r" else n
    x = torch.randn(batch, width, dtype=torch.complex64, generator=gen,
                    device=device)
    if kind == "c2r":
        torch.view_as_real(x)[:, [0, -1], 1] = 0.0
    return x


def tune_length(
    n: int,
    kind: str = "c2c",
    *,
    objective: str = "energy",
    cache: TuningCache | None = None,
    model_device: DeviceSpec = TESLA_V100,
    batch: int | None = None,
    measure_budget: int = DEFAULT_MEASURE_BUDGET,
    repeats: int = 3,
    warmup: int = 1,
    timer: Callable[[], float] | None = None,
    force: bool = False,
    save: bool = True,
    device: torch.device | None = None,
) -> TuneResult:
    """Tune one ``(device, (n,), kind, dtype)`` key end to end.

    Replays the persisted choice with zero measurements when the cache
    already holds the key (pass ``force=True`` to re-measure).  Survivors
    are timed on ``device``: by default the current CUDA device — with no
    GPU it raises; pass ``torch.device("cpu")`` to time the plain versions.
    ``batch`` defaults to ``CUDA_BATCH_POINTS // n`` rows on CUDA and the
    reference's ``max(2**14 // n, 8)`` on the CPU.  ``timer`` is
    injectable (determinism tests feed a fake clock).
    """
    if objective not in ("time", "energy"):
        raise ValueError(f"unknown objective {objective!r}; "
                         "have ('time', 'energy')")
    if kind not in FFT_KINDS:
        raise ValueError(f"unknown transform kind {kind!r}; have {FFT_KINDS}")
    cache = cache if cache is not None else TuningCache.load()
    key = ConfigKey(device=cache.device, shape=(int(n),), kind=kind)
    if not force:
        hit = cache.get(key)
        if hit is not None:
            return TuneResult(key=key, record=hit, measurements=0,
                              replayed=True)

    dev = _measure_device(device)
    if batch is None:
        batch = (max(CUDA_BATCH_POINTS // n, 1) if dev.type == "cuda"
                 else max(2**14 // n, 8))
    candidates = generate_candidates(n, kind, batch)
    survivors = prune_candidates(candidates, n, kind, model_device,
                                 objective, measure_budget)

    # Measure every survivor under a *disabled* tuning context so the plan
    # builders resolve exactly the config under test, nothing else.
    walls: list[float] = []
    with use_tuning(None):
        operand = _fft_operand(n, kind, batch, dev)
        for cand in survivors:
            fn = _fft_executable(n, kind, cand.config)
            walls.append(time_fn(fn, operand, repeats=repeats,
                                 warmup=warmup, timer=timer))
    del operand

    def score(i: int) -> float:
        if objective == "time":
            return walls[i]
        return survivors[i].opt_power_w * walls[i]      # J/call at f_opt

    best = min(range(len(survivors)), key=score)
    # Never regress the heuristic's time: its latency is the bound.
    if walls[best] > walls[0]:
        best = 0
    chosen = survivors[best].config
    if best != 0:
        chosen = dataclasses.replace(chosen, source=SOURCE_TUNED)
    record = TuneRecord(
        config=chosen,
        heuristic=HEURISTIC,
        objective=objective,
        score=score(best),
        heuristic_score=score(0),
        measured_s=walls[best],
        heuristic_s=walls[0],
        candidates=len(candidates),
        measured=len(survivors),
    )
    cache.put(key, record)
    if save:
        cache.save()
    return TuneResult(key=key, record=record,
                      measurements=len(survivors) * (repeats + warmup),
                      replayed=False,
                      survivors=tuple(c.config for c in survivors),
                      walls=tuple(walls))


def tune_segment(
    n: int,
    taps: int,
    templates: int = 1,
    *,
    cache: TuningCache | None = None,
    model_device: DeviceSpec = TESLA_V100,
    save: bool = True,
) -> TuneResult:
    """Pick the overlap-save ``nfft`` by full cost-model sweep (no
    measurement: ``conv_workload`` prices every candidate's actual pass
    structure, and segments only change modelled traffic/FLOPs).

    Persisted under kind ``"conv"`` with shape ``(n, taps, templates)``;
    ``repro_torch.fft.convolve.conv_plan`` consults it before
    ``select_nfft``.
    """
    cache = cache if cache is not None else TuningCache.load()
    key = ConfigKey(device=cache.device, shape=(int(n), int(taps),
                                                int(templates)), kind="conv")
    if (hit := cache.get(key)) is not None:
        return TuneResult(key=key, record=hit, measurements=0, replayed=True)

    def seg_j(nfft: int) -> float:
        case = ConvCase(n=n, templates=templates, taps=taps, nfft=nfft)
        res = dvfs.sweep(conv_workload(case, model_device), model_device)
        return res.optimal.energy / case.n_rows

    segments = _segment_candidates(n, taps)
    scored = sorted(segments, key=seg_j)
    from repro_torch.fft.convolve import select_nfft
    heuristic_seg = select_nfft(taps, n, templates)
    record = TuneRecord(
        config=KernelConfig(segment=scored[0], source=SOURCE_TUNED),
        heuristic=KernelConfig(segment=0),
        objective="energy",
        score=seg_j(scored[0]),
        heuristic_score=seg_j(heuristic_seg),
        candidates=len(segments),
        measured=0,
    )
    cache.put(key, record)
    if save:
        cache.save()
    return TuneResult(key=key, record=record, measurements=0, replayed=False)


# ---------------------------------------------------------------------------
# The paper's Sec. 4 "common configuration" result, on the software axis
# ---------------------------------------------------------------------------

def common_config(
    cache: TuningCache,
    *,
    model_device: DeviceSpec = TESLA_V100,
) -> tuple[KernelConfig, float]:
    """The single config minimising average modelled regret across every
    tuned FFT length — the software mirror of the paper's one-common-clock
    result (Sec. 4: one well-chosen setting recovers ~50% of the savings).

    Only the length-portable axes (``tile_b``, ``radices``) generalise;
    splits and segments stay per-length.  Returns ``(config, regret)``
    where ``regret`` is the mean relative J/transform excess over each
    length's own tuned optimum (0.0 = no loss anywhere).
    """
    keys = [k for k in cache.keys() if k.kind in FFT_KINDS
            and len(k.shape) == 1]
    if not keys:
        raise ValueError("no tuned FFT lengths in the cache")
    pool: list[KernelConfig] = [HEURISTIC]
    for k in keys:
        rec = cache.get(k)
        portable = KernelConfig(tile_b=rec.config.tile_b,
                                radices=rec.config.radices,
                                source=SOURCE_COMMON)
        if portable not in pool:
            pool.append(portable)

    def model_j(cfg: KernelConfig, key: ConfigKey) -> float:
        case = FFTCase(n=key.shape[0], transform=key.kind,
                       radices=cfg.radices or DEFAULT_RADICES)
        res = dvfs.sweep(fft_workload(case, model_device), model_device)
        return dvfs.energy_per_transform(res, case.n_fft)["optimal_j"]

    # One sweep per (config, key): the regret loop reuses these figures.
    j = {(c, k): model_j(c, k) for c in pool for k in keys}
    best_per_key = {k: min(j[(c, k)] for c in pool) for k in keys}
    regrets = []
    for cfg in pool:
        regrets.append(float(np.mean(
            [j[(cfg, k)] / best_per_key[k] - 1.0 for k in keys])))
    i = int(np.argmin(regrets))
    cfg = pool[i]
    if cfg is not HEURISTIC:
        cfg = dataclasses.replace(cfg, source=SOURCE_COMMON)
    return cfg, regrets[i]


def install_common_default(
    cache: TuningCache | None = None,
    *,
    model_device: DeviceSpec = TESLA_V100,
) -> TuningContext:
    """Build a context whose untuned keys fall back to the common config
    (instead of the heuristics) and install it process-wide."""
    cache = cache if cache is not None else TuningCache.load()
    ctx = TuningContext(cache)
    try:
        common, _ = common_config(cache, model_device=model_device)
    except ValueError:
        common = None
    ctx.common = common
    set_tuning_context(ctx)
    return ctx
