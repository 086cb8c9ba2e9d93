"""A survey pointing searched block by block over its DM-trial grid, the
blocks dispatched ahead: the host waits only for the block ``in_flight``
places back, never for the card to drain.

The configuration gives the filterbank (channels, samples, sampling, the
band), the DM grid, the template bank, the harmonics, the sift's
false-alarm rate, pool and candidates, and the file of its plain
reference (``reference``); the traffic the blocks (``dedisp_block``
trials a dedispersion block, ``fdas_block`` a sub-block of planes),
``in_flight``, and the injected pulsars: ``pulsars`` of them, at trials
of the first ``pulsar_blocks`` blocks (the first on a block's first
trial), each a train of Gaussian pulses of a ``duty`` cycle (full width
at half maximum over the period), its spin frequency drawn log-uniform
from the ``spin_bins`` fractions of the spectrum (the first's from
``boundary_spin_bins``, slow, so that its cloud of DM trials crosses
the block boundary), an integer drift of the bank and a fundamental of
``peak_power`` noise units.  The filterbank is made on the device from
the seed: unit Gaussian noise, float32, and the pulsars added, shifted
in each channel by the delays the reference computes for their trials
(``delay_table``), not by the program's.

A unit is one dedispersion block; its input is its share of the
pointing's filterbank (the filterbank's bytes x its trials / the grid's).
The first pass over the grid copies the planes of the checked trials (the
pulsars' and ``extra_checked`` more, drawn from the seed) to pinned host
memory as their sub-blocks end, in the card's order (the program's
``out``), and merges the blocks' candidate pools, which are sifted once
the window ends; the window lasts ``seconds`` and at least until the
checked trials are searched.  The check holds:

* ``delay_mismatch``: the program's delay table to the reference's;
* ``power_err``, ``stat_err``, ``level_flips``: each checked trial's
  planes to the float64 reference's;
* ``pool_misses``: every cell of a checked trial whose reference
  statistic clears the pool's weakest cell by more than ``stat_err``'s
  limit is in the program's merged pool;
* ``sift_mismatch``: the candidates are the reference's sift
  (``sift_cells``) of that pool, no more and no fewer;
* ``missed_pulsars``: each pulsar has a candidate within its cloud: a
  trial within ``max(1, P / 2s)`` of its own (P the period in samples,
  s the samples a DM step smears across the band: the fundamental keeps
  about 40 % of its power there) and a bin within m + (m |z| + zmax) / 2
  of its m-th harmonic, m <= the ladder's top.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
import types

import numpy as np
import torch

from bench.harness import BENCH, load_file_module
from bench.record import Check, TraceWindow, Unit, Window
from bench.yardstick.roofline import FLOAT32
from bench.yardstick.search import KIND

#: FWHM of a Gaussian over its standard deviation.
FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))


@dataclasses.dataclass
class Pulsar:
    trial: int
    drift: int                      # z: bins the spin frequency drifts
    bin: int                        # the spin frequency's starting bin
    duty: float                     # pulse FWHM / period
    power: float                    # the fundamental's, noise units
    phase: float                    # pulse phase at sample 0, turns


@dataclasses.dataclass
class State:
    device: torch.device
    fb: torch.Tensor                # (1, C, N) float32
    plan: object                    # the program's DispersionPlan
    delays: torch.Tensor            # (D, C) int64, the reference's
    drifts: tuple
    pulsars: list
    checked: list                   # trials whose planes are checked
    host: dict                      # trial -> [power, stat, level] buffers
    in_flight: int


def reference(cfg: dict):
    """The configuration's plain reference (``configs/<reference>``)."""
    return load_file_module(BENCH / "configs" / cfg["reference"],
                            f"bench_ref_{cfg['name']}_setup")


def _grid(cfg: dict):
    """The program's filterbank geometry, DM plan and template bank."""
    from repro_torch.data.synthetic import FilterbankSpec
    from repro_torch.search import DispersionPlan, TemplateBank
    a = cfg["assumed"]
    spec = FilterbankSpec(nchan=cfg["nchan"], ntime=cfg["ntime"],
                          f_lo=a["f_lo_mhz"], f_hi=a["f_hi_mhz"],
                          tsamp=cfg["tsamp_s"])
    plan = DispersionPlan.from_spec(spec, n_trials=a["dm_trials"],
                                    dm_step_factor=a["dm_step_factor"])
    bank = TemplateBank.linear(a["zmax"])
    if (bank.n_templates, bank.taps) != (a["templates"], a["taps"]):
        raise ValueError(f"the bank has {bank.n_templates} templates of "
                         f"{bank.taps} taps; the configuration states "
                         f"{a['templates']} of {a['taps']}")
    return spec, plan, bank


def delay_table(ref, cfg: dict) -> torch.Tensor:
    """The grid's (D, C) delays in samples, as the reference computes
    them from the configuration."""
    a = cfg["assumed"]
    return ref.delay_table(a["f_lo_mhz"], a["f_hi_mhz"], cfg["nchan"],
                           cfg["tsamp_s"], a["dm_trials"],
                           a["dm_step_factor"])[1]


def _log_uniform(rng, lo: float, hi: float) -> float:
    return math.exp(rng.uniform(math.log(lo), math.log(hi)))


def _draw(cfg: dict, traffic: dict, seed: int) -> tuple[list, list]:
    """The pulsars and the checked trials a seed gives."""
    a = cfg["assumed"]
    rng = np.random.default_rng(seed)
    db, blocks = int(traffic["dedisp_block"]), int(traffic["pulsar_blocks"])
    span_ = db * blocks
    trials = [db * int(rng.integers(1, blocks))]       # a block's first
    while len(trials) < int(traffic["pulsars"]):
        t = int(rng.integers(0, span_))
        if all(abs(t - u) > 2 for u in trials):
            trials.append(t)
    nbins = cfg["ntime"] // 2 + 1
    pulsars = []
    for i, t in enumerate(trials):
        lo, hi = traffic["boundary_spin_bins" if i == 0 else "spin_bins"]
        pulsars.append(Pulsar(
            t, int(rng.integers(-a["zmax"], a["zmax"] + 1)),
            int(_log_uniform(rng, lo * nbins, hi * nbins)),
            float(rng.uniform(*traffic["duty"])),
            float(rng.uniform(*traffic["peak_power"])),
            float(rng.uniform(0.0, 1.0))))
    checked = set(trials)
    while len(checked) < len(trials) + int(traffic["extra_checked"]):
        checked.add(int(rng.integers(0, span_)))
    return pulsars, sorted(checked)


def _inject(fb: torch.Tensor, p: Pulsar, delays: torch.Tensor) -> None:
    """Add the pulsar's pulse train to each channel, shifted by the
    channel's delay at its trial.  Its phase runs k s + z s^2 / 2 turns
    at s = t / N (a spin frequency of bin k drifting z bins over the
    series); a pulse is a Gaussian in phase whose FWHM is ``duty``
    turns, scaled so that the fundamental, a cosine of amplitude A in
    each of C channels, peaks at C A^2 N / 4 = ``power`` noise units."""
    _, nchan, n = fb.shape
    delays = delays.tolist()
    top = max(delays)
    s = torch.arange(-top, n, dtype=torch.float64, device=fb.device) / n
    turns = p.bin * s + 0.5 * p.drift * s * s + p.phase
    sigma = p.duty / FWHM
    # A Gaussian of height a and width sigma turns has a fundamental of
    # amplitude 2 a sigma sqrt(2 pi) exp(-2 pi^2 sigma^2).
    amp = math.sqrt(4.0 * p.power / (nchan * n))
    height = amp / (2.0 * sigma * math.sqrt(2.0 * math.pi)
                    * math.exp(-2.0 * math.pi ** 2 * sigma ** 2))
    off = turns - torch.round(turns)
    wave = (height * torch.exp(-0.5 * (off / sigma) ** 2)).float()
    del s, turns, off
    for c, d in enumerate(delays):
        fb[0, c] += wave[top - d:top - d + n]


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from repro_torch.search import PulsarSearch  # noqa: F401 (the entry)
    device = torch.device(device)
    _, plan, bank = _grid(cfg)
    delays = delay_table(reference(cfg), cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fb = torch.randn((1, cfg["nchan"], cfg["ntime"]), generator=gen,
                     device=device, dtype=torch.float32)
    pulsars, checked = _draw(cfg, traffic, seed)
    for p in pulsars:
        _inject(fb, p, delays[p.trial])
    plane = (1, bank.n_templates, cfg["ntime"] // 2 + 1)
    cuda = device.type == "cuda"
    host = {t: [torch.empty(plane, dtype=dt, pin_memory=cuda)
                for dt in (torch.float32, torch.float32, torch.int32)]
            for t in checked}
    return State(device=device, fb=fb, plan=plan, delays=delays,
                 drifts=bank.drifts, pulsars=pulsars, checked=checked,
                 host=host, in_flight=int(traffic["in_flight"]))


class _Program:
    """The port's blocked search over the state's filterbank."""

    def __init__(self, cfg: dict, traffic: dict, state: State):
        from repro_torch.search import (PulsarSearch, merge_pools,
                                        sift_threshold)
        a = cfg["assumed"]
        nbins = cfg["ntime"] // 2 + 1
        cells = a["dm_trials"] * a["templates"] * nbins
        _, _, bank = _grid(cfg)
        self.merge_pools = merge_pools
        self.threshold = sift_threshold(cells, a["false_alarms"],
                                        a["n_harmonics"])
        self.search = PulsarSearch(
            state.plan, bank, n_harmonics=a["n_harmonics"],
            threshold=self.threshold, max_candidates=a["max_candidates"],
            pool=a["pool"], dedisp_block=traffic["dedisp_block"],
            fdas_block=traffic["fdas_block"])
        self.search.prepare(state.device)
        self.fb, self.n = state.fb, cfg["ntime"]
        self.n_blocks = self.search.n_blocks
        self.dedisp_block = self.search.dedisp_block

    def block(self, index: int, keep, out):
        return self.search.block(self.fb, index, keep, out)

    def merge(self, cells, res):
        return self.merge_pools(cells, res.pool, self.search.pool)

    def pooled(self, cells) -> list:
        """The merged pool's (stat, flat index, level) cells."""
        return list(zip(cells.vals[0].tolist(), cells.idx[0].tolist(),
                        cells.level[0].tolist()))

    def candidates(self, cells) -> set:
        c = self.search.sift(cells, self.n)
        return {(int(d), int(t), int(b)) for d, t, b in
                zip(c.dm[0].tolist(), c.template[0].tolist(),
                    c.bin[0].tolist()) if d >= 0}


def program(cfg: dict, traffic: dict, state: State):
    """The port's blocked search, every block's delay table on the card."""
    return _Program(cfg, traffic, state)


class _Control:
    """The reference at the next precision below, in the program's place:
    the checked trials' planes from ``ref.control_planes``, each trial's
    strongest ``pool`` cells merged into one pool, and the candidates
    ``ref.sift_cells`` of it; the other trials are not searched."""

    def __init__(self, cfg: dict, traffic: dict, state: State, ref):
        a = cfg["assumed"]
        self.ref, self.state, self.a = ref, state, a
        self.dedisp_block = db = int(traffic["dedisp_block"])
        self.n_blocks = -(-a["dm_trials"] // db)
        self.plane = (a["templates"], cfg["ntime"] // 2 + 1)
        from repro_torch.search import sift_threshold
        self.threshold = sift_threshold(
            a["dm_trials"] * a["templates"] * (cfg["ntime"] // 2 + 1),
            a["false_alarms"], a["n_harmonics"])

    def block(self, index: int, keep, out):
        s, a = self.state, self.a
        db = self.dedisp_block
        trials = range(index * db, min((index + 1) * db, a["dm_trials"]))
        kept = [t for t in trials if t in keep]
        cells = []
        for t in kept:
            p = self.ref.control_planes(s.fb, s.delays[t], s.drifts,
                                        a["taps"], a["n_harmonics"])
            for dst, plane in zip(out[t], p):
                dst.copy_(plane)
            stat = p[1].reshape(-1)
            vals, idx = torch.topk(stat, min(a["pool"], stat.numel()))
            lev = p[2].reshape(-1)[idx]
            first = t * self.plane[0] * self.plane[1]
            cells += [(float(v), int(i) + first, int(lv)) for v, i, lv in
                      zip(vals.tolist(), idx.tolist(), lev.tolist())]
        return types.SimpleNamespace(
            trials=trials, kept=kept, pool=cells,
            over=torch.zeros(1, dtype=torch.int64, device=s.device))

    def merge(self, cells, res):
        ranked = sorted((cells or []) + res.pool, key=lambda c: (-c[0], c[1]))
        return ranked[:self.a["pool"]]

    def pooled(self, cells) -> list:
        return list(cells or [])

    def candidates(self, cells) -> set:
        a = self.a
        return {c[:3] for c in self.ref.sift_cells(
            cells or [], self.plane, threshold=self.threshold,
            max_candidates=a["max_candidates"],
            max_harmonic=a["n_harmonics"])}


def control(cfg: dict, traffic: dict, state: State, ref):
    return _Control(cfg, traffic, state, ref)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(system, state: State) -> None:
    """A block holding a checked trial, its planes copied out and the pool
    sifted, then wait: the kernels, plans and the allocator's blocks are
    made before the window."""
    res = system.block(state.checked[0] // system.dedisp_block,
                       set(state.checked), state.host)
    system.candidates(system.merge(None, res))
    del res
    _sync(state.device)


def _unit(state: State, trials: range, grid: int, now: float) -> Unit:
    _, nchan, n = state.fb.shape
    rows = len(trials)
    return Unit(kind=KIND, n=n, rows=rows, points=rows * n,
                in_bytes=nchan * n * FLOAT32 * rows // grid, t_start=now)


def window(system, state: State, seconds: float, trace: TraceWindow | None
           ) -> Window:
    cuda = state.device.type == "cuda"
    grid = state.plan.n_trials
    keep = set(state.checked)
    ring = collections.deque()
    units: list[Unit] = []
    cells, seen = None, set()
    over = torch.zeros((), dtype=torch.int64, device=state.device)
    _sync(state.device)
    t0 = time.perf_counter()
    i = 0
    while True:
        first_pass = i < system.n_blocks
        res = (system.block(i, keep, state.host) if first_pass
               else system.block(i % system.n_blocks, (), None))
        if first_pass:
            cells = system.merge(cells, res)
            seen.update(res.kept)
        over += res.over.sum()
        units.append(_unit(state, res.trials, grid, time.perf_counter()))
        del res
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ring.append(ev)
            if len(ring) > state.in_flight:
                ring.popleft().synchronize()
        i += 1
        elapsed = time.perf_counter() - t0
        if trace is not None:
            trace.at(elapsed, units)
        if (elapsed >= seconds and seen >= keep
                and (trace is None or trace.done)):
            break
    _sync(state.device)
    t1 = time.perf_counter()
    kept = {"found": system.candidates(cells), "pool": system.pooled(cells),
            "threshold": system.threshold, "searched": seen,
            "over": int(over), "blocks": i}
    return Window(t0=t0, t1=t1, units=units, kept=kept,
                  trace=trace.trace if trace is not None else None)


def _found(p: Pulsar, found: set, cfg: dict) -> bool:
    """Whether a candidate lies in the pulsar's cloud (module docstring)."""
    a = cfg["assumed"]
    period = cfg["ntime"] / p.bin                          # samples
    reach = max(1, math.ceil(period / (2 * a["dm_step_factor"])))
    for d, _, b in found:
        if abs(d - p.trial) > reach:
            continue
        if any(abs(b - m * p.bin) <= m + (m * abs(p.drift) + a["zmax"]) / 2
               for m in range(1, a["n_harmonics"] + 1)):
            return True
    return False


def check(ref, cfg: dict, traffic: dict, state: State, win: Window,
          limits: dict) -> list[Check]:
    a = cfg["assumed"]
    plane = (a["templates"], cfg["ntime"] // 2 + 1)
    cells = plane[0] * plane[1]
    pool = win.kept["pool"]
    floor = min(v for v, _, _ in pool) + limits["stat_err"]
    pooled = {i for _, i, _ in pool}
    mismatch = int((torch.from_numpy(state.plan.delay_array())
                    != state.delays).sum())
    worst = {"power_err": 0.0, "stat_err": 0.0, "level_flips": 0,
             "pool_misses": 0}
    for t in state.checked:
        if t not in win.kept["searched"]:
            worst = dict.fromkeys(worst, math.inf)
            break
        planes = [h.to(state.device)[0] for h in state.host[t]]
        want = [r[0] for r in ref.trial_planes(
            state.fb, state.delays[t], state.drifts, a["taps"],
            a["n_harmonics"])]
        p, s, flips = ref.plane_errors(planes, want)
        above = torch.nonzero(want[1].reshape(-1) > floor).flatten()
        del planes, want
        worst["power_err"] = max(worst["power_err"], p)
        worst["stat_err"] = max(worst["stat_err"], s)
        worst["level_flips"] += flips
        worst["pool_misses"] += sum(i + t * cells not in pooled
                                    for i in above.tolist())
    sifted = {c[:3] for c in ref.sift_cells(
        pool, plane, threshold=win.kept["threshold"],
        max_candidates=a["max_candidates"], max_harmonic=a["n_harmonics"])}
    found = win.kept["found"]
    missed = sum(not _found(p, found, cfg) for p in state.pulsars)
    out = [Check("delay_mismatch", float(mismatch),
                 limits["delay_mismatch"])]
    out += [Check(name, float(worst[name]), limits[name]) for name in worst]
    out.append(Check("sift_mismatch", float(len(found ^ sifted)),
                     limits["sift_mismatch"]))
    out.append(Check("missed_pulsars", float(missed),
                     limits["missed_pulsars"]))
    win.kept["failed"] = sum(not c.ok for c in out)
    return out
