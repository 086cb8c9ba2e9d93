"""The port's pulsar-search pipeline (``repro_torch.search.pipeline``,
``search.sift``, ``data.synthetic``, ``core.workloads`` and
``core.scheduler``) against the reference's on the same numpy
filterbanks, at the reference's ``tests/test_pipeline.py`` geometry (16
channels x 2048 samples, 8 DM trials, the linear 5-template bank):

* power, statistic within 1e-4 * max |ref|, the harmonic level equal
  wherever the winning rung leads the runner-up by more than 1e-4 (a
  closer call may fall either way in float32), and the candidates equal as
  (dm, template, bin, level) sets (``torch.topk`` may order ties
  differently from ``lax.top_k``);
* the two injected pulsars recovered at their exact cells, no candidate
  in the no-signal control, batched filterbanks searched independently,
  one launch of each pipeline kernel (the monkeypatchable hooks);
* the sift unit cases, the dispersion plan's delays and the synthetic
  filterbank bit-identical, and the stage models, the per-stage DVFS plan
  and the scheduler field-identical for the Tesla V100, also at the chip
  check's geometry (1024 channels x 2**17 samples, 128 DM trials, 85
  templates).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_parity import assert_close
import repro.core as ref_core
import repro.data.synthetic as ref_synth
import repro.search.pipeline as ref_pl
from repro.search.sift import sift_candidates as ref_sift
from repro.search.templates import TemplateBank as RefBank
import repro_torch.core as port_core
import repro_torch.search.pipeline as port_pl
from repro_torch.data.synthetic import (FilterbankSpec, InjectedPulsar,
                                        synthetic_filterbank)
from repro_torch.search.pipeline import (DispersionPlan, plan_pulsar_stages,
                                         pulsar_search, serving_sifted)
from repro_torch.search.sift import sift_candidates
from repro_torch.search.templates import TemplateBank

RTOL = 1e-4
SPEC = FilterbankSpec(nchan=16, ntime=2048)
PLAN = DispersionPlan.from_spec(SPEC, n_trials=8)
BANK = TemplateBank.linear(zmax=4.0, n_templates=5)
REF_SPEC = ref_synth.FilterbankSpec(nchan=16, ntime=2048)
REF_PLAN = ref_pl.DispersionPlan.from_spec(REF_SPEC, n_trials=8)
REF_BANK = RefBank.linear(zmax=4.0, n_templates=5)
# drifts are (-4, -2, 0, 2, 4): z=2 -> template 3, z=-4 -> template 0
PULSARS = ((3, 300, 2.0), (6, 611, -4.0))


def filterbank(pulsars=PULSARS, seed=2, amp=0.12):
    return synthetic_filterbank(
        SPEC, tuple(InjectedPulsar(dm=PLAN.dms[d], k0=k, z=z, amp=amp)
                    for d, k, z in pulsars), noise=1.0, seed=seed)


def cells(c, row=0, level=False):
    out = set()
    for i in range(c.dm.shape[-1]):
        if int(c.dm[row, i]) < 0:
            continue
        cell = (int(c.dm[row, i]), int(c.template[row, i]),
                int(c.bin[row, i]))
        out.add(cell + (int(c.level[row, i]),) if level else cell)
    return out


@functools.cache
def searched(seed: int, signal: bool):
    """(reference result, port result) of one filterbank."""
    fb = filterbank(seed=seed) if signal else filterbank((), seed=seed)
    ref = ref_pl.pulsar_search(fb, REF_PLAN, REF_BANK, n_harmonics=8)
    port = pulsar_search(torch.from_numpy(fb), PLAN, BANK, n_harmonics=8)
    return ref, port


def rung_margin(power: np.ndarray, h: int) -> np.ndarray:
    from repro.kernels.harmonic_sum import harmonic_sum_ref
    ladder = np.asarray(harmonic_sum_ref(power, h))
    hs = 2.0 ** np.arange(ladder.shape[-2])
    z = np.sort((ladder - hs[:, None]) / np.sqrt(hs)[:, None], axis=-2)
    return z[..., -1, :] - z[..., -2, :]


@pytest.mark.parametrize("seed,signal", [(2, True), (3, False), (8, True)])
def test_search_matches_reference(seed, signal):
    ref, port = searched(seed, signal)
    assert_close(port.power, ref.power, RTOL)
    assert_close(port.stat, ref.stat, RTOL)
    assert_close(port.sigma2, ref.sigma2, RTOL)
    assert port.level.dtype == torch.int32
    clear = rung_margin(np.asarray(ref.power), 8) > RTOL
    assert clear.mean() > 0.99
    assert np.array_equal(port.level.numpy()[clear],
                          np.asarray(ref.level)[clear])
    assert cells(port.candidates, level=True) == \
        cells(ref.candidates, level=True)
    assert_close(np.sort(port.candidates.snr.numpy()),
                 np.sort(np.asarray(ref.candidates.snr)), RTOL)


def test_two_pulsars_recovered_at_exact_cells():
    _, res = searched(2, True)
    assert cells(res.candidates) == {(3, 3, 300), (6, 0, 611)}
    c = res.candidates
    kept = c.dm[0] >= 0
    assert bool((c.snr[0][kept] > 25.0).all())
    assert bool((c.snr[0][~kept] == 0.0).all())


def test_no_signal_control_zero_candidates():
    _, res = searched(3, False)
    c = res.candidates
    for field in (c.dm, c.template, c.bin, c.level):
        assert bool((field == -1).all())
    assert bool((c.snr == 0.0).all())
    assert float(res.stat.max()) < 25.0


def test_batched_filterbanks_search_independently():
    quiet = filterbank((), seed=4)
    loud = filterbank(((2, 150, 0.0),), seed=5, amp=0.15)
    res = pulsar_search(torch.from_numpy(np.stack([quiet, loud])), PLAN, BANK)
    c = res.candidates
    assert bool((c.dm[0] == -1).all())
    assert (int(c.dm[1, 0]), int(c.template[1, 0]),
            int(c.bin[1, 0])) == (2, 2, 150)
    alone = pulsar_search(torch.from_numpy(loud), PLAN, BANK)
    assert_close(res.stat[1], alone.stat[0].numpy(), 1e-6)


def test_rank_guard_and_serving_packing():
    with pytest.raises(ValueError, match="nchan, ntime"):
        pulsar_search(torch.ones(2, 2, 4, 64), PLAN, BANK)
    _, res = searched(2, True)
    packed = serving_sifted(res)
    assert tuple(packed.shape) == (1, 16, 5)
    assert packed.dtype == torch.float32
    assert packed[0, -1].tolist() == [-1, -1, -1, -1, 0.0]
    rows = {tuple(r[:3]) for r in packed[0].tolist() if r[0] >= 0}
    assert rows == {(3.0, 3.0, 300.0), (6.0, 0.0, 611.0)}


def test_each_kernel_launches_once(monkeypatch):
    calls = {"dedisp": 0, "hsum": 0}
    real_d, real_h = port_pl._kernel_dedisp, port_pl._kernel_hsum

    def count_d(*a, **k):
        calls["dedisp"] += 1
        return real_d(*a, **k)

    def count_h(*a, **k):
        calls["hsum"] += 1
        return real_h(*a, **k)

    monkeypatch.setattr(port_pl, "_kernel_dedisp", count_d)
    monkeypatch.setattr(port_pl, "_kernel_hsum", count_h)
    spec = FilterbankSpec(nchan=3, ntime=256)
    plan = DispersionPlan.from_spec(spec, n_trials=3)
    bank = TemplateBank.linear(zmax=1.0, n_templates=3)
    fb = synthetic_filterbank(spec, (), noise=1.0, seed=7)
    port_pl.pulsar_search(torch.from_numpy(fb), plan, bank, n_harmonics=2,
                          pool=16)
    assert calls == {"dedisp": 1, "hsum": 1}
    # The port runs eagerly: each search launches each kernel once more.
    port_pl.pulsar_search(torch.from_numpy(fb), plan, bank, n_harmonics=2,
                          pool=16)
    assert calls == {"dedisp": 2, "hsum": 2}


def test_ledger_of_one_search():
    from repro_torch.obs.ledger import LaunchLedger
    ledger = LaunchLedger()
    with ledger.capture():
        pulsar_search(torch.from_numpy(filterbank()), PLAN, BANK)
    assert ledger.counts() == {"dedisperse": 1, "fft-r2c": 1,
                               "fft-c2c-mul": 1, "fft-c2c": 1,
                               "harmonic-sum-plane": 1}


def _volume(cells_, shape=(1, 4, 3, 512)):
    stat = np.zeros(shape, np.float32)
    for (d, t, b), v in cells_:
        stat[0, d, t, b] = v
    return stat, np.zeros(shape, np.int32)


def _sift_both(stat, lev, **kw):
    port = sift_candidates(torch.from_numpy(stat), torch.from_numpy(lev),
                           **kw)
    ref = ref_sift(stat, lev, **kw)
    assert cells(port, level=True) == cells(ref, level=True)
    return port


@pytest.mark.parametrize("cells_,kw,want", [
    ([((2, 1, 100), 50.0), ((2, 1, 200), 30.0)], {}, {(2, 1, 100)}),
    ([((2, 1, 100), 50.0), ((3, 1, 101), 30.0)], {}, {(2, 1, 100)}),
    ([((0, 0, 100), 50.0), ((3, 2, 173), 40.0)], {},
     {(0, 0, 100), (3, 2, 173)}),
    ([((1, 0, 50), 10.0)], {"threshold": 25.0}, set()),
    ([((2, 1, 100), 20.0), ((2, 1, 200), 30.0)], {"threshold": 25.0},
     {(2, 1, 200)}),
    ([((2, 1, 100), 50.0), ((2, 1, 100 + 64), 50.0)], {"pool": 4},
     {(2, 1, 100), (2, 1, 164)}),
])
def test_sift_cases_match_reference(cells_, kw, want):
    stat, lev = _volume(cells_)
    assert cells(_sift_both(stat, lev, **kw)) == want


def test_sift_level_travels_with_candidate():
    stat = np.zeros((1, 2, 2, 64), np.float32)
    lev = np.zeros((1, 2, 2, 64), np.int32)
    stat[0, 1, 0, 30] = 40.0
    lev[0, 1, 0, 30] = 3
    assert int(_sift_both(stat, lev).level[0, 0]) == 3


def test_sift_guards():
    with pytest.raises(ValueError, match="volume"):
        sift_candidates(torch.ones(4, 8), torch.zeros(4, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="shapes differ"):
        sift_candidates(torch.ones(1, 2, 2, 8),
                        torch.zeros(1, 2, 2, 9, dtype=torch.int32))


@pytest.mark.parametrize("nchan,ntime,trials", [
    (16, 2048, 8), (8, 512, 4), (1024, 2**17, 128), (5, 300, 1)])
def test_dispersion_plan_is_the_references(nchan, ntime, trials):
    spec = FilterbankSpec(nchan=nchan, ntime=ntime)
    port = DispersionPlan.from_spec(spec, n_trials=trials)
    ref = ref_pl.DispersionPlan.from_spec(
        ref_synth.FilterbankSpec(nchan=nchan, ntime=ntime), n_trials=trials)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert np.array_equal(port.delay_array(), ref.delay_array())
    assert (port.n_trials, port.nchan, port.max_delay) == \
        (ref.n_trials, ref.nchan, ref.max_delay)
    hash(port)


def test_dispersion_plan_guards():
    with pytest.raises(ValueError, match="exceed"):
        DispersionPlan.from_spec(FilterbankSpec(nchan=8, ntime=128),
                                 dms=(1e5,))
    with pytest.raises(ValueError, match="n_trials"):
        DispersionPlan.from_spec(SPEC, n_trials=0)
    with pytest.raises(ValueError, match=">= 1 DM trial"):
        DispersionPlan(dms=(), delays=(), tsamp=1e-4)
    with pytest.raises(ValueError, match="delay rows"):
        DispersionPlan(dms=(0.0, 1.0), delays=((0, 0),), tsamp=1e-4)


@pytest.mark.parametrize("noise,seed", [(1.0, 0), (0.0, 1), (0.5, 7)])
def test_synthetic_filterbank_is_bit_identical(noise, seed):
    pulsars = ((3, 300, 2.0, 0.12, 0.0), (6, 611, -4.0, 0.3, 1.0))
    port = synthetic_filterbank(
        SPEC, tuple(InjectedPulsar(PLAN.dms[d], k, z, a, ph)
                    for d, k, z, a, ph in pulsars), noise=noise, seed=seed)
    ref = ref_synth.synthetic_filterbank(
        REF_SPEC, tuple(ref_synth.InjectedPulsar(REF_PLAN.dms[d], k, z, a, ph)
                        for d, k, z, a, ph in pulsars), noise=noise,
        seed=seed)
    assert port.dtype == ref.dtype == np.float32
    assert np.array_equal(port, ref)
    assert port_pl.FilterbankSpec is FilterbankSpec
    for attr in ("freqs_mhz", "t_acquire", "dm_step"):
        assert np.array_equal(getattr(SPEC, attr), getattr(REF_SPEC, attr))
    assert np.array_equal(SPEC.delay_samples(17.5),
                          REF_SPEC.delay_samples(17.5))


def test_filterbank_spec_guards_are_the_references():
    for kw in (dict(nchan=0), dict(f_lo=1600.0), dict(tsamp=0.0)):
        with pytest.raises(ValueError) as ref_err:
            ref_synth.FilterbankSpec(**kw)
        with pytest.raises(ValueError) as port_err:
            FilterbankSpec(**kw)
        assert str(port_err.value) == str(ref_err.value)


#: (nchan, ntime, dm_trials, templates, taps, n_harmonics): the test
#: geometry and the chip check's.
GEOMETRIES = [(16, 2048, 8, 5, BANK.taps, 8),
              (1024, 2**17, 128, 85, 100, 8),
              (8, 512, 4, 5, BANK.taps, 4)]


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_pulsar_workload_is_field_identical(geom):
    nchan, ntime, dm, t, taps, h = geom
    kw = dict(nchan=nchan, ntime=ntime, dm_trials=dm, templates=t,
              taps=taps, n_harmonics=h)
    port_case, ref_case = port_core.PulsarCase(**kw), \
        ref_core.workloads.PulsarCase(**kw)
    assert dataclasses.asdict(port_case) == dataclasses.asdict(ref_case)
    assert (port_case.n_rows, port_case.nbins, port_case.sample_bytes) == \
        (ref_case.n_rows, ref_case.nbins, ref_case.sample_bytes)
    port_profs = port_core.pulsar_search_workload(port_case,
                                                  port_core.TESLA_V100)
    ref_profs = ref_core.workloads.pulsar_search_workload(
        ref_case, ref_core.TESLA_V100)
    assert [p.name for p in port_profs] == ["dedisp", "fdas",
                                            "harmonic-sum", "sift"]
    assert [dataclasses.asdict(p) for p in port_profs] == \
        [dataclasses.asdict(p) for p in ref_profs]
    assert dataclasses.asdict(port_core.pulsar_search_total_profile(
        port_case, port_core.TESLA_V100)) == dataclasses.asdict(
            ref_core.workloads.pulsar_search_total_profile(
                ref_case, ref_core.TESLA_V100))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_stage_plan_is_field_identical(geom):
    nchan, ntime, dm, t, _, h = geom
    spec = FilterbankSpec(nchan=nchan, ntime=ntime)
    ref_spec = ref_synth.FilterbankSpec(nchan=nchan, ntime=ntime)
    bank = TemplateBank.linear(zmax=(t - 1) / 2.0, n_templates=t)
    ref_bank = RefBank.linear(zmax=(t - 1) / 2.0, n_templates=t)
    port = plan_pulsar_stages(spec, DispersionPlan.from_spec(spec,
                                                             n_trials=dm),
                              bank, h, port_core.TESLA_V100)
    ref = ref_pl.plan_pulsar_stages(
        ref_spec, ref_pl.DispersionPlan.from_spec(ref_spec, n_trials=dm),
        ref_bank, h, ref_core.TESLA_V100)
    assert port.locked == ref.locked
    assert set(port.locked) == {"dedisp", "fdas", "harmonic-sum", "sift"}
    assert dataclasses.asdict(port.report) == dataclasses.asdict(ref.report)
    assert (port.report.i_ef, port.report.slowdown) == \
        (ref.report.i_ef, ref.report.slowdown)
    assert dataclasses.asdict(port.total_profile) == \
        dataclasses.asdict(ref.total_profile)
    assert port.realtime_margin == ref.realtime_margin > 0
    assert dataclasses.asdict(port.realtime) == \
        dataclasses.asdict(ref.realtime)
    assert port.t_acquire == ref.t_acquire == spec.t_acquire


def test_scheduler_is_field_identical():
    case_kw = dict(nchan=16, ntime=2048, dm_trials=8, templates=5, taps=33)
    port_profs = port_core.pulsar_search_workload(
        port_core.PulsarCase(**case_kw), port_core.TESLA_V100)
    ref_profs = ref_core.workloads.pulsar_search_workload(
        ref_core.workloads.PulsarCase(**case_kw), ref_core.TESLA_V100)
    locked = {"fdas": 900.0, "sift": 700.0}
    port_s = port_core.DVFSScheduler(port_core.TESLA_V100)
    ref_s = ref_core.scheduler.DVFSScheduler(ref_core.TESLA_V100)
    port_stages = port_s.plan(port_profs, locked)
    ref_stages = ref_s.plan(ref_profs, locked)
    assert [s.f_locked for s in port_stages] == \
        [s.f_locked for s in ref_stages] == [None, 900.0, None, 700.0]
    assert dataclasses.asdict(port_s.evaluate_pipeline(port_stages)) == \
        dataclasses.asdict(ref_s.evaluate_pipeline(ref_stages))
    for a, b in zip(port_s.power_trace(port_stages, dt=1e-9),
                    ref_s.power_trace(ref_stages, dt=1e-9)):
        assert np.array_equal(a, b)
    for share, gain in ((0.19, 1.5), (0.8, 1.8), (1.0, 1.2)):
        assert port_core.predicted_pipeline_i_ef(share, gain) == \
            ref_core.scheduler.predicted_pipeline_i_ef(share, gain)


def test_realtime_helpers_are_the_references():
    from repro.core import realtime as ref_rt
    from repro_torch.core import realtime as port_rt
    b, rb = (port_rt.RealTimeBudget(8.0, 2.5),
             ref_rt.RealTimeBudget(8.0, 2.5))
    assert (b.speedup, b.slowdown_margin, b.is_realtime(0.5)) == \
        (rb.speedup, rb.slowdown_margin, rb.is_realtime(0.5))
    for slow, margin in ((0.6, 0.0), (0.05, 0.1), (1.2, 0.3)):
        assert port_rt.extra_hardware(slow, margin) == \
            ref_rt.extra_hardware(slow, margin)
        assert port_rt.devices_required(7, slow, margin) == \
            ref_rt.devices_required(7, slow, margin)
    cost, ref_cost = port_rt.CostModel(9000.0), ref_rt.CostModel(9000.0)
    assert cost.total_cost(250.0, 3) == ref_cost.total_cost(250.0, 3)
