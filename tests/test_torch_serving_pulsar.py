"""The port's ``FFTService`` serving ``KIND_PULSAR`` requests, held against
the reference ``repro.serving.FFTService`` on the same numpy filterbanks
(8 channels x 512 samples, 4 DM trials, 5 templates, 4 harmonics): the
same batches, clocks, modelled energies, per-stage receipts (locked clock,
time and energy shares), real-time margin, launches and cache counts; the
sifted candidates equal as cells and within 1e-4 * max |ref| in their
statistic; and one cache entry per pipeline configuration.  The port
serves on the CPU here (``devices=[cpu]``: the kernels' plain versions)."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, fresh_signatures, rand_complex
from repro.core.hardware import TESLA_V100 as REF_V100
from repro.serving import FFTService as RefService
from repro_torch.core.hardware import TESLA_V100
from repro_torch.data.synthetic import (FilterbankSpec, InjectedPulsar,
                                        synthetic_filterbank)
from repro_torch.search.pipeline import DispersionPlan
from repro_torch.serving import KIND_PULSAR, FFTService, ShapeKey
from repro_torch.serving.cache import PlanSweepCache

CPU = torch.device("cpu")
SPEC = FilterbankSpec(nchan=8, ntime=512)
PLAN = DispersionPlan.from_spec(SPEC, n_trials=4)
PULSAR_KW = dict(kind=KIND_PULSAR, n_harmonics=4, templates=5, dm_trials=4)


def filterbank(dm_trial, k0, seed, amp=0.4):
    pulsars = () if dm_trial is None else (
        InjectedPulsar(dm=PLAN.dms[dm_trial], k0=k0, z=0.0, amp=amp),)
    return synthetic_filterbank(SPEC, pulsars, noise=1.0, seed=seed)


def _timer():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _cells(result) -> set:
    r = np.asarray(result)
    return {tuple(int(v) for v in row[:4]) for b in r for row in b
            if row[0] >= 0}


def test_pulsar_requests_match_reference():
    payloads = [
        (filterbank(2, 90, 0), PULSAR_KW),
        (np.stack([filterbank(None, 0, 1), filterbank(1, 140, 2)]),
         PULSAR_KW),
        (rand_complex(3, (2, 256)), {}),
        (filterbank(3, 60, 4), dict(PULSAR_KW, n_harmonics=8)),
    ]
    fresh_signatures()
    ref_svc = RefService(REF_V100, timer=_timer(), batch_bytes=2**24)
    port_svc = FFTService(TESLA_V100, devices=[CPU], timer=_timer(),
                          batch_bytes=2**24)
    ref_reqs = [ref_svc.submit(x, **kw) for x, kw in payloads]
    port_reqs = [port_svc.submit(x, **kw) for x, kw in payloads]
    ref_svc.drain()
    port_svc.drain()
    for (x, kw), rq, pq in zip(payloads, ref_reqs, port_reqs):
        ref, port = ref_svc.receipt(rq), port_svc.receipt(pq)
        assert (port.batch_id, port.clock_mhz, port.modelled_time_s,
                port.energy_j, port.boost_energy_j,
                port.realtime_margin) == (
            ref.batch_id, ref.clock_mhz, ref.modelled_time_s,
            ref.energy_j, ref.boost_energy_j, ref.realtime_margin)
        assert [r.kernel for r in port.launches] == \
            [r.kernel for r in ref.launches]
        if kw.get("kind") != KIND_PULSAR:
            assert port.stages is None and ref.stages is None
            assert_close(port.result, np.asarray(ref.result), 1e-5)
            continue
        assert [dataclasses.asdict(s) for s in port.stages] == \
            [dataclasses.asdict(s) for s in ref.stages]
        assert tuple(port.result.shape) == np.asarray(ref.result).shape
        assert _cells(port.result) == _cells(ref.result)
        assert_close(np.sort(port.result[..., 4].numpy(), axis=-1),
                     np.sort(np.asarray(ref.result)[..., 4], axis=-1), 1e-4)
    first = port_svc.receipt(port_reqs[0])
    assert [s.name for s in first.stages] == ["dedisp", "fdas",
                                              "harmonic-sum", "sift"]
    assert [r.kernel for r in first.launches] == [
        "dedisperse", "fft-r2c", "fft-c2c-mul", "fft-c2c",
        "harmonic-sum-plane"]
    top = first.result[0, 0].tolist()
    assert top[:3] == [2, 2, 90] and top[4] > 25.0
    # The quiet filterbank of request 1 has no candidate; the loud one its
    # own pulsar.
    second = port_svc.receipt(port_reqs[1]).result
    assert bool((second[0, :, 0] == -1).all())
    assert second[1, 0, :3].tolist() == [1, 2, 140]
    ref_rep, port_rep = ref_svc.report(), port_svc.report()
    for field in ("n_requests", "n_transforms", "n_batches", "energy_j",
                  "boost_energy_j", "clock_locks"):
        assert getattr(port_rep, field) == getattr(ref_rep, field), field
    for field in ("hits", "misses", "plan_builds", "sweeps"):
        assert getattr(port_svc.cache.stats, field) == \
            getattr(ref_svc.cache.stats, field), field


def test_requests_of_one_configuration_share_a_batch():
    svc = FFTService(TESLA_V100, devices=[CPU], time_budget=None)
    reqs = [svc.submit(filterbank(d, k, s), **PULSAR_KW)
            for d, k, s in ((2, 90, 0), (1, 140, 2))]
    svc.drain()
    receipts = [svc.receipt(r) for r in reqs]
    assert receipts[0].batch_id == receipts[1].batch_id
    assert [r.result[0, 0, :3].tolist() for r in receipts] == \
        [[2, 2, 90], [1, 2, 140]]
    # Two one-filterbank requests get equal stage shares of the batch.
    for r in receipts:
        assert all(s.clock_mhz > 0 and s.energy_j > 0 for s in r.stages)
    assert receipts[0].stages == receipts[1].stages
    assert svc.cache.stats.misses == 1 and len(svc.cache) == 1


class TestPulsarCacheKeys:
    NCHAN, NTIME = 8, 512

    def _key(self, dm_trials=4, templates=5, n_harmonics=4):
        return ShapeKey(kind="pulsar", n=self.NCHAN * self.NTIME,
                        precision="fp32", n_harmonics=n_harmonics,
                        device=TESLA_V100.name, transform="r2c",
                        shape=(self.NCHAN, self.NTIME),
                        templates=templates, dm_trials=dm_trials)

    def test_distinct_configurations_get_distinct_entries(self):
        from repro.serving.cache import PlanSweepCache as RefCache
        from repro.serving.request import ShapeKey as RefKey
        cache = PlanSweepCache(TESLA_V100, batch_bytes=2**24)
        ref_cache = RefCache(REF_V100, batch_bytes=2**24)
        base = cache.entry(self._key())
        assert cache.entry(self._key()) is base
        for kw in (dict(dm_trials=8), dict(templates=3),
                   dict(n_harmonics=8)):
            assert cache.entry(self._key(**kw)) is not base
            e = cache.entry(self._key(**kw))
            ref = ref_cache.entry(RefKey(**dataclasses.asdict(
                self._key(**kw))))
            assert e.locked == ref.locked
            assert e.realtime_margin == ref.realtime_margin
            assert e.n_fft_model == ref.n_fft_model
            assert dataclasses.asdict(e.stages) == \
                dataclasses.asdict(ref.stages)
        assert (cache.stats.misses, cache.stats.hits) == (4, 4)

    def test_entry_carries_the_stage_plan(self):
        e = PlanSweepCache(TESLA_V100, batch_bytes=2**24).entry(self._key())
        assert e.plan.n_trials == 4 and e.plan.nchan == self.NCHAN
        assert set(e.locked) == {"dedisp", "fdas", "harmonic-sum", "sift"}
        assert len(e.stages.stages) == 4
        assert e.realtime_margin is not None and e.realtime_margin > 0

    def test_key_without_a_filterbank_shape_is_refused(self):
        key = dataclasses.replace(self._key(), shape=(4096,))
        with pytest.raises(ValueError, match="nchan, ntime"):
            PlanSweepCache(TESLA_V100, batch_bytes=2**24).entry(key)


@pytest.mark.parametrize("x,kw", [
    (np.zeros((2, 8, 8), np.float32), dict(kind="pulsar", dm_trials=0)),
    (np.zeros((2, 8, 8), np.float32), dict(kind="pulsar", templates=0)),
    (np.zeros((8,), np.float32), dict(kind="pulsar")),
    (np.zeros((2, 2, 8, 8), np.float32), dict(kind="pulsar")),
])
def test_pulsar_validation_is_the_references(x, kw):
    from repro.serving.request import FFTRequest as RefRequest
    from repro_torch.serving import FFTRequest
    with pytest.raises(ValueError) as ref_err:
        RefRequest(x=x, **kw)
    with pytest.raises(ValueError) as port_err:
        FFTRequest(x=x, **kw)
    assert str(port_err.value) == str(ref_err.value)


def test_pulsar_payloads_stack_real_float32():
    from repro_torch.serving import FFTRequest, coalesce
    svc = FFTService(TESLA_V100, devices=[CPU])
    xs = [filterbank(None, 0, 5).astype(np.float64) + 0j,
          torch.from_numpy(np.stack([filterbank(None, 0, 6)] * 2))]
    (numpy_batch,) = coalesce([FFTRequest(x=xs[0], **PULSAR_KW)],
                              device_name="d", batch_bytes=1e9)
    stacked = svc._stack(numpy_batch, CPU)
    assert stacked.dtype == torch.float32 and tuple(stacked.shape) == \
        (1, 8, 512)
    assert torch.equal(stacked[0], torch.from_numpy(xs[0].real.astype(
        np.float32)))
    (tensor_batch,) = coalesce([FFTRequest(x=xs[1], **PULSAR_KW)],
                               device_name="d", batch_bytes=1e9)
    assert tuple(svc._stack(tensor_batch, CPU).shape) == (2, 8, 512)
