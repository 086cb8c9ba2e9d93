"""The port's serving runtime (``repro_torch.serving``) on the CPU:
coalescing, plan/sweep caching, budgets, work stealing, clock locking,
R2C halving, malformed payloads, requeue and retention — the counterparts
of ``tests/test_serving.py`` — plus a parity test against the reference
``repro.serving.FFTService`` on the same numpy requests.

The service runs on the card by default; these tests pass
``devices=[torch.device("cpu")]``, where every kernel wrapper runs its
plain version.  The paper's Tesla V100 prices every batch (the port has
no TPU model).  Results are held to 1e-5 * max |ref|: the plans run the
same f32 schedules as the reference."""
import itertools

import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, fresh_signatures, rand_complex
from repro.core.hardware import TESLA_V100 as REF_V100
from repro.serving import FFTService as RefService
from repro_torch.core import dvfs
from repro_torch.core.hardware import TESLA_V100
from repro_torch.core.scheduler import ClockController
from repro_torch.core.workloads import COMPLEX_BYTES, FFTCase, fft_workload
from repro_torch.fft.plan import plan_for_length
from repro_torch.runtime.workqueue import WorkStealingQueue
from repro_torch.serving import FFTRequest, FFTService, coalesce

CPU = torch.device("cpu")
RTOL = 1e-5


def service(**kw) -> FFTService:
    return FFTService(TESLA_V100, devices=[CPU], **kw)


def requests(sizes, n):
    return [FFTRequest(x=rand_complex(i, (b, n))) for i, b in enumerate(sizes)]


def rand_real(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# batch coalescing (Eq. 6 memory budget)
# ---------------------------------------------------------------------------

def test_coalescing_respects_memory_budget():
    n = 256
    budget = 8 * n * COMPLEX_BYTES["fp32"]        # room for 8 transforms
    reqs = requests([3, 3, 3, 3, 3], n)           # 15 transforms total
    batches = coalesce(reqs, device_name="d", batch_bytes=budget)
    assert sum(b.n_transforms for b in batches) == 15
    for b in batches:
        assert b.bytes <= budget
    flat = [r.request_id for b in batches for r in b.requests]
    assert flat == [r.request_id for r in reqs]   # FIFO across the split


def test_coalescing_never_mixes_shapes():
    reqs = requests([2, 2], 256) + requests([2], 512)
    batches = coalesce(reqs, device_name="d", batch_bytes=1e9)
    assert len(batches) == 2
    assert {b.key.n for b in batches} == {256, 512}


def test_oversized_single_request_gets_own_batch():
    n = 256
    budget = 4 * n * COMPLEX_BYTES["fp32"]
    batches = coalesce(requests([2, 10, 2], n), device_name="d",
                       batch_bytes=budget)
    oversized = [b for b in batches if b.n_transforms > 4]
    assert len(oversized) == 1 and len(oversized[0].requests) == 1


def test_strictest_latency_budget_governs_batch():
    reqs = requests([1, 1, 1], 128)
    reqs[1].latency_budget = 0.30
    reqs[2].latency_budget = 0.05
    (batch,) = coalesce(reqs, device_name="d", batch_bytes=1e9)
    assert batch.latency_budget == pytest.approx(0.05)


# ---------------------------------------------------------------------------
# plan + sweep cache (call counting)
# ---------------------------------------------------------------------------

def _counting_sweep(calls):
    def sweep(profile, device, power_model=None, **kw):
        calls.append(profile.name)
        return dvfs.sweep(profile, device, power_model, **kw)
    return sweep


def test_cache_hits_skip_recomputation():
    plan_calls, sweep_calls = [], []

    def counting_plan(n, kind="c2c"):
        plan_calls.append((n, kind))
        return plan_for_length(n, kind)

    svc = service(plan_fn=counting_plan, sweep_fn=_counting_sweep(sweep_calls))
    for wave in range(3):                          # repeated-shape stream
        for i in range(4):
            svc.submit(rand_complex(wave * 4 + i, (2, 512)))
        svc.submit(rand_real(wave, (3, 512)), transform="r2c")
        svc.drain()
    # one plan build and one sweep per shape ever, despite 3 drains
    assert plan_calls == [(512, "c2c"), (512, "r2c")]
    assert len(sweep_calls) == 2
    stats = svc.cache.stats
    assert stats.misses == 2 and stats.hits == 4
    assert stats.sweeps == 2 and stats.plan_builds == 2
    assert stats.hit_rate == pytest.approx(4 / 6)


def test_budget_reselects_from_cached_sweep_without_resweep():
    # N=8192 on the V100: the unconstrained optimum carries a small
    # positive slowdown, so a zero budget must select a higher clock.
    sweep_calls = []
    svc = service(sweep_fn=_counting_sweep(sweep_calls))
    tight = svc.submit(rand_complex(0, (2, 8192)), latency_budget=0.0)
    svc.drain()
    loose = svc.submit(rand_complex(9, (2, 8192)), latency_budget=2.0)
    svc.drain()
    assert len(sweep_calls) == 1                  # same shape: one sweep
    rt, rl = svc.receipt(tight), svc.receipt(loose)
    assert rt.clock_mhz > rl.clock_mhz
    entry = svc.cache.peek(tight.shape_key(TESLA_V100.name))
    pt = entry.sweep.at(rt.clock_mhz)
    assert pt.time / entry.sweep.boost.time - 1.0 <= 1e-9


def test_service_default_budget_not_relaxed_by_loose_neighbour():
    svc = service(time_budget=0.0)
    a = svc.submit(rand_complex(1, (1, 8192)))            # service default
    svc.submit(rand_complex(2, (1, 8192)), latency_budget=2.0)  # loose
    svc.drain()
    ra = svc.receipt(a)
    entry = svc.cache.peek(a.shape_key(TESLA_V100.name))
    pt = entry.sweep.at(ra.clock_mhz)
    assert pt.time / entry.sweep.boost.time - 1.0 <= 1e-9


def test_sweep_optimal_under_budget_monotone():
    res = dvfs.sweep(fft_workload(FFTCase(n=2**14), TESLA_V100), TESLA_V100)
    clocks = [res.optimal_under_budget(b).f for b in (0.0, 0.02, 0.10, None)]
    assert clocks == sorted(clocks, reverse=True)
    assert res.optimal_under_budget(None).f == res.optimal.f


# ---------------------------------------------------------------------------
# work stealing
# ---------------------------------------------------------------------------

def test_work_stealing_balances_queues():
    q = WorkStealingQueue(2)
    for i in range(4):
        q.push(0, f"job{i}")                      # all work on worker 0
    got = [q.pop(1), q.pop(1)]                    # worker 1 must steal
    assert q.steals == 2
    assert got == ["job3", "job2"]                # thief takes from the back
    assert q.pop(0) == "job0"                     # owner pops FIFO
    assert q.pop(0) == "job1"
    assert q.pop(0) is None and q.pending() == 0


def test_push_least_loaded_round_robins():
    q = WorkStealingQueue(3)
    workers = [q.push_least_loaded(i) for i in range(6)]
    assert sorted(workers) == [0, 0, 1, 1, 2, 2]
    assert q.lengths() == [2, 2, 2]


def test_two_workers_share_the_batches():
    svc = FFTService(TESLA_V100, devices=[CPU, CPU])
    reqs = [svc.submit(rand_complex(i, (1, n))) for i, n in
            enumerate((64, 128, 256))]
    svc.drain()
    assert sorted({svc.receipt(r).worker for r in reqs}) == [0, 1]
    for i, r in enumerate(reqs):
        assert_close(svc.receipt(r).result,
                     np.fft.fft(np.asarray(r.x, np.complex128)), RTOL)


# ---------------------------------------------------------------------------
# end-to-end service
# ---------------------------------------------------------------------------

def test_service_results_match_oracle():
    svc = service()
    payloads = [rand_complex(b, (b, 1024)) for b in (1, 3, 2)]
    reqs = [svc.submit(p) for p in payloads]
    svc.drain()
    for req, p in zip(reqs, payloads):
        r = svc.receipt(req)
        assert_close(r.result, np.fft.fft(p.astype(np.complex128)), RTOL)
        assert r.energy_j > 0 and r.boost_energy_j >= r.energy_j
        assert r.latency >= 0 and r.clock_mhz <= TESLA_V100.f_max
        assert [rec.kernel for rec in r.launches] == ["fft-c2c"]
    rep = svc.report()
    assert rep.n_requests == 3 and rep.n_transforms == 6
    assert rep.n_batches == 1                     # all coalesced
    assert rep.i_ef >= 1.0 and rep.availability == 1.0
    assert rep.p50_latency_s <= rep.p99_latency_s
    assert rep.joules_per_transform > 0 and rep.throughput_tps > 0


def test_tensor_payloads_are_served():
    svc = service()
    x = rand_real(3, (2, 256))
    req = svc.submit(torch.from_numpy(x), transform="r2c")
    svc.drain()
    assert_close(svc.receipt(req).result, np.fft.rfft(x.astype(np.float64)),
                 RTOL)


def test_tensor_payloads_stack_on_their_device():
    """Tensor payloads are stacked with torch on the batch's device: one
    payload already at the execution dtype is used as it is, several are
    concatenated, and a complex payload of an R2C request keeps its real
    part — no numpy round trip."""
    svc = service()
    x = torch.from_numpy(rand_complex(0, (2, 64)))
    svc.submit(x)
    (one,) = coalesce(svc._pending, device_name=TESLA_V100.name,
                      batch_bytes=1e9)
    assert svc._stack(one, CPU).data_ptr() == x.data_ptr()
    xr = torch.from_numpy(rand_real(1, (3, 64)))
    svc._pending = [FFTRequest(x=xr, transform="r2c"),
                    FFTRequest(x=x[0], transform="r2c")]
    (both,) = coalesce(svc._pending, device_name=TESLA_V100.name,
                       batch_bytes=1e9)
    stacked = svc._stack(both, CPU)
    assert stacked.dtype == torch.float32 and stacked.is_contiguous()
    assert torch.equal(stacked, torch.cat([xr, x[:1].real]))


def test_r2c_batches_execute_real_and_pack_double():
    """R2C payloads stack as real arrays (half the device bytes) and the
    Eq. 6 coalescer fits twice as many of them per memory budget."""
    n = 256
    budget = 8 * n * COMPLEX_BYTES["fp32"]        # 8 complex transforms
    xr = rand_real(0, (4, n))
    reqs_c = [FFTRequest(x=rand_complex(i, (4, n))) for i in range(4)]
    reqs_r = [FFTRequest(x=xr, transform="r2c") for _ in range(4)]
    b_c = coalesce(reqs_c, device_name="d", batch_bytes=budget)
    b_r = coalesce(reqs_r, device_name="d", batch_bytes=budget)
    assert len(b_c) == 2 and len(b_r) == 1        # 16 real transforms fit
    assert b_r[0].bytes == b_c[0].bytes           # same footprint, 2x work
    svc = service()
    svc.submit(xr + 0j, transform="r2c")          # complex payload, r2c
    stacked = svc._stack(coalesce(svc._pending, device_name=TESLA_V100.name,
                                  batch_bytes=budget)[0], CPU)
    assert stacked.dtype == torch.float32


def test_service_r2c_requests_halve_energy():
    """R2C requests serve through their own plan/sweep cache entry and
    cost about half the modelled energy of C2C at the same length."""
    n = 1024
    svc = service()
    xr = rand_real(0, (4, n))
    rc = svc.submit(xr, transform="r2c")
    cc = svc.submit(xr.astype(np.complex64))
    svc.drain()
    rec_r, rec_c = svc.receipt(rc), svc.receipt(cc)
    assert_close(rec_r.result, np.fft.rfft(xr.astype(np.float64)), RTOL)
    assert [rec.kernel for rec in rec_r.launches] == ["fft-r2c"]
    assert rec_r.request.bytes == rec_c.request.bytes // 2
    assert rec_r.energy_j < 0.7 * rec_c.energy_j
    assert len(svc.cache) == 2       # distinct transforms, distinct entries


def test_clock_controller_pairs_lock_and_reset():
    ctrl = ClockController(TESLA_V100)
    with ctrl.locked(800.0):
        assert ctrl.current_f == 800.0
        with ctrl.locked(600.0):                  # nested lock restores outer
            assert ctrl.current_f == 600.0
        assert ctrl.current_f == 800.0
    assert ctrl.current_f == TESLA_V100.f_max
    assert ctrl.lock_count == 2
    assert [e.action for e in ctrl.events] == ["lock", "lock", "reset",
                                               "reset"]
    t, f = ctrl.trace()
    assert f[0] == TESLA_V100.f_max and list(f[1:]) == [800.0, 600.0, 800.0,
                                                       TESLA_V100.f_max]


def test_service_clock_locks_bracket_batches():
    svc = service()
    svc.submit(rand_complex(0, (1, 256)))
    svc.submit(rand_complex(1, (1, 512)))
    svc.drain()
    rep = svc.report()
    assert rep.n_batches == 2
    assert rep.clock_locks == 2                   # one lock/reset per batch
    assert svc.clock.current_f == TESLA_V100.f_max   # always reset after


def test_malformed_payload_rejected_at_submit():
    svc = service()
    with pytest.raises(ValueError, match="payload"):
        svc.submit(np.float32(5.0))               # 0-d scalar
    with pytest.raises(ValueError, match="payload"):
        svc.submit(np.zeros((2, 0), np.complex64))
    with pytest.raises(ValueError, match="precision"):
        svc.submit(np.zeros((1, 8), np.complex64), precision="fp8")
    with pytest.raises(ValueError, match="transform"):
        svc.submit(np.zeros((1, 8), np.complex64), transform="c2r")


@pytest.mark.parametrize("kw,slice_name", [
    ({"kind": "pulsar"}, "pulsar"),
])
def test_later_kinds_name_their_slice(kw, slice_name):
    """The pulsar slice has landed: a pulsar request is accepted as a
    rank-2 filterbank keyed on its whole pipeline configuration (served
    in test_torch_serving_pulsar.py)."""
    req = service().submit(np.zeros((2, 8, 8), np.complex64), **kw)
    key = req.shape_key("d")
    assert (req.kind, req.ndim, req.batch) == (slice_name, 2, 2)
    assert (key.shape, key.transform, key.dm_trials, key.templates,
            key.n_harmonics) == ((8, 8), "r2c", 16, 16, 32)


def test_failed_batch_requeues_unserved_requests():
    svc = service()
    ok = svc.submit(rand_complex(0, (1, 128)))
    bad = svc.submit(rand_complex(1, (1, 256)))
    real_execute = svc._execute_batch

    def flaky(batch, worker, device):
        if batch.key.n == 256:
            raise RuntimeError("injected device failure")
        real_execute(batch, worker, device)

    svc._execute_batch = flaky
    with pytest.raises(RuntimeError):
        svc.drain()
    # the healthy request was served; the failed one is re-queued, and no
    # stale batch lingers in the dispatcher
    assert svc.receipt(ok) is not None
    assert svc.receipt(bad) is None
    assert [r.request_id for r in svc._pending] == [bad.request_id]
    assert svc.dispatcher.queue.pending() == 0
    svc._execute_batch = real_execute
    svc.drain()                                   # next cycle serves it
    assert svc.receipt(bad) is not None


def test_receipt_retention_cap_evicts_oldest():
    svc = service(max_retained_receipts=3)
    reqs = [svc.submit(rand_complex(i, (1, 64))) for i in range(5)]
    svc.drain()
    assert len(svc.receipts) == 3
    assert svc.receipt(reqs[0]) is None           # evicted
    assert svc.receipt(reqs[-1]) is not None
    assert svc.report().n_requests == 3           # report covers the window


def test_service_without_a_cuda_device_raises():
    """The service runs on the card unless the caller asks for the CPU;
    with no CUDA device it raises rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFTService()


# ---------------------------------------------------------------------------
# parity with the reference service
# ---------------------------------------------------------------------------

def _timer():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def test_service_matches_reference():
    """The same numpy C2C and R2C requests at n = 256 and 1024 through the
    reference FFTService(TESLA_V100) and the port's: the same batches, the
    same modelled clocks and energies (the same DVFS model), the same
    launch signatures (kernel names and shapes), and results within 1e-5.

    The one deviation: the reference pads a batch's rows to a power of two
    before it launches, the port launches on the rows as coalesced (the
    R2C batch at n = 1024 has 3)."""
    payloads = [
        (rand_complex(0, (3, 256)), "c2c"),
        (rand_real(1, (4, 256)), "r2c"),
        (rand_complex(2, (2, 1024)), "c2c"),
        (rand_complex(3, (1, 256)), "c2c"),
        (rand_real(4, (3, 1024)), "r2c"),
    ]
    # Launch signatures are kept process-wide per shape key (first capture
    # wins); start both packages from none.
    fresh_signatures()
    ref_svc = RefService(REF_V100, timer=_timer())
    port_svc = FFTService(TESLA_V100, devices=[CPU], timer=_timer())
    ref_reqs = [ref_svc.submit(x, transform=t) for x, t in payloads]
    port_reqs = [port_svc.submit(x, transform=t) for x, t in payloads]
    ref_svc.drain()
    port_svc.drain()
    for (x, t), rq, pq in zip(payloads, ref_reqs, port_reqs):
        ref, port = ref_svc.receipt(rq), port_svc.receipt(pq)
        assert (port.batch_id, port.clock_mhz, port.modelled_time_s,
                port.energy_j, port.boost_energy_j) == (
            ref.batch_id, ref.clock_mhz, ref.modelled_time_s,
            ref.energy_j, ref.boost_energy_j)
        rows = sum(q.batch for q in port_reqs
                   if port_svc.receipt(q).batch_id == port.batch_id)
        assert [(r.kernel, r.shape) for r in port.launches] == \
            [(r.kernel, (rows, *r.shape[1:])) for r in ref.launches]
        assert [r.shape[0] for r in ref.launches] == \
            [1 << (rows - 1).bit_length()]
        assert port.launches[0].kernel == ("fft-r2c" if t == "r2c"
                                           else "fft-c2c")
        assert_close(port.result, np.asarray(ref.result), RTOL)
    ref_rep, port_rep = ref_svc.report(), port_svc.report()
    for field in ("n_requests", "n_transforms", "n_batches", "energy_j",
                  "boost_energy_j", "clock_locks"):
        assert getattr(port_rep, field) == getattr(ref_rep, field), field
