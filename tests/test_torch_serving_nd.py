"""The port's ``FFTService`` serving rank-2 ``KIND_FFT`` and ``KIND_FDAS``
requests, held against the reference ``repro.serving.FFTService`` on the
same numpy requests: the same batches, modelled clocks and energies, cache
counts and validation errors, results within 1e-5 * max |ref| for pow2
transforms, and the same FDAS candidates as (template, bin) sets (ties in
``torch.topk`` may order differently).  The port serves on the CPU here
(``devices=[cpu]``: the kernels' plain versions)."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, fresh_signatures, rand_complex
from repro.core.hardware import TESLA_V100 as REF_V100
from repro.serving import FFTService as RefService
from repro.serving.request import FFTRequest as RefRequest
from repro_torch.core.hardware import TESLA_V100
from repro_torch.serving import KIND_FDAS, FFTRequest, FFTService, coalesce

CPU = torch.device("cpu")
RTOL = 1e-5


def rand_real(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def series(n, k0, z, seed):
    rng = np.random.default_rng(seed)
    s = np.arange(n) / n
    return (0.3 * np.cos(2 * np.pi * (k0 * s + 0.5 * z * s * s))
            + 0.5 * rng.standard_normal(n)).astype(np.float32)[None]


def _timer():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _cells(result) -> set:
    r = np.asarray(result)
    return {(int(t), int(b)) for row in r for t, b, _ in row}


def test_2d_and_fdas_requests_match_reference():
    payloads = [
        (rand_complex(0, (3, 16, 32)), dict(ndim=2)),
        (rand_real(1, (2, 16, 32)), dict(ndim=2, transform="r2c")),
        (rand_complex(2, (2, 512)), {}),
        (series(2048, 150, 2.0, 3), dict(kind=KIND_FDAS, templates=9)),
        (rand_complex(4, (16, 32)), dict(ndim=2)),
        (np.concatenate([series(2048, 300, -3.0, 5),
                         series(2048, 700, 1.0, 6)]),
         dict(kind=KIND_FDAS, templates=9)),
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
                port.energy_j, port.boost_energy_j) == (
            ref.batch_id, ref.clock_mhz, ref.modelled_time_s,
            ref.energy_j, ref.boost_energy_j)
        assert [r.kernel for r in port.launches] == \
            [r.kernel for r in ref.launches]
        if kw.get("kind") == KIND_FDAS:
            assert tuple(port.result.shape) == np.asarray(ref.result).shape
            assert _cells(port.result) == _cells(ref.result)
            assert_close(port.result[..., 2], np.asarray(ref.result)[..., 2],
                         1e-4)
        else:
            assert_close(port.result, np.asarray(ref.result), RTOL)
    assert [r.kernel for r in port_svc.receipt(port_reqs[0]).launches] == \
        ["fft-c2c-t", "fft-c2c-t"]
    assert [r.kernel for r in port_svc.receipt(port_reqs[3]).launches] == \
        ["fft-r2c", "fft-c2c-mul", "fft-c2c"]
    ref_rep, port_rep = ref_svc.report(), port_svc.report()
    for field in ("n_requests", "n_transforms", "n_batches", "energy_j",
                  "boost_energy_j", "clock_locks"):
        assert getattr(port_rep, field) == getattr(ref_rep, field), field
    for field in ("hits", "misses", "plan_builds", "sweeps"):
        assert getattr(port_svc.cache.stats, field) == \
            getattr(ref_svc.cache.stats, field), field


def test_fdas_candidates_recover_the_injected_pulsar():
    """Each served FDAS row answers with its own candidates: the injected
    tone's (template, bin) cell is the first candidate of its row."""
    svc = FFTService(TESLA_V100, devices=[CPU], time_budget=None)
    # templates=9 searches drifts -4, -3, ..., 4 (the linear bank).
    x = np.concatenate([series(4096, 300, 3.0, 1), series(4096, 900, -2.0, 2)])
    req = svc.submit(x, kind=KIND_FDAS, templates=9)
    svc.drain()
    rec = svc.receipt(req)
    top = rec.result[:, 0, :2].numpy().astype(int).tolist()
    assert top[0][0] == 7 and abs(top[0][1] - 300) <= 1    # z = +3: t = 7
    assert top[1][0] == 2 and abs(top[1][1] - 900) <= 1    # z = -2: t = 2
    assert rec.energy_j > 0 and rec.result.dtype == torch.float32


def test_2d_and_1d_keys_of_the_same_points_are_distinct():
    a = FFTRequest(x=np.zeros((2, 16, 32), np.complex64), ndim=2)
    b = FFTRequest(x=np.zeros((2, 512), np.complex64))
    assert a.n == b.n == 512 and a.shape == (16, 32) and b.shape == (512,)
    assert a.shape_key("d") != b.shape_key("d")
    ra = RefRequest(x=np.zeros((2, 16, 32), np.complex64), ndim=2)
    for field in ("kind", "n", "precision", "transform", "shape",
                  "templates", "segment"):
        assert getattr(a.shape_key("d"), field) == \
            getattr(ra.shape_key("d"), field), field
    f = FFTRequest(x=np.zeros((1, 64), np.float32), kind=KIND_FDAS,
                   templates=9, segment=32)
    rf = RefRequest(x=np.zeros((1, 64), np.float32), kind="fdas",
                    templates=9, segment=32)
    assert (f.shape_key("d").templates, f.shape_key("d").segment) == \
        (rf.shape_key("d").templates, rf.shape_key("d").segment) == (9, 32)
    svc = FFTService(TESLA_V100, devices=[CPU])
    svc.submit(np.ones((2, 16, 32), np.complex64), ndim=2)
    svc.submit(np.ones((2, 512), np.complex64))
    svc.drain()
    assert len(svc.cache) == 2 and svc.cache.stats.misses == 2


@pytest.mark.parametrize("x,kw", [
    (np.zeros((4, 4), np.complex64), dict(ndim=3)),
    (np.zeros((2, 4, 4), np.complex64), dict(ndim=2, kind="fdas")),
    (np.zeros((1, 64), np.float32), dict(kind="fdas", templates=0)),
    (np.zeros((2, 0, 4), np.complex64), dict(ndim=2)),
    (np.zeros((2, 2, 4, 4), np.complex64), dict(ndim=2)),
    (np.zeros((1, 8), np.complex64), dict(kind="hartley")),
])
def test_validation_errors_are_the_references(x, kw):
    with pytest.raises(ValueError) as ref_err:
        RefRequest(x=x, **kw)
    with pytest.raises(ValueError) as port_err:
        FFTRequest(x=x, **kw)
    assert str(port_err.value) == str(ref_err.value)


def test_nd_payloads_stack_as_rows_of_the_shape():
    """Numpy and tensor N-D payloads, with and without a batch axis, stack
    as (rows, *shape); FDAS series stack real, in float32."""
    svc = FFTService(TESLA_V100, devices=[CPU])
    xs = [torch.from_numpy(rand_complex(0, (2, 8, 16))),
          torch.from_numpy(rand_complex(1, (8, 16)))]
    svc._pending = [FFTRequest(x=x, ndim=2) for x in xs]
    (batch,) = coalesce(svc._pending, device_name="d", batch_bytes=1e9)
    stacked = svc._stack(batch, CPU)
    assert tuple(stacked.shape) == (3, 8, 16)
    assert torch.equal(stacked, torch.cat([xs[0], xs[1][None]]))
    f = [FFTRequest(x=series(256, 10, 0.0, 1).astype(np.float64) + 0j,
                    kind=KIND_FDAS, templates=3)]
    (fb,) = coalesce(f, device_name="d", batch_bytes=1e9)
    assert svc._stack(fb, CPU).dtype == torch.float32


def test_pulsar_requests_still_name_their_slice():
    """Pulsar requests are served now: the port accepts what the reference
    accepts and rejects a DM grid of no trials with its error."""
    x = np.zeros((2, 8, 8), np.float32)
    port = FFTRequest(x=x, kind="pulsar")
    ref = RefRequest(x=x, kind="pulsar")
    assert dataclasses.asdict(port.shape_key("d")) == \
        dataclasses.asdict(ref.shape_key("d"))
    with pytest.raises(ValueError) as ref_err:
        RefRequest(x=x, kind="pulsar", dm_trials=0)
    with pytest.raises(ValueError) as port_err:
        FFTRequest(x=x, kind="pulsar", dm_trials=0)
    assert str(port_err.value) == str(ref_err.value)
