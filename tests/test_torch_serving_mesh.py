"""The port's sharded service, ``FFTService(mesh=...)``, on meshes of CPU
slots: plain-FFT batches of more than one row split over the mesh's
``data`` axis (``batch_parallel_fft`` with the entry's plan), each shard
launching the plan's kernels (their plain versions here).

Held against ``np.fft`` (the reference's sharded-service test fails under
the installed jax) and against the unsharded port service on the same
stream: the same batches, rungs, clocks and modelled energy on every
receipt.  Rung 2 never shards."""
import numpy as np
import pytest
import torch

from repro_torch.core.hardware import TESLA_V100
from repro_torch.fft.distributed import make_mesh
from repro_torch.serving import (RUNG_PURE_TORCH, SLO, FFTService,
                                 SLOPolicy)
from repro_torch.serving import service as service_mod

CPU = torch.device("cpu")
RTOL = 2e-5
#: Receipt fields that must not depend on where the batch ran.
SAME = ("batch_id", "worker", "status", "rung", "reason", "clock_mhz",
        "modelled_time_s", "energy_j", "boost_energy_j")


def mesh(d: int = 4):
    return make_mesh((d,), ("data",), devices=[CPU] * d)


def rand(seed: int, shape, is_complex: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if is_complex:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


def assert_close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


@pytest.fixture
def shard_calls(monkeypatch):
    """Every batch_parallel_fft call the service makes: (rows, shards)."""
    calls = []
    orig = service_mod.batch_parallel_fft

    def counting(x, m, **kw):
        calls.append((x.shape[0], m.shape["data"]))
        return orig(x, m, **kw)
    monkeypatch.setattr(service_mod, "batch_parallel_fft", counting)
    return calls


def _serve(svc, stream):
    reqs = [svc.submit(x, **kw) for x, kw in stream]
    svc.drain()
    return [svc.receipt(r) for r in reqs]


def test_sharded_service_matches_numpy_and_the_unsharded_service(
        shard_calls):
    stream = [(rand(0, (2, 256)), {}), (rand(1, (3, 256)), {}),
              (rand(2, (5, 512)), {}), (rand(3, (1, 1024)), {}),
              (rand(4, (6, 128), False), {"transform": "r2c"}),
              (rand(5, (3, 16, 32)), {"ndim": 2})]
    sharded = _serve(FFTService(TESLA_V100, mesh=mesh()), stream)
    # (2 + 3) rows of 256, 5 of 512, 6 real of 128, 3 of (16, 32); the
    # single 1024-point row runs whole
    assert sorted(shard_calls) == [(3, 4), (5, 4), (5, 4), (6, 4)]
    plain = _serve(FFTService(TESLA_V100, devices=[CPU]), stream)
    for (x, kw), a, b in zip(stream, sharded, plain):
        for field in SAME:
            assert getattr(a, field) == getattr(b, field), field
        if kw.get("transform") == "r2c":
            want = np.fft.rfft(x, axis=-1)
        elif kw.get("ndim") == 2:
            want = np.fft.fft2(x, axes=(-2, -1))
        else:
            want = np.fft.fft(x, axis=-1)
        assert_close(a.result, want)
        assert_close(a.result, b.result.numpy())


def test_a_five_row_batch_runs_on_four_shards():
    """Rows 5 -> 8 over 4 shards: each shard's plan launches once on 2
    rows (the last two shards partly or wholly zero padding)."""
    svc = FFTService(TESLA_V100, mesh=mesh())
    x = rand(7, (5, 256))
    (r,) = _serve(svc, [(x, {})])
    assert [(rec.kernel, rec.shape) for rec in svc.ledger.records] == [
        ("fft-c2c", (2, 256))] * 4
    assert r.result.shape == (5, 256)
    assert_close(r.result, np.fft.fft(x, axis=-1))


def test_rung_2_never_shards(shard_calls):
    policy = SLOPolicy(default=SLO(deadline_s=1.0, degrade_at=0.0,
                                   degrade_hard_at=0.0, shed_at=None))
    svc = FFTService(TESLA_V100, mesh=mesh(), slo=policy)
    x = rand(8, (4, 256))
    (r,) = _serve(svc, [(x, {})])
    assert r.rung == RUNG_PURE_TORCH and shard_calls == []
    assert svc.ledger.records == []        # the pure-torch engine on CPU
    assert_close(r.result, np.fft.fft(x, axis=-1))
    svc.slo = svc.admission = None
    (r,) = _serve(svc, [(x, {})])
    assert r.rung == 0 and shard_calls == [(4, 4)]
    assert_close(r.result, np.fft.fft(x, axis=-1))


def test_a_mesh_service_has_one_worker_on_the_first_device():
    devs = [torch.device("cpu", i) for i in range(4)]
    m = make_mesh((2, 2), ("data", "model"), devices=devs)
    svc = FFTService(TESLA_V100, mesh=m)
    assert svc.dispatcher.devices == [devs[0]]
    assert svc.dispatcher.queue.n_workers == 1
    x = rand(9, (3, 64))
    (r,) = _serve(svc, [(x, {})])
    assert r.worker == 0
    assert_close(r.result, np.fft.fft(x, axis=-1))
