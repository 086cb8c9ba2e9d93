"""The port's N-D plan graph (``repro_torch.fft.plan_nd``) and its
``fft2``/``rfft2``/``fftn``/``rfftn`` against the reference's, on the
cases of ``tests/test_plan_nd.py``: the same node lists, ``passes``,
``chain_passes``, ``stages`` and ``out_shape``, the same ledger launches,
and the same numbers from one numpy input (the reference runs its Pallas
kernels in interpret mode, the port its kernels' plain versions).

Tolerances: max |a-b| <= 1e-5 * max |ref| for pow2 shapes (the same f32
schedules), 1e-4 with a Bluestein axis (its f32 chirp)."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from test_torch_parity import (assert_close, assert_same_launches,
                               rand_complex, run_both)
import repro.fft as ref_fft
from repro.core.hardware import TESLA_V100 as REF_V100
from repro.core.workloads import FFTCase as RefCase
from repro.core.workloads import fft_workload as ref_workload
import repro_torch.fft as port_fft
from repro_torch.core.hardware import TESLA_V100
from repro_torch.core.workloads import FFTCase, fft_workload
from repro_torch.fft import plan as port_plan
from repro_torch.fft.plan_nd import nd_pass_summary, plan_nd

# ``repro.fft.plan_nd`` names the function once ``repro.fft`` is imported.
ref_plan_nd_mod = importlib.import_module("repro.fft.plan_nd")

POW2_RTOL = 1e-5
BLUESTEIN_RTOL = 1e-4


def rand_real(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rtol(shape) -> float:
    return BLUESTEIN_RTOL if any(n & (n - 1) for n in shape) else POW2_RTOL


def _fields(plan) -> dict:
    return {"shape": plan.shape, "kind": plan.kind,
            "nodes": [dataclasses.asdict(n) for n in plan.nodes],
            "passes": plan.passes, "chain_passes": plan.chain_passes,
            "stages": plan.stages, "out_shape": plan.out_shape,
            "algorithm": plan.algorithm, "n": plan.n}


SPECS = [
    ((256, 512), "c2c"), ((256, 512), "r2c"), ((16, 16, 16), "c2c"),
    ((12, 32), "c2c"), ((4, 2**14), "c2c"), ((16, 2**14), "r2c"),
    ((45, 39), "c2c"), ((16, 100), "r2c"), ((64, 1), "r2c"),
    ((1, 64), "c2c"), ((4, 2), "r2c"), ((4096,), "c2c"), ((100,), "r2c"),
    ((2048, 2048), "c2c"), ((4096, 8192), "r2c"), ((512, 512, 512), "c2c"),
    ((1024, 19321), "c2c"),
]


@pytest.mark.parametrize("shape,kind", SPECS)
def test_plan_graph_is_the_reference_graph(shape, kind):
    ref = ref_plan_nd_mod.plan_nd(shape, kind)
    port = plan_nd(shape, kind)
    assert _fields(port) == _fields(ref)
    assert nd_pass_summary(shape, kind) == \
        ref_plan_nd_mod.nd_pass_summary(shape, kind)


def test_pow2_plans_take_one_pass_per_axis():
    assert [n.op for n in plan_nd((2048, 2048)).nodes] == ["fft_t", "fft_t"]
    assert plan_nd((2048, 2048)).passes == 2
    assert [n.op for n in plan_nd((4096, 8192), "r2c").nodes] == \
        ["rfft_t", "fft_t"]
    assert [n.op for n in plan_nd((512, 512, 512)).nodes] == ["fft_t"] * 3
    assert [n.op for n in plan_nd((1024, 19321)).nodes] == \
        ["fft1d", "transpose", "fft_t"]


FFT2_SHAPES = [(8, 16), (32, 32), (12, 32), (16, 100), (45, 39), (4, 1)]


@pytest.mark.parametrize("shape", FFT2_SHAPES)
def test_fft2_matches_reference(shape):
    x = rand_complex(sum(shape), (3, *shape))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_fft.fft2(x), lambda: port_fft.fft2(torch.from_numpy(x)))
    assert_close(port, ref, _rtol(shape))
    assert_close(port, np.fft.fft2(x.astype(np.complex128)), _rtol(shape))
    assert_same_launches(ref_rec, port_rec)


def test_default_axes_moved_axes_and_repeated_axes():
    x = rand_complex(3, (8, 4, 16))
    xt = torch.from_numpy(x)
    assert_close(port_fft.fftn(xt), np.asarray(ref_fft.fftn(x)), POW2_RTOL)
    assert_close(port_fft.fft2(xt, axes=(0, 2)),
                 np.asarray(ref_fft.fft2(x, axes=(0, 2))), POW2_RTOL)
    assert_close(port_fft.fftn(xt, axes=(2, 2)),
                 np.asarray(ref_fft.fftn(x, axes=(2, 2))), POW2_RTOL)
    with pytest.raises(ValueError, match="repeated axes"):
        port_fft.rfftn(torch.from_numpy(rand_real(0, (4, 8))), axes=(1, 1))


def test_pow2_2d_takes_exactly_two_fused_launches():
    """``BENCH_fft2.json``: ``pow2_2d_passes_ledger = 2``."""
    x = rand_complex(5, (5, 16, 64))
    _, port, _, port_rec = run_both(
        lambda: 0, lambda: port_fft.fft2(torch.from_numpy(x)))
    assert [r.kernel for r in port_rec] == ["fft-c2c-t", "fft-c2c-t"]
    _, _, _, real_rec = run_both(
        lambda: 0,
        lambda: port_fft.rfft2(torch.from_numpy(rand_real(6, (5, 16, 64)))))
    assert [r.kernel for r in real_rec] == ["fft-r2c-t", "fft-c2c-t"]


class _Counting:
    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)


def test_bluestein_axis_routes_the_transpose_hook(monkeypatch):
    tr = _Counting(port_plan.transpose_kernel)
    fused = _Counting(port_plan.fft_kernel_c2c_t)
    monkeypatch.setattr(port_plan, "_kernel_transpose", tr)
    monkeypatch.setattr(port_plan, "_kernel_fft_t", fused)
    x = rand_complex(7, (4, 12, 32))
    assert_close(port_fft.fft2(torch.from_numpy(x)),
                 np.fft.fft2(x.astype(np.complex128)), BLUESTEIN_RTOL)
    assert tr.calls == 1 and fused.calls == 1


def test_kernels_disabled_runs_the_torch_engine(monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("a kernel ran under kernels_disabled()")

    for hook in ("_kernel_fft", "_kernel_fft_t", "_kernel_fft_axis1",
                 "_kernel_rfft", "_kernel_rfft_t", "_kernel_transpose"):
        monkeypatch.setattr(port_plan, hook, fail)
    x = rand_complex(8, (6, 16, 32))
    xr = rand_real(9, (6, 12, 32))
    with port_plan.kernels_disabled():
        assert_close(port_fft.fft2(torch.from_numpy(x)),
                     np.fft.fft2(x.astype(np.complex128)), POW2_RTOL)
        assert_close(port_fft.rfft2(torch.from_numpy(xr)),
                     np.fft.rfft2(xr.astype(np.float64)), BLUESTEIN_RTOL)


def test_plan_nd_1d_degenerates_to_the_planner():
    plan = plan_nd((4096,))
    ref = port_plan.plan_for_length(4096)
    assert (plan.passes, plan.algorithm, plan.fn) == (ref.passes,
                                                      ref.algorithm, ref.fn)
    with pytest.raises(ValueError):
        plan_nd((0, 8))
    with pytest.raises(ValueError):
        plan_nd((8, 8), "hartley")
    with pytest.raises(ValueError, match="trailing axes"):
        plan_nd((8, 8))(torch.zeros(2, 8, 4, dtype=torch.complex64))


@pytest.mark.parametrize("shape,transform", [
    ((1024, 1024), "c2c"), ((512, 512), "r2c"), ((2048, 2048), "c2c"),
    ((4096, 8192), "r2c"), ((512, 512, 512), "c2c"), ((1024, 19321), "c2c"),
])
def test_nd_workload_is_the_reference_workload(shape, transform):
    port = fft_workload(FFTCase(shape=shape, transform=transform), TESLA_V100)
    ref = ref_workload(RefCase(shape=shape, transform=transform), REF_V100)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
