"""The slice as a whole: ``repro_torch.fft.plan`` against ``repro.fft.plan``
(Pallas in interpret mode) on the same numpy inputs — algorithm, passes,
launch-ledger counts and outputs — plus the port's routing rules.

Tolerances: max |a-b| <= 1e-5 * max |ref| for pow2 plans (the same f32
schedule on both sides) and 1e-4 for Bluestein (its f32 chirp and filter
spectrum amplify rounding differences)."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
from repro.fft import plan as ref_plan
from repro.fft import stockham as ref_stockham
from repro.tune.config import KernelConfig as RefConfig
from repro_torch.fft import plan as port_plan
from repro_torch.fft import stockham as port_stockham
from repro_torch.kernels.fft import fft_kernel
from repro_torch.obs.ledger import LaunchLedger
from repro_torch.tune.config import ConfigKey, KernelConfig
from repro_torch.tune.cache import TuneRecord, TuningCache
from repro_torch.tune.context import TuningContext, use_tuning

#: The reference records launches only while jax.jit traces, so every
#: reference call here uses a batch shape no other test file uses.
LEAD = (2, 5)

EXPECTED_LEDGER = {
    64: {"fft-c2c": 1},
    4096: {"fft-c2c": 1},
    2**15: {"fft-c2c-axis1": 1, "fft-c2c-t": 1},
    100: {"fft-c2c": 2},
    139: {"fft-c2c": 2},
}


def _rtol(n: int) -> float:
    return 1e-5 if n & (n - 1) == 0 else 1e-4


def _same_plan(port, ref):
    assert (port.n, port.algorithm, port.passes, port.kind, port.stages,
            port.radices) == (ref.n, ref.algorithm, ref.passes, ref.kind,
                              ref.stages, ref.radices)


@pytest.mark.parametrize("n", sorted(EXPECTED_LEDGER))
def test_plan_for_length_matches_reference(n):
    _same_plan(port_plan.plan_for_length(n), ref_plan.plan_for_length(n))
    x = rand_complex(n, (*LEAD, n))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_plan.plan_for_length(n)(x),
        lambda: port_plan.plan_for_length(n)(torch.from_numpy(x)))
    counts = LaunchLedger().counts
    assert counts(port_rec) == counts(ref_rec) == EXPECTED_LEDGER[n]
    assert port.dtype == torch.complex64
    assert_close(port, ref, _rtol(n))


@pytest.mark.parametrize("n", (64, 2**15))
def test_pow2_inverse_matches_reference(n):
    """Single-pass inverse in the kernel; the four-step inverse through the
    conjugate trick (conj(FFT(conj(x))) / n)."""
    x = rand_complex(n + 3, (*LEAD, n))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_plan.pow2_fft(x, inverse=True),
        lambda: port_plan.pow2_fft(torch.from_numpy(x), inverse=True))
    counts = LaunchLedger().counts
    assert counts(port_rec) == counts(ref_rec)
    assert_close(port, ref, 1e-5)
    assert_close(port, np.fft.ifft(x.astype(np.complex128)), 1e-5)


@pytest.mark.parametrize("n,radices,split", [
    (2**15, (8, 4, 2), (64, 512)),
    (100, (2,), None),
])
def test_plan_with_config_matches_reference(n, radices, split):
    port = port_plan.plan_with_config(
        n, config=KernelConfig(radices=radices, split=split))
    ref = ref_plan.plan_with_config(
        n, config=RefConfig(radices=radices, split=split))
    _same_plan(port, ref)
    x = rand_complex(n + 5, (3, 1, n))
    ref_out, port_out, ref_rec, port_rec = run_both(
        lambda: ref(x), lambda: port(torch.from_numpy(x)))
    assert [r.shape for r in port_rec] == [r.shape for r in ref_rec]
    assert_close(port_out, ref_out, _rtol(n))


def test_tuning_context_supplies_the_config():
    cfg = KernelConfig(radices=(2,))
    cache = TuningCache(device="test-device")
    cache.put(ConfigKey("test-device", (64,)), TuneRecord(config=cfg))
    ctx = TuningContext(cache)
    with use_tuning(ctx):
        plan = port_plan.plan_for_length(64)
        port_plan.plan_for_length(64)
    assert plan.radices == (2,) * 6 and ctx.consults == 1
    assert port_plan.plan_for_length(64).radices == (4, 4, 4)


@pytest.mark.parametrize("n", (64, 2**15, 139))
def test_kernels_disabled_runs_pure_torch_without_launches(n):
    x = rand_complex(n + 7, (3, n))
    ledger = LaunchLedger()
    fft_kernel.reset_launches()
    with port_plan.kernels_disabled(), ledger.capture():
        out = port_plan.plan_for_length(n)(torch.from_numpy(x))
    assert ledger.records == []
    assert port_plan._kernels_enabled()
    assert_close(out, np.fft.fft(x.astype(np.complex128)), _rtol(n))


@pytest.mark.parametrize("hook,n", [
    ("_kernel_fft", 64), ("_kernel_fft", 100),
    ("_kernel_fft_axis1", 2**15), ("_kernel_fft_t", 2**15),
])
def test_kernel_failure_propagates_through_the_plan(monkeypatch, hook, n):
    """No hidden fallback: a kernel that raises is not replaced by the
    pure-torch engine."""
    def boom(*args, **kwargs):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(port_plan, hook, boom)
    x = torch.from_numpy(rand_complex(1, (2, n)))
    with pytest.raises(RuntimeError, match="kernel failed"):
        port_plan.plan_for_length(n)(x)


def test_kernel_function_failure_propagates(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("launch refused")
    monkeypatch.setattr(fft_kernel, "fft_c2c_plain", boom)
    with pytest.raises(RuntimeError, match="launch refused"):
        port_plan.plan_for_length(64)(torch.zeros(2, 64,
                                                  dtype=torch.complex64))


def test_real_kinds_wait_for_their_slice():
    """Their slice has landed: both real kinds plan, and only a non-pow2
    c2r and an unknown kind are refused."""
    for kind in ("r2c", "c2r"):
        assert port_plan.plan_for_length(64, kind).kind == kind
    with pytest.raises(ValueError, match="power-of-two"):
        port_plan.plan_for_length(60, "c2r")
    with pytest.raises(ValueError, match="unknown transform kind"):
        port_plan.plan_for_length(64, "dct")


@pytest.mark.parametrize("n", (8, 512))
def test_stockham_engine_matches_reference(n):
    x = rand_complex(n + 11, (4, n))
    for port_fn, ref_fn in ((port_stockham.fft, ref_stockham.fft),
                            (port_stockham.ifft, ref_stockham.ifft)):
        assert_close(port_fn(torch.from_numpy(x)), np.asarray(ref_fn(x)),
                     1e-5)
    xt = np.ascontiguousarray(x.T)
    assert_close(port_stockham.fft(torch.from_numpy(xt), axis=0),
                 np.asarray(ref_stockham.fft(xt, axis=0)), 1e-5)


def test_stockham_engine_keeps_complex128():
    x = rand_complex(3, (2, 256)).astype(np.complex128)
    out = port_stockham.fft(torch.from_numpy(x))
    assert out.dtype == torch.complex128
    assert_close(out, np.fft.fft(x), 1e-12)
