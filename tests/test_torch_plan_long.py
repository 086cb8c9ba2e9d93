"""The long routes of the plans on the CPU: the real plans whose half
length takes the four-step pair (pack, four-step, split; merge, inverse
four-step, unpack), the long C2C inverse on the four-step's own inverse
passes, and Bluestein at the paper's 19321, whose inner inverse is one.

Outputs against ``torch.fft`` in float64 and the JAX reference (Pallas in
interpret mode) on the same numpy inputs: 1e-5 of max |ref| for pow2
lengths (float32 passes), 1e-4 for Bluestein (its float32 chirp and
filter spectrum amplify rounding differences)."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
from test_torch_plan_real import FOUR_STEP, LONG_REAL
from repro.fft import bluestein as ref_bluestein
from repro.fft import plan as ref_plan
from repro_torch.fft import bluestein as port_bluestein
from repro_torch.fft import plan as port_plan
from repro_torch.obs import trace
from repro_torch.obs.ledger import LaunchLedger

#: The reference records launches only while jax.jit traces, so every
#: reference call here uses a batch shape no other test file uses.
LEAD = (1, 3)


def _real_input(kind: str, n: int, double: bool) -> torch.Tensor:
    rng = np.random.default_rng(n + len(kind) + double)
    x = rng.standard_normal((3, n))
    if kind == "r2c":
        return torch.from_numpy(x if double else x.astype(np.float32))
    spec = np.fft.rfft(x)
    return torch.from_numpy(spec if double else spec.astype(np.complex64))


@pytest.mark.parametrize("double", (False, True))
@pytest.mark.parametrize("kind", ("r2c", "c2r"))
@pytest.mark.parametrize("n", (2**15, 2**16, 2**17))
def test_long_real_plans_match_torch_fft(n, kind, double):
    """float32 or float64 input, complex64 or complex128 spectra: the
    plan runs in float32 and complex64 either way."""
    x = _real_input(kind, n, double)
    ledger = LaunchLedger()
    with ledger.capture():
        y = port_plan.plan_for_length(n, kind)(x)
    assert ledger.counts() == LONG_REAL[kind]
    wide = x.to(torch.float64 if kind == "r2c" else torch.complex128)
    if kind == "r2c":
        assert y.dtype == torch.complex64
        want = torch.fft.rfft(wide)
    else:
        assert y.dtype == torch.float32
        want = torch.fft.irfft(wide, n=n)
    assert_close(y, want.numpy(), 1e-5)


@pytest.mark.parametrize("kernels", ("on", "off"))
@pytest.mark.parametrize("n", (2**14, 2**15, 2**16))
def test_long_inverse_matches_ifft_and_reference(n, kernels, monkeypatch):
    """The pow2 long inverse runs the four-step inverse (no conjugate
    trick), with its kernels or, disabled, in pure torch."""
    def no_conj(*args, **kwargs):
        raise AssertionError("the pow2 inverse took the conjugate trick")
    monkeypatch.setattr(port_plan, "_conj_inverse", no_conj)
    x = rand_complex(n + 5, (*LEAD, n))

    def port():
        if kernels == "off":
            with port_plan.kernels_disabled():
                return port_plan.pow2_fft(torch.from_numpy(x), inverse=True)
        return port_plan.pow2_fft(torch.from_numpy(x), inverse=True)

    ref, got, _, port_rec = run_both(
        lambda: ref_plan.pow2_fft(x, inverse=True), port)
    assert LaunchLedger().counts(port_rec) == (FOUR_STEP if kernels == "on"
                                               else {})
    assert got.dtype == torch.complex64
    assert_close(got, ref, 1e-5)
    assert_close(got, np.fft.ifft(x.astype(np.complex128)), 1e-5)


@pytest.mark.parametrize("route", ("bluestein_fft", "plan"))
def test_bluestein_19321_matches_reference(route):
    """Forward Bluestein: its inner inverse is a 65536-point long
    inverse, two four-step pairs in all."""
    n = 19321
    x = rand_complex(n, (2, n))
    if route == "plan":
        ref_fn = lambda: ref_plan.plan_for_length(n)(x)  # noqa: E731
        port_fn = lambda: port_plan.plan_for_length(n)(  # noqa: E731
            torch.from_numpy(x))
    else:
        ref_fn = lambda: ref_bluestein.bluestein_fft(x)  # noqa: E731
        port_fn = lambda: port_bluestein.bluestein_fft(  # noqa: E731
            torch.from_numpy(x))
    ref, got, _, port_rec = run_both(ref_fn, port_fn)
    assert LaunchLedger().counts(port_rec) == {k: 2 * v
                                               for k, v in FOUR_STEP.items()}
    assert_close(got, ref, 1e-4)
    assert_close(got, np.fft.fft(x.astype(np.complex128)), 1e-4)


def test_inverse_four_step_table_is_built_once():
    """The conjugate inter-pass table is cached beside the forward one,
    once per (n1, n2, device, direction), and is its exact conjugate; a
    direct lookup (as the distributed pencil makes) shares the plan's
    entry."""
    x = torch.from_numpy(rand_complex(7, (2, 2**14)))
    cpu = torch.device("cpu")
    port_plan._four_step_twiddle.cache_clear()
    tracer = trace.Tracer()
    with tracer.active():
        for _ in range(2):
            port_plan.four_step_fft(x, 4, 4096, inverse=True)
            port_plan.four_step_fft(x, 4, 4096)
        inv = port_plan._four_step_twiddle(4, 4096, cpu, inverse=True)
        fwd = port_plan._four_step_twiddle(4, 4096, cpu, inverse=False)
    assert tracer.builds == {"four_step_twiddle": 2}
    assert inv.shape == (4096, 4)
    assert torch.equal(inv, fwd.conj().resolve_conj())
