"""The real-input plans as a whole: ``repro_torch.fft.plan`` kinds
``"r2c"``/``"c2r"`` against ``repro.fft.plan`` (Pallas in interpret mode)
on the same numpy inputs — algorithm, passes, stages, launch-ledger counts
and outputs — plus the pure-torch engine's ``rfft``/``irfft``.

Tolerances: max |a-b| <= 1e-5 * max |ref| for pow2 lengths (the same f32
schedule on both sides) and 1e-4 for the Bluestein-backed r2c at n = 100
(its f32 chirp and filter spectrum amplify rounding differences)."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
from repro.fft import plan as ref_plan
from repro.fft import stockham as ref_stockham
from repro_torch.fft import plan as port_plan
from repro_torch.fft import stockham as port_stockham
from repro_torch.kernels.fft import fft_kernel
from repro_torch.obs.ledger import LaunchLedger

#: The reference records launches only while jax.jit traces, so every
#: reference call here uses a batch shape no other test file uses.
LEAD = (3, 2)

FOUR_STEP = {"fft-c2c-axis1": 1, "fft-c2c-t": 1}
EXPECTED_LEDGER = {
    ("r2c", 64): {"fft-r2c": 1},
    ("r2c", 4096): {"fft-r2c": 1},
    ("r2c", 2**15): FOUR_STEP,       # pack, four-step N/2, split
    ("r2c", 100): {"fft-c2c": 2},    # Bluestein C2C, sliced
    ("c2r", 64): {"fft-c2r": 1},
    ("c2r", 4096): {"fft-c2r": 1},
    ("c2r", 2**15): FOUR_STEP,       # merge, four-step N/2 inverse
}
#: The launches the port makes beyond the reference's: the long route's
#: split and merge, which the reference runs as jnp ops.
PORT_ONLY = {("r2c", 2**15): {"fft-r2c-split": 1},
             ("c2r", 2**15): {"fft-c2r-merge": 1}}
#: The port's launches for each long real call, by kind.
LONG_REAL = {kind: {**FOUR_STEP, **PORT_ONLY[kind, 2**15]}
             for kind in ("r2c", "c2r")}


def _rtol(n: int) -> float:
    return 1e-5 if n & (n - 1) == 0 else 1e-4


def rand_real(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _input(kind: str, n: int, seed: int) -> np.ndarray:
    if kind == "r2c":
        return rand_real(seed, (*LEAD, n))
    return rand_complex(seed, (*LEAD, n // 2 + 1))


@pytest.mark.parametrize("kind,n", sorted(EXPECTED_LEDGER))
def test_real_plan_matches_reference(kind, n):
    port, ref = (port_plan.plan_for_length(n, kind),
                 ref_plan.plan_for_length(n, kind))
    assert (port.n, port.algorithm, port.passes, port.kind, port.stages,
            port.radices) == (ref.n, ref.algorithm, ref.passes, ref.kind,
                              ref.stages, ref.radices)
    x = _input(kind, n, n + len(kind))
    ref_out, port_out, ref_rec, port_rec = run_both(
        lambda: ref(x), lambda: port(torch.from_numpy(x)))
    counts = LaunchLedger().counts
    assert counts(ref_rec) == EXPECTED_LEDGER[kind, n]
    assert counts(port_rec) == {**EXPECTED_LEDGER[kind, n],
                                **PORT_ONLY.get((kind, n), {})}
    assert port_out.dtype == (torch.complex64 if kind == "r2c"
                              else torch.float32)
    assert_close(port_out, ref_out, _rtol(n))
    if kind == "r2c":
        assert_close(port_out, np.fft.rfft(x.astype(np.float64)), _rtol(n))


@pytest.mark.parametrize("n", (64, 4096, 2**15))
def test_c2r_inverts_r2c(n):
    x = rand_real(n + 1, (4, n))
    spec = port_plan.plan_for_length(n, "r2c")(torch.from_numpy(x))
    back = port_plan.plan_for_length(n, "c2r")(spec)
    assert_close(back, x, 1e-5)
    # On a true half-spectrum both agree with numpy's irfft.
    assert_close(back, np.fft.irfft(np.fft.rfft(x.astype(np.float64)), n=n),
                 1e-5)


def test_refused_plans():
    with pytest.raises(ValueError, match="power-of-two"):
        port_plan.plan_for_length(60, "c2r")
    with pytest.raises(ValueError, match="unknown transform kind"):
        port_plan.plan_for_length(64, "dht")


@pytest.mark.parametrize("kind,n", [("r2c", 64), ("c2r", 64),
                                    ("r2c", 2**15), ("c2r", 2**15),
                                    ("r2c", 100)])
def test_kernels_disabled_runs_pure_torch_without_launches(kind, n):
    x = torch.from_numpy(_input(kind, n, 7))
    expected = port_plan.plan_for_length(n, kind)(x)
    ledger = LaunchLedger()
    fft_kernel.reset_launches()
    with port_plan.kernels_disabled(), ledger.capture():
        out = port_plan.plan_for_length(n, kind)(x)
    assert ledger.records == []
    assert set(fft_kernel.LAUNCHES.values()) == {0}
    assert_close(out, expected, _rtol(n))


@pytest.mark.parametrize("hook,kind,n", [
    ("_kernel_rfft", "r2c", 64), ("_kernel_irfft", "c2r", 64),
    ("_kernel_fft_axis1", "r2c", 2**15), ("_kernel_fft_t", "c2r", 2**15),
])
def test_kernel_failure_propagates_through_real_plans(monkeypatch, hook,
                                                      kind, n):
    """No hidden fallback: a kernel that raises is not replaced by the
    pure-torch engine."""
    def boom(*args, **kwargs):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(port_plan, hook, boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        port_plan.plan_for_length(n, kind)(torch.from_numpy(
            _input(kind, n, 1)))


@pytest.mark.parametrize("n", (2, 8, 512))
def test_stockham_real_engine_matches_reference(n):
    x = rand_real(n + 11, (4, n))
    spec = port_stockham.rfft(torch.from_numpy(x))
    assert_close(spec, np.asarray(ref_stockham.rfft(x)), 1e-5)
    X = rand_complex(n + 12, (4, n // 2 + 1))
    assert_close(port_stockham.irfft(torch.from_numpy(X)),
                 np.asarray(ref_stockham.irfft(X)), 1e-5)
    xt = np.ascontiguousarray(x.T)
    assert_close(port_stockham.rfft(torch.from_numpy(xt), axis=0),
                 np.asarray(ref_stockham.rfft(xt, axis=0)), 1e-5)


def test_stockham_real_engine_keeps_float64():
    x = rand_real(3, (2, 256)).astype(np.float64)
    spec = port_stockham.rfft(torch.from_numpy(x))
    assert spec.dtype == torch.complex128
    assert_close(spec, np.fft.rfft(x), 1e-12)
    assert_close(port_stockham.irfft(spec), x, 1e-12)


def test_pack_real_is_a_view():
    """The packing costs no copy for a contiguous input, and copies an
    input at an odd storage offset (a complex view needs an even one)."""
    x = torch.from_numpy(rand_real(4, (3, 64)))
    z = port_stockham._pack_real(x)
    assert z.dtype == torch.complex64 and z.shape == (3, 32)
    assert z.data_ptr() == x.data_ptr()
    assert torch.equal(z.real, x[:, 0::2]) and torch.equal(z.imag, x[:, 1::2])
    odd = torch.from_numpy(rand_real(5, 3 * 64 + 1))[1:].reshape(3, 64)
    assert torch.equal(port_stockham._pack_real(odd).real, odd[:, 0::2])
