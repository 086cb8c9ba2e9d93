"""The CUDA kernels themselves, against their plain torch versions on the
card, and the plans through them.  These need an NVIDIA GPU with nvcc;
elsewhere they skip.  On the GPU machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` covers the same ground at the main path's full sizes."""
import pytest
import torch

from repro_torch.fft import plan as port_plan
from repro_torch.kernels.fft import fft_kernel as K
from repro_torch.kernels.fft import ops
from repro_torch.kernels.fft.ref import fft_ref
from repro_torch.obs.ledger import LaunchLedger

RTOL = 1e-5                    # kernel vs plain: the same f32 schedule


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape):
    return torch.randn(*shape, dtype=torch.complex64, device="cuda",
                       generator=gen)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices", ((4, 2), (2,), (8, 4, 2)))
@pytest.mark.parametrize("n", (2, 64, 1024, 8192))
def test_kernels_match_plain_on_the_card(gen, n, radices, inverse):
    x = _rand(gen, 37, n)
    assert _rel(ops.fft_kernel_c2c(x, inverse=inverse, radices=radices),
                K.fft_c2c_plain(x, inverse=inverse, radices=radices)) <= RTOL
    x3, tw = _rand(gen, 3, 13, n), _rand(gen, 13, n)
    for twiddle in (None, tw):
        assert _rel(ops.fft_kernel_c2c_t(x3, twiddle=twiddle,
                                         inverse=inverse, radices=radices),
                    K.fft_c2c_t_plain(x3, twiddle, inverse=inverse,
                                      radices=radices)) <= RTOL
    xa = _rand(gen, 3, n, 13)
    for twiddle in (None, tw):
        assert _rel(ops.fft_kernel_c2c_axis1(xa, twiddle=twiddle,
                                             inverse=inverse,
                                             radices=radices),
                    K.fft_c2c_axis1_plain(xa, twiddle, inverse=inverse,
                                          radices=radices)) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,expected", [
    (1024, {"fft_c2c": 1}),
    (2**15, {"fft_c2c_axis1": 1, "fft_c2c_t": 1}),
    (139, {"fft_c2c": 2}),
])
def test_plans_launch_the_kernels(gen, n, expected):
    x = _rand(gen, 5, n)
    K.reset_launches()
    ledger = LaunchLedger()
    with ledger.capture():
        y = port_plan.plan_for_length(n)(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == expected
    assert len(ledger.records) == sum(expected.values())
    assert _rel(y, fft_ref(x)) <= (2e-5 if n & (n - 1) == 0 else 1e-4)
