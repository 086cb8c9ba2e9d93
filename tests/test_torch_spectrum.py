"""The port's fused power-spectrum wrapper
(``repro_torch.kernels.spectrum``) against the reference's
(``repro.kernels.spectrum``: the Pallas kernel in interpret mode, and its
oracle) on the same numpy spectra: power, row mean and row std within
1e-5 * max |ref| (the variance is E[p^2] - mean^2 in float32, with its
cancellation, on both sides), with lead dims, real input, the empty-axis
guard and the ledger record."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
from repro.kernels.spectrum import power_spectrum_stats_kernel as ref_stats
from repro.kernels.spectrum.ref import power_spectrum_stats_ref as ref_oracle
from repro_torch.kernels.spectrum import power_spectrum_stats_kernel
from repro_torch.kernels.spectrum import spectrum_kernel
from repro_torch.kernels.spectrum.ref import power_spectrum_stats_ref

RTOL = 1e-5


def check(x):
    p, mean, std = power_spectrum_stats_kernel(torch.from_numpy(x))
    rp, rmean, rstd = ref_stats(x, interpret=True)
    assert p.dtype == mean.dtype == std.dtype == torch.float32
    assert tuple(mean.shape) == tuple(std.shape) == x.shape[:-1]
    assert_close(p, rp, RTOL)
    assert_close(mean, rmean, RTOL)
    assert_close(std, rstd, RTOL)
    return p, mean, std


@pytest.mark.parametrize("batch", [1, 7, 16])
@pytest.mark.parametrize("n", [64, 1025, 8192])
def test_matches_reference(n, batch):
    x = rand_complex(n + batch, (batch, n))
    check(x)
    xr = np.asarray(x)
    for got, want in zip(
            power_spectrum_stats_ref(torch.from_numpy(xr.real),
                                     torch.from_numpy(xr.imag)),
            ref_oracle(xr.real, xr.imag)):
        assert_close(got, want, RTOL)


def test_lead_dims_and_real_input():
    check(rand_complex(1, (3, 2, 256)))
    real = np.random.default_rng(2).standard_normal((4, 300)).astype(
        np.float32)
    p, _, _ = check(real)
    assert_close(p, real ** 2 / 300, RTOL)


def test_parseval_consistency():
    """mean(power) * N == mean |x|^2 of the time series."""
    x = torch.from_numpy(rand_complex(3, (2, 512)))
    _, mean, _ = power_spectrum_stats_kernel(torch.fft.fft(x))
    assert_close(mean, (x.abs() ** 2).mean(-1).numpy(), 1e-4)


def test_ledger_record():
    x = rand_complex(4, (3, 5, 129))
    _, _, ref_recs, port_recs = run_both(
        lambda: ref_stats(x, interpret=True)[0],
        lambda: power_spectrum_stats_kernel(torch.from_numpy(x)))
    (ref,), (port,) = ref_recs, port_recs
    assert (port.kernel, port.shape) == (ref.kernel, ref.shape) == \
        ("power-spectrum-stats", (15, 129))
    assert port.bytes_moved == 4 * 15 * (3 * 129 + 2)
    assert port.grid == (15,) and port.tile == (1, 129)


def test_plain_version_counts_no_launch():
    spectrum_kernel.reset_launches()
    power_spectrum_stats_kernel(torch.from_numpy(rand_complex(5, (2, 64))))
    assert spectrum_kernel.LAUNCHES == {"power_spectrum_stats": 0}


def test_empty_axis_guard_is_the_references():
    x = np.ones((2, 0), np.complex64)
    with pytest.raises(ValueError) as ref_err:
        ref_stats(x, interpret=True)
    with pytest.raises(ValueError) as port_err:
        power_spectrum_stats_kernel(torch.from_numpy(x))
    assert str(port_err.value) == str(ref_err.value)
