"""``repro_torch.kernels.fft.ops.fft_kernel_r2c_t`` (the ``fft_r2c_t``
kernel's plain version on the CPU) against the reference's Pallas kernel
``rfft_t_pallas`` in interpret mode, on ragged row counts.

Tolerance: max |a-b| <= 1e-5 * max |ref| (the same f32 schedule and split
table; they differ by rounding order only)."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, assert_same_launches, run_both
from repro.kernels.fft import ops as ref_ops
from repro_torch.kernels.fft import fft_kernel
from repro_torch.kernels.fft import ops as port_ops

RTOL = 1e-5


def rand_real(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("radices", ((4, 2), (8, 4, 2)))
@pytest.mark.parametrize("c", (4, 64, 1024))
@pytest.mark.parametrize("rows", (7, 13))
def test_fft_kernel_r2c_t_matches_reference(c, rows, radices):
    x = rand_real(c + rows, (2, rows, c))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_r2c_t(x, radices=radices),
        lambda: port_ops.fft_kernel_r2c_t(torch.from_numpy(x),
                                          radices=radices))
    assert tuple(port.shape) == (2, c // 2 + 1, rows)
    assert port.dtype == torch.complex64 and port.is_contiguous()
    assert_close(port, ref, RTOL)
    assert_same_launches(ref_rec, port_rec)
    assert port_rec[0].kernel == "fft-r2c-t"


def test_fft_kernel_r2c_t_keeps_leading_dims_and_takes_complex():
    """Leading dims fold into the batch; complex input keeps its real part
    (the reference's ``x.real``)."""
    x = rand_real(3, (2, 3, 5, 16))
    ref = np.asarray(ref_ops.fft_kernel_r2c_t(x + 0.5j))
    port = port_ops.fft_kernel_r2c_t(torch.from_numpy(x + 0.5j))
    assert tuple(port.shape) == (2, 3, 9, 5)
    assert_close(port, ref, RTOL)
    assert_close(port, np.swapaxes(np.fft.rfft(x.astype(np.float64)), -1,
                                   -2), RTOL)


def test_fft_kernel_r2c_t_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="C >= 4"):
        port_ops.fft_kernel_r2c_t(torch.zeros(2, 3, 2))
    with pytest.raises(ValueError, match="single-pass kernel limit"):
        port_ops.fft_kernel_r2c_t(torch.zeros(1, 2, 2**15))
    with pytest.raises(ValueError, match="power of two"):
        fft_kernel.fft_r2c_t(torch.zeros(1, 2, 100), per_block=1)
    with pytest.raises(ValueError, match="3-D float32"):
        fft_kernel.fft_r2c_t(torch.zeros(2, 64), per_block=1)
