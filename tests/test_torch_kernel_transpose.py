"""``repro_torch.kernels.fft.ops.transpose_kernel`` (the ``transpose``
kernel's plain version on the CPU) against the reference's Pallas kernel
``transpose_pallas`` in interpret mode: float32, complex64 and complex128,
ragged R and C.  A transpose moves bits, so the results are exact."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_same_launches, run_both
from repro.kernels.fft import ops as ref_ops
from repro_torch.kernels.fft import fft_kernel
from repro_torch.kernels.fft import ops as port_ops

SHAPES = [(2, 7, 45), (3, 33, 5), (1, 1, 9), (2, 64, 32)]


def _payload(dtype, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", (np.float32, np.complex64))
@pytest.mark.parametrize("shape", SHAPES)
def test_transpose_kernel_matches_reference(dtype, shape):
    x = _payload(dtype, shape, sum(shape))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.transpose_kernel(x),
        lambda: port_ops.transpose_kernel(torch.from_numpy(x)))
    assert port.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(port.numpy(), ref)
    assert np.array_equal(port.numpy(), np.swapaxes(x, -1, -2))
    assert_same_launches(ref_rec, port_rec)


@pytest.mark.parametrize("shape", SHAPES)
def test_transpose_kernel_keeps_complex128(shape):
    """The reference runs without x64, so it has no complex128 to compare;
    the port keeps the dtype (16-byte elements) and moves them exactly."""
    x = _payload(np.complex128, shape, 7)
    port = port_ops.transpose_kernel(torch.from_numpy(x))
    assert port.dtype == torch.complex128 and port.is_contiguous()
    assert np.array_equal(port.numpy(), np.swapaxes(x, -1, -2))


def test_transpose_kernel_folds_leading_dims_and_resolves_views():
    x = torch.from_numpy(_payload(np.complex64, (2, 3, 4, 6), 1))
    y = port_ops.transpose_kernel(x.conj())
    assert tuple(y.shape) == (2, 3, 6, 4)
    assert torch.equal(y, x.conj().transpose(-1, -2))


def test_transpose_launch_geometry_and_validation():
    assert fft_kernel.transpose_blocks(13, 1024, 19321) == 13 * 32 * 604
    with pytest.raises(ValueError, match="4-, 8- or 16-byte"):
        fft_kernel.transpose(torch.zeros(1, 2, 3, dtype=torch.int16))
    with pytest.raises(ValueError, match="contiguous 3-D"):
        fft_kernel.transpose(torch.zeros(4, 4))
