"""``repro_torch.kernels.fft.ops.fft_kernel_c2c_mul`` (the ``fft_c2c_mul``
kernel's plain version on the CPU) against the reference's Pallas kernel
``fft_mul_pallas`` in interpret mode, for T = 1 and 9 templates.

Tolerance: max |a-b| <= 1e-5 * max |ref| (the same f32 schedule and
multiply order)."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
from repro.kernels.fft import ops as ref_ops
from repro_torch.kernels.fft import fft_kernel
from repro_torch.kernels.fft import ops as port_ops

RTOL = 1e-5


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("templates", (1, 9))
@pytest.mark.parametrize("n,rows", [(8, 7), (64, 5), (1024, 3)])
def test_fft_kernel_c2c_mul_matches_reference(n, rows, templates, inverse):
    x = rand_complex(n + rows, (rows, n))
    bank = rand_complex(templates, (templates, n)).astype(np.complex128)
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_c2c_mul(x, bank, inverse=inverse),
        lambda: port_ops.fft_kernel_c2c_mul(torch.from_numpy(x), bank,
                                            inverse=inverse))
    assert tuple(port.shape) == (rows, templates, n)
    assert_close(port, ref, RTOL)
    want = (np.fft.ifft if inverse else np.fft.fft)(
        x.astype(np.complex128), axis=-1)[:, None, :] * bank[None]
    assert_close(port, want, RTOL)
    # Same kernel and logical shape; the port counts its bytes on the
    # batch, the reference on its padded batch.
    assert [(r.kernel, r.shape) for r in port_rec] == \
        [(r.kernel, r.shape) for r in ref_rec] == \
        [("fft-c2c-mul", (rows, templates, n))]
    assert port_rec[0].bytes_moved == 8 * n * (rows + templates
                                               + rows * templates)


def test_fft_kernel_c2c_mul_keeps_leading_dims():
    x = rand_complex(1, (2, 3, 32))
    bank = rand_complex(2, (4, 32))
    port = port_ops.fft_kernel_c2c_mul(torch.from_numpy(x),
                                       torch.from_numpy(bank))
    assert tuple(port.shape) == (2, 3, 4, 32)
    assert_close(port, np.asarray(ref_ops.fft_kernel_c2c_mul(x, bank)), RTOL)


def test_fft_kernel_c2c_mul_rejects_bad_bank():
    """The reference's message for a bank of the wrong length; the kernel
    function refuses a bank of the wrong type, shape or device."""
    x = torch.zeros(2, 64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="filter bank"):
        port_ops.fft_kernel_c2c_mul(x, np.zeros((3, 32), np.complex64))
    with pytest.raises(ValueError, match="filter bank"):
        port_ops.fft_kernel_c2c_mul(x, np.zeros(64, np.complex64))
    with pytest.raises(ValueError, match="filter bank"):
        fft_kernel.fft_c2c_mul(x, torch.zeros(3, 64, dtype=torch.complex128),
                               per_block=1)
    with pytest.raises(ValueError, match="filter bank"):
        fft_kernel.fft_c2c_mul(x, torch.zeros(0, 64, dtype=torch.complex64),
                               per_block=1)
