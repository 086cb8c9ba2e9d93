"""``repro_torch.kernels.fft.ops.fft_kernel_c2c_axis1`` (the
``fft_c2c_axis1`` kernel's plain version on the CPU) against the
reference's Pallas kernels ``fft_axis1_pallas`` /
``fft_axis1_twiddle_pallas`` in interpret mode.

Tolerance as for the c2c kernel: max |a-b| <= 1e-5 * max |ref|."""
import numpy as np
import pytest
import torch

from test_torch_parity import (assert_close, assert_same_launches,
                               rand_complex, run_both)
from repro.kernels.fft import ops as ref_ops
from repro_torch.kernels.fft import ops as port_ops

RTOL = 1e-5
#: Lengths of this file; test_torch_kernel_axis1_long.py runs the long ones.
SHORT = (2, 8, 64)
LONG = (1024, 8192)
COLS = 7                       # ragged against every block size

CASES = [((4, 2), True), ((2,), True), ((8, 4, 2), True), ((4, 2), False)]


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices,with_twiddle", CASES)
@pytest.mark.parametrize("n", SHORT)
def test_fft_kernel_c2c_axis1_matches_reference(n, radices, with_twiddle,
                                                inverse):
    x = rand_complex(n, (2, n, COLS))
    tw = rand_complex(n + 1, (COLS, n)) if with_twiddle else None
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_c2c_axis1(x, twiddle=tw, inverse=inverse,
                                             radices=radices),
        lambda: port_ops.fft_kernel_c2c_axis1(torch.from_numpy(x),
                                              twiddle=tw, inverse=inverse,
                                              radices=radices))
    assert tuple(port.shape) == (2, n, COLS) and port.is_contiguous()
    assert_close(port, ref, RTOL)
    assert_same_launches(ref_rec, port_rec)


def test_fft_kernel_c2c_axis1_refuses_a_misshapen_twiddle():
    x = torch.zeros(2, 8, 4, dtype=torch.complex64)
    with pytest.raises(ValueError, match="twiddle"):
        port_ops.fft_kernel_c2c_axis1(x, twiddle=np.ones((8, 4), np.complex64))
