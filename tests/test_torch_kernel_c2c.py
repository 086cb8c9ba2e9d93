"""``repro_torch.kernels.fft.ops.fft_kernel_c2c`` (the ``fft_c2c`` kernel's
plain version on the CPU) against the reference's Pallas kernel in
interpret mode, on the same numpy inputs.

Tolerance: both sides run the same f32 radix schedule and tables, so they
differ by rounding order only; max |a-b| <= 1e-5 * max |ref| (the
reference's own error against numpy is ~1.6e-7 relative)."""
import numpy as np
import pytest
import torch

from test_torch_parity import (assert_close, assert_same_launches,
                               rand_complex, run_both)
from repro.kernels.fft import ops as ref_ops
from repro_torch.kernels.fft import fft_kernel
from repro_torch.kernels.fft import ops as port_ops
from repro_torch.kernels.fft.ref import fft_ref

RTOL = 1e-5
#: Lengths of this file; test_torch_kernel_c2c_long.py runs the long ones.
SHORT = (2, 8, 64)
LONG = (1024, 8192)
BATCH = 7                      # ragged against every block size


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices", ((4, 2), (2,), (8, 4, 2)))
@pytest.mark.parametrize("n", SHORT)
def test_fft_kernel_c2c_matches_reference(n, radices, inverse):
    x = rand_complex(n + len(radices), (BATCH, n))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_c2c(x, inverse=inverse, radices=radices),
        lambda: port_ops.fft_kernel_c2c(torch.from_numpy(x),
                                        inverse=inverse, radices=radices))
    assert port.dtype == torch.complex64
    assert_close(port, ref, RTOL)
    assert_same_launches(ref_rec, port_rec)
    assert_close(port, fft_ref(torch.from_numpy(x), inverse=inverse), RTOL)


def test_fft_kernel_c2c_keeps_leading_dims_and_casts_complex128():
    x = rand_complex(5, (2, 3, 64)).astype(np.complex128)
    ref = np.asarray(ref_ops.fft_kernel_c2c(x))
    port = port_ops.fft_kernel_c2c(torch.from_numpy(x))
    assert port.dtype == torch.complex64 and tuple(port.shape) == (2, 3, 64)
    assert_close(port, ref, RTOL)


def test_length_one_is_identity_and_long_lengths_are_refused():
    x = torch.from_numpy(rand_complex(1, (4, 1)))
    assert torch.equal(port_ops.fft_kernel_c2c(x, inverse=True), x)
    with pytest.raises(ValueError, match="single-pass kernel limit"):
        port_ops.fft_kernel_c2c(torch.zeros(2, 2**14, dtype=torch.complex64))


def test_kernel_functions_validate_their_inputs():
    x = torch.zeros(3, 64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="not implemented by the CUDA"):
        fft_kernel.fft_c2c(x, radices=(16, 2), per_block=1)
    with pytest.raises(ValueError, match="complex64"):
        fft_kernel.fft_c2c(x.to(torch.complex128), per_block=1)
    with pytest.raises(ValueError, match="complex64"):
        fft_kernel.fft_c2c(x.t(), per_block=1)
    with pytest.raises(ValueError, match="power of two"):
        fft_kernel.fft_c2c(torch.zeros(3, 100, dtype=torch.complex64),
                           per_block=1)
    with pytest.raises(ValueError, match="shared memory"):
        fft_kernel.transforms_per_block(8192, 4, override=2)


def test_out_receives_the_transform_in_place():
    x = torch.from_numpy(rand_complex(3, (BATCH, 64)))
    want = port_ops.fft_kernel_c2c(x, inverse=True)
    y = x.clone()
    assert port_ops.fft_kernel_c2c(y, inverse=True, out=y) is y
    assert torch.equal(y, want)
    with pytest.raises(ValueError, match="out must be"):
        fft_kernel.fft_c2c(x, per_block=1, out=torch.empty(
            2, 64, dtype=torch.complex64))


def test_plain_versions_never_count_launches():
    fft_kernel.reset_launches()
    x = torch.from_numpy(rand_complex(2, (3, 64)))
    port_ops.fft_kernel_c2c(x)
    assert fft_kernel.LAUNCHES == {"fft_c2c": 0, "fft_c2c_t": 0,
                                   "fft_c2c_axis1": 0, "fft_c2c_mul": 0,
                                   "fft_r2c": 0, "fft_r2c_t": 0,
                                   "fft_c2r": 0, "transpose": 0,
                                   "fft_r2c_split": 0, "fft_c2r_merge": 0}


#: Threads and shared bytes of each geometry case: 16 points a thread (32
#: at 8192), one padded exchange buffer (n + n/16 slots) a transform.
PASS_GEOMETRY = {1024: (256, 4 * 1088 * 8), 8192: (256, 8704 * 8),
                 64: (28, 7 * 68 * 8)}


@pytest.mark.parametrize("n,count,tile,blocks", [
    (1024, 244140, 4, 61035),       # the 2 GB main-path batch
    (8192, 30517, 1, 30517),        # 68 KB of shared memory per block
    (64, 7, 7, 1),                  # small batch: one ragged block
])
def test_launch_geometry(n, count, tile, blocks):
    launch = fft_kernel.pass_launch(n, count)
    assert (launch.per_block, launch.blocks) == (tile, blocks)
    assert (launch.threads, launch.shared_bytes) == PASS_GEOMETRY[n]
    assert launch.resident_blocks >= 2
