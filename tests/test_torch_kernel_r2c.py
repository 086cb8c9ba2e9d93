"""``repro_torch.kernels.fft.ops.fft_kernel_r2c``/``fft_kernel_c2r`` (the
``fft_r2c``/``fft_c2r`` kernels' plain versions on the CPU) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: both sides run the same f32 half-length schedule and the same
split/merge operations, so they differ by rounding order only;
max |a-b| <= 1e-5 * max |ref|.  Kernel against reference may use any C2R
input; against ``torch.fft.irfft`` only a true half-spectrum compares
(the packed merge reads the imaginary parts of bins 0 and N/2, which
``irfft`` drops)."""
import numpy as np
import pytest
import torch

from test_torch_parity import (assert_close, assert_same_launches,
                               rand_complex, run_both)
from repro.kernels.fft import ops as ref_ops
from repro_torch.kernels.fft import fft_kernel
from repro_torch.kernels.fft import ops as port_ops
from repro_torch.kernels.fft.ref import irfft_ref, rfft_ref

RTOL = 1e-5
#: Lengths of this file; test_torch_kernel_r2c_long.py runs the long ones.
SHORT = (8, 64)
LONG = (1024, 16384)
#: Batches the reference does not pad (its tile divides them), so that
#: ledger bytes compare exactly.
BATCHES = (1, 4, 13)
RADICES = ((4, 2), (8, 4, 2))


def rand_real(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def half_spectrum(seed: int, b: int, n: int) -> np.ndarray:
    """The rfft of a real signal: imaginary parts of bins 0 and N/2 zero."""
    return np.fft.rfft(rand_real(seed, (b, n))).astype(np.complex64)


@pytest.mark.parametrize("radices", RADICES)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", SHORT)
def test_fft_kernel_r2c_matches_reference(n, b, radices):
    x = rand_real(n + b, (b, n))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_r2c(x, radices=radices),
        lambda: port_ops.fft_kernel_r2c(torch.from_numpy(x),
                                        radices=radices))
    assert port.dtype == torch.complex64 and port.shape == (b, n // 2 + 1)
    assert_close(port, ref, RTOL)
    assert_same_launches(ref_rec, port_rec)
    assert [r.kernel for r in port_rec] == ["fft-r2c"]
    assert port_rec[0].bytes_moved == 4 * b * (n + 2 * (n // 2 + 1))
    assert_close(port, rfft_ref(torch.from_numpy(x)), RTOL)


@pytest.mark.parametrize("radices", RADICES)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", SHORT)
def test_fft_kernel_c2r_matches_reference(n, b, radices):
    x = rand_complex(n + b, (b, n // 2 + 1))          # any input
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_c2r(x, radices=radices),
        lambda: port_ops.fft_kernel_c2r(torch.from_numpy(x),
                                        radices=radices))
    assert port.dtype == torch.float32 and port.shape == (b, n)
    assert_close(port, ref, RTOL)
    assert_same_launches(ref_rec, port_rec)
    assert [r.kernel for r in port_rec] == ["fft-c2r"]
    assert port_rec[0].bytes_moved == 4 * b * (2 * (n // 2 + 1) + n)
    spec = half_spectrum(n, b, n)
    assert_close(port_ops.fft_kernel_c2r(torch.from_numpy(spec),
                                         radices=radices),
                 irfft_ref(torch.from_numpy(spec)), RTOL)


def test_length_two_takes_the_engine_path():
    """N < 4 has no packed kernel (N/2 < 2): both packages run their
    pure engines and record no launch."""
    x = rand_real(2, (3, 2))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_r2c(x),
        lambda: port_ops.fft_kernel_r2c(torch.from_numpy(x)))
    assert ref_rec == [] and port_rec == []
    assert_close(port, ref, RTOL)
    spec = rand_complex(5, (3, 2))                      # N = 2
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_ops.fft_kernel_c2r(spec),
        lambda: port_ops.fft_kernel_c2r(torch.from_numpy(spec)))
    assert ref_rec == [] and port_rec == []
    assert_close(port, ref, RTOL)


def test_leading_dims_complex_and_wide_inputs():
    """Leading dims are kept, complex input contributes its real part and
    float64 is cast to float32, as in the reference."""
    x = rand_real(3, (2, 3, 64)).astype(np.float64)
    port = port_ops.fft_kernel_r2c(torch.from_numpy(x))
    assert port.dtype == torch.complex64 and port.shape == (2, 3, 33)
    assert_close(port, np.asarray(ref_ops.fft_kernel_r2c(x)), RTOL)
    xc = x + 1j * rand_real(4, x.shape)
    assert_close(port_ops.fft_kernel_r2c(torch.from_numpy(xc)), port, 0)
    spec = np.fft.rfft(x)
    out = port_ops.fft_kernel_c2r(torch.from_numpy(spec))
    assert out.dtype == torch.float32 and out.shape == (2, 3, 64)
    assert_close(out, x, RTOL)


def test_real_input_at_an_odd_offset_is_copied():
    """A contiguous float32 slice at an odd element offset is not 8-byte
    aligned: the wrapper copies it, the kernel function refuses it on the
    card."""
    flat = torch.from_numpy(rand_real(7, 4 * 64 + 1))
    x = flat[1:].reshape(4, 64)
    assert x.is_contiguous() and x.data_ptr() % 8
    assert_close(port_ops.fft_kernel_r2c(x),
                 np.fft.rfft(x.numpy().astype(np.float64)), RTOL)


def test_kernel_functions_validate_their_inputs():
    with pytest.raises(ValueError, match="float32"):
        fft_kernel.fft_r2c(torch.zeros(3, 64, dtype=torch.float64),
                           per_block=1)
    with pytest.raises(ValueError, match="float32"):
        fft_kernel.fft_r2c(torch.zeros(64, 3).t(), per_block=1)
    with pytest.raises(ValueError, match="power of two >= 4"):
        fft_kernel.fft_r2c(torch.zeros(3, 96), per_block=1)
    with pytest.raises(ValueError, match="power of two >= 4"):
        fft_kernel.fft_c2r(torch.zeros(3, 2, dtype=torch.complex64),
                           per_block=1)
    with pytest.raises(ValueError, match="complex64"):
        fft_kernel.fft_c2r(torch.zeros(3, 33), per_block=1)
    with pytest.raises(ValueError, match="single-pass kernel limit"):
        port_ops.fft_kernel_r2c(torch.zeros(2, 2**15))
    with pytest.raises(ValueError, match="single-pass kernel limit"):
        port_ops.fft_kernel_c2r(torch.zeros(2, 2**14 + 1,
                                            dtype=torch.complex64))


def test_plain_versions_never_count_launches():
    fft_kernel.reset_launches()
    x = torch.from_numpy(rand_real(2, (3, 64)))
    port_ops.fft_kernel_c2r(port_ops.fft_kernel_r2c(x))
    assert set(fft_kernel.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("points,count,tile,blocks", [
    (512, 488281, 8, 61036),        # r2c at 1024: the 2 GB main-path batch
    (8192, 30517, 1, 30517),        # r2c at 16384: 68 KB of shared memory
    (513, 488281, 8, 61036),        # c2r at 1024 stages N/2+1 bins
    (8193, 30517, 1, 30517),        # c2r at 16384
])
def test_launch_geometry(points, count, tile, blocks):
    """Both run the N/2-point register passes, one buffer a transform
    that holds the spectrum for the split (R2C, ``points`` = N/2) or the
    N/2+1 staged bins for the merge (C2R, ``points`` = N/2+1)."""
    m = points - points % 2
    launch = fft_kernel.pass_launch(m, count, split=True)
    assert (launch.per_block, launch.blocks) == (tile, blocks)
    assert launch.threads == 256
    assert fft_kernel.split_slots(m) >= m + 1
    assert launch.shared_bytes == tile * fft_kernel.split_slots(m) * 8
    assert launch.shared_bytes == tile * fft_kernel.padded(m) * 8
    assert launch.resident_blocks >= 2
