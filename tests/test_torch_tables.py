"""The state carried across the port: every twiddle, split and chirp table
of ``repro_torch`` is bit-identical to the JAX reference's."""
import numpy as np
import pytest

from repro.fft import bluestein as ref_bluestein
from repro.fft import radix as ref_radix
from repro_torch.fft import bluestein as port_bluestein
from repro_torch.fft import radix as port_radix

LENGTHS = (1, 2, 8, 64, 1024, 8192, 2**15)
RADICES = ((4, 2), (2,), (8, 4, 2))


@pytest.mark.parametrize("radices", RADICES)
@pytest.mark.parametrize("n", LENGTHS)
def test_stage_tables_bit_identical(n, radices):
    assert (port_radix.radix_schedule(n, radices)
            == ref_radix.radix_schedule(n, radices))
    for a, b in zip(port_radix.packed_stage_twiddles(n, radices),
                    ref_radix.packed_stage_twiddles(n, radices)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for inverse in (False, True):
        port = port_radix.stage_twiddles(n, radices, inverse)
        ref = ref_radix.stage_twiddles(n, radices, inverse)
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert np.array_equal(a, b)
    assert (port_radix.mixed_radix_flop_count(n, radices, batch=3)
            == ref_radix.mixed_radix_flop_count(n, radices, batch=3))
    assert (port_radix.r2c_flop_count(n, radices)
            == ref_radix.r2c_flop_count(n, radices))


@pytest.mark.parametrize("r", (2, 4, 8))
def test_dft_matrices_bit_identical(r):
    for inverse in (False, True):
        assert np.array_equal(port_radix.dft_matrix(r, inverse),
                              ref_radix.dft_matrix(r, inverse))


@pytest.mark.parametrize("n", (4, 64, 1024, 2**14))
def test_rfft_split_twiddles_bit_identical(n):
    assert np.array_equal(port_radix.rfft_split_twiddles(n),
                          ref_radix.rfft_split_twiddles(n))


@pytest.mark.parametrize("n", (3, 51, 100, 139, 19321))
def test_chirp_factors_bit_identical(n):
    for inverse in (False, True):
        for a, b in zip(port_bluestein._chirp_factors(n, inverse),
                        ref_bluestein._chirp_factors(n, inverse)):
            assert np.array_equal(a, b)
