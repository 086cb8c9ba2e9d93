"""The long lengths of :mod:`test_torch_kernel_t`, in a file of
their own so that each file stays well inside a minute on one worker."""
import pytest

from test_torch_kernel_passes import RADIX_SETS
from test_torch_kernel_t import CASES, EMULATED_LONG, LONG
from test_torch_kernel_t import (
    test_fft_kernel_c2c_t_matches_reference as check)
from test_torch_kernel_t import (
    test_emulated_c2c_t_is_the_plain_version_bit_for_bit as emulated)


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices,with_twiddle", CASES)
@pytest.mark.parametrize("n", LONG)
def test_fft_kernel_c2c_t_matches_reference_long(
        n, radices, with_twiddle, inverse):
    check(n, radices, with_twiddle, inverse)


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("with_twiddle", (False, True))
@pytest.mark.parametrize("radices", RADIX_SETS)
@pytest.mark.parametrize("n", EMULATED_LONG)
def test_emulated_c2c_t_is_the_plain_version_bit_for_bit_long(
        n, radices, with_twiddle, inverse):
    emulated(n, radices, with_twiddle, inverse)
