"""The long lengths of :mod:`test_torch_kernel_t`, in a file of
their own so that each file stays well inside a minute on one worker."""
import pytest

from test_torch_kernel_t import CASES, LONG
from test_torch_kernel_t import (
    test_fft_kernel_c2c_t_matches_reference as check)


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices,with_twiddle", CASES)
@pytest.mark.parametrize("n", LONG)
def test_fft_kernel_c2c_t_matches_reference_long(
        n, radices, with_twiddle, inverse):
    check(n, radices, with_twiddle, inverse)
