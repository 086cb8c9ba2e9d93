"""The long lengths of :mod:`test_torch_kernel_axis1`, in a file of
their own so that each file stays well inside a minute on one worker."""
import pytest

from test_torch_kernel_axis1 import CASES, LONG
from test_torch_kernel_axis1 import (
    test_fft_kernel_c2c_axis1_matches_reference as check)


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices,with_twiddle", CASES)
@pytest.mark.parametrize("n", LONG)
def test_fft_kernel_c2c_axis1_matches_reference_long(
        n, radices, with_twiddle, inverse):
    check(n, radices, with_twiddle, inverse)
