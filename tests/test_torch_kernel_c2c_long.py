"""The long lengths of :mod:`test_torch_kernel_c2c`, in a file of
their own so that each file stays well inside a minute on one worker."""
import pytest

from test_torch_kernel_c2c import LONG
from test_torch_kernel_c2c import (
    test_fft_kernel_c2c_matches_reference as check)


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices", ((4, 2), (2,), (8, 4, 2)))
@pytest.mark.parametrize("n", LONG)
def test_fft_kernel_c2c_matches_reference_long(
        n, radices, inverse):
    check(n, radices, inverse)
