"""The long C2R lengths of :mod:`test_torch_kernel_r2c`, in a file of their
own so that each file stays well inside a minute on one worker."""
import pytest

from test_torch_kernel_r2c import BATCHES, LONG, RADICES
from test_torch_kernel_r2c import (
    test_fft_kernel_c2r_matches_reference as check)


@pytest.mark.parametrize("radices", RADICES)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", LONG)
def test_fft_kernel_c2r_matches_reference_long(n, b, radices):
    check(n, b, radices)
