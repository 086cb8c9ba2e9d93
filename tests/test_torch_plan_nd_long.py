"""The real and 3-D cases of :mod:`test_torch_plan_nd` (``rfft2``,
``fftn``, ``rfftn`` against the reference's, same tolerances), in a file
of their own so that each file stays well inside a minute on one
worker."""
import numpy as np
import pytest
import torch

from test_torch_parity import (assert_close, assert_same_launches,
                               rand_complex, run_both)
from test_torch_plan_nd import _rtol, rand_real
import repro.fft as ref_fft
import repro_torch.fft as port_fft


@pytest.mark.parametrize("shape", [(8, 16), (32, 32), (12, 32), (16, 100),
                                   (64, 1), (4, 2)])
def test_rfft2_matches_reference(shape):
    x = rand_real(sum(shape), (2, *shape))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_fft.rfft2(x), lambda: port_fft.rfft2(torch.from_numpy(x)))
    assert_close(port, ref, _rtol(shape))
    assert_close(port, np.fft.rfft2(x.astype(np.float64)), _rtol(shape))
    assert_same_launches(ref_rec, port_rec)


@pytest.mark.parametrize("shape", [(4, 8, 16), (8, 8, 8), (4, 12, 16)])
def test_fftn_and_rfftn_match_reference(shape):
    x = rand_complex(1, (2, *shape))
    axes = (1, 2, 3)
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_fft.fftn(x, axes=axes),
        lambda: port_fft.fftn(torch.from_numpy(x), axes=axes))
    assert_close(port, ref, _rtol(shape))
    assert_same_launches(ref_rec, port_rec)
    xr = rand_real(2, (2, *shape))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_fft.rfftn(xr, axes=axes),
        lambda: port_fft.rfftn(torch.from_numpy(xr), axes=axes))
    assert_close(port, ref, _rtol(shape))
    assert_same_launches(ref_rec, port_rec)
