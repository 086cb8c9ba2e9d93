"""The plain reference against numpy.fft and the port's CPU path at tiny
sizes, and its control (bfloat16) failing there."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.harness import BENCH, load_file_module

fft_ref = load_file_module(BENCH / "configs" / "paper_fft_2gb_ref.py",
                           "test_fft_ref")


@pytest.mark.parametrize("kind,n", [("c2c", 64), ("c2c", 2**15),
                                    ("r2c", 256), ("r2c", 2**15),
                                    ("c2r", 256), ("c2r", 2**15)])
def test_fft_reference_matches_numpy_and_the_port(kind, n):
    from repro_torch.fft.plan import plan_for_length
    gen = torch.Generator().manual_seed(5)
    if kind == "c2c":
        x = torch.randn(6, n, dtype=torch.complex64, generator=gen)
        want = np.fft.fft(x.numpy().astype(np.complex128))
    elif kind == "r2c":
        x = torch.randn(6, n, generator=gen)
        want = np.fft.rfft(x.numpy().astype(np.float64))
    else:
        x = torch.fft.rfft(torch.randn(6, n, generator=gen))
        want = np.fft.irfft(x.numpy().astype(np.complex128), n=n)
    got = fft_ref.reference(kind, n, x).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    port = plan_for_length(n, kind)(x)
    assert fft_ref.rel_err(kind, n, x, port) < 1e-6
    assert fft_ref.rel_err(kind, n, x, fft_ref.control(kind, n, x)) > 1e-3
