"""The port's overlap-save engine (``repro_torch.fft.convolve``) against
the reference's: the same ``ConvPlan`` fields and segment choices, the
same convolution from one numpy input (max |a-b| <= 1e-4 * max |ref|, the
reference's own tolerance against ``numpy.convolve``), one ``fft-c2c-mul``
launch plus one batched inverse launch, and filter spectra cached per
bank key (on the host, and once per device)."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
from repro.fft import convolve as ref_conv
from repro_torch.fft import convolve as port_conv
from repro_torch.fft import plan as port_plan

RTOL = 1e-4


def oracle(x, filters):
    x = np.atleast_2d(np.asarray(x))
    filters = np.atleast_2d(np.asarray(filters))
    return np.stack([[np.convolve(row, f) for f in filters] for row in x])


@pytest.mark.parametrize("n,taps,t,nfft", [
    (4096, 32, 8, 0), (1000, 33, 3, 0), (513, 17, 4, 64), (64, 8, 2, 0),
    (100, 129, 2, 0), (2**15, 6000, 2, 0), (2**15, 33, 2, 0),
    (2**21 + 1, 100, 85, 0), (2**19 + 1, 100, 85, 0), (4097, 32, 9, 0),
])
def test_conv_plan_is_the_reference_plan(n, taps, t, nfft):
    port = port_conv.conv_plan(n, taps, t, nfft)
    ref = ref_conv.conv_plan(n, taps, t, nfft)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.traffic_ratio == ref.traffic_ratio
    assert port.passes_per_template == ref.passes_per_template


def test_fdas_plan_of_the_chip_check():
    """The FDAS size the chip check runs: n = 2**22 series, 85 templates
    of 100 taps over 2**21 + 1 bins."""
    plan = port_conv.conv_plan(2**21 + 1, 100, 85)
    assert (plan.nfft, plan.step, plan.n_segments) == (2048, 1949, 1077)
    assert plan.fused and plan.forward_passes == 1


@pytest.mark.parametrize("taps,n,t", [(17, 4096, 4), (65, 1000, 4), (5, 64, 1),
                                      (100, 2**21 + 1, 85)])
def test_select_nfft_is_the_reference_choice(taps, n, t):
    assert port_conv.select_nfft(taps, n, t) == ref_conv.select_nfft(taps, n,
                                                                     t)


@pytest.mark.parametrize("n,taps,t,nfft", [
    (1000, 33, 3, None), (513, 17, 4, 64), (100, 129, 2, None),
])
def test_overlap_save_matches_reference(n, taps, t, nfft):
    x = rand_complex(n, (2, n))
    h = rand_complex(taps, (t, taps))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_conv.overlap_save_conv(x, h, nfft=nfft),
        lambda: port_conv.overlap_save_conv(torch.from_numpy(x), h,
                                            nfft=nfft))
    assert tuple(port.shape) == (2, t, n + taps - 1)
    assert_close(port, ref, RTOL)
    assert_close(port, oracle(x, h), RTOL)
    # One fused forward launch, one batched inverse launch over all T
    # planes; the same kernels and logical shapes as the reference.
    assert [r.kernel for r in port_rec] == ["fft-c2c-mul", "fft-c2c"]
    assert [(r.kernel, r.shape) for r in port_rec] == \
        [(r.kernel, r.shape) for r in ref_rec]


@pytest.mark.parametrize("n,taps,t,nfft,first,length", [
    (1000, 32, 5, 256, 16, 1000),    # whole segments and both ends
    (1000, 32, 5, 256, 0, 1031),     # the full convolution
    (300, 100, 3, 128, 50, 20),      # inside one segment
    (300, 100, 3, 128, 50, 300),     # no whole segment, two partial
    (4097, 100, 4, 2048, 50, 4097),  # the survey's taps and segment
])
def test_segments_power_is_the_assembled_planes_power(n, taps, t, nfft,
                                                      first, length):
    """The one-pass power of a window of the convolution equals |c|^2 /
    scale of the assembled convolution c, bit for bit."""
    x = torch.from_numpy(rand_complex(n, (2, 3, n)))
    h = rand_complex(taps, (t, taps))
    scale = torch.rand(2, 3, 1, 1, generator=torch.Generator().manual_seed(
        n)) + 0.5
    c = port_conv.overlap_save_conv(x, h, nfft=nfft)[..., first:first + length]
    want = (c.real ** 2 + c.imag ** 2) / scale
    y, plan = port_conv.overlap_save_segments(x, h, nfft=nfft)
    got = port_conv.segments_power(y, plan, first, length, scale)
    assert got.shape == (2, 3, t, length) and got.is_contiguous()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        port_conv.segments_power(y, plan, 1, plan.n_segments * plan.step,
                                 scale)


def test_real_and_1d_inputs():
    x0 = np.random.default_rng(0).standard_normal(300).astype(np.float32)
    h = rand_complex(3, (2, 21))
    got = port_conv.overlap_save_conv(torch.from_numpy(x0), h)
    assert tuple(got.shape) == (2, 320)
    assert_close(got, oracle(x0, h)[0], RTOL)


def test_unfused_segment_routes_fft_then_multiply():
    """A segment past the single-pass limit: the routed FFT plus one
    torch multiply, no fused kernel (the reference's plan decision)."""
    x = rand_complex(1, (1, 300))
    h = rand_complex(2, (1, 9000))
    _, port, _, port_rec = run_both(
        lambda: 0, lambda: port_conv.overlap_save_conv(torch.from_numpy(x), h))
    assert "fft-c2c-mul" not in [r.kernel for r in port_rec]
    assert_close(port, oracle(x, h), RTOL)


def test_filter_spectra_cached_per_key_and_device():
    h = rand_complex(11, (3, 9))
    before = port_conv._SPECTRA_BUILDS
    a = port_conv.cached_filter_spectra(("test-bank", 1), h, 64)
    b = port_conv.cached_filter_spectra(("test-bank", 1), h, 64)
    assert port_conv._SPECTRA_BUILDS == before + 1 and a is b
    assert np.array_equal(a, ref_conv._bank_spectra(h, 64))
    port_conv.cached_filter_spectra(("test-bank", 1), h, 128)
    assert port_conv._SPECTRA_BUILDS == before + 2
    cpu = torch.device("cpu")
    d1 = port_conv.device_filter_spectra(("test-bank", 1), h, 64, cpu)
    d2 = port_conv.device_filter_spectra(("test-bank", 1), h, 64, cpu)
    assert d1 is d2 and d1.dtype == torch.complex64
    assert port_conv._SPECTRA_BUILDS == before + 2


def test_conv_validation_errors():
    with pytest.raises(ValueError, match="longer than the segment"):
        port_conv.overlap_save_conv(torch.zeros(100), np.ones((1, 65)),
                                    nfft=64)
    with pytest.raises(ValueError, match="power of two"):
        port_conv.overlap_save_conv(torch.zeros(100), np.ones((1, 5)),
                                    nfft=48)
    with pytest.raises(ValueError):
        port_conv.conv_plan(1024, 17, 0)


def test_fft_mul_kernels_disabled_is_fft_then_multiply(monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("a kernel ran under kernels_disabled()")

    monkeypatch.setattr(port_plan, "_kernel_fft_mul", fail)
    monkeypatch.setattr(port_plan, "_kernel_fft", fail)
    x = rand_complex(2, (2, 333))
    h = rand_complex(3, (3, 17))
    with port_plan.kernels_disabled():
        assert_close(port_conv.overlap_save_conv(torch.from_numpy(x), h),
                     oracle(x, h), RTOL)
