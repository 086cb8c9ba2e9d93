"""The port's Sec. 5.3 demonstration pipeline (``repro_torch.fft.pipeline``)
against the reference's (``repro.fft.pipeline``) on the same numpy series:
the S/N spectra of ``pulsar_pipeline`` (C2C and R2C, through the planned
FFT) and each plain stage within 1e-4 * max |ref|, the ledger of one run,
and the per-stage models, merged profile and FFT time share
field-identical for the Tesla V100.  The demo stays plain torch around the
FFT, with the reference's clamped harmonic indices; where k * H < n it
agrees with the zero-padded harmonic-sum kernel."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
import repro.core as ref_core
import repro.fft.pipeline as ref_demo
import repro_torch.core as port_core
import repro_torch.fft.pipeline as demo
from repro_torch.kernels.harmonic_sum import harmonic_sum_kernel

RTOL = 1e-4


@pytest.mark.parametrize("h", [2, 8, 32])
@pytest.mark.parametrize("real_input", [False, True])
@pytest.mark.parametrize("n", [1024, 4096])
def test_pipeline_matches_reference(n, real_input, h):
    x = rand_complex(n + h, (3, n))
    if real_input:
        x = x.real.copy()
    ref, port, ref_recs, port_recs = run_both(
        lambda: ref_demo.pulsar_pipeline(x, h, real_input),
        lambda: demo.pulsar_pipeline(torch.from_numpy(x), h, real_input))
    assert_close(port, ref, RTOL)
    assert [r.kernel for r in port_recs] == [r.kernel for r in ref_recs] == \
        (["fft-r2c"] if real_input else ["fft-c2c"])


def test_stages_match_reference():
    spec = rand_complex(1, (4, 513))
    p, rp = demo.power_spectrum(torch.from_numpy(spec), 1024), \
        ref_demo.power_spectrum(spec, 1024)
    assert_close(p, rp, 1e-6)
    for got, want in zip(demo.spectrum_stats(p), ref_demo.spectrum_stats(rp)):
        assert_close(got, want, 1e-5)
    hs, rhs = demo.harmonic_sum(p, 16), ref_demo.harmonic_sum(rp, 16)
    assert_close(hs, rhs, 1e-5)
    mean, std = demo.spectrum_stats(p)
    assert_close(demo.candidate_snr(hs, mean, std),
                 ref_demo.candidate_snr(rhs, *ref_demo.spectrum_stats(rp)),
                 RTOL)


def test_clamped_ladder_agrees_with_the_kernel_below_n_over_h():
    """The demo clamps j * k to n - 1; the kernel zero-pads past n.  They
    agree on every bin with k * H < n, and differ above it."""
    n, h = 1024, 32
    p = torch.from_numpy(np.random.default_rng(2).random((3, n)).astype(
        np.float32))
    clamped, padded = demo.harmonic_sum(p, h), harmonic_sum_kernel(p, h)
    k = n // h
    assert_close(clamped[..., :k], padded[..., :k].numpy(), 1e-6)
    assert not torch.allclose(clamped[..., k:], padded[..., k:])


@pytest.mark.parametrize("real_input", [False, True])
@pytest.mark.parametrize("batch,n,h", [(32, 2**20, 32), (4, 4096, 8),
                                       (8, 2**16, 1)])
def test_cost_model_is_field_identical(batch, n, h, real_input):
    shape = demo.PipelineShape(batch=batch, n=n, n_harmonics=h,
                               real_input=real_input)
    ref_shape = ref_demo.PipelineShape(batch=batch, n=n, n_harmonics=h,
                                       real_input=real_input)
    assert dataclasses.asdict(shape) == dataclasses.asdict(ref_shape)
    dev, ref_dev = port_core.TESLA_V100, ref_core.TESLA_V100
    assert [dataclasses.asdict(p) for p in demo.stage_profiles(shape, dev)] \
        == [dataclasses.asdict(p)
            for p in ref_demo.stage_profiles(ref_shape, ref_dev)]
    assert dataclasses.asdict(demo.total_profile(shape, dev)) == \
        dataclasses.asdict(ref_demo.total_profile(ref_shape, ref_dev))
    assert demo.fft_time_share(shape, dev) == \
        ref_demo.fft_time_share(ref_shape, ref_dev)
