"""The port's FDAS search (``repro_torch.search``) against the reference's
(``repro.search``): bit-identical template taps, field-identical DVFS
workloads for the Tesla V100, the same matched-filter plane from one numpy
input (max |a-b| <= 1e-4 * max |ref|, the reference's plane tolerance),
and the injected accelerated pulsar of ``BENCH_fdas.json`` recovered at
(template 7, bin 1200).  Candidates are compared as (template, bin) sets:
``torch.topk`` may order equal powers differently from ``lax.top_k``."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
import repro.search as ref_search
from repro.core import TESLA_V100 as REF_V100
from repro.core import workloads as ref_workloads
import repro_torch.search as port_search
from repro_torch.core import TESLA_V100
from repro_torch.core import workloads as port_workloads
from repro_torch.fft import plan as port_plan

RTOL = 1e-4


def accelerated_series(n, k0, z, *, amp=0.25, noise=0.5, seed=0):
    """``benchmarks/run.py``'s injected pulsar: a tone starting at bin k0
    that drifts z bins, in white noise."""
    rng = np.random.default_rng(seed)
    s = np.arange(n) / n
    x = (amp * np.cos(2 * np.pi * (k0 * s + 0.5 * z * s * s))
         + noise * rng.standard_normal(n))
    return x.astype(np.float32)[None]


@pytest.mark.parametrize("zmax,n_templates,taps", [
    (8, 9, None), (42, None, None), (4, 5, 48), (0, None, None),
    (3, 7, None), (2.5, 4, 33),
])
def test_taps_are_bit_identical(zmax, n_templates, taps):
    ref = ref_search.TemplateBank.linear(zmax, n_templates, taps)
    port = port_search.TemplateBank.linear(zmax, n_templates, taps)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.key, port.offset, port.n_templates) == \
        (ref.key, ref.offset, ref.n_templates)
    assert np.array_equal(port.time_domain(), ref.time_domain())


def test_fdas_bank_of_the_chip_check():
    bank = port_search.TemplateBank.linear(zmax=42)
    assert (bank.n_templates, bank.taps) == (85, 100)
    plan = port_search.fdas_conv_plan(2**22, bank)
    assert (plan.nfft, plan.step, plan.n_segments) == (2048, 1949, 1077)


@pytest.mark.parametrize("n,templates,taps", [
    (2**12 + 1, 9, 32), (4097, 18, 32), (2**21 + 1, 85, 100),
    (2**19 + 1, 85, 100), (1025, 5, 33),
])
def test_workloads_are_field_identical(n, templates, taps):
    ref_case = ref_workloads.ConvCase(n=n, templates=templates, taps=taps)
    port_case = port_workloads.ConvCase(n=n, templates=templates, taps=taps)
    assert dataclasses.asdict(port_case) == dataclasses.asdict(ref_case)
    assert port_case.n_rows == ref_case.n_rows
    assert dataclasses.asdict(port_workloads.conv_workload(
        port_case, TESLA_V100)) == dataclasses.asdict(
            ref_workloads.conv_workload(ref_case, REF_V100))
    series = 2 * (n - 1)
    port_profs = port_workloads.fdas_workload(port_case, TESLA_V100,
                                              series_n=series)
    ref_profs = ref_workloads.fdas_workload(ref_case, REF_V100,
                                            series_n=series)
    assert [dataclasses.asdict(p) for p in port_profs] == \
        [dataclasses.asdict(p) for p in ref_profs]
    assert dataclasses.asdict(port_workloads.fdas_total_profile(
        port_case, TESLA_V100)) == dataclasses.asdict(
            ref_workloads.fdas_total_profile(ref_case, REF_V100))


@pytest.mark.parametrize("nbins", [513, 700])
def test_plane_matches_reference(nbins):
    bank_args = dict(zmax=4, n_templates=5)
    spec = rand_complex(nbins, (2, nbins))
    ref, port, ref_rec, port_rec = run_both(
        lambda: ref_search.matched_filter_plane(
            spec, ref_search.TemplateBank.linear(**bank_args)),
        lambda: port_search.matched_filter_plane(
            torch.from_numpy(spec),
            port_search.TemplateBank.linear(**bank_args)))
    assert tuple(port.shape) == (2, 5, nbins)
    assert_close(port, ref, RTOL)
    assert [r.kernel for r in port_rec] == ["fft-c2c-mul", "fft-c2c"]
    inverse = port_rec[1]
    plan = port_search.fdas_conv_plan(2 * (nbins - 1), port_search.
                                      TemplateBank.linear(**bank_args))
    # One inverse launch covers every (row, segment, template) plane.
    assert inverse.shape == (2 * plan.n_segments * 5, plan.nfft)
    assert [(r.kernel, r.shape) for r in port_rec] == \
        [(r.kernel, r.shape) for r in ref_rec]


def test_injected_pulsar_recovered_at_template_7_bin_1200():
    """``BENCH_fdas.json``: n = 8192, 9 templates, the tone at bin 1200
    drifting 6 bins is recovered at (template 7, bin 1200), as the
    reference recovers it; the candidate sets agree."""
    n, k0, z = 8192, 1200, 6.0
    x = accelerated_series(n, k0, z)
    ref_bank = ref_search.TemplateBank.linear(zmax=8, n_templates=9)
    port_bank = port_search.TemplateBank.linear(zmax=8, n_templates=9)
    ref = ref_search.fdas_search(x, ref_bank)
    port = port_search.fdas_search(torch.from_numpy(x), port_bank)
    power = port.power[0].numpy()
    t_hit, b_hit = np.unravel_index(int(power.argmax()), power.shape)
    t_want = int(np.argmin(np.abs(np.array(port_bank.drifts) - z)))
    assert (t_hit, t_want) == (7, 7) and b_hit == k0
    assert_close(port.power, np.asarray(ref.power), RTOL)
    assert_close(port.sigma2, np.asarray(ref.sigma2), 1e-5)

    def cells(c):
        return {(int(t), int(b)) for t, b in zip(np.asarray(c.template)[0],
                                                 np.asarray(c.bin)[0])}
    assert cells(port.candidates) == cells(ref.candidates)
    assert (int(port.candidates.template[0, 0]),
            int(port.candidates.bin[0, 0])) == (7, 1200)
    packed = port_search.serving_candidates(port)
    assert tuple(packed.shape) == (1, 16, 3) and packed.dtype == torch.float32


def test_search_runs_r2c_then_one_fused_multiply():
    bank = port_search.TemplateBank.linear(zmax=2, n_templates=5)
    x = accelerated_series(1024, 200, 2.0, seed=5)
    _, res, _, rec = run_both(
        lambda: 0, lambda: port_search.fdas_search(torch.from_numpy(x), bank,
                                                   threshold=5.0))
    assert [r.kernel for r in rec] == ["fft-r2c", "fft-c2c-mul", "fft-c2c"]
    assert tuple(res.power.shape) == (1, 5, 513)


def test_extract_candidates_masks_below_threshold():
    power = torch.zeros(1, 3, 100)
    power[0, 1, 40] = 50.0
    power[0, 2, 7] = 9.0
    c = port_search.extract_candidates(power, threshold=8.0,
                                       max_candidates=4)
    assert (int(c.template[0, 0]), int(c.bin[0, 0])) == (1, 40)
    assert (int(c.template[0, 1]), int(c.bin[0, 1])) == (2, 7)
    assert int(c.template[0, 2]) == -1 and int(c.bin[0, 2]) == -1
    assert float(c.power[0, 2]) == 0.0
    assert c.template.dtype == torch.int32


def test_kernels_disabled_search_matches(monkeypatch):
    bank = port_search.TemplateBank.linear(zmax=3, n_templates=7)
    x = torch.from_numpy(accelerated_series(2048, 300, 3.0, seed=2))
    want = port_search.fdas_search(x, bank)

    def fail(*args, **kwargs):
        raise AssertionError("a kernel ran under kernels_disabled()")

    for hook in ("_kernel_fft", "_kernel_rfft", "_kernel_fft_mul"):
        monkeypatch.setattr(port_plan, hook, fail)
    with port_plan.kernels_disabled():
        got = port_search.fdas_search(x, bank)
    assert_close(got.power, want.power.numpy(), 1e-5)
