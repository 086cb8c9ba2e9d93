"""DVFS pricing: ``repro_torch.core`` is field-identical to ``repro.core``
for the paper's devices over the quickstart's lengths (the models are the
same numpy arithmetic, so equality is exact)."""
import dataclasses

import pytest

from repro import core as ref
from repro_torch import core as port

DEVICES = ("TESLA_V100", "JETSON_NANO", "TITAN_V")
#: examples/quickstart.py's lengths, plus the paper's Bluestein example.
LENGTHS = tuple(2**k for k in range(10, 21, 2)) + (139**2,)


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("radices", (None, (4, 2)))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("device", DEVICES)
def test_fft_workload_and_sweep_are_identical(device, n, radices):
    ref_dev, port_dev = getattr(ref, device), getattr(port, device)
    assert _asdict(port_dev) == _asdict(ref_dev)
    ref_case = ref.FFTCase(n=n, radices=radices)
    port_case = port.FFTCase(n=n, radices=radices)
    assert _asdict(port_case) == _asdict(ref_case)
    assert port_case.n_fft == ref_case.n_fft
    ref_prof = ref.fft_workload(ref_case, ref_dev)
    port_prof = port.fft_workload(port_case, port_dev)
    assert _asdict(port_prof) == _asdict(ref_prof)
    ref_res = ref.sweep(ref_prof, ref_dev)
    port_res = port.sweep(port_prof, port_dev)
    assert _asdict(port_res) == _asdict(ref_res)
    assert port_res.i_ef_boost == ref_res.i_ef_boost
    assert port_res.i_ef_base == ref_res.i_ef_base
    assert port_res.slowdown == ref_res.slowdown
    assert port_res.power_reduction == ref_res.power_reduction


@pytest.mark.parametrize("device", DEVICES)
def test_mean_optimal_is_identical(device):
    ref_dev, port_dev = getattr(ref, device), getattr(port, device)
    ref_mo = ref.mean_optimal(
        [ref.sweep(ref.fft_workload(ref.FFTCase(n=n), ref_dev), ref_dev)
         for n in LENGTHS], ref_dev)
    port_mo = port.mean_optimal(
        [port.sweep(port.fft_workload(port.FFTCase(n=n), port_dev), port_dev)
         for n in LENGTHS], port_dev)
    assert _asdict(port_mo) == _asdict(ref_mo)
    assert port_mo.loss_pp == ref_mo.loss_pp


def test_sweep_options_are_identical():
    dev = "TITAN_V"
    case = (2**16,)
    ref_prof = ref.fft_workload(ref.FFTCase(n=case[0]), ref.TITAN_V,
                                regime_c=True)
    port_prof = port.fft_workload(port.FFTCase(n=case[0]), port.TITAN_V,
                                  regime_c=True)
    assert _asdict(port_prof) == _asdict(ref_prof), dev
    kw = dict(time_budget=0.05, driver_cap_mhz=1335.0)
    assert (_asdict(port.sweep(port_prof, port.TITAN_V, **kw))
            == _asdict(ref.sweep(ref_prof, ref.TITAN_V, **kw)))


def test_builders_of_later_slices_raise():
    """No workload model waits for a later slice any more: the N-D, FDAS
    and pulsar-search models all price (their parity is in
    test_torch_plan_nd.py, test_torch_fdas.py and test_torch_pipeline.py)."""
    assert port.fft_workload(port.FFTCase(shape=(64, 64)),
                             port.TESLA_V100).t_mem > 0
    kw = dict(nchan=16, ntime=2048, dm_trials=8, templates=5, taps=33)
    assert [_asdict(p) for p in port.pulsar_search_workload(
        port.PulsarCase(**kw), port.TESLA_V100)] == [
            _asdict(p) for p in ref.workloads.pulsar_search_workload(
                ref.workloads.PulsarCase(**kw), ref.TESLA_V100)]
