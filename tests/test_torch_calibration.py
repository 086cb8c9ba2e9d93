"""The rest of ``core``: ``repro_torch.core`` against ``repro.core``.

The calibration rows, the full report, the sweeps over the paper's
lengths with their mean optimum and energy per transform, the FLOP
counts, the sampled-trace energy and ``absolute_profile`` are the same
numpy arithmetic in both packages, so they are compared for equality on
the devices both have.  The claims of the reference's
``tests/test_calibration.py`` are held on the port, and the H100 SXM
record that replaces the reference's TPU record is checked against the
figures it was written from."""
import dataclasses
import math

import numpy as np
import pytest

from repro import core as ref
from repro.core import calibration as ref_cal
from repro.core import dvfs as ref_dvfs
from repro.core import energy as ref_energy
from repro.core import workloads as ref_workloads
from repro.fft import stockham as ref_stockham
from repro_torch import core as port
from repro_torch.core import calibration as port_cal
from repro_torch.core import workloads as port_workloads
from repro_torch.fft import stockham as port_stockham

SHARED = ("TESLA_V100", "JETSON_NANO", "TITAN_V")
CALIBRATED = ("TESLA_V100", "JETSON_NANO")


def _asdict(x):
    return dataclasses.asdict(x)


def _precisions():
    return [(d, p) for d in CALIBRATED
            for p in ref_cal.supported_precisions(getattr(ref, d))]


@pytest.mark.parametrize("device,precision", _precisions())
def test_calibrate_rows_are_identical(device, precision):
    ref_dev, port_dev = getattr(ref, device), getattr(port, device)
    assert (port_cal.supported_precisions(port_dev)
            == ref_cal.supported_precisions(ref_dev))
    want = ref_cal.calibrate(ref_dev, precision)
    got = port.calibrate(port_dev, precision)
    assert got.row() == want.row()
    assert [_asdict(s) for s in got.sweeps] == [_asdict(s)
                                                for s in want.sweeps]
    assert _asdict(got.mean_opt) == _asdict(want.mean_opt)
    assert got.mean_i_ef_base == want.mean_i_ef_base


def test_full_report_is_identical():
    assert port.full_report() == ref_cal.full_report()


def test_paper_lengths_are_identical():
    assert port.paper_lengths() == ref.paper_lengths()
    assert (port_workloads.V100_REGIME_C_LENGTHS
            == ref_workloads.V100_REGIME_C_LENGTHS)
    for n in range(0, 70):
        assert port_workloads.is_pow2(n) == ref_workloads.is_pow2(n)
        assert port_stockham._is_pow2(n) == ref_stockham._is_pow2(n)


@pytest.mark.parametrize("device", SHARED)
def test_sweep_mean_optimal_and_energy_per_transform_are_identical(device):
    ref_dev, port_dev = getattr(ref, device), getattr(port, device)
    ref_sweeps, port_sweeps = [], []
    for n in ref.paper_lengths():
        ref_case, port_case = ref.FFTCase(n=n), port.FFTCase(n=n)
        ref_res = ref.sweep(ref.fft_workload(ref_case, ref_dev), ref_dev)
        port_res = port.sweep(port.fft_workload(port_case, port_dev),
                              port_dev)
        assert _asdict(port_res) == _asdict(ref_res), n
        assert (port.energy_per_transform(port_res, port_case.n_fft)
                == ref_dvfs.energy_per_transform(ref_res, ref_case.n_fft))
        ref_sweeps.append(ref_res)
        port_sweeps.append(port_res)
    assert (_asdict(port.mean_optimal(port_sweeps, port_dev))
            == _asdict(ref.mean_optimal(ref_sweeps, ref_dev)))


def test_energy_per_transform_counts_at_least_one_transform():
    res = port.sweep(port.fft_workload(port.FFTCase(n=1024), port.TESLA_V100),
                     port.TESLA_V100)
    assert (port.energy_per_transform(res, 0)
            == ref_dvfs.energy_per_transform(res, 0))
    assert port.energy_per_transform(res, 0)["optimal_j"] == res.optimal.energy


@pytest.mark.parametrize("n", (2, 8, 1024, 19321, 2**22))
def test_flop_counts_are_identical(n):
    for nb, nf in ((1, 1), (3, 7), (2, 244140)):
        assert port.fft_flops(n, nb, nf) == ref.fft_flops(n, nb, nf)
    for batch in (1, 5, 30517):
        assert (port_stockham.fft_flop_count(n, batch)
                == ref_stockham.fft_flop_count(n, batch))
    assert port.fft_flops(n) == 5.0 * n * math.log2(n)


def test_energy_from_trace_is_identical():
    rng = np.random.default_rng(3)
    p = rng.uniform(60.0, 700.0, 257)
    dt = rng.uniform(0.009, 0.011, 257)
    for args in ((p, dt), (p, 0.01), (p.tolist(), dt.tolist()), ([], 0.01)):
        assert (port.energy_from_trace(*args)
                == ref_energy.energy_from_trace(*args))
    assert port.energy_from_trace([100.0, 200.0], 0.5) == 150.0


@pytest.mark.parametrize("device", SHARED)
@pytest.mark.parametrize("kw", (
    {},
    {"issue_efficiency": 0.4, "cache_bytes": 3e8, "contention": 0.02},
    {"mxu_flops": 1e9, "stages": 4, "stage_bytes": 2e8, "passes": 2,
     "pass_bytes": 5e8},
    {"collective_bytes": 1e9, "flops": 0.0},
))
def test_absolute_profile_is_identical(device, kw):
    ref_dev, port_dev = getattr(ref, device), getattr(port, device)
    args = {"hbm_bytes": 4e9, "flops": 2.5e10, **kw}
    assert (_asdict(port.absolute_profile("w", device=port_dev, **args))
            == _asdict(ref.absolute_profile("w", device=ref_dev, **args)))
    link = dataclasses.replace(ref_dev, link_bandwidth=50e9)
    port_link = dataclasses.replace(port_dev, link_bandwidth=50e9)
    assert (_asdict(port.absolute_profile("w", device=port_link, **args))
            == _asdict(ref.absolute_profile("w", device=link, **args)))


@pytest.mark.parametrize("device", SHARED)
@pytest.mark.parametrize("n", (1024, 8192, 2**20, 139**2))
def test_regime_is_identical(device, n):
    ref_dev, port_dev = getattr(ref, device), getattr(port, device)
    for regime_c in (False, True):
        r = ref.fft_workload(ref.FFTCase(n=n), ref_dev, regime_c=regime_c)
        p = port.fft_workload(port.FFTCase(n=n), port_dev, regime_c=regime_c)
        assert p.regime() == r.regime()
        assert p.regime(port_dev) == r.regime(ref_dev)
        assert p.knee_frac == r.knee_frac


# ---------------------------------------------------------------------------
# the device records
# ---------------------------------------------------------------------------

def test_shared_device_records_are_identical():
    for name in SHARED:
        assert _asdict(getattr(port, name)) == _asdict(getattr(ref, name))
        dev = getattr(port, name)
        assert port.get_device(dev.name) is dev
        assert port.DEVICES[dev.name] is dev
    assert (port.hardware.TITAN_V_DRIVER_CAP_MHZ
            == ref.hardware.TITAN_V_DRIVER_CAP_MHZ)
    assert set(port.DEVICES) == set(ref.DEVICES) - {"tpu-v5e"} | {"h100-sxm"}


def test_tpu_record_is_not_in_the_port():
    with pytest.raises(KeyError, match="h100-sxm"):
        port.get_device("tpu-v5e")
    assert not hasattr(port, "TPU_V5E")


def test_h100_record():
    dev = port.get_device("h100-sxm")
    assert dev is port.H100_SXM
    assert (dev.peak_flops, dev.hbm_bandwidth, dev.memory_bytes, dev.tdp) == (
        67e12, 3.35e12, 80e9, 700.0)
    # 132 SMs x 128 bytes a clock at f_max: the 33.5e12 of the chip check.
    assert dev.cache_bandwidth == pytest.approx(33.5e12, rel=2e-3)
    # The card's graphics-clock grid: 1980 down to 345 MHz, 15 MHz apart.
    grid = dev.frequencies()
    assert len(grid) == 110 and grid[0] == 1980.0 and grid[-1] == 345.0
    assert np.all(np.diff(grid) == -15.0)
    assert dev.f_base == 1980.0 and 0.0 < dev.idle_power < dev.tdp
    assert dev.link_bandwidth is None
    # Uncalibrated: the voltage and issue parameters are the defaults.
    defaults = port.DeviceSpec("x", 1.0, None, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                               1.0, 1.0)
    for field in ("v_max", "v_floor", "f_vfloor_frac", "issue_superlinearity",
                  "issue_efficiency", "stall_power_frac", "exec_overlap",
                  "mem_power_frac", "power_sensor_includes_mem"):
        assert getattr(dev, field) == getattr(defaults, field), field


@pytest.mark.parametrize("kind,n", (("c2c", 1024), ("c2c", 8192),
                                    ("r2c", 16384)))
def test_h100_model_prices_the_main_path(kind, n):
    """The phase-9 cases on the H100 model: an optimum on the grid, below
    boost, with less energy than boost and a finite per-transform figure."""
    case = port.FFTCase(n, transform=kind)
    res = port.sweep(port.fft_workload(case, port.H100_SXM), port.H100_SXM)
    e = port.energy_per_transform(res, case.n_fft)
    assert e["optimal_mhz"] in port.H100_SXM.frequencies()
    assert e["optimal_mhz"] < port.H100_SXM.f_max
    assert 0.0 < e["optimal_j"] < e["boost_j"]
    assert res.boost.power <= port.H100_SXM.tdp


# ---------------------------------------------------------------------------
# the claims of tests/test_calibration.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v100_fp32():
    return port.calibrate(port.TESLA_V100, "fp32")


@pytest.fixture(scope="module")
def nano_fp32():
    return port.calibrate(port.JETSON_NANO, "fp32")


class TestV100Claims:
    def test_mean_optimal_frequency_table3(self, v100_fp32):
        assert 0.55 <= v100_fp32.mean_opt_frac <= 0.70
        assert abs(v100_fp32.mean_opt.f_mean - 945.0) <= 80.0

    def test_precision_independence_of_optimal(self):
        fracs = [port.calibrate(port.TESLA_V100, p).mean_opt_frac
                 for p in port.supported_precisions(port.TESLA_V100)]
        assert max(fracs) - min(fracs) <= 0.06

    def test_slowdown_below_10pct(self, v100_fp32):
        slowdowns = [s.slowdown for s in v100_fp32.sweeps]
        assert np.median(slowdowns) <= 0.05
        assert np.quantile(slowdowns, 0.9) <= 0.10

    def test_power_cut_up_to_60pct(self, v100_fp32):
        assert 0.50 <= v100_fp32.max_power_reduction <= 0.72

    def test_mean_power_cut_50pct(self, v100_fp32):
        assert 0.38 <= v100_fp32.mean_power_reduction <= 0.60

    def test_i_ef_vs_base_sec62(self, v100_fp32):
        assert 1.15 <= v100_fp32.mean_i_ef_base <= 1.45

    def test_i_ef_vs_boost(self, v100_fp32):
        assert 1.40 <= v100_fp32.mean_i_ef_boost <= 2.10

    def test_mean_opt_loss_within_paper_band(self, v100_fp32):
        assert 0.0 <= v100_fp32.mean_opt.loss_pp <= 16.0

    def test_regime_c_length_8192(self, v100_fp32):
        s = next(x for x in v100_fp32.sweeps if "n8192-" in x.profile.name)
        assert s.profile.regime() == "c"
        assert s.slowdown >= -0.02

    def test_energy_u_shape_all_lengths(self, v100_fp32):
        for s in v100_fp32.sweeps:
            n = int(s.profile.name.split("-")[1][1:])
            if port_workloads.uses_bluestein(n):
                continue
            e = np.array([p.energy for p in s.points])
            assert e.argmin() > 0, s.profile.name


class TestJetsonClaims:
    def test_mean_optimal_frequency_table3(self, nano_fp32):
        assert abs(nano_fp32.mean_opt.f_mean - 460.8) <= 76.8 + 1e-9

    def test_slowdown_around_60pct(self, nano_fp32):
        assert 0.30 <= np.median([s.slowdown for s in nano_fp32.sweeps]) <= 0.90

    def test_regime_c_dominates(self, nano_fp32):
        pow2 = [s for s in nano_fp32.sweeps
                if port_workloads.is_pow2(int(s.profile.name.split("-")[1][1:]))]
        frac_c = np.mean([s.profile.regime(port.JETSON_NANO) == "c"
                          for s in pow2])
        assert frac_c >= 0.75

    def test_i_ef_vs_boost_70pct(self, nano_fp32):
        assert 1.45 <= nano_fp32.mean_i_ef_boost <= 2.0

    def test_nano_v100_efficiency_same_magnitude(self, nano_fp32, v100_fp32):
        nano_eff = np.median([s.optimal.gflops_per_watt
                              for s in nano_fp32.sweeps])
        v100_eff = np.median([s.optimal.gflops_per_watt
                              for s in v100_fp32.sweeps])
        assert 0.5 <= nano_eff / v100_eff <= 2.0

    def test_mean_opt_loss_small(self, nano_fp32):
        assert nano_fp32.mean_opt.loss_pp <= 16.0


# ---------------------------------------------------------------------------
# the checks of tests/test_core_model.py, on the port
# ---------------------------------------------------------------------------

class TestCoreModelChecks:
    @pytest.mark.parametrize("device", ("TESLA_V100", "H100_SXM"))
    def test_grid_voltage_and_power_are_monotone(self, device):
        dev = getattr(port, device)
        f = dev.frequencies()
        assert f[0] == dev.f_max and f[-1] >= dev.f_min
        assert np.all(np.diff(f) < 0)
        v = dev.voltage(f)
        assert v[0] == pytest.approx(1.0) and np.all(np.diff(v) <= 1e-12)
        assert v[-1] == pytest.approx(dev.v_floor)
        p = port.PowerModel(dev).power(f)
        assert np.all(np.diff(p) <= 1e-9)
        assert p[0] <= dev.tdp + 1e-9 and p[-1] >= 0

    def test_time_model_regimes(self):
        dev = port.TESLA_V100
        f = dev.frequencies()
        prof_b = port.WorkloadProfile("b", t_mem=1.0, t_issue=0.4)
        t = prof_b.time(f, dev)
        knee_f = 0.4 ** (1 / dev.issue_superlinearity) * dev.f_max
        assert np.allclose(t[f > knee_f * 1.05], t[0], rtol=0.02)
        assert t[-1] > 2.0 and prof_b.regime() == "b"
        prof_c = port.WorkloadProfile("c", t_mem=1.0, t_cache=1.02)
        assert np.all(np.diff(prof_c.time(f, dev)) >= -1e-12)
        assert prof_c.regime() == "c"
        prof_a = port.WorkloadProfile("a", t_mem=1.0, t_issue=0.3,
                                      contention=0.02)
        t_a = prof_a.time(f, dev)
        assert t_a.min() < t_a[0] and prof_a.regime() == "a"

    @pytest.mark.parametrize("device", ("TESLA_V100", "H100_SXM"))
    def test_energy_u_shape_and_optimal_interior(self, device):
        dev = getattr(port, device)
        res = port.sweep(port.fft_workload(port.FFTCase(n=2**14), dev), dev)
        energies = np.array([p.energy for p in res.points])
        assert 0 < int(np.argmin(energies)) < len(energies) - 1
        assert res.optimal.energy < res.boost.energy

    def test_eq5_eq6_and_trace_energy(self):
        assert port.fft_flops(1024) == pytest.approx(5 * 1024 * 10)
        assert port.ffts_per_batch(2e9, 2**14, 8) == int(2e9 // (2**14 * 8))
        assert port.energy_from_trace(np.full(100, 200.0), 0.01) == (
            pytest.approx(200.0))

    def test_driver_cap_and_time_budget(self):
        cap = port.hardware.TITAN_V_DRIVER_CAP_MHZ
        prof = port.fft_workload(port.FFTCase(n=2**14), port.TITAN_V)
        res = port.sweep(prof, port.TITAN_V, driver_cap_mhz=cap)
        assert max(p.f for p in res.points) <= cap
        prof = port.fft_workload(port.FFTCase(n=2**14), port.JETSON_NANO)
        tight = port.sweep(prof, port.JETSON_NANO, time_budget=0.05)
        loose = port.sweep(prof, port.JETSON_NANO)
        assert tight.slowdown <= 0.05 + 1e-9
        assert loose.optimal.energy <= tight.optimal.energy + 1e-12
