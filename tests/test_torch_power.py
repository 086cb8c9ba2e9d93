"""The power plane: ``repro_torch.power`` against ``repro.power``.

Parity (on ``TESLA_V100``, a record both packages have): the simulated
sampler's readings are bit-identical for a seed, with drift and with each
sensor-fault kind injected (each side gets its own fresh reference
``FaultPlan``, and again with the port's side driven by the port's own
``repro_torch.runtime.faults.FaultPlan``); the watchdog's labels and health, the governor's clock
sequence, the fleet telemetry and a ``SiteBudgetScheduler`` run shaped
like the reference benchmark's power site (8 devices, priorities 1-4,
the sweep optimum of n = 4096 as fallback) are identical, tick for tick
and digest for digest.

Behaviour (on ``H100_SXM``): the checks of the reference's
``tests/test_power.py`` on the port, with the site cap at the same share
of the fleet's TDP as the reference benchmark's (1400 W of 8 x 220 W).
The governor's default gains are sized for ~200 W parts and do not settle
a 700 W part within 40 ticks (measurement noise of 1 % is ~6 W there, 4x
the default dead band), so the site checks pass a ``GovernorConfig``
scaled by 700 / 220: gains divided by it, dead band and integral clamp
multiplied by it.  The defaults are unchanged.
"""
import dataclasses
import math

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from _hyp import given, settings, st

import repro.power as ref_power
from repro.core import FFTCase as RefFFTCase
from repro.core import TESLA_V100 as REF_V100
from repro.core import fft_workload as ref_fft_workload
from repro.core import sweep as ref_sweep
from repro.power import sampler as ref_sampler
from repro.runtime.faults import (SENSOR_DROPOUT, SENSOR_KINDS, SENSOR_SPIKE,
                                  SENSOR_STALE, FaultEvent, FaultPlan)
import repro_torch.power as port_power
import repro_torch.runtime.faults as port_faults
from repro_torch.core import H100_SXM, TESLA_V100, FFTCase, PowerModel
from repro_torch.core import fft_workload, sweep
from repro_torch.power import (DROPOUT, FRESH, HEALTHY, SPIKE, STALE, SUSPECT,
                               UNHEALTHY, FleetTelemetry, GovernorConfig,
                               PowerGovernor, PowerReading,
                               SimulatedPowerSampler, SiteBudgetScheduler,
                               SitePipeline, TelemetryRing, TelemetryWatchdog)
from repro_torch.power import sampler as port_sampler


def _bits(r):
    """A reading as comparable bits (NaN equals NaN)."""
    return (r.device_index, float(r.t).hex(), float(r.power_w).hex())


# ---------------------------------------------------------------------------
# parity on TESLA_V100
# ---------------------------------------------------------------------------

def test_public_names_match_the_reference():
    assert port_power.__all__ == ref_power.__all__
    for name in port_power.__all__:
        assert hasattr(port_power, name), name
    assert (port_sampler.SENSOR_DROPOUT, port_sampler.SENSOR_SPIKE,
            port_sampler.SENSOR_STALE) == (SENSOR_DROPOUT, SENSOR_SPIKE,
                                           SENSOR_STALE)
    for name in ("DROPOUT", "FRESH", "STALE", "SPIKE", "HEALTHY", "SUSPECT",
                 "UNHEALTHY"):
        assert getattr(port_power, name) == getattr(ref_power, name)


def test_hash_frac_gives_the_same_bits():
    for seed in (0, 1, 12345):
        for dev in range(4):
            for k in range(64):
                assert (port_sampler._hash_frac(seed, dev, k)
                        == ref_sampler._hash_frac(seed, dev, k))


def _drive_sampler(mod, dev, *, plan=None, **kw):
    s = mod.SimulatedPowerSampler(dev, fault_plan=plan, **kw)
    out = []
    for k in range(40):
        d = k % 3
        over = {}
        if k % 4 == 1:
            over = {"f_mhz": 900.0 + 7.5 * k, "u_core": 0.5, "u_mem": 0.25}
        out.append(_bits(s.sample(d, 0.05 * k, token=k, **over)))
        out.append(float(s.truth_w(d)).hex())
    return out


@pytest.mark.parametrize("seed", (0, 7, 2**31 - 1))
@pytest.mark.parametrize("drift_w", (0.0, 3.0))
@pytest.mark.parametrize("noise_frac", (0.0, 0.01, 0.2))
def test_sampler_readings_are_bit_identical(seed, drift_w, noise_frac):
    kw = dict(seed=seed, drift_w=drift_w, noise_frac=noise_frac,
              drift_tau_s=0.7)
    assert (_drive_sampler(port_power, TESLA_V100, **kw)
            == _drive_sampler(ref_power, REF_V100, **kw))


def _storm(kind, faults=None):
    """A storm of ``kind`` on the reference's fault plane, or on
    ``faults`` (the port's ``runtime.faults``)."""
    event = FaultEvent if faults is None else faults.FaultEvent
    plan = FaultPlan if faults is None else faults.FaultPlan
    events = [event(kind, batch_id=k, worker=k % 3)
              for k in (0, 3, 4, 5, 11, 12, 20)]
    events.append(event(kind))                      # any sample
    return plan(events=events)


@pytest.mark.parametrize("kind", SENSOR_KINDS)
def test_sampler_faults_are_bit_identical(kind):
    ref_plan, port_plan = _storm(kind), _storm(kind)
    want = _drive_sampler(ref_power, REF_V100, plan=ref_plan, seed=3,
                          drift_w=2.0)
    got = _drive_sampler(port_power, TESLA_V100, plan=port_plan, seed=3,
                         drift_w=2.0)
    assert got == want
    assert port_plan.fired_count(kind) == ref_plan.fired_count(kind) > 0
    assert port_plan.pending() == ref_plan.pending()


def test_sampler_mixed_faults_are_bit_identical():
    def plan():
        return FaultPlan(events=[FaultEvent(SENSOR_DROPOUT, batch_id=0),
                                 FaultEvent(SENSOR_SPIKE, batch_id=1),
                                 FaultEvent(SENSOR_STALE, batch_id=3),
                                 FaultEvent(SENSOR_STALE, batch_id=4),
                                 FaultEvent(SENSOR_SPIKE, worker=2)])
    assert (_drive_sampler(port_power, TESLA_V100, plan=plan(), seed=1)
            == _drive_sampler(ref_power, REF_V100, plan=plan(), seed=1))


@pytest.mark.parametrize("kind", SENSOR_KINDS)
def test_sampler_faults_from_the_ports_plan_are_bit_identical(kind):
    ref_plan, port_plan = _storm(kind), _storm(kind, port_faults)
    want = _drive_sampler(ref_power, REF_V100, plan=ref_plan, seed=3,
                          drift_w=2.0)
    got = _drive_sampler(port_power, TESLA_V100, plan=port_plan, seed=3,
                         drift_w=2.0)
    assert got == want
    assert port_plan.fired_count(kind) == ref_plan.fired_count(kind) > 0
    assert port_plan.pending() == ref_plan.pending()
    assert [(e.kind, e.batch_id, e.worker) for e in port_plan.fired] == \
        [(e.kind, e.batch_id, e.worker) for e in ref_plan.fired]


def test_sampler_mixed_faults_from_a_generated_port_plan():
    """FaultPlan.generate draws the same sensor events in both packages,
    and they corrupt the same readings."""
    kw = dict(n_batches=40, sensor_dropout_rate=0.1, sensor_spike_rate=0.1,
              sensor_stale_rate=0.1)
    ref_plan = FaultPlan.generate(9, **kw)
    port_plan = port_faults.FaultPlan.generate(9, **kw)
    assert (_drive_sampler(port_power, TESLA_V100, plan=port_plan, seed=1)
            == _drive_sampler(ref_power, REF_V100, plan=ref_plan, seed=1))
    assert all(port_plan.fired_count(k) == ref_plan.fired_count(k)
               for k in SENSOR_KINDS)
    assert sum(port_plan.fired_count(k) for k in SENSOR_KINDS) > 3


def _readings(seed, n=120):
    """A stream of readings with dropouts, spikes, steps and stale stamps."""
    rng = np.random.default_rng(seed)
    out, level = [], 150.0
    for k in range(n):
        t, now = 0.01 * k, 0.01 * k
        u = rng.random()
        if u < 0.08:
            p = float("nan")
        elif u < 0.14:
            p = float(rng.choice([-5.0, 900.0, level + 200.0]))
        elif u < 0.2:
            t = now - float(rng.choice([0.05, 0.06, 0.3]))
            p = level
        elif u < 0.25:
            level = float(rng.uniform(60.0, 290.0))
            p = level
        else:
            p = level + float(rng.normal(0.0, 2.0))
        out.append((PowerReading(k % 2, t, p), now))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", ({}, {"unhealthy_after": 2, "rearm_after": 3,
                                      "step_w": 40.0, "stale_timeout_s": 0.02}))
def test_watchdog_labels_and_health_are_identical(seed, kw):
    port_dog = TelemetryWatchdog(TESLA_V100, **kw)
    ref_dog = ref_power.TelemetryWatchdog(REF_V100, **kw)
    for reading, now in _readings(seed):
        ref_reading = ref_power.PowerReading(reading.device_index, reading.t,
                                             reading.power_w)
        assert (port_dog.classify(reading, now)
                == ref_dog.classify(ref_reading, now))
        assert (port_dog.observe(reading, now)
                == ref_dog.observe(ref_reading, now))
        assert port_dog.healthy == ref_dog.healthy
    assert port_dog.counts == ref_dog.counts
    assert port_dog.unhealthy_entries == ref_dog.unhealthy_entries
    assert (_bits(port_dog.baseline) if port_dog.baseline else None) == (
        _bits(ref_dog.baseline) if ref_dog.baseline else None)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cfg", ({}, {"kp_mhz_per_w": 1.5, "ki_mhz_per_w": 0.5,
                                      "hysteresis_w": 4.0,
                                      "slew_mhz_per_tick": 30.0,
                                      "integral_clamp_w": 80.0}))
def test_governor_clock_sequences_are_identical(seed, cfg):
    rng = np.random.default_rng(100 + seed)
    port_gov = PowerGovernor(TESLA_V100, target_w=180.0, fallback_mhz=967.5,
                             config=GovernorConfig(**cfg), f0_mhz=1200.0)
    ref_gov = ref_power.PowerGovernor(REF_V100, target_w=180.0,
                                      fallback_mhz=967.5,
                                      config=ref_power.GovernorConfig(**cfg),
                                      f0_mhz=1200.0)
    for k in range(150):
        if k == 60:
            port_gov.set_target(120.0)
            ref_gov.set_target(120.0)
        u = rng.random()
        measured = (None if u < 0.05 else float("nan") if u < 0.08
                    else float(rng.uniform(40.0, 320.0)))
        healthy = not (30 <= k < 36 or rng.random() < 0.03)
        assert (port_gov.step(measured, healthy=healthy).hex()
                == ref_gov.step(measured, healthy=healthy).hex())
        assert port_gov.mode == ref_gov.mode
        assert port_gov.integral_w == ref_gov.integral_w
    assert (port_gov.ticks, port_gov.moves, port_gov.fallback_engagements) == (
        ref_gov.ticks, ref_gov.moves, ref_gov.fallback_engagements)


@pytest.mark.parametrize("kind", (None,) + SENSOR_KINDS)
def test_fleet_telemetry_is_identical(kind):
    def plan():
        return None if kind is None else _storm(kind)
    port_tel = FleetTelemetry.for_serving(TESLA_V100, seed=4,
                                          fault_plan=plan(), drift_w=1.0)
    ref_tel = ref_power.FleetTelemetry.for_serving(REF_V100, seed=4,
                                                   fault_plan=plan(),
                                                   drift_w=1.0)
    for k in range(30):
        kw = dict(token=k, f_mhz=1000.0 + 5.0 * k, u_core=0.8, u_mem=0.6)
        got = port_tel.read(k % 3, 1e-6 * k, **kw)
        want = ref_tel.read(k % 3, 1e-6 * k, **kw)
        assert (_bits(got.reading), got.label, got.health) == (
            _bits(want.reading), want.label, want.health)
        assert (got.measured_w is None) == (want.measured_w is None)
        assert got.fresh == want.fresh
        assert port_tel.healthy(k % 3) == ref_tel.healthy(k % 3)
    assert port_tel.summary() == ref_tel.summary()
    assert ([len(r) for r in port_tel.rings.values()]
            == [len(r) for r in ref_tel.rings.values()])


@pytest.mark.parametrize("kind", SENSOR_KINDS)
def test_fleet_telemetry_from_the_ports_plan_is_identical(kind):
    port_tel = FleetTelemetry.for_serving(
        TESLA_V100, seed=4, fault_plan=_storm(kind, port_faults),
        drift_w=1.0)
    ref_tel = ref_power.FleetTelemetry.for_serving(
        REF_V100, seed=4, fault_plan=_storm(kind), drift_w=1.0)
    for k in range(30):
        kw = dict(token=k, f_mhz=1000.0 + 5.0 * k, u_core=0.8, u_mem=0.6)
        got = port_tel.read(k % 3, 1e-6 * k, **kw)
        want = ref_tel.read(k % 3, 1e-6 * k, **kw)
        assert (_bits(got.reading), got.label, got.health) == (
            _bits(want.reading), want.label, want.health)
    assert port_tel.summary() == ref_tel.summary()
    assert port_tel.summary()["labels"].get(
        {SENSOR_DROPOUT: DROPOUT, SENSOR_SPIKE: SPIKE,
         SENSOR_STALE: STALE}[kind], 0) > 0


def _site(pkg, dev, fallback, *, fault_plan=None, site_cap_w=1400.0,
          hard_cap_w=1500.0, n_devices=8, seed=0):
    """The reference benchmark's power site on ``dev``: 8 governed devices,
    priorities 1-4, one sweep-optimum fallback clock."""
    pipes = [pkg.SitePipeline(name=f"pipe{i}", device_index=i,
                              priority=(i % 4) + 1, fallback_mhz=fallback,
                              u_core=0.9, u_mem=0.8)
             for i in range(n_devices)]
    return pkg.SiteBudgetScheduler(dev, pipes, site_cap_w=site_cap_w,
                                   hard_cap_w=hard_cap_w, seed=seed,
                                   fault_plan=fault_plan)


def _v100_fallbacks():
    ref_f = ref_sweep(ref_fft_workload(RefFFTCase(n=4096), REF_V100),
                      REF_V100).optimal.f
    port_f = sweep(fft_workload(FFTCase(n=4096), TESLA_V100),
                   TESLA_V100).optimal.f
    assert port_f == ref_f
    return ref_f


def _same_run(port_site, ref_site):
    assert ([dataclasses.asdict(t) for t in port_site.history]
            == [dataclasses.asdict(t) for t in ref_site.history])
    assert port_site.digest() == ref_site.digest()
    assert port_site.first_converged_tick == ref_site.first_converged_tick
    assert port_site.emergencies == ref_site.emergencies
    assert ([p.name for p in port_site.shed]
            == [p.name for p in ref_site.shed])


@pytest.mark.parametrize("seed", (0, 5))
def test_site_run_gives_identical_ticks_and_digest(seed):
    fb = _v100_fallbacks()
    port_site = _site(port_power, TESLA_V100, fb, seed=seed)
    ref_site = _site(ref_power, REF_V100, fb, seed=seed)
    port_site.run(80, dt=0.1)
    ref_site.run(80, dt=0.1)
    _same_run(port_site, ref_site)
    assert ref_site.first_converged_tick is not None


@pytest.mark.parametrize("kind", SENSOR_KINDS)
def test_site_sensor_storm_is_identical(kind):
    fb = _v100_fallbacks()

    def storm():
        return FaultPlan(events=[FaultEvent(kind, batch_id=k, worker=0)
                                 for k in range(10, 14)])
    port_plan, ref_plan = storm(), storm()
    port_site = _site(port_power, TESLA_V100, fb, fault_plan=port_plan)
    ref_site = _site(ref_power, REF_V100, fb, fault_plan=ref_plan)
    port_site.run(30, dt=0.1)
    ref_site.run(30, dt=0.1)
    _same_run(port_site, ref_site)
    assert port_plan.fired_count(kind) == ref_plan.fired_count(kind)


@pytest.mark.parametrize("kind", SENSOR_KINDS)
def test_site_sensor_storm_from_the_ports_plan_is_identical(kind):
    fb = _v100_fallbacks()
    port_plan = port_faults.FaultPlan(events=[
        port_faults.FaultEvent(kind, batch_id=k, worker=0)
        for k in range(10, 14)])
    ref_plan = FaultPlan(events=[FaultEvent(kind, batch_id=k, worker=0)
                                 for k in range(10, 14)])
    port_site = _site(port_power, TESLA_V100, fb, fault_plan=port_plan)
    ref_site = _site(ref_power, REF_V100, fb, fault_plan=ref_plan)
    port_site.run(30, dt=0.1)
    ref_site.run(30, dt=0.1)
    _same_run(port_site, ref_site)
    assert port_plan.fired_count(kind) == ref_plan.fired_count(kind) > 0


def test_site_emergency_is_identical():
    fb = _v100_fallbacks()
    sites = (_site(port_power, TESLA_V100, fb), _site(ref_power, REF_V100, fb))
    for site in sites:
        site.run(20, dt=0.1)
        site.site_cap_w, site.hard_cap_w = 500.0, 560.0
        site.run(20, dt=0.1)
    _same_run(*sites)
    assert sites[1].emergencies >= 1


# ---------------------------------------------------------------------------
# behaviour on H100_SXM (the checks of tests/test_power.py)
# ---------------------------------------------------------------------------

DEV = H100_SXM
#: The sweep optimum of n = 4096 on the H100 model, a grid clock.
FALLBACK = float(sweep(fft_workload(FFTCase(n=4096), DEV), DEV).optimal.f)
#: The reference benchmark's site: 1400 W cap, 1500 W hard cap over
#: 8 x 220 W; the same shares of 8 x 700 W.
SHARE = 8 * DEV.tdp / (8 * 220.0)
SITE_CAP, HARD_CAP = 1400.0 * SHARE, 1500.0 * SHARE
#: GovernorConfig's defaults scaled from ~200 W to 700 W parts.
SCALE = DEV.tdp / 220.0
SCALED = GovernorConfig(kp_mhz_per_w=4.0 / SCALE, ki_mhz_per_w=1.0 / SCALE,
                        hysteresis_w=1.5 * SCALE,
                        integral_clamp_w=50.0 * SCALE)


def reading(p, t=0.0, dev=0):
    return PowerReading(device_index=dev, t=t, power_w=p)


class TestSampler:
    def test_same_seed_reproduces_every_reading(self):
        a = SimulatedPowerSampler(DEV, seed=7, drift_w=3.0)
        b = SimulatedPowerSampler(DEV, seed=7, drift_w=3.0)
        for k in range(10):
            assert a.sample(0, 0.1 * k) == b.sample(0, 0.1 * k)

    def test_device_streams_are_interleaving_independent(self):
        a = SimulatedPowerSampler(DEV, seed=3)
        b = SimulatedPowerSampler(DEV, seed=3)
        seq_a = [a.sample(0, 0.1 * k) for k in range(5)]
        b.sample(1, 0.0)
        seq_b = [b.sample(0, 0.1 * k) for k in range(5)]
        assert seq_a == seq_b

    def test_noise_bounded_by_noise_frac(self):
        s = SimulatedPowerSampler(DEV, seed=1, noise_frac=0.02)
        truth = s.truth_w(0)
        for _ in range(50):
            assert abs(s.sample(0, 0.0).power_w - truth) <= 0.02 * truth + 1e-9

    def test_fault_plan_corrupts_readings(self):
        plan = FaultPlan(events=[FaultEvent(SENSOR_DROPOUT, batch_id=0),
                                 FaultEvent(SENSOR_SPIKE, batch_id=1),
                                 FaultEvent(SENSOR_STALE, batch_id=3)])
        s = SimulatedPowerSampler(DEV, seed=1, fault_plan=plan)
        assert math.isnan(s.sample(0, 0.0, token=0).power_w)
        assert s.sample(0, 0.1, token=1).power_w == pytest.approx(
            2.0 * DEV.tdp)
        ok = s.sample(0, 0.2, token=2)
        assert s.sample(0, 0.3, token=3) == ok   # frozen value and stamp

    def test_any_plan_with_take_drives_the_faults(self):
        class Plan:
            def __init__(self):
                self.calls = []

            def take(self, kind, *, batch_id=None, worker=None):
                self.calls.append((kind, batch_id, worker))
                return kind == SENSOR_DROPOUT and batch_id == 2

        plan = Plan()
        s = SimulatedPowerSampler(DEV, seed=1, fault_plan=plan)
        assert s.sample(1, 0.0, token=1).ok
        assert math.isnan(s.sample(1, 0.1, token=2).power_w)
        # Stale is asked for only once there is a reading to replay.
        assert plan.calls == [(SENSOR_DROPOUT, 1, 1), (SENSOR_SPIKE, 1, 1),
                              (SENSOR_DROPOUT, 2, 1)]

    def test_stale_needs_a_previous_reading(self):
        plan = FaultPlan(events=[FaultEvent(SENSOR_STALE, batch_id=0)])
        s = SimulatedPowerSampler(DEV, seed=1, fault_plan=plan)
        assert s.sample(0, 0.0, token=0).ok and plan.pending() == 1

    def test_ring_is_bounded_and_counts_drops(self):
        ring = TelemetryRing(capacity=4)
        for k in range(10):
            ring.push(reading(100.0 + k, t=0.1 * k))
        assert len(ring) == 4 and ring.pushed == 10 and ring.dropped == 6
        assert ring.latest().power_w == 109.0
        assert [r.power_w for r in ring.window(2)] == [108.0, 109.0]
        ring.clear()
        assert len(ring) == 0 and ring.dropped == 10
        with pytest.raises(ValueError):
            TelemetryRing(capacity=0)


class TestWatchdog:
    def test_stale_timeout_boundary_is_exclusive(self):
        dog = TelemetryWatchdog(DEV, stale_timeout_s=0.05)
        assert dog.classify(reading(450.0, t=0.0), now=0.05) == FRESH
        assert dog.classify(reading(450.0, t=0.0), now=0.0500001) == STALE

    def test_dropout_and_envelope_spike(self):
        dog = TelemetryWatchdog(DEV, envelope_frac=1.25)
        assert dog.classify(reading(float("nan")), now=0.0) == DROPOUT
        assert dog.classify(reading(-1.0), now=0.0) == SPIKE
        assert dog.classify(reading(1.25 * DEV.tdp + 1.0), now=0.0) == SPIKE

    def test_single_sample_spike_vs_sustained_step(self):
        glitch = TelemetryWatchdog(DEV, step_w=150.0)
        labels = [glitch.observe(reading(p, t=0.1 * k), now=0.1 * k)[0]
                  for k, p in enumerate([450.0, 451.0, 690.0, 450.0, 451.0])]
        assert labels == [FRESH, FRESH, SPIKE, SPIKE, FRESH]
        step = TelemetryWatchdog(DEV, step_w=150.0)
        labels = [step.observe(reading(p, t=0.1 * k), now=0.1 * k)[0]
                  for k, p in enumerate([450.0, 451.0, 690.0, 691.0, 690.0])]
        assert labels == [FRESH, FRESH, SPIKE, FRESH, FRESH]

    def test_dropout_recovery_rearm(self):
        dog = TelemetryWatchdog(DEV, unhealthy_after=3, rearm_after=2)
        for k in range(3):
            dog.observe(reading(float("nan"), t=0.1 * k), now=0.1 * k)
        assert dog.health == UNHEALTHY and dog.unhealthy_entries == 1
        dog.observe(reading(450.0, t=0.3), now=0.3)
        assert dog.health == UNHEALTHY
        dog.observe(reading(450.5, t=0.4), now=0.4)
        assert dog.health == HEALTHY and dog.healthy

    def test_suspect_after_one_bad_counts_as_usable(self):
        dog = TelemetryWatchdog(DEV)
        dog.observe(reading(float("nan")), now=0.0)
        assert dog.health == SUSPECT and dog.healthy

    def test_default_step_is_half_the_tdp(self):
        assert TelemetryWatchdog(DEV).step_w == 0.5 * DEV.tdp
        with pytest.raises(ValueError):
            TelemetryWatchdog(DEV, unhealthy_after=0)


def governor(**kw):
    kw.setdefault("target_w", 450.0)
    kw.setdefault("fallback_mhz", FALLBACK)
    return PowerGovernor(DEV, **kw)


class TestGovernor:
    def test_starts_at_fallback_and_validates_it(self):
        assert governor().f_mhz == FALLBACK
        with pytest.raises(ValueError):
            governor(fallback_mhz=DEV.f_max + 100.0)

    def test_hysteresis_dead_band_holds(self):
        gov = governor(config=GovernorConfig(hysteresis_w=2.0))
        f0 = gov.f_mhz
        assert gov.step(449.0) == f0 and gov.mode == "hold"
        assert gov.integral_w == 0.0

    def test_slew_rate_limit_bounds_every_move(self):
        gov = governor(config=SCALED)
        prev = gov.f_mhz
        for measured in [150.0, 120.0, 690.0, 90.0, 450.0, 270.0]:
            f = gov.step(measured)
            assert abs(f - prev) <= SCALED.slew_mhz_per_tick + 1e-9
            prev = f

    def test_missing_sample_holds_without_windup(self):
        gov = governor()
        gov.step(300.0)
        integral, f = gov.integral_w, gov.f_mhz
        assert gov.step(None) == f and gov.mode == "hold"
        assert gov.step(float("nan")) == f
        assert gov.integral_w == integral

    def test_unhealthy_pins_bit_exact_fallback_and_resets(self):
        gov = governor()
        for _ in range(5):
            gov.step(180.0)
        assert gov.f_mhz != FALLBACK and gov.integral_w != 0.0
        assert gov.step(180.0, healthy=False) == FALLBACK
        assert gov.integral_w == 0.0 and gov.in_fallback
        assert gov.fallback_engagements == 1
        gov.step(None, healthy=False)
        assert gov.fallback_engagements == 1

    @settings(max_examples=50, deadline=None)
    @given(st.lists(st.one_of(
        st.none(),
        st.floats(min_value=-1e3, max_value=1e4,
                  allow_nan=False, allow_infinity=False)),
        min_size=1, max_size=40),
        st.booleans())
    def test_output_always_within_clock_bounds(self, measured, flip):
        gov = governor(config=SCALED)
        for k, m in enumerate(measured):
            f = gov.step(m, healthy=not (flip and k % 3 == 0))
            assert DEV.f_min <= f <= DEV.f_max

    @settings(max_examples=50, deadline=None)
    @given(st.floats(min_value=0.0, max_value=1400.0, allow_nan=False),
           st.floats(min_value=0.0, max_value=1400.0, allow_nan=False))
    def test_single_step_monotone_in_power_error(self, m_low, m_high):
        lo, hi = min(m_low, m_high), max(m_low, m_high)
        assert governor(config=SCALED).step(lo) >= governor(
            config=SCALED).step(hi)


class TestFleetTelemetry:
    def test_fresh_read_exposes_measured_w(self):
        tel = FleetTelemetry(DEV, SimulatedPowerSampler(DEV, seed=2))
        tr = tel.read(0, 0.0)
        assert tr.fresh and tr.measured_w == tr.reading.power_w
        assert tel.healthy(0) and tel.healthy(5)

    def test_non_fresh_read_withholds_measured_w(self):
        plan = FaultPlan(events=[FaultEvent(SENSOR_DROPOUT, batch_id=0)])
        tel = FleetTelemetry(
            DEV, SimulatedPowerSampler(DEV, seed=2, fault_plan=plan))
        tr = tel.read(0, 0.0, token=0)
        assert tr.label == DROPOUT and tr.measured_w is None

    def test_summary_aggregates_per_device_watchdogs(self):
        tel = FleetTelemetry(DEV, SimulatedPowerSampler(DEV, seed=2))
        tel.read(0, 0.0)
        tel.read(1, 0.0)
        s = tel.summary()
        assert s["reads"] == 2 and s["labels"][FRESH] == 2
        assert s["health"] == {0: HEALTHY, 1: HEALTHY}


def make_site(seed=0, fault_plan=None, cap=SITE_CAP, hard=HARD_CAP, n=8):
    pipes = [SitePipeline(name=f"p{i}", device_index=i,
                          priority=(i % 4) + 1, fallback_mhz=FALLBACK,
                          u_core=0.9, u_mem=0.8)
             for i in range(n)]
    return SiteBudgetScheduler(DEV, pipes, site_cap_w=cap, hard_cap_w=hard,
                               seed=seed, fault_plan=fault_plan,
                               governor_config=SCALED)


class TestSite:
    def test_cap_never_exceeded_and_converges(self):
        site = make_site()
        ticks = site.run(60, dt=0.1)
        assert max(t.truth_w for t in ticks) <= site.site_cap_w
        assert site.first_converged_tick is not None
        assert site.first_converged_tick <= 40

    def test_digest_reproducible_across_fresh_runs(self):
        a, b = make_site(seed=5), make_site(seed=5)
        a.run(40, dt=0.1)
        b.run(40, dt=0.1)
        assert a.digest() == b.digest()

    @pytest.mark.parametrize("kind", SENSOR_KINDS)
    def test_each_sensor_fault_gives_the_exact_fallback_clock(self, kind):
        plan = FaultPlan(events=[FaultEvent(kind, batch_id=k, worker=0)
                                 for k in range(10, 14)])
        site = make_site(fault_plan=plan)
        ticks = site.run(30, dt=0.1)
        fb = [k for k, t in enumerate(ticks) if t.modes[0] == "fallback"]
        assert fb, f"governor never fell back under the {kind} storm"
        assert all(ticks[k].clocks_mhz[0] == FALLBACK for k in fb)
        assert site.governors["p0"].fallback_engagements >= 1
        assert max(t.truth_w for t in ticks) <= site.site_cap_w
        assert ticks[-1].health[0] == HEALTHY

    def test_shed_order_is_lowest_priority_first(self):
        # A cap whose budget (headroom * cap) cannot hold all eight
        # f_min floors must shed priority-1 names first.
        floors = 8 * PowerModel(DEV).power(DEV.f_min, u_core=0.9, u_mem=0.8)
        site = make_site(cap=floors, hard=floors + 50.0 * SCALE)
        assert site.shed, "tight cap must shed"
        survivors = {p.priority for p in site.active}
        victims = {p.priority for p in site.shed}
        assert max(victims) <= min(survivors)

    def test_emergency_rung_floors_sheds_and_restores(self):
        site = make_site()
        site.run(20, dt=0.1)
        pre = len(site.active)
        site.site_cap_w, site.hard_cap_w = 850.0 * SHARE, 900.0 * SHARE
        ticks = site.run(20, dt=0.1)[20:]
        assert site.emergencies >= 1 and len(site.active) < pre
        emergency_tick = next(t for t in ticks if t.emergency)
        floored = [f for p, f in zip(site.pipelines, emergency_tick.clocks_mhz)
                   if p.name in set(emergency_tick.active)]
        assert all(f == DEV.f_min for f in floored)
        assert ticks[-1].truth_w <= site.hard_cap_w

    def test_distinct_devices_required(self):
        pipes = [SitePipeline(name="a", device_index=0, priority=1,
                              fallback_mhz=FALLBACK),
                 SitePipeline(name="b", device_index=0, priority=2,
                              fallback_mhz=FALLBACK)]
        with pytest.raises(ValueError):
            SiteBudgetScheduler(DEV, pipes, site_cap_w=SITE_CAP)
