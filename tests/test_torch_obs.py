"""The port's observability leaf modules and arrival processes held against
the reference: ``obs.trace`` (spans on a fake clock; JSONL, digest and
Chrome trace byte for byte; the flight recorder through
``notify_fault``), ``obs.metrics`` (histogram quantiles and the
Prometheus text), ``obs.drift`` (EWMA states, alerts, summary),
``obs.log`` (silence under pytest, levels, lines) and ``data.arrivals``
(identical arrays and drain waves for a seed); and the port's own span
entry point (``obs.trace.span``: the shared no-op, an active tracer's
device time and builds, the bounded profiler session)."""
import collections
import io
import json
import time

import numpy as np
import pytest
import torch
from torch.autograd.profiler import profile

import repro.data.arrivals as ref_arrivals
import repro.obs as ref_obs
import repro_torch.data as port_data
import repro_torch.obs as port_obs
from repro_torch.data import arrivals as port_arrivals
from repro_torch.obs import trace as port_trace


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.00125
        return t[0]
    return clock


def _trace(obs):
    """One nested trace on a fake clock: two workers, inherited and
    overridden attributes, a tuple attribute, a span closed by an
    exception."""
    tracer = obs.Tracer(timer=_fake_clock(), recorder_capacity=3)
    for worker in (0, 1):
        with tracer.span("batch", kind="fft", shape=(4, 1024), worker=worker,
                         clock_mhz=1380.0):
            with tracer.span("plan", rung=0):
                pass
            with tracer.span("execute", kind="r2c"):
                with tracer.span("kernel", name_hint="fft_c2c"):
                    pass
    try:
        with tracer.span("drain", worker=1):
            raise KeyError("lost")
    except KeyError:
        pass
    return tracer


def test_trace_exports_are_the_references():
    port, ref = _trace(port_obs), _trace(ref_obs)
    assert port_obs.to_jsonl(port.spans) == ref_obs.to_jsonl(ref.spans)
    assert port_obs.digest(port.spans) == ref_obs.digest(ref.spans)
    assert json.dumps(port_obs.to_chrome_trace(port.spans)) == \
        json.dumps(ref_obs.to_chrome_trace(ref.spans))
    assert [s.to_dict() for s in port.flight.ring(1)] == \
        [s.to_dict() for s in ref.flight.ring(1)]
    assert len(port.flight.ring(1)) == 3          # the ring's capacity
    assert port.spans[1].attrs["shape"] == (4, 1024)
    assert port.spans[2].attrs["kind"] == "r2c"   # own keys win


@pytest.mark.parametrize("error", [RuntimeError("device 1 lost"),
                                   ValueError(""), KeyError("k")])
def test_notify_fault_snapshots_every_live_tracer(error):
    snaps = []
    for obs in (port_obs, ref_obs):
        tracer = _trace(obs)
        with tracer.span("open", worker=0):
            with tracer.span("inner"):
                obs.notify_fault(error)
        assert len(tracer.flight.snapshots) == 1
        snap = tracer.flight.snapshots[0]
        snaps.append((snap.error_type, snap.message,
                      {d: [s.to_dict() for s in ring]
                       for d, ring in snap.spans.items()},
                      [s.name for s in snap.open_spans]))
    assert snaps[0] == snaps[1]
    assert snaps[0][0] == type(error).__name__
    assert snaps[0][3] == ["open", "inner"]


def test_span_off_is_one_shared_no_op():
    """With no active tracer and no profiler, the program's span is one
    shared object and records nothing."""
    session = port_trace.profiler_spans()
    x = torch.zeros(2, 4)
    first = port_trace.span("fft.plan", x, kind="c2c", n=4, rows=2)
    assert port_trace.span("r2c.split") is first
    assert not port_trace.tracing()
    with first:
        port_trace.count_build("plan")
    assert port_trace.profiler_spans() is session


def test_active_tracer_records_device_time_and_builds():
    tracer = port_obs.Tracer(timer=_fake_clock())
    assert port_obs.Tracer().timer is time.time   # the profiler's clock
    with tracer.active():
        assert port_trace.tracing()
        with port_trace.span("fft.plan", torch.zeros(2, 4), kind="c2c"):
            with port_trace.span("kernel.fft-c2c", n=4):
                pass
            port_trace.count_build("plan")
    assert not port_trace.tracing()
    kernel, plan = tracer.spans
    assert (kernel.parent, plan.parent) == ("fft.plan", None)
    assert kernel.attrs == {"device": "cpu", "kind": "c2c", "n": 4}
    assert kernel.device_s == kernel.duration == pytest.approx(0.00125)
    assert tracer.builds == {"plan": 1}
    assert "device_s" not in kernel.to_dict()     # exports unchanged


def test_device_time_is_sampled_by_root_kind(monkeypatch):
    """A tree times the device once in DEVICE_PERIOD_S for each (name,
    kind, n) of its root; its events go back to the pool once read."""
    class Event:
        def elapsed_time(self, end):
            return 2.0                                  # ms

    pool = collections.defaultdict(list)
    monkeypatch.setattr(port_trace, "_EVENT_POOL", pool)
    monkeypatch.setattr(port_trace, "_start_events",
                        lambda device: [device, Event(), Event()])
    monkeypatch.setattr(port_trace, "_end_events", lambda events: None)
    now = [0.0]
    tracer = port_obs.Tracer(timer=lambda: now[0])
    period = port_trace.DEVICE_PERIOD_S
    with tracer.active():
        for t, kind in ((0.0, "r2c"), (0.1, "r2c"), (0.1, "c2r"),
                        (period, "r2c")):
            now[0] = t
            with port_trace.span("fft.plan", kind=kind, n=8,
                                 device="cuda:0"):
                with port_trace.span("r2c.split"):
                    pass
    assert [(s.attrs["kind"], s.device_s) for s in tracer.spans] == \
        [("r2c", 0.002)] * 2 + [("r2c", None)] * 2 + \
        [("c2r", 0.002)] * 2 + [("r2c", 0.002)] * 2
    assert len(pool["cuda:0"]) == 12


def test_bounded_tracer_drops_the_oldest_spans(monkeypatch):
    """A profiler session keeps its last SESSION_SPANS spans and counts
    the ones it dropped."""
    assert port_trace.SESSION_SPANS == 2**16
    monkeypatch.setattr(port_trace, "SESSION_SPANS", 3)
    with profile(use_kineto=True):
        for i in range(5):
            with port_trace.span(f"s{i}"):
                pass
    session = port_trace.profiler_spans()
    assert [s.name for s in session.spans] == ["s2", "s3", "s4"]
    assert session.dropped == 2


def _registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("repro_requests_total", "requests served").inc(7)
    reg.counter("repro_requests_total").inc()
    reg.gauge("repro_clock_mhz", "locked clock").set(1380)
    reg.gauge("repro_margin").set(0.125)
    hist = reg.histogram("repro_latency_seconds", "request latency")
    for v in (5e-5, 2e-4, 0.003, 0.003, 0.07, 0.4, 2.0, 100.0):
        hist.observe(v)
    small = reg.histogram("repro_small", buckets=(1, 2, 4))
    for v in (0.5, 1, 1.5, 3, 3, 3):
        small.observe(v)
    return reg


def test_metrics_render_and_quantiles_are_the_references():
    port, ref = _registry(port_obs), _registry(ref_obs)
    assert port.render() == ref.render()
    assert port_obs.MetricsRegistry().render() == ""
    for name in ("repro_latency_seconds", "repro_small"):
        ph, rh = port.histogram(name), ref.histogram(name)
        assert ph.counts == rh.counts and ph.n == rh.n
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert ph.quantile(q) == rh.quantile(q)
    assert port_obs.Histogram("h").quantile(0.5) == 0.0
    assert "repro_margin" in port and "nope" not in port


@pytest.mark.parametrize("make", [
    lambda obs: obs.Counter("c").inc(-1),
    lambda obs: obs.Histogram("h", buckets=(2, 1)),
    lambda obs: obs.Histogram("h", buckets=()),
    lambda obs: (lambda r: (r.counter("m"), r.gauge("m")))(
        obs.MetricsRegistry()),
])
def test_metrics_refuse_what_the_reference_refuses(make):
    with pytest.raises(Exception) as ref_err:
        make(ref_obs)
    with pytest.raises(type(ref_err.value)) as port_err:
        make(port_obs)
    assert str(port_err.value) == str(ref_err.value)


def _drift(obs):
    det = obs.DriftDetector(alpha=0.3, threshold=0.15, min_samples=3)
    rng = np.random.default_rng(4)
    for i in range(40):
        key = ("fft", (1024,), 1380.0 if i % 2 else 1530.0)
        modelled = 1e-6 * (1 + i % 5)
        bias = 1.3 if key[2] == 1380.0 else 1.0
        noise = 1 + 0.05 * rng.standard_normal()
        det.observe(key, modelled=modelled, measured=modelled * bias * noise)
    det.observe(("idle", (), 0.0), modelled=0.0, measured=0.0)
    det.observe(("pulsar", (8, 512), 1200.0), modelled=2.0, measured=1.0)
    return det


def test_drift_states_are_the_references():
    port, ref = _drift(port_obs), _drift(ref_obs)
    assert {k: vars(s) for k, s in port.states.items()} == \
        {k: vars(s) for k, s in ref.states.items()}
    assert port.alerts == ref.alerts and port.drift_alerts >= 1
    assert port.summary() == ref.summary()
    port_reg, ref_reg = port_obs.MetricsRegistry(), ref_obs.MetricsRegistry()
    port.fill_metrics(port_reg)
    ref.fill_metrics(ref_reg)
    assert port_reg.render() == ref_reg.render()
    with pytest.raises(ValueError, match="alpha"):
        port_obs.DriftDetector(alpha=0.0)


def _log_lines(obs, monkeypatch, level):
    stream = io.StringIO()
    if level is None:
        monkeypatch.delenv("REPRO_LOG_LEVEL", raising=False)
    else:
        monkeypatch.setenv("REPRO_LOG_LEVEL", level)
    lg = obs.StructuredLogger("tune", stream=stream)
    lg.debug("candidate", n=1024, tile=2)
    lg.info("chosen", config="tile 2", speedup=1.0312, empty="")
    lg.warning("slow", ms=1.5)
    lg.error("failed", kind="c2r")
    return stream.getvalue()


@pytest.mark.parametrize("level", [None, "debug", "info", "warning",
                                   "error", "off", "bogus"])
def test_logger_levels_and_silence_are_the_references(monkeypatch, level):
    port = _log_lines(port_obs, monkeypatch, level)
    ref = _log_lines(ref_obs, monkeypatch, level)
    assert port == ref
    if level in (None, "off"):
        assert port == ""                 # silenced under pytest / off
    if level == "debug":
        assert port.splitlines()[1] == \
            "INFO    tune: chosen config='tile 2' speedup=1.0312 empty=''"


def test_get_logger_caches_and_checks_levels():
    assert port_obs.get_logger("x") is port_obs.get_logger("x")
    with pytest.raises(ValueError, match="unknown log level"):
        port_obs.get_logger("x").log("loud", "e")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("process,kw", [
    ("poisson", {}), ("gamma", {}), ("gamma", dict(gamma_shape=2.0)),
    ("poisson", dict(rate_hz=50.0))])
def test_arrivals_are_the_references(seed, process, kw):
    port = port_data.arrival_times(257, seed=seed, process=process, **kw)
    ref = ref_arrivals.arrival_times(257, seed=seed, process=process, **kw)
    np.testing.assert_array_equal(port, ref)
    for period in (1e-3, 0.01, 1.0):
        waves = list(port_arrivals.wave_slices(port, period))
        assert waves == list(ref_arrivals.wave_slices(ref, period))
        assert waves[0][0] == 0 and waves[-1][1] == len(port)
        assert all(a < b for a, b in waves)


@pytest.mark.parametrize("call", [
    lambda m: m.arrival_times(-1, seed=0),
    lambda m: m.arrival_times(3, seed=0, rate_hz=0.0),
    lambda m: m.arrival_times(3, seed=0, process="uniform"),
    lambda m: m.arrival_times(3, seed=0, process="gamma", gamma_shape=0.0),
    lambda m: list(m.wave_slices(np.zeros(3), 0.0)),
])
def test_arrivals_refuse_what_the_reference_refuses(call):
    with pytest.raises(ValueError) as ref_err:
        call(ref_arrivals)
    with pytest.raises(ValueError) as port_err:
        call(port_arrivals)
    assert str(port_err.value) == str(ref_err.value)


def test_exports_are_the_references():
    assert set(port_obs.__all__) == set(ref_obs.__all__)
    import repro.data as ref_data
    assert {"arrival_times", "wave_slices"} <= set(port_data.__all__)
    assert {"arrival_times", "wave_slices"} <= set(ref_data.__all__)
