"""The port's autotuner (``repro_torch.tune``) held against the reference
``repro.tune``: the JSON form of configs, keys and cache files (one
package saves, the other loads), the cost model's candidate scores,
pruning order, segment and common-config choices; the tuner on the CPU
with a fake clock (determinism, never-regress, zero-measurement replay);
the tile axis from ``fft_kernel.pass_launch``; plan routing (one consult a
key, tuned tiles, radices and splits reaching the kernel entry points,
Bluestein, the disable switch, the tuned overlap-save segment) and the
serving cache's keys (a re-tune rebuilds; FDAS entries key on the conv
segment, pulsar entries on the (R2C, conv) pair)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.tune as ref_tune
import repro.tune.tuner as ref_tuner
from repro.core.hardware import TESLA_V100 as REF_V100
from repro.fft.plan import _four_step_split as ref_four_step_split
from repro.serving.cache import PlanSweepCache as RefCache
from repro.serving.request import ShapeKey as RefKey
from repro_torch.core.hardware import H100_SXM, TESLA_V100
from repro_torch.fft import convolve as port_convolve
from repro_torch.fft import plan as port_plan
from repro_torch.fft.plan_nd import plan_nd
from repro_torch.kernels.fft import fft_kernel
from repro_torch.search.templates import TemplateBank
from repro_torch.serving import ShapeKey
from repro_torch.serving.cache import PlanSweepCache
from repro_torch.tune import (CACHE_VERSION, HEURISTIC, ConfigKey,
                              KernelConfig, TuneRecord, TuningCache,
                              TuningContext, cache_path, common_config,
                              default_device_name, generate_candidates,
                              plan_config, prune_candidates, time_fn,
                              tune_length, tune_segment, use_tuning)
from repro_torch.tune import tuner as port_tuner

CPU = torch.device("cpu")

CONFIGS = [
    dict(),
    dict(tile_b=16, radices=(8, 4, 2), split=(64, 128), segment=1024,
         source="tuned"),
    dict(radices=(2,), source="common"),
    dict(split=(32, 512), source="tuned"),
    dict(segment=2048, source="tuned"),
]


def _tuned_cache(device="testdev", entries=()):
    cache = TuningCache(device=device)
    for shape, kind, cfg in entries:
        cache.put(ConfigKey(device, shape, kind), TuneRecord(config=cfg))
    return cache


def _ref_config(cfg: KernelConfig) -> ref_tune.KernelConfig:
    return ref_tune.KernelConfig.from_dict(cfg.to_dict())


class _FakeClock:
    """Deterministic pseudo-random clock: same call sequence, same times."""

    def __init__(self):
        self.t = 0.0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        self.t += 1e-4 * ((self.calls * 7919) % 13 + 1)
        return self.t


# ---------------------------------------------------------------------------
# Config, key and cache file: the reference's JSON form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", CONFIGS)
def test_config_json_is_the_references(kw):
    port, ref = KernelConfig(**kw), ref_tune.KernelConfig(**kw)
    assert port.to_dict() == ref.to_dict()
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    assert KernelConfig.from_dict(ref.to_dict()) == port
    assert port.is_heuristic == ref.is_heuristic


@pytest.mark.parametrize("key", [
    ("NVIDIA-H100-80GB-HBM3", (1024,), "c2c", "fp32"),
    ("cpu", (2**21 + 1, 100, 85), "conv", "fp32"),
    ("dev", (64, 64), "r2c", "fp16"),
])
def test_key_token_is_the_references(key):
    port, ref = ConfigKey(*key), ref_tune.ConfigKey(*key)
    assert port.token() == ref.token()
    assert ConfigKey.from_token(ref.token()) == port


def _records():
    return [
        ((256,), "c2c", TuneRecord(
            config=KernelConfig(tile_b=2, source="tuned"),
            objective="energy", score=1.5, heuristic_score=2.0,
            measured_s=0.5, heuristic_s=0.7, candidates=12, measured=5)),
        ((512,), "r2c", TuneRecord(config=KernelConfig(radices=(2,),
                                                       source="tuned"))),
        ((2**20,), "c2c", TuneRecord(config=KernelConfig(
            split=(512, 2048), radices=(8, 4, 2), source="tuned"))),
        ((4097, 100, 85), "conv", TuneRecord(
            config=KernelConfig(segment=2048, source="tuned"),
            heuristic=KernelConfig(segment=0))),
    ]


def test_cache_file_moves_between_the_packages(tmp_path):
    port = TuningCache(device="testdev")
    ref = ref_tune.TuningCache(device="testdev")
    for shape, kind, rec in _records():
        port.put(ConfigKey("testdev", shape, kind), rec)
        ref.put(ref_tune.ConfigKey("testdev", shape, kind),
                ref_tune.TuneRecord.from_dict(rec.to_dict()))
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    from_port = ref_tune.TuningCache.load("testdev",
                                          path=str(tmp_path / "port.json"))
    from_ref = TuningCache.load("testdev", path=str(tmp_path / "ref.json"))
    assert len(from_port) == len(from_ref) == len(_records())
    for shape, kind, rec in _records():
        got = from_ref.get(ConfigKey("testdev", shape, kind))
        assert got == rec
        assert from_port.get(ref_tune.ConfigKey(
            "testdev", shape, kind)).to_dict() == rec.to_dict()
    rec = from_ref.get(ConfigKey("testdev", (256,), "c2c"))
    assert rec.speedup_vs_heuristic == pytest.approx(1.4)


@pytest.mark.parametrize("content", [
    "{ not json !!",
    json.dumps({"version": CACHE_VERSION + 1, "entries": {
        "testdev|256|c2c|fp32": {"config": {"tile_b": 4}}}}),
    json.dumps({"version": CACHE_VERSION,
                "entries": {"testdev|256|c2c|fp32": 42}}),
    json.dumps([1, 2, 3]),
])
def test_unreadable_cache_falls_back_empty(tmp_path, content):
    path = tmp_path / "dev.json"
    path.write_text(content)
    port = TuningCache.load("testdev", path=str(path))
    ref = ref_tune.TuningCache.load("testdev", path=str(path))
    assert len(port) == len(ref) == 0
    with use_tuning(TuningContext(port)):
        plan = port_plan.plan_for_length(256)
    assert plan is port_plan.plan_with_config(256)


def test_missing_cache_file_is_empty(tmp_path):
    assert len(TuningCache.load("testdev",
                                path=str(tmp_path / "nope.json"))) == 0


def test_cache_path_env_override_and_own_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "x.json"))
    assert cache_path("anydev") == str(tmp_path / "x.json")
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    assert cache_path("anydev").endswith(
        os.path.join(".cache", "repro-torch-tune", "anydev.json"))
    assert os.path.dirname(cache_path("anydev")) != \
        os.path.dirname(ref_tune.cache_path("anydev"))


def test_atomic_save_creates_dirs(tmp_path):
    path = str(tmp_path / "deep" / "nested" / "dev.json")
    assert _tuned_cache().save(path) == path
    assert json.load(open(path))["version"] == CACHE_VERSION
    assert [f for f in os.listdir(os.path.dirname(path))] == ["dev.json"]


def test_default_device_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_device_name() == "cpu"
    assert TuningCache().device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    assert default_device_name() == "NVIDIA-H100-80GB-HBM3"


# ---------------------------------------------------------------------------
# The cost model: the reference's scores, order and choices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2**k for k in range(1, 25)] + [100, 19321])
def test_split_candidates_are_the_references(n):
    assert port_tuner._split_candidates(n) == ref_tuner._split_candidates(n)
    assert port_plan._four_step_split(n) == ref_four_step_split(n)
    assert port_tuner.RADIX_CANDIDATES == ref_tuner.RADIX_CANDIDATES
    assert port_tuner.DEFAULT_MEASURE_BUDGET == \
        ref_tuner.DEFAULT_MEASURE_BUDGET


@pytest.mark.parametrize("kind", ["c2c", "r2c", "c2r"])
@pytest.mark.parametrize("n", [256, 1024, 8192, 2**20])
def test_model_candidate_scores_are_the_references(n, kind):
    for radices in (None,) + ref_tuner.RADIX_CANDIDATES[1:]:
        cfg = KernelConfig(radices=radices, source="tuned")
        port = port_tuner._model_candidate(cfg, n, kind, TESLA_V100)
        ref = ref_tuner._model_candidate(_ref_config(cfg), n, kind, REF_V100)
        for field in ("model_time", "model_j", "opt_power_w"):
            assert getattr(port, field) == pytest.approx(
                getattr(ref, field), rel=1e-12), (radices, field)


@pytest.mark.parametrize("objective", ["time", "energy"])
@pytest.mark.parametrize("n,kind", [(1024, "c2c"), (2**20, "c2c"),
                                    (1024, "r2c"), (16384, "c2r")])
def test_prune_keeps_the_references_order(n, kind, objective):
    configs = generate_candidates(n, kind, 64)
    port = prune_candidates(configs, n, kind, TESLA_V100, objective, 5)
    ref = ref_tuner.prune_candidates([_ref_config(c) for c in configs], n,
                                     kind, REF_V100, objective, 5)
    assert [c.config.to_dict() for c in port] == \
        [c.config.to_dict() for c in ref]
    assert port[0].config is HEURISTIC and len(port) <= 5


@pytest.mark.parametrize("n,taps,templates", [
    (4096, 64, 8), (2**21 + 1, 100, 85), (2**15, 5000, 2), (1000, 9, 1)])
def test_tune_segment_is_the_references(n, taps, templates):
    port = tune_segment(n, taps, templates, cache=TuningCache("seg"),
                        save=False)
    ref = ref_tune.tune_segment(n, taps, templates,
                                cache=ref_tune.TuningCache("seg"),
                                save=False)
    assert port.config.to_dict() == ref.config.to_dict()
    assert port.record.score == pytest.approx(ref.record.score, rel=1e-12)
    assert port.record.heuristic_score == pytest.approx(
        ref.record.heuristic_score, rel=1e-12)
    assert port.record.candidates == ref.record.candidates
    assert port.key.token() == ref.key.token()


@pytest.mark.parametrize("entries", [
    [((256,), "c2c", HEURISTIC), ((512,), "c2c", HEURISTIC)],
    [((2**14,), "c2c", KernelConfig(tile_b=16, radices=(8, 4, 2),
                                    split=(32, 512), source="tuned"))],
    [((1024,), "c2c", KernelConfig(tile_b=2, radices=(8, 4, 2),
                                   source="tuned")),
     ((8192,), "c2c", KernelConfig(radices=(2,), source="tuned")),
     ((16384,), "r2c", HEURISTIC),
     ((2**20,), "c2c", KernelConfig(split=(512, 2048), source="tuned")),
     ((4097, 100, 85), "conv", KernelConfig(segment=2048, source="tuned"))],
])
def test_common_config_is_the_references(entries):
    port = _tuned_cache(entries=entries)
    ref = ref_tune.TuningCache(device="testdev")
    for shape, kind, cfg in entries:
        ref.put(ref_tune.ConfigKey("testdev", shape, kind),
                ref_tune.TuneRecord(config=_ref_config(cfg)))
    cfg, regret = common_config(port)
    ref_cfg, ref_regret = ref_tune.common_config(ref)
    assert cfg.to_dict() == ref_cfg.to_dict()
    assert regret == pytest.approx(ref_regret, rel=1e-12, abs=1e-15)
    assert cfg.split is None and cfg.segment == 0
    h100, h100_regret = common_config(port, model_device=H100_SXM)
    assert h100.split is None and h100_regret >= 0.0


def test_common_config_of_an_empty_cache_raises():
    with pytest.raises(ValueError, match="no tuned"):
        common_config(TuningCache("empty"))


# ---------------------------------------------------------------------------
# Candidates: the tile axis from pass_launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kind,batch", [
    (256, "c2c", 64), (1024, "c2c", 244140), (8192, "c2c", 30517),
    (2**15, "c2c", 8), (2**20, "c2c", 238), (1024, "r2c", 488281),
    (16384, "r2c", 30517), (16384, "c2r", 30517), (2**20, "r2c", 30),
    (100, "c2c", 8), (1024, "c2c", 3)])
def test_candidates_run_every_tile_and_clone_no_heuristic(n, kind, batch):
    configs = generate_candidates(n, kind, batch)
    assert configs[0] is HEURISTIC
    assert len(configs) == len(set(configs))
    assert not any(c.is_heuristic for c in configs[1:])
    seen = set()
    for cfg in configs:
        launches = port_tuner.plan_launches(n, kind, batch, cfg)
        for name, launch in launches:
            assert launch.threads <= fft_kernel.PASS_THREADS
            assert name in fft_kernel.LAUNCHES
        shape = tuple(launches)
        assert shape not in seen, cfg       # no two configs run the same
        seen.add(shape)
        if cfg.tile_b is not None:
            plain = port_tuner.plan_launches(
                n, kind, batch, dataclasses.replace(cfg, tile_b=None))
            assert [l.per_block for _, l in launches] != \
                [l.per_block for _, l in plain]


@pytest.mark.parametrize("n,kind,tiles", [
    (1024, "c2c", [None, 1, 2]), (8192, "c2c", [None]),
    (1024, "r2c", [None, 1, 2, 4]), (16384, "c2r", [None]),
    (2**20, "c2c", [None, 1, 2])])
def test_tile_candidates_follow_the_launch_limits(n, kind, tiles):
    batch = 1 << 16
    assert port_tuner._tile_candidates(n, kind, batch, None, None) == tiles
    heuristic = port_tuner.plan_launches(n, kind, batch)
    for t in tiles[1:]:
        for _, launch in port_tuner.plan_launches(
                n, kind, batch, KernelConfig(tile_b=t)):
            assert launch.per_block == t
            assert launch.resident_blocks >= heuristic[0][1].resident_blocks


def test_plan_launches_follow_the_plan(monkeypatch):
    """The launches plan_launches lists are the ones the plan makes."""
    calls = []
    for hook in ("_kernel_fft", "_kernel_fft_t", "_kernel_fft_axis1",
                 "_kernel_rfft", "_kernel_irfft"):
        orig = getattr(port_plan, hook)

        def spy(x, *a, _orig=orig, _hook=hook, **kw):
            calls.append((_hook, kw.get("tile_b"), kw.get("radices")))
            return _orig(x, *a, **kw)
        monkeypatch.setattr(port_plan, hook, spy)
    names = {"_kernel_fft": "fft_c2c", "_kernel_fft_t": "fft_c2c_t",
             "_kernel_fft_axis1": "fft_c2c_axis1", "_kernel_rfft": "fft_r2c",
             "_kernel_irfft": "fft_c2r"}
    cfg = KernelConfig(tile_b=2, radices=(8, 4, 2), split=(64, 256))
    for n, kind in [(2**14, "c2c"), (256, "c2c"), (45, "c2c"),
                    (512, "r2c"), (512, "c2r"), (2**15, "r2c")]:
        calls.clear()
        width = n // 2 + 1 if kind == "c2r" else n
        x = torch.zeros(3, width, dtype=torch.float32 if kind == "r2c"
                        else torch.complex64)
        port_plan.plan_with_config(n, kind, cfg)(x)
        want = port_tuner.plan_launches(n, kind, 3, cfg)
        assert [names[h] for h, _, _ in calls] == [k for k, _ in want]
        assert all(t == 2 and r == (8, 4, 2) for _, t, r in calls)


# ---------------------------------------------------------------------------
# The tuner on the CPU (explicit device, fake clock)
# ---------------------------------------------------------------------------

def test_tuner_is_deterministic_under_a_fake_clock():
    results = []
    for _ in range(2):
        res = tune_length(256, cache=TuningCache(device="det-test"),
                          objective="time", repeats=3, warmup=0,
                          timer=_FakeClock(), save=False, device=CPU)
        results.append(res)
    a, b = results
    assert a.config == b.config and a.record == b.record
    assert a.measurements == b.measurements > 0
    assert a.walls == b.walls and len(a.walls) == len(a.survivors)
    assert a.survivors[0] is HEURISTIC


def test_tuner_never_regresses_the_heuristic():
    class RiggedClock(_FakeClock):
        def __call__(self):
            self.calls += 1
            self.t += 1e-4 * self.calls     # each later call looks slower
            return self.t

    res = tune_length(128, cache=TuningCache(device="rig-test"),
                      objective="time", repeats=2, warmup=0,
                      timer=RiggedClock(), save=False, device=CPU)
    assert res.config == HEURISTIC
    assert res.speedup_vs_heuristic == 1.0


@pytest.mark.parametrize("objective", ["time", "energy"])
def test_replay_from_the_saved_cache_measures_nothing(tmp_path, objective):
    path = str(tmp_path / "dev.json")
    cache = TuningCache(device="replay-test")
    first = tune_length(256, cache=cache, objective=objective, repeats=2,
                        warmup=0, timer=_FakeClock(), save=False,
                        device=CPU)
    assert first.speedup_vs_heuristic >= 1.0
    cache.save(path)
    again = tune_length(256, cache=TuningCache.load("replay-test",
                                                    path=path))
    assert again.replayed and again.measurements == 0
    assert again.config == first.config


def test_tuner_refuses_unknown_objective_and_kind():
    with pytest.raises(ValueError, match="objective"):
        tune_length(64, objective="joules", cache=TuningCache("x"),
                    device=CPU)
    with pytest.raises(ValueError, match="kind"):
        tune_length(64, kind="dct", cache=TuningCache("x"), device=CPU)


def test_tuner_without_a_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tune_length(64, cache=TuningCache("x"), save=False)


@pytest.mark.parametrize("kind", ["c2c", "r2c", "c2r"])
def test_tuner_times_the_plans_it_chose_from(monkeypatch, kind):
    timed = []
    monkeypatch.setattr(port_tuner, "time_fn",
                        lambda fn, x, **kw: timed.append((fn, x)) or 1.0)
    res = tune_length(512, kind, cache=TuningCache("x"), save=False,
                      device=CPU, batch=5, objective="time")
    assert [fn for fn, _ in timed] == [
        port_plan.plan_with_config(512, kind, c).fn for c in res.survivors]
    x = timed[0][1]
    assert x.shape == (5, 257 if kind == "c2r" else 512)
    if kind == "c2r":
        assert not x[:, 0].imag.any() and not x[:, -1].imag.any()
    assert res.config == HEURISTIC     # equal times keep the heuristic


def test_time_fn_uses_the_timer_and_reduces():
    clock = iter([0.0, 2.0, 10.0, 11.0, 20.0, 23.0])
    calls = []
    got = time_fn(lambda v: calls.append(v), 7, repeats=3, warmup=2,
                  timer=lambda: next(clock))
    assert got == 1.0 and calls == [7] * 5
    assert time_fn(lambda: None, repeats=2, warmup=0) >= 0.0


# ---------------------------------------------------------------------------
# Plan routing
# ---------------------------------------------------------------------------

def test_plan_consults_cache_exactly_once_per_key():
    cache = _tuned_cache(entries=[
        ((256,), "c2c", KernelConfig(tile_b=2, source="tuned"))])
    ctx = TuningContext(cache)
    with use_tuning(ctx):
        for _ in range(7):
            port_plan.plan_for_length(256)
        assert ctx.consults == 1 and cache.lookups == 1
        port_plan.plan_for_length(256, "r2c")
        assert ctx.consults == 2
        port_plan.plan_for_length(512)
        assert ctx.consults == 3
        for _ in range(5):
            plan_nd((64, 64))
        assert ctx.consults == 4


@pytest.mark.parametrize("n,kind,cfg,hook,expect", [
    (256, "c2c", KernelConfig(tile_b=2, radices=(2,)), "_kernel_fft",
     {"tile_b": 2, "radices": (2,)}),
    (1024, "r2c", KernelConfig(tile_b=4), "_kernel_rfft", {"tile_b": 4}),
    (1024, "c2r", KernelConfig(radices=(8, 4, 2)), "_kernel_irfft",
     {"radices": (8, 4, 2)}),
    (2**14, "c2c", KernelConfig(tile_b=1, split=(32, 512)),
     "_kernel_fft_axis1", {"tile_b": 1}),
])
def test_tuned_config_reaches_the_kernel_call(monkeypatch, n, kind, cfg,
                                              hook, expect):
    calls = []
    orig = getattr(port_plan, hook)

    def spy(x, *a, **kw):
        calls.append((tuple(x.shape), kw))
        return orig(x, *a, **kw)
    monkeypatch.setattr(port_plan, hook, spy)
    cache = _tuned_cache(entries=[((n,), kind, dataclasses.replace(
        cfg, source="tuned"))])
    with use_tuning(TuningContext(cache)):
        plan = port_plan.plan_for_length(n, kind)
    rng = np.random.default_rng(n)
    if kind == "r2c":
        x = rng.standard_normal((3, n)).astype(np.float32)
        want = np.fft.rfft(x.astype(np.float64))
    elif kind == "c2r":
        want = rng.standard_normal((3, n))
        x = np.fft.rfft(want).astype(np.complex64)
    else:
        x = (rng.standard_normal((3, n))
             + 1j * rng.standard_normal((3, n))).astype(np.complex64)
        want = np.fft.fft(x.astype(np.complex128))
    got = plan(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert calls and all(kw[k] == v for _, kw in calls
                         for k, v in expect.items())
    if cfg.split:
        assert calls[0][0] == (3, 32, 512)


def test_bluestein_plan_threads_config_into_inner_ffts(monkeypatch):
    calls = []
    orig = port_plan._kernel_fft

    def spy(x, **kw):
        calls.append(kw)
        return orig(x, **kw)
    monkeypatch.setattr(port_plan, "_kernel_fft", spy)
    cfg = KernelConfig(radices=(2,), tile_b=4, source="tuned")
    plan = port_plan.plan_with_config(45, "c2c", cfg)
    assert plan.algorithm == "bluestein"
    rng = np.random.default_rng(45)
    x = (rng.standard_normal((3, 45))
         + 1j * rng.standard_normal((3, 45))).astype(np.complex64)
    got = plan(torch.from_numpy(x)).numpy()
    want = np.fft.fft(x.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert any(kw.get("radices") == (2,) and kw.get("tile_b") == 4
               for kw in calls)


def test_invalid_tuned_split_falls_back_to_balanced():
    n = 2**14
    plan = port_plan.plan_with_config(
        n, "c2c", KernelConfig(split=(3, n // 3), source="tuned"))
    assert plan.stages == port_plan.plan_with_config(n).stages
    assert port_plan._resolve_split(n, KernelConfig(split=(3, n // 3))) == \
        port_plan._four_step_split(n)


def test_disable_env_restores_the_heuristic_bit_for_bit(monkeypatch):
    heuristic = port_plan.plan_with_config(256)
    cache = _tuned_cache(entries=[
        ((256,), "c2c", KernelConfig(tile_b=4, radices=(2,),
                                     source="tuned"))])
    with use_tuning(TuningContext(cache)):
        tuned = port_plan.plan_for_length(256)
        assert tuned is not heuristic
        monkeypatch.setenv("REPRO_FFT_DISABLE_TUNING", "1")
        assert port_plan.plan_for_length(256) is heuristic
        assert plan_config((256,)) is None
        assert plan_nd((256,)).fn is not None
        monkeypatch.delenv("REPRO_FFT_DISABLE_TUNING")
        assert port_plan.plan_for_length(256) is tuned
    assert plan_config((256,), "c2c") is None
    assert port_plan.plan_for_length(256) is heuristic


def test_conv_plan_uses_a_valid_tuned_segment_only():
    n, taps, t = 2048, 33, 4
    base = port_convolve.select_nfft(taps, n, t)
    for segment, want in ((1024, 1024), (16, base), (1000, base)):
        cache = _tuned_cache(entries=[
            ((n, taps, t), "conv", KernelConfig(segment=segment,
                                                source="tuned"))])
        with use_tuning(TuningContext(cache)):
            assert port_convolve.conv_plan(n, taps, t).nfft == want
    assert port_convolve.conv_plan(n, taps, t).nfft == base
    assert port_convolve.conv_plan(n, taps, t) == \
        port_convolve.conv_plan(n, taps, t, base)


def test_common_default_serves_untuned_keys():
    cache = _tuned_cache(entries=[
        ((256,), "c2c", KernelConfig(radices=(8, 4, 2), source="tuned"))])
    ctx = TuningContext(cache)
    ctx.common = KernelConfig(radices=(8, 4, 2), source="common")
    with use_tuning(ctx):
        tuned = port_plan.plan_for_length(256)
        untuned = port_plan.plan_for_length(1024)
    assert tuned.radices == (4, 8, 8)
    assert untuned.radices == (2, 8, 8, 8)


def test_install_common_default_installs_and_returns_the_context():
    from repro_torch.tune import get_tuning_context, set_tuning_context
    cache = _tuned_cache(entries=[
        ((1024,), "c2c", KernelConfig(radices=(8, 4, 2), source="tuned"))])
    try:
        ctx = port_tuner.install_common_default(cache)
        assert get_tuning_context() is ctx
        assert ctx.common == common_config(cache)[0]
    finally:
        set_tuning_context(None)


# ---------------------------------------------------------------------------
# Serving: the plan/sweep cache keys on the tuned config
# ---------------------------------------------------------------------------

def _service_cache():
    return PlanSweepCache(TESLA_V100, batch_bytes=2**24)


def test_retune_rebuilds_fft_entries():
    cache = _service_cache()
    key = ShapeKey(kind="fft", n=256, precision="fp32",
                   device=TESLA_V100.name)
    e1 = cache.entry(key)
    assert cache.entry(key) is e1
    tuned = _tuned_cache(entries=[
        ((256,), "c2c", KernelConfig(radices=(2,), source="tuned"))])
    ctx = TuningContext(tuned)
    with use_tuning(ctx):
        e2 = cache.entry(key)
        assert e2 is not e1 and e2.plan.radices == (2,) * 8
        for _ in range(5):
            assert cache.entry(key) is e2
    assert ctx.consults == 1
    assert cache.entry(key) is e1


def _fdas_key(cls, templates=5, segment=0, n=2048):
    return cls(kind="fdas", n=n, precision="fp32", device=TESLA_V100.name,
               templates=templates, segment=segment)


def test_fdas_entries_key_on_the_tuned_conv_segment():
    n, templates = 2048, 5
    bank = TemplateBank.linear(zmax=(templates - 1) / 2.0,
                               n_templates=templates)
    cache = _service_cache()
    key = _fdas_key(ShapeKey)
    e1 = cache.entry(key)
    assert cache.entry(key) is e1
    tuned = _tuned_cache(entries=[
        ((n // 2 + 1, bank.taps, templates), "conv",
         KernelConfig(segment=512, source="tuned"))])
    with use_tuning(TuningContext(tuned)):
        e2 = cache.entry(key)
        assert e2 is not e1 and e2.plan.nfft == 512
        assert cache.entry(key) is e2
        # An explicit segment is part of the key: no tuning consulted.
        pinned = _fdas_key(ShapeKey, segment=256)
        assert cache.entry(pinned).plan.nfft == 256
    assert cache.entry(key) is e1


class _Recording:
    """Wraps a tuning cache and records the tokens looked up."""

    def __init__(self, cache):
        self.cache, self.tokens = cache, []
        self.device = cache.device

    def get(self, key):
        self.tokens.append(key.token())
        return self.cache.get(key)


@pytest.mark.parametrize("kw", [
    dict(kind="fdas", n=2048, templates=5),
    dict(kind="fdas", n=4096, templates=9, segment=512),
    dict(kind="pulsar", n=8 * 512, templates=5, shape=(8, 512),
         dm_trials=4, n_harmonics=4, transform="r2c"),
    dict(kind="fft", n=512, transform="r2c"),
])
def test_serving_consults_the_references_keys(kw):
    port_rec = _Recording(TuningCache(device="d"))
    ref_rec = _Recording(ref_tune.TuningCache(device="d"))
    full = dict(precision="fp32", device=TESLA_V100.name, **kw)
    with use_tuning(TuningContext(port_rec)):
        PlanSweepCache._tuned_config(ShapeKey(**full))
    with ref_tune.use_tuning(ref_tune.TuningContext(ref_rec)):
        RefCache(REF_V100, batch_bytes=2**24)._tuned_config(RefKey(**full))
    assert port_rec.tokens == ref_rec.tokens


class TestPulsarRetune:
    NCHAN, NTIME, TEMPLATES = 8, 512, 5

    def _key(self):
        return ShapeKey(kind="pulsar", n=self.NCHAN * self.NTIME,
                        precision="fp32", n_harmonics=4,
                        device=TESLA_V100.name, transform="r2c",
                        shape=(self.NCHAN, self.NTIME),
                        templates=self.TEMPLATES, dm_trials=4)

    @pytest.mark.parametrize("which", ["r2c", "conv"])
    def test_retune_of_either_inner_pass_rebuilds(self, which):
        bank = TemplateBank.linear(zmax=(self.TEMPLATES - 1) / 2.0,
                                   n_templates=self.TEMPLATES)
        cache = _service_cache()
        key = self._key()
        e1 = cache.entry(key)
        assert cache.entry(key) is e1
        entry = (((self.NTIME,), "r2c",
                  KernelConfig(tile_b=8, source="tuned")) if which == "r2c"
                 else ((self.NTIME // 2 + 1, bank.taps, self.TEMPLATES),
                       "conv", KernelConfig(segment=128, source="tuned")))
        with use_tuning(TuningContext(_tuned_cache(entries=[entry]))):
            e2 = cache.entry(key)
            assert e2 is not e1
            assert cache.entry(key) is e2
        assert cache.entry(key) is e1
