"""The port's training-side runtime (``repro_torch.runtime.fault`` and
``repro_torch.runtime.checkpoint``) against the reference's: the claims of
``tests/test_runtime.py`` (straggler monitor, checkpoint save/restore,
retention, multi-host ``DONE`` markers, the fault-tolerant driver) and of
the driver's fake-timer case in ``tests/test_obs.py``, on torch tensors —
and checkpoints written by either package restore in the other, equal
leaf for leaf."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.runtime.checkpoint import CheckpointManager as RefCheckpoints
from repro.runtime.fault import StragglerMonitor as RefMonitor
from repro_torch.runtime import (CheckpointManager, FaultTolerantDriver,
                                 SimulatedFailure, StragglerMonitor)


class FakeTimer:
    def __init__(self, dt=0.0, t0=0.0):
        self.t = t0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((2, 3)).astype(np.float32),
            "b": [rng.standard_normal(4).astype(np.float32),
                  {"c": rng.integers(0, 9, (2, 2)).astype(np.int32)}],
            "d": (rng.standard_normal(1).astype(np.float16),)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch(v) for v in tree)
    return torch.from_numpy(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


# ---------------------------------------------------------------------------
# straggler monitor (tests/test_runtime.py, and the reference's numbers)
# ---------------------------------------------------------------------------

def test_straggler_monitor():
    mon = StragglerMonitor(n_hosts=4, factor=1.5)
    times = np.array([1.0, 1.0, 1.0, 3.0])
    for _ in range(5):
        flagged = mon.observe(times)
    assert flagged == [3]
    assign = mon.shard_assignment(step=0, excluded=[3])
    total = sorted(s for v in assign.values() for s in v)
    assert total == [0, 1, 2, 3]                 # every shard still owned


def test_straggler_shards_split_half_and_half():
    mon = StragglerMonitor(n_hosts=4, factor=1.5, shards_per_host=4)
    times = np.array([1.0, 0.5, 1.0, 3.0])
    for _ in range(5):
        flagged = mon.observe(times)
    assert flagged == [3]
    for step in range(4):
        assign = mon.shard_assignment(step=step, excluded=[3])
        assert assign[3] == [12, 13]             # straggler keeps half
        assert assign[1] == [4, 5, 6, 7, 14, 15]  # fastest host absorbs rest
        total = sorted(s for v in assign.values() for s in v)
        assert total == list(range(16))


def test_straggler_all_flagged_no_reassignment():
    mon = StragglerMonitor(n_hosts=2, shards_per_host=2)
    mon.observe(np.array([1.0, 1.0]))
    assign = mon.shard_assignment(step=0, excluded=[0, 1])
    assert assign == {0: [0, 1], 1: [2, 3]}


@pytest.mark.parametrize("seed", range(3))
def test_straggler_monitor_matches_reference(seed):
    rng = np.random.default_rng(seed)
    port = StragglerMonitor(n_hosts=6, factor=1.3, alpha=0.4,
                            shards_per_host=3)
    ref = RefMonitor(n_hosts=6, factor=1.3, alpha=0.4, shards_per_host=3)
    for step in range(8):
        times = rng.gamma(2.0, 1.0, 6)
        flagged = port.observe(times)
        assert flagged == ref.observe(times)
        np.testing.assert_array_equal(port.ewma, ref.ewma)
        assert port.shard_assignment(step, flagged) == \
            ref.shard_assignment(step, flagged)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _torch(_tree(0))
    mgr.save(5, tree)
    like = {"a": torch.zeros(2, 3), "b": [torch.zeros(4),
                                          {"c": torch.zeros(2, 2,
                                                            dtype=torch.int32)}],
            "d": (torch.zeros(1, dtype=torch.float16),)}
    out = mgr.restore(like)
    assert isinstance(out["b"], list) and isinstance(out["d"], tuple)
    for got, want in zip(_leaves(out), _leaves(tree)):
        np.testing.assert_array_equal(got, want)
    assert out["b"][1]["c"].dtype == torch.int32
    assert out["d"][0].dtype == torch.float16


def test_restore_follows_the_like_dtype_and_numpy_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(4, dtype=torch.float32),
                 "n": np.arange(3, dtype=np.int64), "skip": None})
    out = mgr.restore({"w": torch.zeros(4, dtype=torch.float64),
                       "n": np.zeros(3, np.int32), "skip": None})
    assert out["w"].dtype == torch.float64
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert isinstance(out["n"], np.ndarray) and out["n"].dtype == np.int32
    assert out["skip"] is None


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, n_hosts=2)
    mgr.save(1, {"w": torch.ones(3)})            # host 0 only -> incomplete
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(3)})


def test_multi_host_done_markers(tmp_path):
    """Two hosts write their own leaves into one step folder; the step is
    complete only once both DONE markers exist, and each host restores
    its own manifest."""
    h0 = CheckpointManager(str(tmp_path), n_hosts=2, host_id=0)
    h1 = CheckpointManager(str(tmp_path), n_hosts=2, host_id=1)
    h0.save(3, {"w": torch.zeros(2)})
    assert h1.latest_step() is None
    h1.save(3, {"w": torch.ones(2)})
    assert h0.latest_step() == h1.latest_step() == 3
    names = sorted(os.listdir(tmp_path / "step_00000003"))
    assert names == ["DONE.host0", "DONE.host1", "manifest.host0.json",
                     "manifest.host1.json", "w.host0.npy", "w.host1.npy"]
    assert h0.restore({"w": torch.ones(2)})["w"].tolist() == [0.0, 0.0]
    assert h1.restore({"w": torch.zeros(2)})["w"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("seed", range(2))
def test_checkpoints_restore_across_packages(tmp_path, seed):
    tree = _tree(seed)
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(port_dir).save(7, _torch(tree))
    ref_tree = {"a": jnp.asarray(tree["a"]),
                "b": [jnp.asarray(tree["b"][0]),
                      {"c": jnp.asarray(tree["b"][1]["c"])}],
                "d": (np.asarray(tree["d"][0]),)}
    RefCheckpoints(ref_dir).save(7, ref_tree)
    # the same files, names and manifests
    for name in sorted(os.listdir(os.path.join(port_dir, "step_00000007"))):
        with open(os.path.join(port_dir, "step_00000007", name), "rb") as f:
            mine = f.read()
        with open(os.path.join(ref_dir, "step_00000007", name), "rb") as f:
            assert f.read() == mine, name
    # the reference restores the port's checkpoint, the port the reference's
    ref_out = RefCheckpoints(port_dir).restore(ref_tree)
    port_out = CheckpointManager(ref_dir).restore(_torch(tree))
    for got_ref, got_port, want in zip(_leaves(ref_out), _leaves(port_out),
                                       _leaves(tree)):
        np.testing.assert_array_equal(got_ref, want)
        np.testing.assert_array_equal(got_port, want)
        assert got_port.dtype == want.dtype


# ---------------------------------------------------------------------------
# the fault-tolerant driver
# ---------------------------------------------------------------------------

def _step(state, inputs, labels):
    """A deterministic step: the state is a tensor that accumulates the
    batch; the loss is a pure function of (state, batch)."""
    state = state + inputs
    return state, {"loss": float(state.sum())}


def _data(i):
    return torch.full((3,), float(i + 1)), None


def test_driver_survives_failures(tmp_path):
    driver = FaultTolerantDriver(
        train_step=_step, state=torch.zeros(3), data_iter_fn=_data,
        ckpt=CheckpointManager(str(tmp_path)), ckpt_every=5,
        fail_at={7: 0, 13: 1})
    final, log, restarts = driver.run(20)
    assert restarts == 2
    # every step ran exactly once into the final state: sum 1..20
    assert final.tolist() == [210.0] * 3
    assert [m["step"] for m in log] == list(range(20))


def test_restart_is_deterministic(tmp_path):
    d1 = FaultTolerantDriver(_step, torch.zeros(3), _data,
                             CheckpointManager(str(tmp_path / "a")),
                             ckpt_every=5, fail_at={7: 0})
    _, log1, _ = d1.run(10)
    d2 = FaultTolerantDriver(_step, torch.zeros(3), _data,
                             CheckpointManager(str(tmp_path / "b")),
                             ckpt_every=5)
    _, log2, _ = d2.run(10)
    assert [(m["step"], m["loss"]) for m in log1] == \
        [(m["step"], m["loss"]) for m in log2]


def test_driver_gives_up_after_max_restarts(tmp_path):
    driver = FaultTolerantDriver(
        _step, torch.zeros(3), _data, CheckpointManager(str(tmp_path)),
        ckpt_every=2, max_restarts=1, fail_at={1: 0, 3: 1})
    with pytest.raises(SimulatedFailure, match="host 1 lost at step 3"):
        driver.run(6)


def test_wall_metrics_deterministic_under_fake_timer(tmp_path):
    driver = FaultTolerantDriver(
        train_step=lambda s, i, l: (s + 1, {}),
        state=torch.zeros(()),
        data_iter_fn=lambda i: (None, None),
        ckpt=CheckpointManager(str(tmp_path)), ckpt_every=100,
        timer=FakeTimer(dt=0.25),
    )
    _, log, _ = driver.run(3)
    assert [m["wall"] for m in log] == [pytest.approx(0.25)] * 3
