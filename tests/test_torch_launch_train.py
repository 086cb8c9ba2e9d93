"""The port's train driver (``repro_torch.launch.train``), the
fault-tolerant loop around its step, and train-state checkpoints, against
the reference's: ``main`` on the CPU gives the reference step's losses
and final state from the same initial state (the reference's own main
cannot train under the installed jax); the reference's driver claims
(``tests/test_runtime.py``: it survives failures, a restart replays the
same losses); a ``TrainState`` checkpoint restores across the packages
under the reference's key names; a bf16 checkpoint is byte-identical to
the reference's and restores in the port (the reference cannot restore
it); ``--mesh 2x1`` on CPU slots trains as ``1x1`` does, ``--mesh 2x2``
too for reduced qwen2, deepseek-v2-lite, mamba2 and zamba2, its
``--dvfs-report`` pricing the model and data axes apart; a card-less
``cuda`` raises; an embeddings-input model cannot be trained in either
package."""
import json
import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _model_parity import (STEP_ATOL, STEP_RTOL, close, flat, load_arch,
                           one_torch_thread)  # noqa: F401
from repro.launch import train as ref_train
from repro.data.synthetic import SyntheticTokens as RefTokens
from repro.runtime.checkpoint import CheckpointManager as RefCheckpoints
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.fft.distributed import make_mesh
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models.convert import tensors_from_reference
from repro_torch.runtime import CheckpointManager, FaultTolerantDriver
from repro_torch.train.sharded import accounted_record
from repro_torch.train.step import make_train_step

ARGS = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "3", "--batch", "2",
        "--seq", "16", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def qwen2():
    return load_arch("qwen2-0.5b")


def test_main_gives_the_reference_steps(qwen2, tmp_path, capsys):
    """The port's main from the reference's PRNGKey(0) state, carried
    across: the reference's jitted step over the same synthetic batches
    gives the same losses and, after three steps, parameters within the
    reference's step tolerance; the driver's lines and checkpoints are
    the reference main's."""
    log = []
    got = train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--device",
                             "cpu", "--dvfs-report"],
                     state=qwen2.port_state(), log=log)
    out = capsys.readouterr().out.splitlines()
    step = jax.jit(ref_make_train_step(qwen2.ref, peak_lr=1e-2))
    ds = RefTokens(qwen2.cfg.vocab, 16, 2)
    want, losses = qwen2.ref_state(), []
    for i in range(3):
        b = jnp.asarray(ds.batch(i))
        want, m = step(want, b[:, :-1], b[:, 1:])
        losses.append(float(m["loss"]))
    assert [m["step"] for m in log] == [0, 1, 2]
    np.testing.assert_allclose([float(m["loss"]) for m in log], losses,
                               rtol=1e-5)
    assert out[:3] == [
        f"step {i:5d}  loss {float(m['loss']):.4f}  lr {float(m['lr']):.2e}"
        f"  wall {m['wall']*1e3:.1f} ms" for i, m in enumerate(log)]
    assert out[3] == (f"[train] done: 3 steps, 0 restarts, final loss "
                      f"{float(log[-1]['loss']):.4f}")
    assert out[4].startswith("[dvfs] bound=")
    assert int(got.step) == int(want.step) == 3
    for a, b in zip(flat(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
    for a, b in zip(flat(got.opt.v), jax.tree.leaves(want.opt.v)):
        close(a, b, 1e-3)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]


def test_the_reference_main_cannot_train_under_the_installed_jax(tmp_path):
    """The reference's main puts its state on a (1, 1) mesh with explicit
    shardings; the installed jax then refuses the embedding gather."""
    with pytest.raises(Exception, match="out_sharding") as err:
        ref_train.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    assert type(err.value).__name__ == "ShardingTypeError"


def test_main_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device trains")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(ARGS + ["--ckpt-dir", str(tmp_path)])


def test_a_data_mesh_trains_as_one_device(tmp_path, capsys):
    """``--mesh 2x1`` on two CPU slots: the slot list printed, the losses
    of ``--mesh 1x1`` and, after three steps, its state within the step
    tolerance; the checkpoints hold the gathered state and restore in an
    unsharded run's state."""
    args = ARGS + ["--device", "cpu", "--dvfs-report"]
    one_log, mesh_log = [], []
    one = train.main(args + ["--ckpt-dir", str(tmp_path / "1x1")],
                     log=one_log)
    capsys.readouterr()
    got = train.main(args + ["--mesh", "2x1", "--ckpt-dir",
                             str(tmp_path / "2x1")], log=mesh_log)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] mesh 2x1 (data, model) on slots cpu, cpu"
    assert out[-2].startswith("[dvfs] one slot of 2x1: ")
    assert " B of collectives (" in out[-2]
    assert out[-1].startswith("[dvfs] bound=")
    np.testing.assert_allclose([float(m["loss"]) for m in mesh_log],
                               [float(m["loss"]) for m in one_log],
                               rtol=1e-5)
    assert int(got.step) == int(one.step) == 3
    for a, b in zip(flat(got), flat(one)):
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)
    restored = CheckpointManager(str(tmp_path / "2x1")).restore(one, 3)
    for a, b in zip(flat(restored), flat(got)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b",
                                  "mamba2-370m", "zamba2-1.2b"])
def test_a_two_axis_mesh_trains_as_one_device(arch, tmp_path, capsys):
    """``--mesh 2x2`` on four CPU slots: the losses of ``--mesh 1x1`` and,
    after three steps, its state within the step tolerance; the
    ``--dvfs-report`` line prices the step's data and model bytes apart,
    at the network and NVLink rates, and they are the record of one step
    (``train.sharded.accounted_record``)."""
    args = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "4",
            "--seq", "16", "--ckpt-every", "2", "--device", "cpu",
            "--dvfs-report"]
    one_log, mesh_log = [], []
    one = train.main(args + ["--ckpt-dir", str(tmp_path / "1x1")],
                     log=one_log)
    capsys.readouterr()
    got = train.main(args + ["--mesh", "2x2", "--ckpt-dir",
                             str(tmp_path / "2x2")], log=mesh_log)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] mesh 2x2 (data, model) on slots " + ", ".join(
        ["cpu"] * 4)
    np.testing.assert_allclose([float(m["loss"]) for m in mesh_log],
                               [float(m["loss"]) for m in one_log],
                               rtol=1e-5)
    for a, b in zip(flat(got), flat(one)):
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)
    found = re.fullmatch(
        r"\[dvfs\] one slot of 2x2: .* B of state read and written "
        r"\(.* ms\), (\d+) B of collectives \(([\d.]+) ms at 50 GB/s\) on "
        r"data, (\d+) B of collectives \(([\d.]+) ms at 450 GB/s\) "
        r"on model",
        out[-2])
    assert found and out[-1].startswith("[dvfs] bound=")
    model = build_model(get_arch(arch).reduced())
    mesh = make_mesh((2, 2), ("data", "model"), devices=[torch.device("cpu")]
                     * 4)
    _, by_axis = accounted_record(model, one, mesh, 2 * 16)
    data, model_bytes = int(found[1]), int(found[3])
    assert (data, model_bytes) == (round(by_axis["data"]),
                                   round(by_axis["model"]))
    assert float(found[2]) == round(data / 50e9 * 1e3, 4)
    assert float(found[4]) == round(model_bytes / 450e9 * 1e3, 4)


def test_a_data_mesh_on_the_card_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device trains")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(ARGS + ["--mesh", "4x1", "--ckpt-dir", str(tmp_path)])


def test_an_embeddings_input_model_cannot_be_trained_in_either_package(
        tmp_path):
    """Pixtral takes embeddings: both mains feed it the synthetic token
    ids, and both raise on the shapes (the reference's before its
    sharding fault)."""
    args = ["--arch", "pixtral-12b", "--reduced", "--steps", "1", "--batch",
            "2", "--seq", "16"]
    with pytest.raises(ValueError, match="broadcast"):
        ref_train.main(args + ["--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(RuntimeError, match="size of tensor"):
        train.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                           "--device", "cpu"])


def _driver_setup(qwen2):
    step = make_train_step(qwen2.model)
    ds = SyntheticTokens(qwen2.cfg.vocab, 16, 4, seed=3)

    def data(i):
        b = torch.from_numpy(ds.batch(i)).long()
        return b[:, :-1], b[:, 1:]
    return step, data


def test_driver_survives_failures(qwen2, tmp_path):
    """The reference's claim, on the port's step."""
    step, data = _driver_setup(qwen2)
    driver = FaultTolerantDriver(
        train_step=step, state=qwen2.port_state(), data_iter_fn=data,
        ckpt=CheckpointManager(str(tmp_path)), ckpt_every=5,
        fail_at={7: 0, 13: 1})
    final, log, restarts = driver.run(20)
    assert restarts == 2
    assert int(final.step) == 20
    assert [m["step"] for m in log] == list(range(20))


def test_restart_is_deterministic(qwen2, tmp_path):
    """The reference's claim: replayed steps give the same loss (batch i
    is a pure function of i, the restored state is the saved one)."""
    step, data = _driver_setup(qwen2)
    d1 = FaultTolerantDriver(step, qwen2.port_state(), data,
                             CheckpointManager(str(tmp_path / "a")),
                             ckpt_every=5, fail_at={7: 0})
    _, log1, _ = d1.run(10)
    d2 = FaultTolerantDriver(step, qwen2.port_state(), data,
                             CheckpointManager(str(tmp_path / "b")),
                             ckpt_every=5)
    _, log2, _ = d2.run(10)
    assert [float(m["loss"]) for m in log1] == [float(m["loss"])
                                                for m in log2]


def test_train_state_checkpoints_restore_across_the_packages(qwen2,
                                                             tmp_path):
    """A float32 ``TrainState`` saved by either package restores in the
    other, leaf for leaf, under the reference's key names."""
    ref_state = qwen2.ref_train["s1"]
    RefCheckpoints(str(tmp_path / "ref")).save(1, ref_state)
    like = qwen2.port_state()
    got = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert type(got) is type(like) and type(got.opt) is type(like.opt)
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    for a, b in zip(flat(got), jax.tree.leaves(ref_state)):
        np.testing.assert_array_equal(a, np.asarray(b))

    CheckpointManager(str(tmp_path / "port")).save(1, got)
    with open(tmp_path / "port" / "step_00000001" / "manifest.host0.json") as f:
        port_keys = list(json.load(f)["leaves"])
    with open(tmp_path / "ref" / "step_00000001" / "manifest.host0.json") as f:
        ref_keys = list(json.load(f)["leaves"])
    assert port_keys == ref_keys and len(ref_keys) == 44
    assert ref_keys[:2] == ["params/embed", "params/final_norm"]
    assert ref_keys[-1] == "step" and "opt/step" in ref_keys
    back = RefCheckpoints(str(tmp_path / "port")).restore(qwen2.ref_state())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    again = CheckpointManager(str(tmp_path / "port")).restore(like)
    for a, b in zip(flat(again), flat(got)):
        np.testing.assert_array_equal(a, b)


def test_bf16_checkpoints_are_the_references_bytes(tmp_path):
    """bf16 leaves go to disk as their 16-bit words (descr ``<V2``,
    manifest dtype "bfloat16"), byte for byte what ``np.save`` writes for the
    reference's array.  The port restores them; the reference's restore
    raises on its own file."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
            "layers": {"ln": rng.standard_normal((2, 5)).astype(
                ml_dtypes.bfloat16)}}
    RefCheckpoints(str(tmp_path / "ref")).save(2, tree)
    port_tree = tensors_from_reference(tree, "cpu")
    assert port_tree["w"].dtype == torch.bfloat16
    CheckpointManager(str(tmp_path / "port")).save(2, port_tree)
    ref_dir = tmp_path / "ref" / "step_00000002"
    port_dir = tmp_path / "port" / "step_00000002"
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    for name in os.listdir(ref_dir):
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes()
    manifest = json.loads((port_dir / "manifest.host0.json").read_text())
    assert {v["dtype"] for v in manifest["leaves"].values()} == {"bfloat16"}
    assert np.load(port_dir / "w.host0.npy").dtype == np.dtype("V2")

    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
            "layers": {"ln": torch.zeros(2, 5, dtype=torch.bfloat16)}}
    got = CheckpointManager(str(tmp_path / "ref")).restore(like)
    for key, a, b in (("w", got["w"], tree["w"]),
                      ("ln", got["layers"]["ln"], tree["layers"]["ln"])):
        assert a.dtype == torch.bfloat16, key
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      b.view(np.int16))
    with pytest.raises(ValueError, match="cast"):
        RefCheckpoints(str(tmp_path / "ref")).restore(
            jax.tree.map(jnp.asarray, tree))


def test_a_module_checkpoints_as_its_parameter_tree(qwen2, tmp_path):
    """A ``ParamTree`` module is walked as its dict: the reference's keys
    and files; it restores as the nested dict of tensors."""
    RefCheckpoints(str(tmp_path / "ref")).save(1, qwen2.ref_params)
    CheckpointManager(str(tmp_path / "port")).save(1, qwen2.params)
    names = [sorted(os.listdir(tmp_path / d / "step_00000001"))
             for d in ("ref", "port")]
    assert names[0] == names[1]
    got = CheckpointManager(str(tmp_path / "ref")).restore(qwen2.params)
    assert type(got) is dict
    for a, b in zip(flat(got), jax.tree.leaves(qwen2.np_params)):
        np.testing.assert_array_equal(a, b)
