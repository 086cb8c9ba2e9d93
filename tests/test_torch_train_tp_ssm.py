"""Tensor parallelism over ``model`` in the sharded train step
(``repro_torch.train.sharded``) for the SSM and hybrid families, on
(data, model) meshes of CPU slots: mamba2's SSM heads split over the
model slots (``in_proj``, ``conv_w`` and ``conv_b`` used whole,
``gate_norm`` over the whole inner width from the slots' all-reduced sums
of squares, ``out_proj`` row-parallel), zamba2's shared block in
Megatron's layout with ``site_proj`` used whole.

Reduced float32 mamba2 and zamba2 on (1, 2), (2, 2) and (1, 4): two steps
within ``_model_parity.TrainParity``'s tolerances of the port's
unsharded step (``train.step``), the mesh's (kind, axis) record of a step
equal to ``train.sharded.accounted_record``, and the first step in
float64 within 1e-12 of a leaf's largest |value|.  The 2x2 step against
the reference's own: its ``make_train_step`` jitted with the
``in_shardings`` of its train state on a ``jax.sharding.Mesh((2, 2),
("data", "model"))`` of four forced host devices, in one subprocess for
the module (~25 s), from the same initial state (carried across by the
reference's checkpoint).  Also: SSM heads that do not divide over the
slots, ``gate_norm`` by hand on two slots, and a mamba2 checkpoint
written on 2x2 restored on 1x1 and 1x2."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _model_parity import (LOSS_RTOL, assert_same_training, close,
                           close_or_zero, flat,
                           one_torch_thread)  # noqa: F401
from repro_torch.configs import ARCHS
from repro_torch.fft.distributed import make_mesh
from repro_torch.launch.specs import fix_tree
from repro_torch.models import build_model, common, mamba2, zamba2
from repro_torch.runtime import CheckpointManager
from repro_torch.train.sharded import (accounted_record, gather_state,
                                       make_sharded_train_step, shard_state)
from repro_torch.train.step import (init_train_state, make_train_step,
                                    map_state)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 4, 16
SSM = ["mamba2-370m", "zamba2-1.2b"]
SHAPES = [(1, 2), (2, 2), (1, 4)]
F64_RTOL = 1e-12

REFERENCE = """
import json
import sys

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCHS
from repro.models import build_model
from repro.runtime.checkpoint import CheckpointManager
from repro.train.step import (init_train_state, make_train_step,
                              train_state_specs)

out, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
metrics = {}
for name in sys.argv[4:]:
    model = build_model(ARCHS[name].reduced())
    state = init_train_state(model, jax.random.PRNGKey(0))
    put = jax.tree.map(lambda s: NamedSharding(mesh, s),
                       train_state_specs(model),
                       is_leaf=lambda x: isinstance(x, P))
    rows = NamedSharding(mesh, P("data", None))
    tokens = np.random.default_rng(1).integers(0, model.cfg.vocab,
                                               (batch, seq + 1))
    step = jax.jit(make_train_step(model), in_shardings=(put, rows, rows))
    new, m = step(jax.device_put(state, put), tokens[:, :-1], tokens[:, 1:])
    CheckpointManager(f"{out}/{name}").save(0, state)
    CheckpointManager(f"{out}/{name}").save(1, jax.device_get(new))
    metrics[name] = {k: float(v) for k, v in m.items()}
with open(f"{out}/metrics.json", "w") as f:
    json.dump(metrics, f)
"""


def mesh_of(d: int, m: int):
    return make_mesh((d, m), ("data", "model"), devices=[CPU] * (d * m))


def batch(cfg, seed: int = 1):
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, SEQ + 1)))
    return tokens[:, :-1], tokens[:, 1:]


def setup(cfg, seed: int = 0):
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(seed), CPU)
    return model, state, *batch(cfg, seed + 1)


class _Float64(torch.overrides.TorchFunctionMode):
    """Float32 code run in float64: a float32 dtype argument becomes
    float64 and ``.float()`` ``.double()``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        wide = lambda a: torch.float64 if a is torch.float32 else a
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        return func(*map(wide, args),
                    **{k: wide(v) for k, v in (kwargs or {}).items()})


@contextlib.contextmanager
def float64(monkeypatch):
    """The port's float32 train steps computed in float64: float64 the
    default dtype, :class:`_Float64`, and ``remat`` a plain call (a mode
    does not reach a checkpoint's recompute; the values are the same)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    monkeypatch.setattr(common, "checkpoint", lambda fn, *a, **kw: fn(*a))
    try:
        with _Float64():
            yield
    finally:
        torch.set_default_dtype(old)
        monkeypatch.undo()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", SSM)
def test_tensor_parallel_steps_equal_the_unsharded_steps(name, shape):
    """Two steps on a (d, m) mesh against two unsharded steps from the
    same state and batch; the second step's record against the
    accounting."""
    d, m = shape
    model, state, inp, labels = setup(ARCHS[name].reduced())
    mesh = mesh_of(d, m)
    one_step = make_train_step(model)
    step = make_sharded_train_step(model, mesh)
    one, sharded = state, shard_state(state, model, mesh)
    for i in (1, 2):
        one, m_one = one_step(one, inp, labels)
        mesh.reset_collective_record()
        sharded, m_sharded = step(sharded, inp, labels)
        assert_same_training(one, gather_state(sharded), m_one, m_sharded, i)
    got = mesh.collective_totals()
    assert got == accounted_record(model, state, mesh, BATCH // d * SEQ)
    assert got[1]["model"] > 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", SSM)
def test_first_step_in_float64_equals_the_unsharded_step(name, shape,
                                                         monkeypatch):
    """The first step in float64 on a (d, m) mesh: the loss, the grad
    norm and both moments within 1e-12 of the unsharded step's (a leaf's
    largest |value|), the parameters unchanged (lr 0)."""
    d, m = shape
    model, state, inp, labels = setup(ARCHS[name].reduced())
    wide = map_state(lambda t: common.tree_map(
        lambda a: a.double() if a.is_floating_point() else a, t), state)
    mesh = mesh_of(d, m)
    with float64(monkeypatch):
        one, m_one = make_train_step(model)(wide, inp, labels)
        got, m_got = make_sharded_train_step(model, mesh)(
            shard_state(wide, model, mesh), inp, labels)
    got = gather_state(got)
    close(m_got["loss"], m_one["loss"], F64_RTOL)
    close(m_got["grad_norm"], m_one["grad_norm"], F64_RTOL)
    for a, b in zip(flat(got.params), flat(wide.params)):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    for part in ("m", "v"):
        for a, b in zip(flat(getattr(got.opt, part)),
                        flat(getattr(one.opt, part))):
            close_or_zero(a, b, F64_RTOL)


@pytest.fixture(scope="module")
def reference_2x2(tmp_path_factory):
    """The reference's initial states and one 2x2 step of reduced mamba2
    and zamba2 (checkpoints, metrics), one subprocess for the module."""
    out = tmp_path_factory.mktemp("tp_ssm_ref")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    # LLVM's cheaper passes: the same program, its compile ~40 % less CPU.
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true "
                        + env.get("XLA_FLAGS", ""))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out),
         str(BATCH), str(SEQ), *SSM],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    with open(out / "metrics.json") as f:
        return out, json.load(f)


@pytest.mark.parametrize("name", SSM)
def test_the_2x2_step_equals_the_references_2x2_step(name, reference_2x2):
    """From the reference's initial state, restored from its checkpoint:
    the port's 2x2 step against the reference's jitted step on its 2x2
    mesh, within TrainParity's tolerances (the loss 1e-5 relative, the
    grad norm and the moments 1e-4 of a leaf's largest |value|, the
    parameters unchanged, as the reference's are at lr 0)."""
    out, metrics = reference_2x2
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    like = init_train_state(model, torch.Generator().manual_seed(0), CPU)
    start = CheckpointManager(str(out / name)).restore(like, 0)
    want = CheckpointManager(str(out / name)).restore(like, 1)
    mesh = mesh_of(2, 2)
    got, m_got = make_sharded_train_step(model, mesh)(
        shard_state(start, model, mesh), *batch(cfg))
    got = gather_state(got)
    close(m_got["loss"], metrics[name]["loss"], LOSS_RTOL)
    close(m_got["grad_norm"], metrics[name]["grad_norm"])
    assert int(got.step) == int(want.step) == 1
    for a, b in zip(flat(got.params), flat(want.params)):
        np.testing.assert_array_equal(a, b)
    for part in ("m", "v"):
        for a, b in zip(flat(getattr(got.opt, part)),
                        flat(getattr(want.opt, part))):
            close_or_zero(a, b)


def test_the_leaves_each_family_uses_whole():
    """On (2, 2): mamba2's ``in_proj`` and conv used whole, its
    ``gate_norm`` and ``out_proj`` blocks the slots' heads'; zamba2's
    mamba blocks alike, its shared block's heads and MLP width split,
    ``site_proj`` whole; the vocabulary split in both."""
    mesh = mesh_of(2, 2)
    for name, mod, parents in (
            ("mamba2-370m", mamba2, ["layers"]),
            ("zamba2-1.2b", zamba2, ["head_layers/0", "site_layers"])):
        model = build_model(ARCHS[name].reduced())
        shapes = model.param_shapes()
        blocks = mod.tp_blocks(model.cfg, shapes, fix_tree(
            shapes, model.param_specs(), mesh), 2)
        assert blocks["embed"] and blocks["lm_head"]
        for parent in parents:
            assert {n: blocks[f"{parent}/{n}"] for n in (
                "in_proj", "conv_w", "conv_b", "gate_norm", "out_proj")} == {
                "in_proj": False, "conv_w": False, "conv_b": False,
                "gate_norm": True, "out_proj": True}
        assert mod.tp_blocks(model.cfg, shapes, fix_tree(
            shapes, model.param_specs(), mesh_of(2, 1)), 1) == {}
    assert not blocks["site_proj"]
    assert all(blocks[f"shared_attn/{n}"] for n in (
        "w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down"))


def test_heads_that_do_not_divide_over_the_slots():
    """A reduced mamba2 of 3 SSM heads of 32 (d_model 48) on (1, 2): its
    ``in_proj`` (227 columns) cannot split, so ``fix_sharding`` moves
    ``model`` onto d_model; ``gate_norm`` is used whole, every slot runs
    every head and takes its rows of ``out_proj``; two steps equal the
    unsharded ones, the record the accounting."""
    base = ARCHS["mamba2-370m"].reduced()
    cfg = dataclasses.replace(base, d_model=48, ssm=dataclasses.replace(
        base.ssm, head_dim=32))
    model = build_model(cfg)
    mesh = mesh_of(1, 2)
    shapes = model.param_shapes()
    fixed = fix_tree(shapes, model.param_specs(), mesh)
    assert shapes["layers"]["in_proj"].shape == (2, 48, 227)
    assert tuple(fixed["layers"]["in_proj"]) == (None, ("data", "model"))
    blocks = mamba2.tp_blocks(cfg, shapes, fixed, 2)
    assert not blocks["layers/gate_norm"] and blocks["layers/out_proj"]
    assert not any(blocks[f"layers/{n}"]
                   for n in ("in_proj", "conv_w", "conv_b"))
    model, state, inp, labels = setup(cfg)
    one, sharded = state, shard_state(state, model, mesh)
    step = make_sharded_train_step(model, mesh)
    for i in (1, 2):
        one, m_one = make_train_step(model)(one, inp, labels)
        mesh.reset_collective_record()
        sharded, m_sharded = step(sharded, inp, labels)
        assert_same_training(one, gather_state(sharded), m_one, m_sharded, i)
    assert mesh.collective_totals() == accounted_record(model, state, mesh,
                                                        BATCH * SEQ)


def test_gate_norm_by_hand_on_two_slots():
    """``common.rms_norm_slots`` on the two halves of a (2, 3, 8) input
    on the model line of a (1, 2) mesh: each slot's float32 sum of
    squares, all-reduced, over the whole width gives ``rms_norm`` over the
    whole width, each slot its half; the all-reduce moves 4 bytes a token
    a slot; the gradient is ``rms_norm``'s."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 8, generator=gen, dtype=torch.float64)
    scale = torch.randn(8, generator=gen, dtype=torch.float64)
    x.requires_grad_()
    mesh = mesh_of(1, 2)
    line = mesh.line("model", {"data": 0})
    halves = list(x.split(4, -1))
    got = common.rms_norm_slots(halves, list(scale.split(4)), 1e-5, 8, line)
    want = common.rms_norm(x, scale, 1e-5)
    assert all(g.dtype == torch.float64 for g in got)
    torch.testing.assert_close(torch.cat(got, -1), want, rtol=1e-6,
                               atol=1e-6)
    assert mesh.collective_record == {("all-reduce", "model"): 2 * 6 * 4 / 2}
    w = torch.randn(2, 3, 8, generator=gen, dtype=torch.float64)
    (g_got,) = torch.autograd.grad((torch.cat(got, -1) * w).sum(), [x])
    (g_want,) = torch.autograd.grad((want * w).sum(), [x])
    torch.testing.assert_close(g_got, g_want, rtol=1e-6, atol=1e-6)
    one = common.rms_norm_slots([x.detach()], [scale], 1e-5, 8,
                                mesh_of(1, 1).line("model", {"data": 0}))
    torch.testing.assert_close(one[0], want.detach(), rtol=1e-6, atol=1e-6)


def test_mamba2_checkpoints_restore_across_meshes(tmp_path):
    """A mamba2 step on 2x2 saved; restored unsharded (1x1) with the same
    bits, and on 1x2, where the next step equals the unsharded one."""
    cfg = ARCHS["mamba2-370m"].reduced()
    model, state, inp, labels = setup(cfg)
    mesh = mesh_of(2, 2)
    on22, _ = make_sharded_train_step(model, mesh)(
        shard_state(state, model, mesh), inp, labels)
    CheckpointManager(str(tmp_path / "2x2")).save(1, on22)
    plain = CheckpointManager(str(tmp_path / "2x2")).restore(state, 1)
    for a, b in zip(flat(plain), flat(gather_state(on22))):
        np.testing.assert_array_equal(a, b)
    mesh12 = mesh_of(1, 2)
    on12 = CheckpointManager(str(tmp_path / "2x2")).restore(
        shard_state(state, model, mesh12), 1)
    assert on12.params["layers"]["in_proj"].mesh is mesh12
    for a, b in zip(flat(gather_state(on12)), flat(plain)):
        np.testing.assert_array_equal(a, b)
    on12, m12 = make_sharded_train_step(model, mesh12)(on12, inp, labels)
    one, m1 = make_train_step(model)(plain, inp, labels)
    assert_same_training(one, gather_state(on12), m1, m12, 2)
