"""The sharded train step (``repro_torch.train.sharded``) on data meshes of
CPU slots, against the port's unsharded step (``train.step``), which
``tests/test_torch_train_*.py`` hold to the reference's
``make_train_step``; one case also against the reference's own steps.

Reduced float32 qwen2, gemma3 (its 5:1 groups rematerialised whole),
mamba2 and zamba2 (the shared block) on (2, 1) and (4, 1) meshes, two
steps each, within ``_model_parity.TrainParity``'s tolerances: the loss
within 1e-5 relative, the first step's moments and grad norm within 1e-4
of the largest |value| (the schedule's lr is 0 at step 0, so the moments
hold the clipped gradient and the parameters stay), and the parameters
and moments after two steps within ``STEP_RTOL``, ``STEP_ATOL``.

The mesh's (kind, axis) record of a step equals
``analysis.cost.collective_accounting`` of the fixed specs but for two
stated departures (``train.sharded.accounted_record``).  Also: the mesh's
training collectives on hand-worked shards, the state's placement,
checkpoints across 4x1, 1x1 and 2x1, a driver restart on a mesh,
``microbatches=2`` (on 2x2 for the SSM and hybrid families, whose
tensor parallelism ``tests/test_torch_train_tp_ssm.py`` checks), and
``remat`` leaving a call without sharded leaves as it was."""
import math

import jax
import numpy as np
import pytest
import torch

from _model_parity import (LOSS_RTOL, STEP_ATOL, STEP_RTOL,
                           assert_same_training, close, flat, load_arch,
                           one_torch_thread)  # noqa: F401
from repro_torch.configs import ARCHS
from repro_torch.fft.distributed import (ReplicatedTensor, ShardedTensor,
                                         make_mesh)
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime import CheckpointManager, FaultTolerantDriver
from repro_torch.train.sharded import (accounted_record, gather_state,
                                       make_sharded_train_step, shard_state,
                                       slot_state)
from repro_torch.train.step import init_train_state, make_train_step

CPU = torch.device("cpu")
BATCH, SEQ = 4, 16
FAMILIES = ["qwen2-0.5b", "gemma3-12b", "mamba2-370m", "zamba2-1.2b"]
def data_mesh(d: int):
    return make_mesh((d, 1), ("data", "model"), devices=[CPU] * d)


def setup(name: str, seed: int = 0):
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(seed), CPU)
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (BATCH, SEQ + 1)))
    return model, state, tokens[:, :-1], tokens[:, 1:]




@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_steps_equal_the_unsharded_steps(name, d):
    """Two steps on a (d, 1) mesh against two unsharded steps from the same
    state and batch; the second step's record against the accounting."""
    model, state, inp, labels = setup(name)
    mesh = data_mesh(d)
    one_step = make_train_step(model)
    step = make_sharded_train_step(model, mesh)
    one, sharded = state, shard_state(state, model, mesh)
    for i in (1, 2):
        one, m_one = one_step(one, inp, labels)
        mesh.reset_collective_record()
        sharded, m_sharded = step(sharded, inp, labels)
        assert_same_training(one, gather_state(sharded), m_one, m_sharded, i)
    assert mesh.collective_totals() == accounted_record(
        model, state, mesh, BATCH // d * SEQ)
    assert mesh.collective_totals()[1]["model"] == 0


def test_sharded_steps_equal_the_references_steps():
    """qwen2 from the reference's initial state on a (2, 1) mesh: the
    reference's jitted ``make_train_step``, twice."""
    arch = load_arch("qwen2-0.5b")
    want = arch.ref_train
    mesh = data_mesh(2)
    step = make_sharded_train_step(arch.model, mesh)
    state = shard_state(arch.port_state(), arch.model, mesh)
    inp, labels = arch.port_batch()
    state, m1 = step(state, inp, labels)
    state, m2 = step(state, inp, labels)
    close(m1["loss"], want["m1"]["loss"], LOSS_RTOL)
    close(m1["grad_norm"], want["m1"]["grad_norm"])
    close(m2["loss"], want["m2"]["loss"], LOSS_RTOL)
    got = gather_state(state)
    for tree, ref in ((got.params, want["s2"].params),
                      (got.opt.m, want["s2"].opt.m),
                      (got.opt.v, want["s2"].opt.v)):
        for a, b in zip(flat(tree), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)


def test_microbatches_split_each_replicas_rows():
    """``microbatches=2`` on (2, 1): the unsharded step with two
    microbatches, and every weight gathered twice as often."""
    name = "qwen2-0.5b"
    model, state, inp, labels = setup(name, seed=3)
    mesh = data_mesh(2)
    one, m_one = make_train_step(model, microbatches=2)(state, inp, labels)
    sharded, m_sharded = make_sharded_train_step(
        model, mesh, microbatches=2)(shard_state(state, model, mesh), inp,
                                     labels)
    assert_same_training(one, gather_state(sharded), m_one, m_sharded, 1)
    assert mesh.collective_totals() == accounted_record(
        model, state, mesh, BATCH // 2 // 2 * SEQ, microbatches=2)


def test_state_placement_follows_the_fixed_specs():
    """On (4, 1): the embedding (P('model', 'data')) split along d, a
    stacked projection (P(None, 'data', 'model')) along its input dim,
    the norms and counters replicated; each slot holds a quarter of a
    split leaf; gathering gives the state back bit for bit."""
    model, state, _, _ = setup("qwen2-0.5b")
    mesh = data_mesh(4)
    sharded = shard_state(state, model, mesh)
    embed = sharded.params["embed"]
    w_q = sharded.params["layers"]["attn"]["w_q"]
    assert isinstance(embed, ShardedTensor) and embed.dim == 1
    assert isinstance(w_q, ShardedTensor) and w_q.dim == 1
    assert isinstance(sharded.opt.m["embed"], ShardedTensor)
    for leaf in (sharded.params["final_norm"],
                 sharded.params["layers"]["ln_attn"], sharded.step,
                 sharded.opt.step):
        assert isinstance(leaf, ReplicatedTensor)
        assert len(leaf.copies) == 4
    local = slot_state(sharded, 3)
    assert local.params["embed"].shape == (256, 16)
    torch.testing.assert_close(local.params["embed"],
                               state.params["embed"][:, 48:], rtol=0, atol=0)
    back = gather_state(sharded)
    for a, b in zip(flat(back), flat(state)):
        np.testing.assert_array_equal(a, b)


def test_checkpoints_restore_across_meshes(tmp_path):
    """A step on 4x1, saved; restored unsharded (1x1), saved again;
    restored on 2x1: the same bits throughout, and the next step on 2x1
    equals the unsharded one from the same state.  A checkpoint holds the
    gathered state under the reference's key paths."""
    model, state, inp, labels = setup("zamba2-1.2b")
    mesh4, mesh2 = data_mesh(4), data_mesh(2)
    on4, _ = make_sharded_train_step(model, mesh4)(
        shard_state(state, model, mesh4), inp, labels)
    CheckpointManager(str(tmp_path / "4x1")).save(1, on4)
    plain = CheckpointManager(str(tmp_path / "4x1")).restore(state, 1)
    for a, b in zip(flat(plain), flat(gather_state(on4))):
        np.testing.assert_array_equal(a, b)
    CheckpointManager(str(tmp_path / "1x1")).save(1, plain)
    on2 = CheckpointManager(str(tmp_path / "1x1")).restore(
        shard_state(state, model, mesh2), 1)
    assert isinstance(on2.params["embed"], ShardedTensor)
    assert on2.params["embed"].mesh is mesh2
    for a, b in zip(flat(gather_state(on2)), flat(plain)):
        np.testing.assert_array_equal(a, b)
    on2, m2 = make_sharded_train_step(model, mesh2)(on2, inp, labels)
    one, m1 = make_train_step(model)(plain, inp, labels)
    assert_same_training(one, gather_state(on2), m1, m2, 2)


def test_the_driver_restarts_a_sharded_step(tmp_path):
    """``FaultTolerantDriver`` on a (2, 1) mesh with a failure at step 3:
    every step once, and the losses of the uninterrupted unsharded run."""
    model, state, _, _ = setup("qwen2-0.5b")
    mesh = data_mesh(2)
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.integers(0, 256, (BATCH, SEQ + 1)))
               for _ in range(5)]
    data = lambda i: (batches[i][:, :-1], batches[i][:, 1:])
    driver = FaultTolerantDriver(
        make_sharded_train_step(model, mesh, peak_lr=1e-2),
        shard_state(state, model, mesh), data,
        CheckpointManager(str(tmp_path / "mesh")), ckpt_every=2,
        fail_at={3: 0})
    final, log, restarts = driver.run(5)
    plain = FaultTolerantDriver(
        make_train_step(model, peak_lr=1e-2), state, data,
        CheckpointManager(str(tmp_path / "plain")), ckpt_every=2)
    want, want_log, _ = plain.run(5)
    assert restarts == 1 and [m["step"] for m in log] == list(range(5))
    np.testing.assert_allclose([float(m["loss"]) for m in log],
                               [float(m["loss"]) for m in want_log],
                               rtol=LOSS_RTOL)
    for a, b in zip(flat(gather_state(final).params), flat(want.params)):
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("name,shape", [("mamba2-370m", (2, 2)),
                                        ("zamba2-1.2b", (2, 2))])
def test_ssm_families_on_a_two_axis_mesh_equal_one_device(name, shape):
    """mamba2 and zamba2 on 2x2 with ``microbatches=2``: the unsharded
    step with two microbatches, and the record of the accounting, every
    weight gathered twice as often."""
    model, state, inp, labels = setup(name, seed=2)
    mesh = make_mesh(shape, ("data", "model"), devices=[CPU] * math.prod(
        shape))
    one, m_one = make_train_step(model, microbatches=2)(state, inp, labels)
    sharded, m_sharded = make_sharded_train_step(
        model, mesh, microbatches=2)(shard_state(state, model, mesh), inp,
                                     labels)
    assert_same_training(one, gather_state(sharded), m_one, m_sharded, 1)
    assert mesh.collective_totals() == accounted_record(
        model, state, mesh, BATCH // shape[0] * SEQ, microbatches=2)


def test_training_collectives_on_hand_worked_shards():
    """``all_gather`` (to each slot), ``reduce_scatter`` and
    ``all_reduce`` over the data axis of a (2, 1) mesh: their values,
    float32 sums returned in the parts' dtype, and the record (each
    result's bytes over the mesh's two devices); ``collective_bytes``
    stays 0."""
    mesh = data_mesh(2)
    a = torch.arange(6.0).reshape(2, 3)
    b = torch.arange(6.0, 12.0).reshape(2, 3)
    whole = torch.cat([a, b], dim=1)
    assert all(torch.equal(mesh.all_gather([a, b], 1, axis="data",
                                           slot=slot), whole)
               for slot in (0, 1))
    assert mesh.collective_record == {("all-gather", "data"): 2 * 6 * 4}
    mesh.reset_collective_record()
    assert torch.equal(mesh.all_gather([a, b], 1, axis="data", slot=1),
                       whole)
    assert mesh.collective_record == {("all-gather", "data"): 2 * 6 * 4 / 2}
    parts = [torch.ones(4, 2, dtype=torch.bfloat16),
             torch.full((4, 2), 2.0, dtype=torch.bfloat16)]
    shards = mesh.reduce_scatter(parts, 0, axis="data")
    assert [s.shape for s in shards] == [(2, 2), (2, 2)]
    assert all(s.dtype == torch.bfloat16 and bool((s == 3).all())
               for s in shards)
    sums = mesh.all_reduce([a, b], axis="data")
    assert all(torch.equal(s, a + b) for s in sums)
    assert mesh.collective_record == {
        ("all-gather", "data"): 24.0, ("reduce-scatter", "data"): 8.0,
        ("all-reduce", "data"): 24.0}
    assert mesh.collective_totals() == (
        {"all-gather": 24.0, "reduce-scatter": 8.0, "all-reduce": 24.0},
        {"data": 56.0, "model": 0.0})
    assert mesh.collective_bytes == 0.0


def test_adamw_takes_a_precomputed_norm():
    """A tree's halves updated apart with the whole tree's norm give the
    whole tree's update and moments; without the norm each half clips by
    its own (the first moment shows it: Adam's first step does not)."""
    gen = torch.Generator().manual_seed(2)
    params = {"a": torch.randn(3, 4, generator=gen),
              "b": torch.randn(5, generator=gen)}
    grads = {k: 10 * torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    whole, opt, norm = adamw_update(params, grads, adamw_init(params),
                                    lr=1e-2)
    for key in params:
        part = {key: params[key]}
        got, got_opt, got_norm = adamw_update(
            part, {key: grads[key]}, adamw_init(part), lr=1e-2,
            grad_norm=norm)
        assert got_norm is norm
        torch.testing.assert_close(got[key], whole[key], rtol=0, atol=0)
        torch.testing.assert_close(got_opt.m[key], opt.m[key], rtol=0,
                                   atol=0)
        _, own, _ = adamw_update(part, {key: grads[key]}, adamw_init(part),
                                 lr=1e-2)
        assert not torch.equal(own.m[key], opt.m[key])


def test_remat_leaves_a_call_without_sharded_leaves_as_it_was(monkeypatch):
    """Without a ``LazyLeaf`` among its arguments ``remat`` checkpoints the
    function itself (the unsharded step and serving keep their bits);
    with one, the leaf is made inside the checkpointed call."""
    seen = []
    real = common.checkpoint
    monkeypatch.setattr(common, "checkpoint",
                        lambda fn, *a, **kw: seen.append(fn) or real(
                            fn, *a, **kw))
    fn = lambda p, x: p["w"] * x
    x = torch.ones(3, requires_grad=True)
    common.remat(fn, {"w": torch.full((3,), 2.0)}, x)
    assert seen == [fn]

    class Two(common.LazyLeaf):
        def make(self):
            return torch.full((3,), 2.0)
    out = common.remat(fn, {"w": Two()}, x)
    assert seen[1] is not fn and torch.equal(out, torch.full((3,), 2.0))
