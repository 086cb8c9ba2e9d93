"""Tensor parallelism over ``model`` in the sharded train step
(``repro_torch.train.sharded``) for the dense transformer family, on
(data, model) meshes of CPU slots, against the port's unsharded step
(``train.step``), which ``tests/test_torch_train_*.py`` hold to the
reference's ``make_train_step``.

Reduced float32 qwen2 (GQA, qkv bias, tied embeddings), gemma3 (5:1
sliding windows, its groups rematerialised whole), pixtral (embeddings
input, untied ``lm_head``) and musicgen on (1, 2) and (2, 2) meshes, and
qwen2 on (1, 4), where its 2 key/value heads are fewer than the slots:
two steps each within ``_model_parity.TrainParity``'s tolerances, and the
mesh's (kind, axis) record of a step equal to
``train.sharded.accounted_record``.  Also: leaves the slots use whole
(heads that do not divide over the slots, an MLP width that
``fix_sharding`` moves off its dim), the mesh's collectives over a line
of a two-axis mesh by hand (values, float32 sums in the parts' dtype,
their backwards), the two-axis placement and checkpoints across 2x2,
1x1 and 1x2."""
import dataclasses

import numpy as np
import pytest
import torch

from _model_parity import (assert_same_training, flat,
                           one_torch_thread)  # noqa: F401
from repro_torch.configs import ARCHS
from repro_torch.fft.distributed import PlacedTensor, make_mesh, place
from repro_torch.launch.specs import fix_tree
from repro_torch.models import build_model, transformer
from repro_torch.runtime import CheckpointManager
from repro_torch.train.sharded import (accounted_record, gather_state,
                                       make_sharded_train_step, shard_state,
                                       slot_state)
from repro_torch.train.step import init_train_state, make_train_step

CPU = torch.device("cpu")
BATCH, SEQ = 4, 16
DENSE = ["qwen2-0.5b", "gemma3-12b", "pixtral-12b", "musicgen-medium"]


def mesh_of(d: int, m: int):
    return make_mesh((d, m), ("data", "model"), devices=[CPU] * (d * m))


def setup(cfg, seed: int = 0):
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(seed), CPU)
    rng = np.random.default_rng(seed + 1)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ)))
    if cfg.input_mode == "embeds":
        inp = torch.from_numpy(rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32))
    else:
        inp = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ)))
    return model, state, inp, labels




def train_both(cfg, d: int, m: int, microbatches: int = 1) -> None:
    """Two steps on a (d, m) mesh against two unsharded steps from the
    same state and batch; the second step's record against the
    accounting."""
    model, state, inp, labels = setup(cfg)
    mesh = mesh_of(d, m)
    one_step = make_train_step(model, microbatches=microbatches)
    step = make_sharded_train_step(model, mesh, microbatches=microbatches)
    one, sharded = state, shard_state(state, model, mesh)
    for i in (1, 2):
        one, m_one = one_step(one, inp, labels)
        mesh.reset_collective_record()
        sharded, m_sharded = step(sharded, inp, labels)
        assert_same_training(one, gather_state(sharded), m_one, m_sharded, i)
    assert mesh.collective_totals() == accounted_record(
        model, state, mesh, BATCH // d * SEQ, microbatches=microbatches)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", DENSE)
def test_tensor_parallel_steps_equal_the_unsharded_steps(name, shape):
    train_both(ARCHS[name].reduced(), *shape)


def test_fewer_kv_heads_than_model_slots():
    """qwen2 on (1, 4): 4 query heads, one a slot, 2 key/value heads.
    The fixed spec splits ``w_k`` (64, 32) over the 4 slots inside a
    head, so the slots use it whole (each its group's head) and the
    queries' blocks; the record has the gathers over ``model``."""
    cfg = ARCHS["qwen2-0.5b"].reduced()
    model = build_model(cfg)
    mesh = mesh_of(1, 4)
    shapes = model.param_shapes()
    blocks = transformer.tp_blocks(
        cfg, shapes, fix_tree(shapes, model.param_specs(), mesh), 4)
    assert blocks["layers/attn/w_q"] and blocks["layers/attn/b_q"]
    assert not any(blocks[f"layers/attn/{n}"]
                   for n in ("w_k", "b_k", "w_v", "b_v"))
    assert blocks["layers/attn/w_o"] and blocks["embed"]
    train_both(cfg, 1, 4)


def test_leaves_the_slots_use_whole():
    """A reduced qwen2 with 3 query heads of 16 (1 key/value head) and an
    MLP width of 129 on (1, 2): the heads do not divide over the slots, so
    every slot runs every head and takes its rows of ``w_o``; the MLP's
    ``model`` axis ``fix_sharding`` moves onto d_model, so its weights are
    gathered and it runs whole; both train as the unsharded step."""
    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(), n_heads=3,
                              n_kv_heads=1, head_dim=16, d_ff=129)
    model = build_model(cfg)
    mesh = mesh_of(1, 2)
    shapes = model.param_shapes()
    fixed = fix_tree(shapes, model.param_specs(), mesh)
    assert tuple(fixed["layers"]["mlp"]["w_gate"]) == (None,
                                                      ("data", "model"))
    blocks = transformer.tp_blocks(cfg, shapes, fixed, 2)
    assert not blocks["layers/attn/w_q"] and blocks["layers/attn/w_o"]
    assert not blocks["layers/mlp/w_gate"]
    train_both(cfg, 1, 2)


def test_two_axis_placement_and_checkpoints(tmp_path):
    """On (2, 2): ``w_q`` (P(None, 'data', 'model')) in four blocks, the
    embedding (P('model', 'data')) vocab-major, a norm on every slot;
    gathering gives the state back bit for bit; a step on 2x2 saved,
    restored unsharded (1x1) and on 1x2, where the next step equals the
    unsharded one."""
    cfg = ARCHS["qwen2-0.5b"].reduced()
    model, state, inp, labels = setup(cfg)
    mesh = mesh_of(2, 2)
    sharded = shard_state(state, model, mesh)
    w_q = sharded.params["layers"]["attn"]["w_q"]
    assert isinstance(w_q, PlacedTensor)
    assert tuple(w_q.spec) == (None, "data", "model")
    local = slot_state(sharded, mesh.slot_of({"data": 1, "model": 0}))
    torch.testing.assert_close(
        local.params["layers"]["attn"]["w_q"],
        state.params["layers"]["attn"]["w_q"][:, 32:, :32], rtol=0, atol=0)
    torch.testing.assert_close(
        local.params["embed"], state.params["embed"][:128, 32:], rtol=0,
        atol=0)
    assert len({id(s) for s in sharded.params["final_norm"].shards}) == 4
    for a, b in zip(flat(gather_state(sharded)), flat(state)):
        np.testing.assert_array_equal(a, b)

    on22, _ = make_sharded_train_step(model, mesh)(sharded, inp, labels)
    CheckpointManager(str(tmp_path / "2x2")).save(1, on22)
    plain = CheckpointManager(str(tmp_path / "2x2")).restore(state, 1)
    for a, b in zip(flat(plain), flat(gather_state(on22))):
        np.testing.assert_array_equal(a, b)
    CheckpointManager(str(tmp_path / "1x1")).save(1, plain)
    mesh12 = mesh_of(1, 2)
    on12 = CheckpointManager(str(tmp_path / "1x1")).restore(
        shard_state(state, model, mesh12), 1)
    assert on12.params["embed"].mesh is mesh12
    for a, b in zip(flat(gather_state(on12)), flat(plain)):
        np.testing.assert_array_equal(a, b)
    on12, m12 = make_sharded_train_step(model, mesh12)(on12, inp, labels)
    one, m1 = make_train_step(model)(plain, inp, labels)
    assert_same_training(one, gather_state(on12), m1, m12, 2)


def test_microbatches_on_a_two_axis_mesh():
    """``microbatches=2`` on (2, 2): the unsharded step with two
    microbatches, every weight gathered twice as often."""
    train_both(ARCHS["qwen2-0.5b"].reduced(), 2, 2, microbatches=2)


def test_collectives_on_a_line_of_a_two_axis_mesh():
    """On a (2, 3) mesh: the line of ``model`` at data index 1 is slots
    3..5; ``all_gather``, ``reduce_scatter`` and ``all_reduce`` over it
    and over a data line; ``send``; each result's bytes over the mesh's
    six devices on the record."""
    devs = [torch.device("cpu", i) for i in range(6)]
    mesh = make_mesh((2, 3), ("data", "model"), devices=devs)
    assert mesh.line_slots("model", {"data": 1}) == [3, 4, 5]
    assert mesh.axis_devices("data", {"model": 2}) == [devs[2], devs[5]]
    assert mesh.index_of(4) == {"data": 1, "model": 1}
    assert mesh.slot_of({"data": 1, "model": 2}) == 5
    a, b, c = (torch.full((2,), float(v)) for v in (1, 2, 3))
    assert torch.equal(mesh.all_gather([a, b, c], 0, axis="model", slot=2,
                                       at={"data": 1}),
                       torch.tensor([1.0, 1, 2, 2, 3, 3]))
    parts = [torch.full((3, 2), 1.0, dtype=torch.bfloat16),
             torch.full((3, 2), 2.0 ** -8, dtype=torch.bfloat16),
             torch.full((3, 2), 2.0 ** -8, dtype=torch.bfloat16)]
    # bf16 holds 1 + 2^-7 but not 1 + 2^-8: a float32 sum keeps the two
    # small parts, a bf16 one in order would drop each.
    sums = mesh.all_reduce(parts, axis="model", at={"data": 1})
    assert all(s.dtype == torch.bfloat16 and bool((s == 1 + 2.0 ** -7).all())
               for s in sums)
    shards = mesh.reduce_scatter([torch.arange(6.0)] * 2, 0, axis="data",
                                 at={"model": 1})
    assert [s.tolist() for s in shards] == [[0.0, 2, 4], [6.0, 8, 10]]
    top = mesh.all_reduce([a, c], axis="data", at={"model": 0}, op="max")
    assert all(torch.equal(t, c) for t in top)
    x = torch.arange(4)
    sent = mesh.send(x, axis="data", dst=1, at={"model": 2})
    assert sent is not x and sent.tolist() == [0, 1, 2, 3]
    assert mesh.collective_totals() == (
        {"all-gather": 24 / 6, "all-reduce": 3 * 12 / 6 + 2 * 8 / 6,
         "reduce-scatter": 2 * 12 / 6, "collective-permute": 32 / 6},
        {"data": 2 * 12 / 6 + 2 * 8 / 6 + 32 / 6,
         "model": 24 / 6 + 3 * 12 / 6})


def test_line_collectives_and_their_backwards():
    """``MeshLine``'s autograd collectives on the model line at data index
    1 of a (2, 2) mesh: the all-reduce of partial sums (backward: the
    all-reduce of the cotangents), the all-gather (backward: the
    reduce-scatter), the copy of a replicated value (backward: the sum),
    the max without a gradient; each forward and backward recorded under
    its (kind, 'model'); a line of one slot is the identity."""
    mesh = mesh_of(2, 2)
    line = mesh.line("model", {"data": 1})
    x = [torch.tensor([1.0, 2.0], requires_grad=True),
         torch.tensor([3.0, 5.0], requires_grad=True)]
    s = line.all_reduce(x)
    assert all(t.tolist() == [4.0, 7.0] for t in s)
    grads = torch.autograd.grad(s[0].sum() + 2 * s[1][1], x)
    assert all(g.tolist() == [1.0, 3.0] for g in grads)
    assert mesh.collective_record == {("all-reduce", "model"): 2 * 2 * 8 / 4}
    mesh.reset_collective_record()
    g = line.all_gather(x, 0)
    assert all(t.tolist() == [1.0, 2.0, 3.0, 5.0] for t in g)
    grads = torch.autograd.grad(g[0][0] + g[1][3], x)
    assert [t.tolist() for t in grads] == [[1.0, 0.0], [0.0, 1.0]]
    assert mesh.collective_record == {("all-gather", "model"): 2 * 16 / 4,
                                      ("reduce-scatter", "model"): 2 * 8 / 4}
    mesh.reset_collective_record()
    v = torch.tensor([2.0], requires_grad=True)
    copies = line.copy(v)
    (grad,) = torch.autograd.grad(3 * copies[0] + 4 * copies[1], [v])
    assert grad.tolist() == [7.0]
    assert mesh.collective_record == {("all-reduce", "model"): 2 * 4 / 4}
    top = line.all_reduce_max(x)
    assert all(t.tolist() == [3.0, 5.0] and not t.requires_grad
               for t in top)
    one = mesh_of(2, 1).line("model", {"data": 1})
    assert all(a is b for a, b in zip(one.all_reduce(x), x))
    assert all(a is b for a, b in zip(one.all_gather(x, 0), x))


def test_place_and_gather_by_a_two_axis_spec():
    """``place`` by P(('model', 'data'), None): dim 0 split over both
    axes, model major; a spec naming no axis copies; ``gather`` gives the
    tensor back."""
    mesh = mesh_of(2, 2)
    x = torch.arange(16.0).reshape(8, 2)
    t = place(x, mesh, (("model", "data"), None))
    assert [s[:, 0].tolist() for s in t.shards] == [
        [0.0, 2.0], [8.0, 10.0], [4.0, 6.0], [12.0, 14.0]]
    assert t.shape == (8, 2) and torch.equal(t.gather(), x)
    r = place(x, mesh, ())
    assert all(torch.equal(s, x) for s in r.shards)
    assert torch.equal(r.gather(), x)
