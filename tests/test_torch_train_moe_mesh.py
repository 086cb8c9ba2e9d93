"""Expert parallelism over ``model`` and MoE on data meshes in the sharded
train step (``repro_torch.train.sharded``): reduced float32 dbrx and
deepseek-v2-lite (MLA, shared experts, a dense first layer) on (2, 1),
(1, 2) and (2, 2) meshes of CPU slots, against the port's unsharded step
(``train.step``, one microbatch: the reference's sharded step routes the
whole batch at once), which ``tests/test_torch_train_moe.py`` holds to
the reference's ``make_train_step``; that file also holds the (2, 2)
step to the reference's own jitted steps, whose run its process has
already made.

An MoE layer routes the whole batch's groups: the group size comes from
the global token count, the aux loss from the whole batch's statistics
(each replica's ``frac`` all-reduced over ``data``), and a group that
spans two replicas (2 x 4 tokens on 2x1 with reduced groups of 8; 2 x 12
tokens, groups 8..15 across the boundary) hands its expert counts on.
Two steps each within ``_model_parity.TrainParity``'s tolerances, and the
mesh's record of a step equal to ``train.sharded.accounted_record``."""
import numpy as np
import pytest
import torch

from _model_parity import (AUX_ATOL, LOSS_RTOL, assert_same_training,
                           close, one_torch_thread)  # noqa: F401
from repro_torch.configs import ARCHS
from repro_torch.fft.distributed import make_mesh
from repro_torch.models import build_model
from repro_torch.train import sharded as sharded_step
from repro_torch.train.sharded import (accounted_record, gather_state,
                                       make_sharded_train_step, shard_state)
from repro_torch.train.step import init_train_state, make_train_step

CPU = torch.device("cpu")
MOE = ["dbrx-132b", "deepseek-v2-lite-16b"]


def mesh_of(d: int, m: int):
    return make_mesh((d, m), ("data", "model"), devices=[CPU] * (d * m))


def setup(name: str, batch: int, seq: int, seed: int = 0):
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(seed), CPU)
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (batch, seq + 1)))
    return model, state, tokens[:, :-1], tokens[:, 1:]




def train_both(name: str, d: int, m: int, batch: int = 4, seq: int = 16,
               microbatches: int = 1):
    """Two steps on a (d, m) mesh against two unsharded steps with the
    same microbatches from one state and batch; the second step's record
    against the accounting, which it returns."""
    model, state, inp, labels = setup(name, batch, seq)
    mesh = mesh_of(d, m)
    one_step = make_train_step(model, microbatches=microbatches)
    step = make_sharded_train_step(model, mesh, microbatches=microbatches)
    one, sharded = state, shard_state(state, model, mesh)
    for i in (1, 2):
        one, m_one = one_step(one, inp, labels)
        mesh.reset_collective_record()
        sharded, m_sharded = step(sharded, inp, labels)
        assert_same_training(one, gather_state(sharded), m_one, m_sharded, i)
    record = mesh.collective_totals()
    assert record == accounted_record(model, state, mesh,
                                      batch // d * seq, microbatches)
    return record


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("name", MOE)
def test_moe_steps_equal_the_unsharded_steps(name, shape):
    """Whole groups on each replica; on (1, 2) and (2, 2) each model slot
    runs 2 of the 4 experts and the combine is all-reduced."""
    record = train_both(name, *shape)
    assert "collective-permute" not in record[0]


@pytest.mark.parametrize("name,shape,batch,seq", [
    ("dbrx-132b", (2, 1), 2, 4), ("dbrx-132b", (2, 2), 2, 12),
    ("deepseek-v2-lite-16b", (2, 1), 2, 12),
    ("deepseek-v2-lite-16b", (2, 2), 2, 4)])
def test_groups_that_span_replicas(name, shape, batch, seq):
    """2 x 4 tokens: one group of 8 over both replicas; 2 x 12 tokens:
    groups of 8, the second across the replicas' boundary.  The later
    replica's capacity positions start after the earlier one's counts,
    which its model slots get from the earlier replica's
    (``collective-permute`` over ``data``)."""
    record = train_both(name, *shape, batch=batch, seq=seq)
    assert record[0]["collective-permute"] > 0


def test_microbatches_route_each_microbatch_whole():
    """``microbatches=2`` on (2, 1) at 4 x 12 tokens: microbatch i is rows
    [2 i, 2 i + 2) over both replicas, as in the unsharded step, each
    microbatch's groups spanning the replicas."""
    train_both("dbrx-132b", 2, 1, seq=12, microbatches=2)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("name", MOE)
def test_the_aux_loss_is_the_whole_batchs(name, shape, monkeypatch):
    """The sharded step's loss with the aux weight 1, less its loss with
    the weight 0, is the unsharded forward's aux loss over the whole
    batch (2 x 4 tokens, one group spanning the replicas), and that loss
    equals the unsharded step's with the weight 1."""
    model, state, inp, labels = setup(name, 2, 4)
    mesh = mesh_of(*shape)
    losses = {}
    for weight in (0.0, 1.0):
        monkeypatch.setattr(sharded_step, "AUX_WEIGHT", weight)
        step = make_sharded_train_step(model, mesh)
        _, metrics = step(shard_state(state, model, mesh), inp, labels)
        losses[weight] = float(metrics["loss"])
    _, want = model.forward_hidden(state.params, inp)
    assert abs(losses[1.0] - losses[0.0] - float(want)) <= AUX_ATOL
    _, m_one = make_train_step(model, aux_weight=1.0)(state, inp, labels)
    close(losses[1.0], m_one["loss"], LOSS_RTOL)
