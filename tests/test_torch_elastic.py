"""The port's elastic re-mesh planner (``repro_torch.runtime.elastic``)
field for field against the reference's, and the elastic restore path of
``repro_torch.runtime.checkpoint``: a sharded leaf saved on one mesh of
CPU slots restores onto the shrunk mesh the plan gives, and the same
checkpoint restores in the reference."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.runtime.checkpoint import CheckpointManager as RefCheckpoints
from repro.runtime.elastic import elastic_remesh_plan as ref_plan
from repro_torch.fft.distributed import ShardedTensor, make_mesh, shard
from repro_torch.runtime import (CheckpointManager, RemeshPlan,
                                 elastic_remesh_plan)

CPU = torch.device("cpu")
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((8,), ("data",)),
          ((2, 4), ("data", "model")))


@pytest.mark.parametrize("shape,names", MESHES)
def test_remesh_plan_identical_to_reference(shape, names):
    for n_failed in range(21):
        try:
            want = ref_plan(shape, names, n_failed)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                elastic_remesh_plan(shape, names, n_failed)
            continue
        got = elastic_remesh_plan(shape, names, n_failed)
        assert isinstance(got, RemeshPlan)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), n_failed


def test_remesh_plan_needs_a_data_axis():
    with pytest.raises(ValueError, match="shrinks the 'data' axis"):
        elastic_remesh_plan((4,), ("model",), 1)


def test_sharded_checkpoint_restores_on_the_shrunk_mesh(tmp_path):
    old = make_mesh((4,), ("data",), devices=[CPU] * 4)
    w = np.random.default_rng(0).standard_normal((12, 8)).astype(np.float32)
    tree = {"w": shard(torch.from_numpy(w), old, "data", 0),
            "step": torch.tensor(3)}
    CheckpointManager(str(tmp_path)).save(5, tree)
    plan = elastic_remesh_plan(tuple(old.shape.values()), old.axis_names,
                               n_failed=1)
    assert plan.new_mesh == (3,)
    new = make_mesh(plan.new_mesh, plan.axis_names, devices=[CPU] * 3)
    like = {"w": shard(torch.zeros(12, 8), new, "data", 0),
            "step": torch.tensor(0)}
    out = CheckpointManager(str(tmp_path)).restore(like)
    assert isinstance(out["w"], ShardedTensor) and out["w"].mesh is new
    assert [s.shape for s in out["w"].shards] == [(4, 8)] * 3
    assert np.array_equal(out["w"].gather().numpy(), w)
    assert int(out["step"]) == 3
    # the manifest is mesh-agnostic: the reference restores it whole
    ref = RefCheckpoints(str(tmp_path)).restore(
        {"w": np.zeros((12, 8), np.float32), "step": np.int64(0)})
    assert np.array_equal(np.asarray(ref["w"]), w)
    assert int(ref["step"]) == 3
