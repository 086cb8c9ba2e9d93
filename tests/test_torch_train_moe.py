"""The port's training step against the reference's for the MoE models
(dbrx; deepseek-v2-lite with MLA and a dense first layer): the checks of
``_model_parity.TrainParity``, the aux loss weighted in; and the sharded
step on a (2, 2) mesh of CPU slots (expert and tensor parallelism, the
whole batch's routing) against the reference's jitted steps, whose run
this process has already made."""
import jax
import numpy as np
import pytest
import torch

from _model_parity import (LOSS_RTOL, STEP_ATOL, STEP_RTOL, TrainParity,
                           close, flat, load_arch,
                           one_torch_thread)  # noqa: F401
from repro_torch.fft.distributed import make_mesh
from repro_torch.train.sharded import (gather_state, make_sharded_train_step,
                                       shard_state)


@pytest.fixture(scope="module", params=["dbrx-132b", "deepseek-v2-lite-16b"])
def arch(request):
    return load_arch(request.param)


class TestTrainParity(TrainParity):
    def test_moe_mesh_steps_equal_the_references_steps(self, arch):
        """From the reference's initial state on a (2, 2) mesh: the
        reference's jitted ``make_train_step``, twice."""
        want = arch.ref_train
        mesh = make_mesh((2, 2), ("data", "model"),
                         devices=[torch.device("cpu")] * 4)
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
