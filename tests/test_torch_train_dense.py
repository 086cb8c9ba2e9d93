"""The port's training step against the reference's for the dense decoders
(qwen2, codeqwen1.5, qwen1.5) and gemma3's 5:1 stack (the checks of
``_model_parity.TrainParity``), ``microbatches=2`` against the reference's,
the loss falling over 30 steps (the reference's claim), and the remat:
the bytes autograd keeps through ``forward_hidden``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _model_parity import (STEP_ATOL, STEP_RTOL, TrainParity, close, flat,
                           load_arch, one_torch_thread)  # noqa: F401
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.models import build_model, transformer
from repro_torch.models.common import tree_map, unstack
from repro_torch.train.step import init_train_state, make_train_step


@pytest.fixture(scope="module", params=["qwen2-0.5b", "codeqwen1.5-7b",
                                              "qwen1.5-4b", "gemma3-12b"])
def arch(request):
    return load_arch(request.param)


class TestTrainParity(TrainParity):
    pass


def test_microbatched_step_matches_the_reference():
    """``microbatches=2`` against the reference's ``microbatches=2`` (its
    ``lax.scan`` over float32 gradients), and against one batch within
    the reference test's tolerance."""
    arch = load_arch("qwen2-0.5b")
    inp, labels = arch.train_batch(batch=4)
    ref_step = jax.jit(ref_make_train_step(arch.ref, microbatches=2))
    ref_state, ref_m = ref_step(arch.ref_state(), inp, labels)
    args = (torch.from_numpy(inp), torch.from_numpy(labels))
    state, m = make_train_step(arch.model, microbatches=2)(
        arch.port_state(), *args)
    close(m["loss"], ref_m["loss"], 1e-5)
    close(m["grad_norm"], ref_m["grad_norm"])
    for a, b in zip(flat(state.opt.m), jax.tree.leaves(ref_state.opt.m)):
        close(a, b)
    one, m1 = make_train_step(arch.model)(arch.port_state(), *args)
    assert float(m1["loss"]) == pytest.approx(float(m["loss"]), rel=1e-3)
    for a, b in zip(flat(one.opt.m), flat(state.opt.m)):
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)


def test_train_loop_loss_decreases():
    """The reference's claim: 30 steps on the tiny qwen2 at peak lr 1e-2
    reduce the loss on the synthetic motif."""
    cfg = ARCHS["qwen2-0.5b"].reduced()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(model, peak_lr=1e-2)
    losses = []
    for inp, lab in synthetic_batches(cfg.vocab, 32, 4, 30, seed=7):
        state, m = step(state, torch.from_numpy(inp).long(),
                        torch.from_numpy(lab).long())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::10]


def _saved_bytes(fn) -> int:
    """Bytes of the distinct tensors autograd saves for backward while
    ``fn`` runs (inside a rematerialised call the checkpoint's own hooks
    take them, so they are not counted)."""
    seen = {}

    def pack(t):
        seen[id(t)] = t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_remat_keeps_the_carries_not_the_activations():
    """Through ``forward_hidden`` autograd keeps a few (B, S, d) carries,
    far below what the layers would keep unrematerialised."""
    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(), n_layers=4)
    model = build_model(cfg)
    params = tree_map(lambda t: t.detach().requires_grad_(),
                      model.init(torch.Generator().manual_seed(0),
                                 "cpu").tree())
    b, s = 2, 64
    inp = torch.randint(0, cfg.vocab, (b, s),
                        generator=torch.Generator().manual_seed(1))
    kept = _saved_bytes(lambda: model.forward_hidden(params, inp))
    x = params["embed"][inp]
    pos = torch.arange(s).expand(b, s)
    layer = _saved_bytes(lambda: transformer._layer_forward(
        unstack(params["layers"], cfg.n_layers)[0], x, pos, cfg,
        window=None, moe_layer=False))
    carry = b * s * cfg.d_model * 4
    assert kept <= 8 * carry, (kept, carry)
    assert kept <= 0.1 * cfg.n_layers * layer, (kept, layer)
    with torch.no_grad():
        assert _saved_bytes(lambda: model.forward_hidden(params, inp)) == 0
