"""The training step: loss, gradients, AdamW, with microbatching (the
counterpart of ``repro.train.step``).

DVFS integration (the paper's technique as a first-class feature): the
launcher prices this step with the DVFS model (``launch.train
--dvfs-report``): the step's roofline profile decides the energy-optimal
clock, as the paper's Sec. 5.3 NVML calls lock the clock around the cuFFT
invocation.

The reference's ``jax.value_and_grad`` of a jitted step becomes
``torch.autograd.grad``: the parameters stay a nested dict of tensors in
the reference's layout (``LanguageModel.tree()``), which the family
functions take as they take a module, and each step makes its own
gradient leaves (``detach().requires_grad_()``), so the parameters carry
no graph between steps.  The layers and the cross-entropy chunks are
rematerialised in backward (``models.common.remat``), as the reference's
are under ``jax.checkpoint``.  :func:`train_state_specs` gives the
state's PartitionSpecs, which the dry run (``launch.dryrun``) prices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.api import Model, resolve_device
from repro_torch.models.common import (P, chunked_cross_entropy,
                                       tree_leaves, tree_map)
from repro_torch.models.convert import (params_to_reference,
                                        tensors_from_reference)
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     optimizer_specs)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime.checkpoint import tree_dataclass


@tree_dataclass
@dataclasses.dataclass
class TrainState:
    params: Any                 # nested dict of tensors, reference layout
    opt: AdamWState
    step: torch.Tensor          # int32, 0-d


def init_train_state(model: Model, gen: torch.Generator, device=None
                     ) -> TrainState:
    """Parameters drawn from ``gen`` (``model.init``) on ``device`` (the
    card unless the caller asks for the CPU), zero moments, step 0."""
    params = tree_map(lambda t: t.detach(), model.init(gen, device).tree())
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def train_state_specs(model: Model) -> TrainState:
    """The train state's PartitionSpecs: the moments mirror the params."""
    ps = model.param_specs()
    return TrainState(params=ps, opt=optimizer_specs(ps), step=P())


def loss_fn(model: Model, params, inp, labels, *, aux_weight: float
            ) -> torch.Tensor:
    """Mean token cross-entropy of ``labels`` plus ``aux_weight`` times
    the MoE load-balancing loss."""
    hidden, aux = model.forward_hidden(params, inp)
    ce = chunked_cross_entropy(lambda h: model.unembed(params, h), hidden,
                               labels)
    return ce + aux_weight * aux


#: The weight of the MoE load-balancing loss in the train steps' loss.
AUX_WEIGHT = 0.01


def make_train_step(model: Model, *, microbatches: int = 1,
                    aux_weight: float = AUX_WEIGHT, peak_lr: float = 3e-4
                    ) -> Callable:
    """Build ``train_step(state, inputs, labels) -> (state, metrics)``.

    ``microbatches`` > 1 accumulates float32 gradients over sequential
    microbatches (the reference's ``lax.scan``) — activation memory drops
    by the factor, the weights are read again each microbatch.  The
    metrics are 0-d tensors: ``loss``, ``grad_norm`` (before the clip)
    and ``lr`` (the schedule at the step before the update)."""

    def value_and_grad(params, inp, labels):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        loss = loss_fn(model, leaves, inp, labels, aux_weight=aux_weight)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # A parameter the loss does not reach (an embeds-input model's
        # table) has a zero gradient, as ``jax.grad`` gives it.
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads, flat))
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(state: TrainState, inp, labels):
        with torch.enable_grad():
            if microbatches == 1:
                loss, grads = value_and_grad(state.params, inp, labels)
            else:
                mb_inp = inp.reshape(microbatches, -1, *inp.shape[1:])
                mb_lab = labels.reshape(microbatches, -1, *labels.shape[1:])
                loss = torch.zeros((), dtype=torch.float32,
                                   device=inp.device)
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device),
                    state.params)
                for i, l in zip(mb_inp, mb_lab):
                    mb_loss, mb_grads = value_and_grad(state.params, i, l)
                    loss = loss + mb_loss
                    grads = tree_map(torch.add, grads, mb_grads)
                loss = loss / microbatches
                grads = tree_map(lambda g: g / microbatches, grads)

        with torch.no_grad():
            lr = cosine_schedule(state.opt.step, peak_lr=peak_lr)
            new_params, new_opt, gnorm = adamw_update(state.params, grads,
                                                      state.opt, lr=lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


def map_state(fn: Callable, state) -> TrainState:
    """A ``TrainState`` of ``fn`` over each of ``state``'s trees (the
    parameters, the moments) and counters; ``state`` may be any object
    with the fields."""
    return TrainState(params=fn(state.params),
                      opt=AdamWState(step=fn(state.opt.step),
                                     m=fn(state.opt.m), v=fn(state.opt.v)),
                      step=fn(state.step))


def state_from_reference(tree, device=None) -> TrainState:
    """The reference's ``TrainState`` (numpy leaves, or anything
    ``np.asarray`` reads; any object with its fields) as the port's on
    ``device`` (the card unless the caller asks for the CPU); bf16
    travels as its bits (``models.convert``)."""
    device = resolve_device(device)
    return map_state(lambda t: tensors_from_reference(t, device), tree)


def state_to_reference(state: TrainState) -> TrainState:
    """The state with numpy leaves in the reference's layout (bf16 as
    ``ml_dtypes.bfloat16``), from whose fields the reference's
    ``TrainState`` is built.  The round trip is bit-identical."""
    return map_state(params_to_reference, state)
