"""The train step sharded over the data replicas of a single-controller
mesh: ZeRO-3 on the ``data`` axis of a ``(D, 1)`` ``("data", "model")``
mesh (``repro_torch.fft.distributed.Mesh``), the counterpart of the
reference's step jitted with the ``in_shardings`` of its train state.

**The state.** :func:`shard_state` places a ``TrainState`` (parameters,
both AdamW moments, counters) by the specs of ``train_state_specs`` fixed
for the mesh (``launch.specs.fix_tree``): a leaf whose fixed spec names
``data`` is split along that dim over the ``data`` slots (a
``ShardedTensor``), any other leaf is held whole on every slot (a
``ReplicatedTensor``).  :func:`gather_state` gives the ``TrainState``
back; checkpoints save it gathered and restore it onto any data mesh, or
unsharded (``runtime.checkpoint``).

**The step** (:func:`make_sharded_train_step`) runs ``make_train_step``'s
arithmetic with the global batch split over ``data``: replica r takes
rows [r B/D, (r+1) B/D) on slot r.  One process drives every slot, one
replica after another.  In replica r's forward:

* a sharded weight of the stacked layers (the family's ``REMAT_PARAMS``)
  is a :class:`GatheredLeaf`, which ``models.common.remat`` all-gathers
  onto slot r inside each layer's checkpointed call, and again in the
  recompute: two gathers a step, as the accounting counts;
* every other sharded weight (the embedding, the unembedding, zamba2's
  head layers and shared block) is gathered onto slot r once, before the
  forward, and held to the backward: one gather where the accounting
  counts two;
* a replicated leaf is slot r's copy.

The gather's backward hands replica r's whole gradient of the weight to
slot r.  After the replicas, the sharded leaves' gradients are
reduce-scattered to their shards and the replicated leaves' all-reduced,
summed in float32 (``Mesh.reduce_scatter``, ``Mesh.all_reduce``); the
loss and the gradient are the replicas' means.  The global gradient norm
is the root of an all-reduce of each slot's squared sum: its shards, and
on slot 0 the replicated leaves, so each is counted once.  Each slot then
updates its shards and its copies by AdamW clipped by that norm
(``adamw_update(grad_norm=)``).  ``microbatches`` > 1 splits each
replica's rows and accumulates float32 gradients on its slot, as
``make_train_step`` does.

**The collectives.** The mesh's ``collective_record`` of one step equals
``analysis.cost.collective_accounting`` of the fixed parameter specs
(kind ``"train"``, one replica's tokens) but for two departures: a weight
gathered once is gathered once, not twice, and the all-reduce carries 8
bytes more (the loss and the squared norm, float32 scalars).  With
``microbatches`` = k each weight is gathered k times as often.
:func:`accounted_record` is the accounting with these departures.

The gather's backward returns the replica's gradient of the whole
weight, and the reduce-scatter runs after the last replica: each slot
holds its replica's gradient of the whole model until then, not the
1/D that ZeRO-3 (and ``analysis.cost``'s memory) assumes.

Not here: the ``model`` axis (tensor parallelism), and an MoE
architecture on more than one data replica, whose routing statistics
(the Switch aux loss, the group size and with it capacity and drops) are
the whole batch's, not a replica's.  Both raise ``NotImplementedError``
naming ROADMAP.md queue 1 item 12e.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.analysis.cost import collective_accounting
from repro_torch.fft.distributed import (Mesh, ReplicatedTensor,
                                         ShardedTensor, replicate, shard)
from repro_torch.launch.specs import fix_tree
from repro_torch.models.api import Model, family_module
from repro_torch.models.common import (LazyLeaf, dtype_of, tree_items,
                                       tree_leaves, tree_map)
from repro_torch.optim.adamw import AdamWState, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.step import (AUX_WEIGHT, TrainState, loss_fn,
                                    train_state_specs)

AXIS = "data"


def check_mesh(model: Model, mesh: Mesh) -> int:
    """The mesh's number of data replicas; raises where the sharded step
    cannot run ``model`` on ``mesh``."""
    if tuple(mesh.axis_names) != (AXIS, "model"):
        raise ValueError(f"the sharded train step runs on a ('data', "
                         f"'model') mesh, not {mesh.axis_names}")
    check_sizes(model, mesh.shape[AXIS], mesh.shape["model"])
    return mesh.shape[AXIS]


def check_sizes(model: Model, d: int, m: int) -> None:
    """Raise ``NotImplementedError`` where the sharded step cannot run
    ``model`` on a (``d``, ``m``) (data, model) mesh."""
    if m > 1:
        raise NotImplementedError(
            f"a ({d}, {m}) mesh: tensor parallelism over 'model' is "
            "ROADMAP.md queue 1 item 12e; the sharded step runs (D, 1)")
    if d > 1 and model.cfg.moe is not None:
        raise NotImplementedError(
            f"{model.cfg.name} on {d} data replicas: an MoE layer's routing "
            "statistics are the whole batch's; all-reducing them is "
            "ROADMAP.md queue 1 item 12e")


def _data_dim(spec) -> int | None:
    """The dim a fixed spec splits over ``data``, or None."""
    for i, entry in enumerate(spec):
        if entry is not None and AXIS in ((entry,) if isinstance(entry, str)
                                          else entry):
            return i
    return None


def _leafwise(fn: Callable, *states) -> TrainState:
    """The ``TrainState`` of ``fn`` over the states' corresponding
    leaves."""
    over = lambda get: tree_map(fn, *map(get, states))
    return TrainState(
        params=over(lambda s: s.params),
        opt=AdamWState(step=over(lambda s: s.opt.step),
                       m=over(lambda s: s.opt.m), v=over(lambda s: s.opt.v)),
        step=over(lambda s: s.step))


def shard_state(state: TrainState, model: Model, mesh: Mesh) -> TrainState:
    """``state`` placed on ``mesh`` by the fixed ``train_state_specs``: a
    leaf split over ``data`` is a ``ShardedTensor``, any other leaf a
    ``ReplicatedTensor``."""
    check_mesh(model, mesh)
    fixed = fix_tree(state, train_state_specs(model), mesh)

    def place(leaf, spec):
        dim = _data_dim(spec)
        return (replicate(leaf, mesh, AXIS) if dim is None
                else shard(leaf, mesh, AXIS, dim))
    return _leafwise(place, state, fixed)


def gather_state(sharded: TrainState) -> TrainState:
    """The ``TrainState`` a sharded one holds, on the first slot's
    device."""
    return _leafwise(lambda leaf: leaf.gather(), sharded)


def slot_state(sharded: TrainState, p: int) -> TrainState:
    """What slot ``p`` holds of a sharded state: its shards and copies."""
    return _leafwise(lambda leaf: leaf.shards[p] if isinstance(
        leaf, ShardedTensor) else leaf.copies[p], sharded)


def accounted_record(model: Model, state: TrainState, mesh: Mesh,
                     tokens: int, microbatches: int = 1
                     ) -> tuple[dict[str, float], dict[str, float]]:
    """``collective_accounting`` of one step of ``state`` on ``mesh``
    (``tokens`` a replica), in ``Mesh.collective_totals``' form, with the
    executor's departures: a data-sharded leaf outside the family's
    ``REMAT_PARAMS`` is gathered once a microbatch, not twice (its bytes
    off the all-gathers); every leaf is gathered once a microbatch (the
    all-gathers times ``microbatches``); the loss and the squared
    gradient norm are all-reduced (8 bytes more, float32 scalars)."""
    fixed = fix_tree(state, train_state_specs(model), mesh).params
    by_kind, by_axis = collective_accounting(
        state.params, fixed, mesh, kind="train", tokens=tokens,
        act_bytes=dtype_of(model.cfg).itemsize)
    lazy = family_module(model.cfg).REMAT_PARAMS
    specs = dict(tree_items(fixed))
    once = sum(leaf.numel() * leaf.element_size()
               for path, leaf in tree_items(state.params)
               if path.split("/")[0] not in lazy
               and AXIS in specs[path].axes)
    gathered = (by_kind["all-gather"] - once) * microbatches
    by_axis[AXIS] += gathered - by_kind["all-gather"] + 8
    by_kind["all-gather"] = gathered
    by_kind["all-reduce"] += 8
    return by_kind, by_axis


class _Gather(torch.autograd.Function):
    """One replica's all-gather of a sharded weight onto its slot; the
    backward hands the whole gradient to the replica's sink."""

    @staticmethod
    def forward(ctx, sink, leaf: ShardedTensor, slot: int):
        return leaf.mesh.all_gather(leaf.shards, leaf.dim, axis=leaf.axis,
                                    slot=slot)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class GatheredLeaf(LazyLeaf):
    """Replica ``slot``'s use of the sharded weight ``leaf``: :meth:`make`
    all-gathers it onto the slot (recorded on the mesh).  ``sink`` stands
    in for the weight on the slot, holding no data (a zero expanded to the
    weight's shape); the gradient of the replica's loss with respect to
    it is the replica's gradient of the weight."""

    def __init__(self, leaf: ShardedTensor, slot: int,
                 sink: torch.Tensor | None = None):
        self.leaf = leaf
        self.slot = slot
        if sink is None:
            device = leaf.mesh.axis_devices(leaf.axis)[slot]
            sink = torch.zeros((), dtype=leaf.dtype, device=device).expand(
                leaf.shape).requires_grad_()
        self.sink = sink

    def make(self) -> torch.Tensor:
        return _Gather.apply(self.sink, self.leaf, self.slot)

    def unbind(self, dim: int = 0) -> list[GatheredLeaf]:
        """The layers' leaves of a stacked weight: dim 0 must not be the
        split one."""
        if dim != 0 or self.leaf.dim == 0:
            raise ValueError(f"a weight split along dim {self.leaf.dim} "
                             f"unbinds along dim 0 only, not {dim}")
        layers = zip(*(s.unbind(0) for s in self.leaf.shards))
        return [GatheredLeaf(ShardedTensor(tuple(shards), self.leaf.mesh,
                                           self.leaf.axis, self.leaf.dim - 1),
                             self.slot, sink)
                for shards, sink in zip(layers, self.sink.unbind(0))]


def make_sharded_train_step(model: Model, mesh: Mesh, *,
                            microbatches: int = 1, peak_lr: float = 3e-4
                            ) -> Callable:
    """Build ``train_step(state, inputs, labels) -> (state, metrics)`` on a
    state placed by :func:`shard_state`: ``make_train_step``'s arithmetic
    and metrics (``loss``, ``grad_norm``, ``lr``, on the first slot), the
    batch split over the ``data`` slots."""
    d = check_mesh(model, mesh)
    slots = mesh.axis_devices(AXIS)
    lazy_keys = set(family_module(model.cfg).REMAT_PARAMS)

    def replica_tree(params, r: int):
        """Replica r's parameter tree, and the tensors its gradients are
        taken with respect to, in the order of ``tree_leaves(params)``."""
        wrt: list[torch.Tensor] = []

        def leaf(t, lazy: bool):
            if isinstance(t, ReplicatedTensor):
                x = t.copies[r].detach().requires_grad_()
                wrt.append(x)
                return x
            g = GatheredLeaf(t, r)
            wrt.append(g.sink)
            return g if lazy else g.make()
        tree = {key: tree_map(lambda t, lazy=key in lazy_keys: leaf(t, lazy),
                              sub) for key, sub in params.items()}
        return tree, wrt

    def value_and_grad(params, r: int, inp, labels):
        tree, wrt = replica_tree(params, r)
        loss = loss_fn(model, tree, inp, labels, aux_weight=AUX_WEIGHT)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        # A parameter the loss does not reach has a zero gradient.
        return loss.detach(), [
            g if g is not None else torch.zeros(w.shape, dtype=w.dtype,
                                                device=w.device)
            for g, w in zip(grads, wrt)]

    def replica(params, r: int, inp, labels):
        """Replica r's summed loss and gradients over its microbatches."""
        if microbatches == 1:
            return value_and_grad(params, r, inp, labels)
        loss, grads = 0.0, None
        for i, l in zip(inp.reshape(microbatches, -1, *inp.shape[1:]),
                        labels.reshape(microbatches, -1, *labels.shape[1:])):
            mb_loss, mb_grads = value_and_grad(params, r, i, l)
            loss = loss + mb_loss
            grads = ([g.float() for g in mb_grads] if grads is None
                     else [a + b for a, b in zip(grads, mb_grads)])
        return loss, grads

    def train_step(state: TrainState, inp, labels):
        if inp.shape[0] % d:
            raise ValueError(f"a batch of {inp.shape[0]} rows does not "
                             f"split over {d} data replicas")
        rows = inp.shape[0] // d
        losses, per_replica = [], []
        with torch.enable_grad():
            for r, dev in enumerate(slots):
                part = slice(r * rows, (r + 1) * rows)
                loss, grads = replica(state.params, r, inp[part].to(dev),
                                      labels[part].to(dev))
                losses.append(loss)
                per_replica.append(grads)

        with torch.no_grad():
            n = d * microbatches
            leaves = tree_leaves(state.params)
            reduced = []            # per leaf: the mean gradient a slot
            for j, leaf in enumerate(leaves):
                parts = [g[j] for g in per_replica]
                for g in per_replica:
                    g[j] = None
                out = (mesh.reduce_scatter(parts, leaf.dim, axis=AXIS)
                       if isinstance(leaf, ShardedTensor)
                       else mesh.all_reduce(parts, axis=AXIS))
                reduced.append([o / n for o in out])
            loss = mesh.all_reduce(losses, axis=AXIS)[0] / n
            squares = []
            for p, dev in enumerate(slots):
                sq = torch.zeros((), dtype=torch.float32, device=dev)
                for leaf, g in zip(leaves, reduced):
                    if p == 0 or isinstance(leaf, ShardedTensor):
                        sq = sq + torch.sum(torch.square(g[p].float()))
                squares.append(sq)
            norms = [torch.sqrt(s) for s in
                     mesh.all_reduce(squares, axis=AXIS)]

            updated, lrs = [], []
            for p in range(d):
                local = slot_state(state, p)
                it = iter(g[p] for g in reduced)
                grads = tree_map(lambda _: next(it), local.params)
                lr = cosine_schedule(local.opt.step, peak_lr=peak_lr)
                new_params, new_opt, _ = adamw_update(
                    local.params, grads, local.opt, lr=lr,
                    grad_norm=norms[p])
                updated.append(TrainState(params=new_params, opt=new_opt,
                                          step=local.step + 1))
                lrs.append(lr)

        def assemble(like, *per_slot):
            if isinstance(like, ShardedTensor):
                return ShardedTensor(per_slot, mesh, AXIS, like.dim)
            return ReplicatedTensor(per_slot, mesh, AXIS)
        metrics = {"loss": loss, "grad_norm": norms[0], "lr": lrs[0]}
        return _leafwise(assemble, state, *updated), metrics

    return train_step
