"""The train step sharded over a single-controller ``("data", "model")``
mesh (``repro_torch.fft.distributed.Mesh``): ZeRO-3 over ``data``, tensor
and expert parallelism over ``model``, the counterpart of the reference's
step jitted with the ``in_shardings`` of its train state on
``jax.make_mesh((D, M), ("data", "model"))``.

**The state.** :func:`shard_state` places a ``TrainState`` (parameters,
both AdamW moments, counters) by the specs of ``train_state_specs`` fixed
for the mesh (``launch.specs.fix_tree``).  On a ``(D, 1)`` mesh a leaf
whose fixed spec names ``data`` is split along that dim over the ``data``
slots (a ``ShardedTensor``), any other leaf is held whole on every slot
(a ``ReplicatedTensor``).  With a model axis every leaf is a
``PlacedTensor``: slot (r, m) holds the block at data index r and model
index m of the dims its spec splits, a copy along an axis the spec does
not name.  :func:`gather_state` gives the ``TrainState`` back;
checkpoints save it gathered and restore it onto any mesh, or unsharded
(``runtime.checkpoint``).

**The step** (:func:`make_sharded_train_step`) runs ``make_train_step``'s
arithmetic with the global batch split over ``data``: microbatch i of k
is rows [i B/k, (i+1) B/k), as in the reference's scan, and replica r
takes the r-th D-th of them.  One process drives every slot, one replica
after another, and within a replica its model slots one after another
(no threads: autograd's device threads would deadlock on a collective's
barrier in a backward).  In replica r's forward each leaf is a
:class:`SlotLeaf`, its value on each of the replica's model slots:

* a leaf split over ``data`` is all-gathered over the data line of each
  model slot (r, m), down to the slot's model block: inside each
  rematerialised layer for the stacked layers (the family's
  ``REMAT_PARAMS``), and again in the recompute, as the accounting
  counts; once, before the forward, for any other leaf;
* a leaf whose model block the family cannot use (its ``tp_blocks``:
  key/value heads fewer than the slots, MLA's ``w_dkv``, mamba2's
  ``in_proj`` and conv, whose blocks split [z | x | B | C | dt] off the
  SSM head boundaries, zamba2's ``site_proj``, an axis ``fix_sharding``
  moved) is then all-gathered over the model line, whose backward
  reduce-scatters its gradient back to the blocks;
* a replicated leaf is the slot's copy.

The data gather's backward hands each slot's gradient of its block to
the slot.  Each family runs its ``forward_loss_slots``
(``models.transformer``, ``models.mamba2``, ``models.zamba2``):
Megatron's layout, the activations replicated over a replica's model
slots, a partial sum of each row-parallel product (``w_o``, ``w_down``,
mamba2's ``out_proj``), of the expert-parallel MoE combine and of the
vocab-parallel embedding all-reduced over ``model`` once, mamba2's SSM
heads split over the slots with ``gate_norm``'s sums of squares
all-reduced, the loss taken once a replica (on slot (r, 0)); on one
model slot it is the unsharded forward.

**MoE on a data mesh.** An MoE layer's groups are those of the whole
microbatch's tokens, so its group size (with it capacity and drops) comes
from the global token count, and a group may span two replicas: there,
the later replica's capacity positions start after the earlier
replicas' per-expert counts in that group, handed on from slot (r-1, m)
to slot (r, m) (a ``collective-permute`` over ``data``).  The Switch aux
loss takes the fraction of tokens each expert takes first (``frac``,
which has no gradient) and the mean router probability over the whole
microbatch: every replica's forward runs first (the rematerialised layers
keep only their inputs), the replicas' ``frac`` are all-reduced over
``data``, and then each replica's backward runs with its aux term
``E * sum(frac_global * probs_mean_replica)``, whose mean over the
replicas is the global aux loss exactly.

**After the replicas** each leaf's gradients are reduce-scattered over
each data line to their shards (a leaf split over ``data``) or
all-reduced over it, and a leaf replicated over ``model`` has its model
slots' gradients (each slot's share of its use) all-reduced over each
model line; sums in float32 (``Mesh.reduce_scatter``,
``Mesh.all_reduce``); the loss and the gradient are the replicas' means.
The global gradient norm is the root of each slot's squared sum (its
blocks, and a replicated leaf on the first slot of its axes only)
all-reduced over ``model`` and then ``data``.  Each slot then updates
its blocks and copies by AdamW clipped by that norm
(``adamw_update(grad_norm=)``).  ``microbatches`` > 1 accumulates each
slot's float32 gradients.  Each slot holds its replica's gradient of its
model block until the reduce-scatter, not the 1/D that ZeRO-3 (and
``analysis.cost``'s memory) assumes.

**The collectives.** The mesh's ``collective_record`` of one step equals
``analysis.cost.collective_accounting`` of the fixed parameter specs
(kind ``"train"``, one replica's tokens, the router's k) with the
departures that :func:`accounted_record` states as formulas.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.analysis.cost import collective_accounting
from repro_torch.fft.distributed import (Mesh, PlacedTensor,
                                         ReplicatedTensor, ShardedTensor,
                                         place, replicate, shard)
from repro_torch.launch.specs import fix_tree
from repro_torch.models.api import Model, family_module
from repro_torch.models.common import (LazyLeaf, Slots, dtype_of,
                                       tree_items, tree_map)
from repro_torch.models.moe import _group_size
from repro_torch.optim.adamw import AdamWState, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.step import (AUX_WEIGHT, TrainState,
                                    train_state_specs)

AXIS = "data"
MODEL = "model"


def check_mesh(mesh: Mesh) -> tuple[int, int]:
    """The mesh's (data, model) sizes; raises where its axes are not
    ``("data", "model")``."""
    if tuple(mesh.axis_names) != (AXIS, MODEL):
        raise ValueError(f"the sharded train step runs on a ('data', "
                         f"'model') mesh, not {mesh.axis_names}")
    return mesh.shape[AXIS], mesh.shape[MODEL]


def _dims(leaf: PlacedTensor) -> tuple[int | None, int | None]:
    """The dims of a placed leaf split over ``data`` and over ``model``
    (None: not split, or an axis of one slot)."""
    found = {AXIS: None, MODEL: None}
    for i, axes in enumerate(leaf.entries):
        for a in axes:
            if leaf.mesh.shape[a] > 1:
                found[a] = i
    return found[AXIS], found[MODEL]


def _check_specs(fixed, mesh: Mesh) -> None:
    """A data gather concatenates a dim's blocks, so where one dim splits
    over both axes ``model`` must be the major one."""
    if mesh.shape[AXIS] == 1 or mesh.shape[MODEL] == 1:
        return
    for path, spec in tree_items(fixed):
        for entry in spec:
            if (isinstance(entry, tuple) and AXIS in entry
                    and MODEL in entry
                    and entry.index(AXIS) < entry.index(MODEL)):
                raise NotImplementedError(
                    f"{path}: the fixed spec {spec} splits one dim over "
                    "'data' then 'model'; the sharded step gathers 'data' "
                    "within a model block")


def shard_state(state: TrainState, model: Model, mesh: Mesh) -> TrainState:
    """``state`` placed on ``mesh`` by the fixed ``train_state_specs``: on
    a ``(D, 1)`` mesh a leaf split over ``data`` is a ``ShardedTensor``,
    any other leaf a ``ReplicatedTensor``; with a model axis every leaf is
    a ``PlacedTensor``."""
    check_mesh(mesh)
    fixed = fix_tree(state, train_state_specs(model), mesh)
    _check_specs(fixed.params, mesh)
    if mesh.shape[MODEL] > 1:
        return _leafwise(lambda leaf, spec: place(leaf, mesh, spec), state,
                         fixed)

    def put(leaf, spec):
        dim = next((i for i, e in enumerate(spec) if e is not None and AXIS
                    in ((e,) if isinstance(e, str) else e)), None)
        return (replicate(leaf, mesh, AXIS) if dim is None
                else shard(leaf, mesh, AXIS, dim))
    return _leafwise(put, state, fixed)


def _leafwise(fn: Callable, *states) -> TrainState:
    """The ``TrainState`` of ``fn`` over the states' corresponding
    leaves."""
    over = lambda get: tree_map(fn, *map(get, states))
    return TrainState(
        params=over(lambda s: s.params),
        opt=AdamWState(step=over(lambda s: s.opt.step),
                       m=over(lambda s: s.opt.m), v=over(lambda s: s.opt.v)),
        step=over(lambda s: s.step))


def gather_state(sharded: TrainState) -> TrainState:
    """The ``TrainState`` a sharded one holds, on the first slot's
    device."""
    return _leafwise(lambda leaf: leaf.gather(), sharded)


def slot_state(sharded: TrainState, p: int) -> TrainState:
    """What slot ``p`` (row-major over the mesh) holds of a sharded state:
    its blocks and copies."""
    return _leafwise(lambda leaf: leaf.copies[p] if isinstance(
        leaf, ReplicatedTensor) else leaf.shards[p], sharded)


def _placed(leaf) -> PlacedTensor:
    """A ``ShardedTensor`` or ``ReplicatedTensor`` of a ``(D, 1)`` mesh as
    the ``PlacedTensor`` of the same blocks."""
    if isinstance(leaf, PlacedTensor):
        return leaf
    if isinstance(leaf, ReplicatedTensor):
        return PlacedTensor(leaf.copies, leaf.mesh, ())
    spec = [None] * leaf.shards[0].dim()
    spec[leaf.dim] = leaf.axis
    return PlacedTensor(leaf.shards, leaf.mesh, tuple(spec))


def _like(like, shards: tuple) -> object:
    """``shards`` (one a slot) as a leaf of ``like``'s kind."""
    if isinstance(like, PlacedTensor):
        return PlacedTensor(shards, like.mesh, like.spec)
    if isinstance(like, ShardedTensor):
        return ShardedTensor(shards, like.mesh, AXIS, like.dim)
    return ReplicatedTensor(shards, like.mesh, AXIS)


class _Gather(torch.autograd.Function):
    """Replica r's all-gather over ``data`` of a leaf's blocks on model
    line m, onto slot (r, m); the backward hands the gradient to the
    slot's sink."""

    @staticmethod
    def forward(ctx, sink, leaf: PlacedTensor, dim: int, r: int, m: int):
        mesh = leaf.mesh
        blocks = [leaf.shards[p] for p in mesh.line_slots(AXIS, {MODEL: m})]
        return mesh.all_gather(blocks, dim, axis=AXIS, slot=r,
                               at={MODEL: m})

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None, None


class SlotLeaf(LazyLeaf):
    """Replica ``r``'s use of the placed leaf ``leaf`` on its model slots:
    :meth:`make` gives a ``models.common.Slots`` of slot (r, m)'s tensors,
    all-gathered over ``data`` (recorded on the mesh) and, where the slots
    use the whole leaf (``whole``), over ``model``.  ``wrt`` holds, a
    slot, the tensor its gradient is taken with respect to: a sink
    standing in for the data-gathered block (a zero expanded to its
    shape, holding no data), else the slot's block itself."""

    def __init__(self, leaf: PlacedTensor, r: int, whole: bool,
                 wrt: list[torch.Tensor] | None = None):
        self.leaf, self.r, self.whole = leaf, r, whole
        self.data_dim, self.model_dim = _dims(leaf)
        mesh = leaf.mesh
        self.line = mesh.line(MODEL, {AXIS: r})
        if wrt is None:
            slots = mesh.line_slots(MODEL, {AXIS: r})
            if self.data_dim is None:
                wrt = [leaf.shards[p].detach().requires_grad_()
                       for p in slots]
            else:
                shape = list(leaf.shards[slots[0]].shape)
                shape[self.data_dim] *= mesh.shape[AXIS]
                wrt = [torch.zeros((), dtype=leaf.dtype,
                                   device=mesh.devices[p]).expand(
                                       shape).requires_grad_()
                       for p in slots]
        self.wrt = wrt

    def make(self) -> Slots:
        blocks = list(self.wrt)
        if self.data_dim is not None:
            blocks = [_Gather.apply(sink, self.leaf, self.data_dim, self.r, m)
                      for m, sink in enumerate(blocks)]
        if self.model_dim is not None and self.whole:
            blocks = self.line.all_gather(blocks, self.model_dim)
        return Slots(blocks,
                     split=self.model_dim is not None and not self.whole)

    def unbind(self, dim: int = 0) -> list[SlotLeaf]:
        """The layers' leaves of a stacked weight: dim 0 must not be
        split."""
        if dim != 0 or 0 in (self.data_dim, self.model_dim):
            raise ValueError("a stacked weight unbinds along its unsplit "
                             f"dim 0 only, not {dim}")
        spec = tuple(self.leaf.spec[1:])
        layers = zip(*(s.unbind(0) for s in self.leaf.shards))
        wrts = zip(*(w.unbind(0) for w in self.wrt))
        return [SlotLeaf(PlacedTensor(tuple(shards), self.leaf.mesh, spec),
                         self.r, self.whole, list(w))
                for shards, w in zip(layers, wrts)]


class _Routing:
    """The MoE groups of one microbatch over the data replicas: the group
    size of the microbatch's tokens, and each replica's per-expert counts
    in its last group, which a replica whose first group began on an
    earlier replica takes as the capacity positions already held
    (``models.moe.moe_block_slots``'s ``routing``; :meth:`replica` is
    replica r's view)."""

    def __init__(self, mesh: Mesh, cfg, tokens: int):
        self.mesh, self.tokens = mesh, tokens
        self.group_size = _group_size(mesh.shape[AXIS] * tokens, cfg)
        self.carry: dict[tuple[int, int], list] = {}   # into replica r
        self.out: dict[tuple[int, int], list] = {}     # out of replica r

    def replica(self, r: int) -> _ReplicaRouting:
        return _ReplicaRouting(self, r)


class _ReplicaRouting:
    def __init__(self, routing: _Routing, r: int):
        self.routing, self.r = routing, r
        self.group_size = routing.group_size
        self.lead = r * routing.tokens % routing.group_size

    def offset(self, layer: int) -> list[torch.Tensor] | None:
        """Slot m's positions of each expert that earlier replicas took in
        this replica's first group, sent from slot (r - 1, m) once (the
        recompute reuses them); None where the group begins here."""
        if not self.lead:
            return None
        rt, key = self.routing, (self.r, layer)
        if key not in rt.carry:
            rt.carry[key] = [rt.mesh.send(c, axis=AXIS, dst=self.r,
                                          at={MODEL: m})
                             for m, c in enumerate(rt.out[self.r - 1,
                                                          layer])]
        return rt.carry[key]

    def report(self, layer: int, counts: list[torch.Tensor]) -> None:
        """Slot m's per-expert counts (groups, E) of this replica's tokens:
        the positions its last group hands on (with those it took in, if
        that group is also its first and began before it)."""
        carried = self.offset(layer) if counts[0].shape[0] == 1 else None
        self.routing.out[self.r, layer] = [
            c[-1] + carried[m] if carried else c[-1]
            for m, c in enumerate(counts)]


def accounted_record(model: Model, state: TrainState, mesh: Mesh,
                     tokens: int, microbatches: int = 1
                     ) -> tuple[dict[str, float], dict[str, float]]:
    """``collective_accounting`` of one step of ``state`` on ``mesh``
    (``tokens`` a replica, the router's k), in ``Mesh.collective_totals``'
    form, with the executor's departures, each a formula (per device, k =
    ``microbatches``, U = ``tokens`` x d_model x an activation's bytes,
    ``local`` a leaf's bytes over the sizes of the axes its spec names):

    * a data-sharded leaf outside the family's ``REMAT_PARAMS`` is
      gathered over ``data`` once a microbatch, not twice, and every leaf
      k times: all-gather (data) = (A - sum of such leaves' gathered
      bytes) x k, A the accounting's;
    * a leaf the model slots use whole (the family's ``tp_blocks``; among
      them mamba2's ``in_proj``, ``conv_w`` and ``conv_b`` and zamba2's
      ``site_proj``) is all-gathered over ``model``: its bytes, twice a
      microbatch inside the rematerialised layers and once elsewhere, and
      its gradient reduce-scattered: its bytes / M a microbatch;
    * a leaf replicated over ``model`` (M > 1) has its gradient
      all-reduced over ``model``: ``local``;
    * zamba2's shared block (``shared_attn``) is used once a site: the
      accounting takes n_sites uses of each of its leaves (``uses=``), as
      the dry run does;
    * the row-parallel all-reduces (model: ``w_o``, ``w_down``, mamba2's
      ``out_proj``) run 3 times a use inside the rematerialised layers
      (zamba2's shared block inside each site too) and 2 times outside
      them (deepseek's dense layer, zamba2's head layers), where the
      accounting counts 3: -U for each such use; a leaf
      whose ``model`` axis ``fix_sharding`` moved onto its contracted dim
      is gathered and used whole, where the accounting counts 3 x tokens
      x its width x an activation's bytes a use;
    * a mamba block whose SSM heads the model slots split all-reduces
      ``gate_norm``'s per-token sums of squares (float32) once a pass: 4
      x ``tokens`` bytes a layer, 3 passes inside the rematerialised
      layers and 2 outside (model);
    * the embedding's lookup all-reduce runs in the forward and the
      backward, 2 U, against the 3 U the accounting counts (an
      embeddings-input model looks nothing up: -3 U);
    * an MoE layer's combine (its experts' shares and the shared experts'
      partial sum) is all-reduced once a pass over ``model``, 3 U a layer,
      where the accounting counts the dispatch and combine all-to-alls,
      3 x 2 x tokens / M x k_router x d_model x an activation's bytes a
      layer, and the shared experts' all-reduce, 3 U: the all-to-alls go
      and the combine's 3 U stand in for the shared experts';
    * the vocab-parallel cross-entropy all-reduces per token the max (4
      bytes) and the sum of exps with the label's logit (8) in the
      forward and the recompute, and the latter in the backward: 32 x
      ``tokens`` bytes (model);
    * an MoE model on D > 1 all-reduces its layers' token fractions over
      ``data`` on the first model line: n_moe x E x 4 / M a microbatch;
      where the microbatch's groups span replicas, each model slot of a
      replica whose first group began earlier gets the counts of the
      replica before: (such replicas) x E x 8 / D a layer and microbatch
      (``collective-permute``, data);
    * the loss is all-reduced over ``data`` on the first model line (4 /
      M bytes), the squared gradient norm over ``model`` and ``data`` (4
      bytes each).

    No collective runs over an axis of one slot."""
    cfg = model.cfg
    d, m, k = mesh.shape[AXIS], mesh.shape[MODEL], microbatches
    fixed = fix_tree(state, train_state_specs(model), mesh).params
    act = dtype_of(cfg).itemsize
    top_k = cfg.moe.top_k if cfg.moe is not None else 0
    n_sites = (cfg.n_layers // cfg.shared_attn_every
               if cfg.shared_attn_every else 1)
    shared = lambda path: path.startswith("shared_attn/")
    uses_of = lambda path, shape: (n_sites if shared(path)
                                   else math.prod(shape[:-2]))
    by_kind, by_axis = collective_accounting(
        state.params, fixed, mesh, kind="train", tokens=tokens,
        act_bytes=act, top_k=top_k, uses=uses_of)

    def add(kind: str, axis: str, nbytes: float) -> None:
        if nbytes:
            by_kind[kind] = by_kind.get(kind, 0.0) + nbytes
            by_axis[axis] += nbytes

    family = family_module(cfg)
    lazy = family.REMAT_PARAMS
    blocks = family.tp_blocks(cfg, state.params, fixed, m)
    specs = dict(tree_items(fixed))
    size = lambda axes: math.prod(mesh.shape[a] for a in axes)
    data_gathers = by_kind.get("all-gather", 0.0)    # all over data
    once = 0.0
    u = tokens * cfg.d_model * act
    for path, leaf in tree_items(state.params):
        spec, shape = specs[path], tuple(leaf.shape)
        axes = spec.axes
        nbytes = leaf.numel() * leaf.element_size()
        in_remat = path.split("/")[0] in lazy
        if d > 1 and AXIS in axes and not in_remat:
            once += nbytes / size([a for a in axes if a != AXIS])
        if m == 1:
            continue
        if MODEL not in axes:
            add("all-reduce", MODEL, nbytes / size(axes))
        elif not blocks.get(path, False):
            add("all-gather", MODEL, nbytes * (2 if in_remat else 1) * k)
            add("reduce-scatter", MODEL, nbytes / m * k)
        name = path.rsplit("/", 1)[-1]
        passes = 3 if in_remat or shared(path) else 2
        if name == "gate_norm" and blocks.get(path, False):
            add("all-reduce", MODEL,
                passes * math.prod(shape[:-1]) * 4 * tokens)
        if len(shape) < 2:
            continue
        entries = list(spec) + [None] * (len(shape) - len(spec))
        counted = MODEL in ((entries[-2],) if isinstance(entries[-2], str)
                            else entries[-2] or ())
        uses = uses_of(path, shape)
        if path == "embed":
            ran = 2 * (cfg.input_mode != "embeds"
                       and blocks.get("embed", False))
        elif (name in ("w_o", "w_down", "out_proj")
              and "/moe/" not in f"/{path}/"):
            ran = passes * blocks.get(path, False)
        elif path.endswith("moe/w_gate"):
            parent = path.rsplit("/", 1)[0]
            ran = passes * (blocks.get(path, False)
                            or blocks.get(f"{parent}/shared_down", False))
            uses = math.prod(shape[:-3])
        else:                                 # shared_down: in the combine
            ran = 0
        add("all-reduce", MODEL, (ran * u - 3 * counted * tokens * shape[-1]
                                  * act) * uses)
    add("all-gather", AXIS, (data_gathers - once) * k - data_gathers)
    if m > 1:
        add("all-to-all", MODEL, -by_kind.get("all-to-all", 0.0))
        if blocks.get("embed" if cfg.tie_embeddings else "lm_head", False):
            add("all-reduce", MODEL, 32 * tokens)
        add("all-reduce", MODEL, 4)
    if d > 1:
        add("all-reduce", AXIS, 4 / m + 4)
        if cfg.moe is not None:
            n_moe = cfg.n_layers - cfg.n_dense_layers
            e = cfg.moe.n_experts
            add("all-reduce", AXIS, n_moe * e * 4 / m * k)
            per = tokens // k
            gs = _group_size(d * per, cfg.moe)
            sends = sum(1 for r in range(1, d) if r * per % gs)
            add("collective-permute", AXIS, sends * e * 8 / d * n_moe * k)
    return ({kd: v for kd, v in by_kind.items() if v}, by_axis)


def make_sharded_train_step(model: Model, mesh: Mesh, *,
                            microbatches: int = 1, peak_lr: float = 3e-4
                            ) -> Callable:
    """Build ``train_step(state, inputs, labels) -> (state, metrics)`` on a
    state placed by :func:`shard_state`: ``make_train_step``'s arithmetic
    and metrics (``loss``, ``grad_norm``, ``lr``, on the first slot), the
    batch split over the ``data`` slots and each layer over the ``model``
    slots."""
    d, m_size = check_mesh(mesh)
    cfg = model.cfg
    family = family_module(cfg)
    lazy_keys = set(family.REMAT_PARAMS)
    deferred = cfg.moe is not None and d > 1

    shapes = model.param_shapes()
    fixed = fix_tree(shapes, model.param_specs(), mesh)
    _check_specs(fixed, mesh)
    blocks = family.tp_blocks(cfg, shapes, fixed, m_size)
    # Each leaf's (used whole over ``model``, made inside the remat).
    flags = {path: (not blocks.get(path, False),
                    path.split("/")[0] in lazy_keys)
             for path, _ in tree_items(shapes)}

    def replica_forward(params, leaves, r: int, inp, labels, routing):
        """Replica r's (cross-entropy or loss on slot (r, 0), MoE stats,
        the gradient's tensors a leaf and slot)."""
        made = [SlotLeaf(leaf, r, whole) for leaf, whole, _ in leaves]
        it = iter(s if lazy else s.make()
                  for s, (_, _, lazy) in zip(made, leaves))
        tree = tree_map(lambda _: next(it), params)
        wrt = [s.wrt for s in made]
        line = mesh.line(MODEL, {AXIS: r})
        ce, stats = family.forward_loss_slots(
            tree, line.copy(inp), line.copy(labels), cfg, line,
            routing.replica(r) if routing is not None else None)
        return ce, stats, wrt

    def backward(loss, wrt):
        flat = [w for ws in wrt for w in ws]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # A parameter the loss does not reach has a zero gradient.
        grads = iter(g if g is not None else torch.zeros(
            w.shape, dtype=w.dtype, device=w.device)
            for g, w in zip(grads, flat))
        return [[next(grads) for _ in ws] for ws in wrt]

    def with_aux(ce, stats, fracs):
        """The replica's loss: the cross-entropy and its aux term, each
        MoE layer's E x sum(frac x mean probability), frac the whole
        microbatch's."""
        loss = ce
        if stats:
            e = cfg.moe.n_experts
            aux = sum(e * (f * prob).sum() for (prob, _), f in
                      zip(stats, fracs))
            loss = ce + AUX_WEIGHT * aux
        return loss

    def train_step(state: TrainState, inp, labels):
        b = inp.shape[0]
        if b % (d * microbatches):
            raise ValueError(f"a batch of {b} rows does not split into "
                             f"{microbatches} microbatches over {d} data "
                             "replicas")
        rows = b // (d * microbatches)
        leaves = [(_placed(leaf), *flags[path])
                  for path, leaf in tree_items(state.params)]
        sums = [None] * d              # [replica][leaf][model slot]
        losses = [0.0] * d

        def add(r, loss, grads):
            losses[r] = losses[r] + loss.detach()
            if microbatches > 1:
                grads = [[g.float() for g in gs] for gs in grads]
            sums[r] = grads if sums[r] is None else [
                [a + g for a, g in zip(ga, gg)]
                for ga, gg in zip(sums[r], grads)]

        with torch.enable_grad():
            for i in range(microbatches):
                routing = (_Routing(mesh, cfg.moe, rows * inp.shape[1])
                           if cfg.moe is not None else None)
                pending = []
                for r in range(d):
                    part = slice((i * d + r) * rows, (i * d + r + 1) * rows)
                    ce, stats, wrt = replica_forward(
                        state.params, leaves, r, inp[part], labels[part],
                        routing)
                    if deferred:
                        pending.append((ce, stats, wrt))
                        continue
                    loss = with_aux(ce, stats, [f for _, f in stats])
                    add(r, loss, backward(loss, wrt))
                if pending:
                    fracs = mesh.all_reduce(
                        [torch.stack([f for _, f in st])
                         for _, st, _ in pending], axis=AXIS,
                        at={MODEL: 0})
                    for r, ((ce, stats, wrt), f) in enumerate(
                            zip(pending, fracs)):
                        pending[r] = None
                        loss = with_aux(ce, stats, f / d)
                        add(r, loss, backward(loss, wrt))

        with torch.no_grad():
            n = d * microbatches
            reduced = []            # per leaf: the mean gradient a slot
            for j, (leaf, _, _) in enumerate(leaves):
                data_dim, model_dim = _dims(leaf)
                out: list = [None] * mesh.size
                for mm in range(m_size):
                    parts = [sums[r][j][mm] for r in range(d)]
                    if d > 1 and data_dim is not None:
                        parts = mesh.reduce_scatter(parts, data_dim,
                                                    axis=AXIS, at={MODEL: mm})
                    elif d > 1:
                        parts = mesh.all_reduce(parts, axis=AXIS,
                                                at={MODEL: mm})
                    for r, g in enumerate(parts):
                        out[mesh.slot_of({AXIS: r, MODEL: mm})] = g
                if m_size > 1 and model_dim is None:
                    for r in range(d):
                        slots = mesh.line_slots(MODEL, {AXIS: r})
                        for p, g in zip(slots, mesh.all_reduce(
                                [out[p] for p in slots], axis=MODEL,
                                at={AXIS: r})):
                            out[p] = g
                for r in range(d):
                    sums[r][j] = None
                reduced.append([g / n for g in out])
            loss = losses[0]
            if d > 1:
                loss = mesh.all_reduce(losses, axis=AXIS, at={MODEL: 0})[0]
            loss = loss / n
            squares = []
            for p, dev in enumerate(mesh.devices):
                index = mesh.index_of(p)
                sq = torch.zeros((), dtype=torch.float32, device=dev)
                for (leaf, _, _), g in zip(leaves, reduced):
                    data_dim, model_dim = _dims(leaf)
                    if ((data_dim is not None or index[AXIS] == 0)
                            and (model_dim is not None
                                 or index[MODEL] == 0)):
                        sq = sq + torch.sum(torch.square(g[p].float()))
                squares.append(sq)
            for axis, other, size in ((MODEL, AXIS, m_size),
                                      (AXIS, MODEL, d)):
                if size == 1:
                    continue
                for i in range(mesh.shape[other]):
                    slots = mesh.line_slots(axis, {other: i})
                    for p, s in zip(slots, mesh.all_reduce(
                            [squares[p] for p in slots], axis=axis,
                            at={other: i})):
                        squares[p] = s
            norms = [torch.sqrt(s) for s in squares]

            updated, lrs = [], []
            for p in range(mesh.size):
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

        metrics = {"loss": loss, "grad_norm": norms[0], "lr": lrs[0]}
        return _leafwise(lambda like, *s: _like(like, s), state,
                         *updated), metrics

    return train_step

