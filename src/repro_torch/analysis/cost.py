"""Cost counting of one step on ``meta`` tensors: the counterpart of
``repro.analysis.hlo``.

The reference compiles a step, SPMD-partitions it and reads FLOPs, HBM
bytes and collective bytes from the per-device HLO text.  The port runs
eagerly and has no HLO (hence the other file name): :func:`analyze_step`
runs the step itself, usually on ``meta`` tensors (shapes and dtypes, no
data, no device), and counts what each aten op would do:

  * FLOPs   — ``torch.utils.flop_counter.FlopCounterMode`` over the call:
              2 per multiply-add of every matrix product (``mm``, ``bmm``,
              ``addmm``, the attention and convolution kernels), forward,
              rematerialised forward and backward alike.  Elementwise ops
              and reductions count 0, as the reference's ``dot``-only
              count does.
  * bytes   — :class:`ByteCounter`: the bytes of the operands and results
              of every aten op that is not a view (an argument the op
              writes counts once, as a result).  In eager torch every op
              is its own kernel, so each op's operands are read from and
              its results written to device memory: the counterpart of the
              reference's "fusion boundaries".  On ``meta`` a bf16
              unembed takes the card's branch of ``models.common.
              matmul_f32`` (bf16 operands, float32 result), so the count
              is the card's.

There is no partitioner, so the collectives come from the mesh-fixed
spec trees (``launch.specs.fix_tree``) by this accounting
(:func:`collective_accounting`).  A leaf's bytes are its shape times its
dtype; ``local`` is a leaf's bytes over the product of the sizes of the
axes its fixed spec names; ``tokens`` are the tokens of one data replica
in the step (the global batch times the sequence, over the batch axes
that the fixed input spec places).

  ================  =====================================  ===  =====  =====
  collective        when; its per-device output bytes      fwd  train  axis
  ================  =====================================  ===  =====  =====
  all-gather        a leaf sharded over a batch axis        1     2    that
                    (data, pod) is gathered over it                  batch
                    before use: its bytes over the sizes             axis
                    of its other axes
  reduce-scatter    that leaf's gradient: ``local``         0     1    same
  all-reduce        a leaf replicated over batch axes:      0     1    pod,
  (gradient)        its gradient, ``local``, all-reduced             else
                    over those axes at once                          data
  all-reduce (TP)   a product whose weight's contracted     1     3    model
                    dim (-2) is split over ``model``: its
                    (tokens, width) output, once a use
  all-to-all        an expert-parallel MoE layer (experts   1     3    model
                    split over ``model``): dispatch and
                    combine, tokens / model x top_k x d
  ================  =====================================  ===  =====  =====

"train" counts the forward, the rematerialised forward and the backward.
A weight's uses in one forward default to the product of its leading
(stacked-layer) dims; the caller says otherwise (a shared block).  No
collective is counted over an axis of size 1: a partitioner emits none
there, and the sharded train step (``train.sharded``) moves nothing.
Not counted: the split-KV reduction of a decode cache whose sequence
carries ``model``, and collectives of the inputs.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models.common import tree_items

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all")

#: Ops that allocate without reading or writing data.
_FREE = {torch.ops.aten.empty.memory_format,
         torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
         torch.ops.aten.new_empty_strided.default}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes each non-view aten op reads and writes: its tensor
    operands (an operand the op writes is not read) and its results."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _FREE:
            return out
        schema = func._schema.arguments
        named = {a.name: v for a, v in zip(schema, args)} | kwargs
        written = {a.name for a in schema
                   if a.alias_info is not None and a.alias_info.is_write}
        self.bytes += sum(_nbytes(t) for name, v in named.items()
                          if name not in written
                          for t in _pytree_leaves(v))
        self.bytes += sum(_nbytes(t) for t in _pytree_leaves(out))
        self.ops += 1
        return out


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def collective_accounting(params, specs, mesh, *, kind: str, tokens: int,
                          act_bytes: int = 2, top_k: int = 0,
                          uses: Callable[[str, tuple], int] | None = None
                          ) -> tuple[dict[str, float], dict[str, float]]:
    """(bytes by collective kind, bytes by mesh axis) per device of one
    step by the accounting of the module docstring.

    ``params``: the parameter tree (tensors or ``TensorSpec``s);
    ``specs``: its fixed spec tree; ``kind``: ``"train"`` or a forward
    (``"prefill"``, ``"decode"``, ``"forward"``); ``tokens``: one data
    replica's tokens; ``act_bytes``: an activation element's bytes;
    ``top_k``: the MoE router's k; ``uses(path, shape)``: a weight's uses
    in one forward."""
    train = kind == "train"
    gathers, passes = (2, 3) if train else (1, 1)
    batch = [a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1]
    model = mesh.shape.get("model", 1)
    by_kind = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
    by_axis = dict.fromkeys(mesh.axis_names, 0.0)

    def add(kind_: str, axis: str, nbytes: float) -> None:
        by_kind[kind_] += nbytes
        by_axis[axis] += nbytes

    spec_of = dict(tree_items(specs))
    for path, leaf in tree_items(params):
        shape = tuple(leaf.shape)
        spec = spec_of[path]
        entries = list(spec) + [None] * (len(shape) - len(spec))
        named = spec.axes
        size = lambda axes: math.prod(mesh.shape[a] for a in axes)
        nbytes = math.prod(shape) * leaf.dtype.itemsize
        local = nbytes / size(named)
        gathered = [a for a in batch if a in named]
        if gathered:
            rest = [a for a in named if a not in gathered]
            add("all-gather", gathered[-1], gathers * nbytes / size(rest))
            if train:
                add("reduce-scatter", gathered[-1], local)
        replicated = [a for a in batch if a not in named]
        if train and replicated:
            add("all-reduce", replicated[0], local)
        n_uses = (uses(path, shape) if uses is not None
                  else math.prod(shape[:-2]))
        if (model > 1 and len(shape) >= 2 and "model" in _axes(entries[-2])
                and n_uses):
            add("all-reduce", "model",
                passes * n_uses * tokens * shape[-1] * act_bytes)
        if (model > 1 and path.endswith("moe/w_gate") and top_k
                and "model" in _axes(entries[-3])):
            layers = math.prod(shape[:-3])
            add("all-to-all", "model", passes * 2 * layers * tokens / model
                * top_k * shape[-2] * act_bytes)
    return ({k: v for k, v in by_kind.items() if v},
            {k: v for k, v in by_axis.items()})


def analyze_step(fn: Callable, *args, mesh=None, params=None, specs=None,
                 kind: str = "forward", tokens: int = 0, act_bytes: int = 2,
                 top_k: int = 0, uses: Callable | None = None) -> dict:
    """Run ``fn(*args)`` once under the FLOP and byte counters and return
    the reference's ``analyze_hlo`` keys — ``flops``, ``bytes``,
    ``collectives`` (bytes by kind), ``collective_bytes`` — and
    ``collective_by_axis``.  FLOPs and bytes are the call's whole (the
    caller divides them among devices); the collectives, per device, come
    from :func:`collective_accounting` of ``params`` under the fixed
    ``specs`` on ``mesh`` (none without a mesh)."""
    counter = ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args)
    coll, by_axis = ({}, {})
    if mesh is not None:
        coll, by_axis = collective_accounting(
            params, specs, mesh, kind=kind, tokens=tokens,
            act_bytes=act_bytes, top_k=top_k, uses=uses)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes), "collectives": coll,
            "collective_bytes": float(sum(coll.values())),
            "collective_by_axis": by_axis}
