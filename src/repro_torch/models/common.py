"""Shared model components: norms, RoPE, init, loss, the parameter tree
and the sharding vocabulary (the counterpart of ``repro.models.common``).

The sharding vocabulary (:class:`PartitionSpec`, ``spec_*``,
:func:`stack_specs`) names, for each parameter and cache leaf, the mesh
axes its dimensions split over; ``launch.specs`` fixes the names for a
mesh and ``analysis.cost`` prices the collectives they imply.  The
reference's ``activation_sharding``, ``constrain_acts`` and ``PERF_OPTS``
only place values on devices for its SPMD partitioner: in one eager
process they change no value, so the port has no such code paths
(``launch.dryrun --opt`` records the options it applies to the spec
trees).

Parameters live in a :class:`ParamTree`, an ``nn.Module`` that mirrors the
reference's parameter pytree: a dict becomes a ``ParamTree``, a list an
``nn.ModuleList``, an array an ``nn.Parameter`` (``requires_grad=False``:
serving records no graph; ``repro_torch.train.step`` makes its own
gradient leaves from the nested dict).  So ``state_dict()`` keys are
the reference tree's paths joined by ``.`` (``layers.attn.w_q``,
``dense_layers.0.mlp.w_gate``), and the forward code indexes a
``ParamTree`` and a plain nested dict of tensors alike.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import Any, Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a cache leaf (``jax.ShapeDtypeStruct``'s place
    in ``cache_shapes``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


class PartitionSpec(tuple):
    """The mesh axes each dimension of a leaf splits over: one entry a
    dimension, ``None`` (not split), an axis name or a tuple of names;
    missing trailing entries are ``None`` (``jax.sharding.PartitionSpec``'s
    place; ``tuple(spec)`` compares with the reference's).  A leaf of the
    trees :func:`tree_map` walks."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    @property
    def axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec names, in order."""
        return tuple(a for e in self if e is not None
                     for a in ((e,) if isinstance(e, str) else e))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class ParamTree(nn.Module):
    """A nested parameter dict as a module; ``tree[key]`` gives a
    parameter, a ``ParamTree`` or an ``nn.ModuleList`` of them."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v) for v in value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def tree(self) -> dict:
        """The nested dict (lists for ``ModuleList``s) of the parameter
        tensors: the reference's pytree structure, e.g. for
        ``runtime.checkpoint``."""
        return tree_map(lambda t: t, self)


def _is_tree(node) -> bool:
    return isinstance(node, (dict, ParamTree))


def tree_map(fn: Callable, *trees) -> Any:
    """``fn`` over the leaves of nested dicts / ``ParamTree``s and lists /
    ``ModuleList``s of the same structure; dicts come back as dicts.  A
    :class:`PartitionSpec` is a leaf."""
    first = trees[0]
    if _is_tree(first):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first.keys()}
    if (isinstance(first, (list, tuple, nn.ModuleList))
            and not isinstance(first, PartitionSpec)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_items(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in :func:`tree_leaves`' order; a path joins the
    dict keys and list indices by ``/``, as the reference's key paths."""
    if _is_tree(tree):
        keys = [(k, tree[k]) for k in tree.keys()]
    elif (isinstance(tree, (list, tuple, nn.ModuleList))
          and not isinstance(tree, PartitionSpec)):
        keys = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(path, tree)]
    return [item for k, v in keys
            for item in tree_items(v, f"{path}/{k}" if path else k)]


def unstack(tree, n: int) -> list[dict]:
    """The ``n`` slices along the leading (stacked-layer) axis of every
    leaf, as ``n`` nested dicts of views (``jax.lax.scan``'s per-step
    ``xs``): one ``unbind`` a leaf (a :class:`LazyLeaf`'s gives its
    layers' leaves)."""
    if _is_tree(tree):
        parts = {k: unstack(tree[k], n) for k in tree.keys()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def stack(trees: list) -> Any:
    """Stack a list of same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(q: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding; q: (..., S, H, D), positions: (..., S)."""
    d = q.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device) / half)
    ang = positions[..., :, None, None].float() * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    q1, q2 = q[..., :half], q[..., half:]
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    return out.to(q.dtype)


#: The generator that ``init_params`` takes to build a parameter tree of
#: ``meta`` tensors (shapes and dtypes, no data, nothing drawn): the
#: families' ``param_shapes``, the counterpart of the reference's
#: ``jax.eval_shape(model.init, key)``.
SHAPES_ONLY = types.SimpleNamespace(device=torch.device("meta"))


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None
               ) -> torch.Tensor:
    """A normal draw from ``gen`` (on the generator's device), scaled by
    ``scale`` or fan_in ** -0.5; from :data:`SHAPES_ONLY`, an empty meta
    tensor.  The port cannot reproduce JAX's random numbers: parity goes
    through ``models.convert``."""
    if gen is SHAPES_ONLY:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=gen, device=gen.device) * s
            ).to(dtype)


class LazyLeaf:
    """A parameter leaf made where it is used: a weight sharded over the
    mesh, whose all-gathers run on use (``train.sharded``).
    :func:`remat` makes the leaves among its arguments inside the
    checkpointed function, so that the recompute makes them again, as the
    reference's ``jax.checkpoint`` gathers a ZeRO-sharded weight again;
    :func:`unstack` splits one into its layers' leaves."""

    def make(self) -> torch.Tensor:
        raise NotImplementedError

    def unbind(self, dim: int = 0) -> list["LazyLeaf"]:
        raise NotImplementedError


class Slots:
    """A leaf's values on the model slots of one data replica, slot m's
    at index m (``train.sharded`` on a mesh with a ``model`` axis).
    ``split``: the slots hold the leaf's blocks along the dim the family
    splits over ``model`` (tensor or expert parallelism); else each holds
    the whole leaf.  A leaf of the trees :func:`tree_map` walks."""

    def __init__(self, values, split: bool = False):
        self.values = tuple(values)
        self.split = split

    def __getitem__(self, m: int):
        return self.values[m]

    def __len__(self) -> int:
        return len(self.values)

    def __iter__(self):
        return iter(self.values)


def at_slot(tree, m: int):
    """Slot ``m``'s tree of a tree of :class:`Slots`."""
    return tree_map(lambda s: s[m], tree)


def _model_major(spec, ndim: int, dim: int) -> bool:
    """Whether ``model`` is the major mesh axis of ``dim`` in ``spec``."""
    entry = (list(spec) + [None] * (ndim - len(spec)))[dim]
    return entry == "model" or (isinstance(entry, tuple) and bool(entry)
                                and entry[0] == "model")


def major_of(params, specs) -> Callable[[str, int], bool]:
    """``major(path, dim)``: whether ``model`` is the major mesh axis of
    dim ``dim`` of leaf ``path`` of ``params`` under its fixed spec in
    ``specs`` (the families' ``tp_blocks``)."""
    ndim = {p: len(t.shape) for p, t in tree_items(params)}
    spec = dict(tree_items(specs))
    return lambda path, dim: _model_major(spec[path], ndim[path], dim)


def vocab_blocks(params, major: Callable[[str, int], bool]
                 ) -> dict[str, bool]:
    """The embedding's and ``lm_head``'s entries of a ``tp_blocks``: the
    model slots use their vocabulary rows where ``model`` is the major
    axis of the vocabulary dim."""
    out: dict[str, bool] = {}
    if "embed" in params:
        out["embed"] = major("embed", 0)
    if "lm_head" in params:
        out["lm_head"] = major("lm_head", -1)
    return out


def naming_model(blocks: dict[str, bool], specs) -> dict[str, bool]:
    """``blocks`` cut to the leaves whose fixed spec names ``model``."""
    spec = dict(tree_items(specs))
    return {p: v for p, v in blocks.items() if "model" in spec[p].axes}


def embed_slots(params, inp, cfg, line) -> list:
    """The embedded input on each model slot of ``line`` (a
    ``fft.distributed.MeshLine``): with the table split over the
    vocabulary, each slot looks up the tokens its rows hold (zeros
    elsewhere) and one all-reduce sums them."""
    if cfg.input_mode == "embeds":
        return [x.to(dtype_of(cfg)) for x in inp]
    table = params["embed"]
    if not table.split:
        return [w[ids] for w, ids in zip(table, inp)]
    parts = []
    for m, (w, ids) in enumerate(zip(table, inp)):
        rows = w.shape[0]
        local = ids - m * rows
        inside = (local >= 0) & (local < rows)
        parts.append(torch.where(inside[..., None],
                                 w[local.clamp(0, rows - 1)], 0))
    return line.all_reduce(parts)


def rms_norm_slots(xs: list, scales: list, eps: float, width: int, line
                   ) -> list:
    """:func:`rms_norm` over the last dim, ``width`` wide, whose blocks
    the model slots of ``line`` hold (slot m's in ``xs[m]``, its block of
    the scale in ``scales[m]``): each slot's per-row sum of squares in
    float32, summed by one all-reduce, over ``width`` is the mean."""
    xf = [x.float() for x in xs]
    sums = line.all_reduce([v.square().sum(-1, keepdim=True) for v in xf])
    return [(v * torch.rsqrt(s / width + eps) * (1.0 + w.float())).to(x.dtype)
            for x, v, s, w in zip(xs, xf, sums, scales)]


def lm_loss_slots(params, xs: list, labels: list, cfg, line) -> torch.Tensor:
    """The final norm and the mean token cross-entropy of one data replica
    over its model slots, on slot 0: vocab-parallel where the unembedding
    (``lm_head``, or the tied embedding) is split over ``model``."""
    hs = [rms_norm(x, g, cfg.norm_eps)
          for x, g in zip(xs, params["final_norm"])]
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    fns = [(lambda h, w=w: matmul_f32(h, w.t() if cfg.tie_embeddings
                                      else w)) for w in table]
    return chunked_cross_entropy_slots(fns, hs, labels, line,
                                       split=table.split)


def _made(fn: Callable, *args):
    """``fn(*args)`` with every :class:`LazyLeaf` of ``args`` made."""
    return fn(*tree_map(lambda a: a.make() if isinstance(a, LazyLeaf)
                        else a, list(args)))


def remat(fn: Callable, *args):
    """``fn(*args)``, rematerialised in backward: the reference's
    ``jax.checkpoint(policy=nothing_saveable)``.  Where autograd records
    (``torch.is_grad_enabled()``), ``fn`` runs under
    ``torch.utils.checkpoint``, which keeps none of its activations and
    runs it again when backward needs them; elsewhere (serving under
    ``inference_mode``) it is a plain call.  The values are the same bits
    either way.  A :class:`LazyLeaf` among ``args`` is made inside the
    checkpointed call, and the recompute then runs ``fn`` to its end (no
    early stop), so that each collective in it runs again, as the
    reference's remat pass does; without one, ``fn`` is called as it
    is."""
    if torch.is_grad_enabled():
        if any(isinstance(a, LazyLeaf) for a in tree_leaves(list(args))):
            with set_checkpoint_early_stop(False):
                return checkpoint(functools.partial(_made, fn), *args,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class _MatmulBf16F32(torch.autograd.Function):
    """(M, K) @ (K, N) of bf16 operands with a float32 result (cuBLAS's
    ``out_dtype``), whose backward ``torch.mm`` lacks: the float32
    cotangent is rounded to bf16 and each gradient is a bf16 product with
    float32 accumulation (the reference forms it in float32 and rounds
    once)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.t() if ctx.needs_input_grad[0] else None
        gb = a.t() @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a: (..., K), b: (K, N)) with a float32 result: the
    reference's ``preferred_element_type=jnp.float32``.

    Float32 operands multiply as they are.  On the card, bf16 operands
    stay bf16 and cuBLAS writes a float32 result (``out_dtype``), which
    keeps the reference's f32 output without an f32 copy of the weight
    (at full width the unembed weight is up to 262144 x 3840); a dry run
    on ``meta`` tensors takes the same branch, so that it counts the
    card's operations and bytes.  Elsewhere both operands are cast up,
    which is exact for the products."""
    if a.dtype == b.dtype == torch.float32:
        return a @ b
    if (a.device.type in ("cuda", "meta")
            and a.dtype == b.dtype == torch.bfloat16):
        flat = a.reshape(-1, a.shape[-1])
        return _MatmulBf16F32.apply(flat, b).reshape(
            *a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) f32-accumulated."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return (logz - gold).mean()


def _ce_chunk(s: int, chunk: int) -> int:
    """The cross-entropy's chunk of a sequence of ``s``: ``chunk``, halved
    until it divides ``s``."""
    c = min(chunk, s)
    while s % c:
        c //= 2
    return c


def chunked_cross_entropy(unembed_fn: Callable, hidden: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512
                          ) -> torch.Tensor:
    """CE without materialising the full (B, S, V) logits: the unembed
    and softmax run per sequence chunk, each rematerialised in backward
    (:func:`remat`, as the reference's ``jax.checkpoint``), so the
    transient is one (B, chunk, V) chunk."""
    b, s = labels.shape
    c = _ce_chunk(s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, c):
        total = total + remat(_chunk_ce, unembed_fn,
                              hidden[:, start:start + c],
                              labels[:, start:start + c])
    return total / (b * s)


def _chunk_ce(unembed_fn: Callable, h: torch.Tensor, labels: torch.Tensor
              ) -> torch.Tensor:
    """Summed token cross-entropy of one chunk."""
    logits = unembed_fn(h).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return (logz - gold).sum()


def chunked_cross_entropy_slots(unembed_fns: list[Callable],
                                hidden: list[torch.Tensor],
                                labels: list[torch.Tensor], line, *,
                                split: bool, chunk: int = 512
                                ) -> torch.Tensor:
    """:func:`chunked_cross_entropy` of one data replica over its model
    slots (``line``, a ``fft.distributed.MeshLine``; slot m's unembedding,
    hidden states and labels at index m), on slot 0.  With ``split``,
    slot m's unembedding gives the logits of its block of the vocabulary
    (vocab-parallel): each chunk all-reduces the per-token max, then the
    per-token sum of exps and the label's logit, so the (tokens, vocab)
    logits are never gathered; else slot 0 computes the whole."""
    if not split:
        return chunked_cross_entropy(unembed_fns[0], hidden[0], labels[0],
                                     chunk=chunk)
    b, s = labels[0].shape
    c = _ce_chunk(s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden[0].device)
    for start in range(0, s, c):
        total = total + remat(_chunk_ce_slots, unembed_fns,
                              [h[:, start:start + c] for h in hidden],
                              [y[:, start:start + c] for y in labels], line)
    return total / (b * s)


def _chunk_ce_slots(unembed_fns: list[Callable], hidden: list, labels: list,
                    line) -> torch.Tensor:
    """Summed token cross-entropy of one chunk, vocab-parallel: the max
    without a gradient (the log-sum-exp's gradient does not depend on its
    shift), the sums of exps and the label's logits (0 on a slot whose
    block does not hold the label) all-reduced together."""
    logits = [fn(h).float() for fn, h in zip(unembed_fns, hidden)]
    top = line.all_reduce_max([z.amax(-1) for z in logits])
    parts = []
    for m, (z, y, mx) in enumerate(zip(logits, labels, top)):
        width = z.shape[-1]
        local = y - m * width
        inside = (local >= 0) & (local < width)
        gold = torch.take_along_dim(z, local.clamp(0, width - 1)[..., None],
                                    dim=-1)[..., 0]
        parts.append(torch.stack([torch.exp(z - mx[..., None]).sum(-1),
                                  torch.where(inside, gold, 0.0)], dim=-1))
    sums = line.all_reduce(parts)[0]
    return (torch.log(sums[..., 0]) + top[0] - sums[..., 1]).sum()


# ---------------------------------------------------------------------------
# Sharding vocabulary.  Meshes use axes ("data", "model") and optionally a
# leading "pod" axis that is pure DP (params replicated across pods).
# Large 2-D weights are sharded over BOTH axes (TP on the feature axis,
# FSDP/ZeRO-style on the other), as the reference's are.
# ---------------------------------------------------------------------------

REPLICATED = P()


def spec_embed() -> PartitionSpec:      # (vocab, d): vocab over TP
    return P("model", "data")


def spec_in_proj() -> PartitionSpec:    # (d, features): features over TP
    return P("data", "model")


def spec_out_proj() -> PartitionSpec:   # (features, d)
    return P("model", "data")


def spec_expert_in() -> PartitionSpec:  # (E, d, ff): experts over TP (EP)
    return P("model", None, "data")


def spec_expert_out() -> PartitionSpec:  # (E, ff, d)
    return P("model", "data", None)


def spec_vector() -> PartitionSpec:     # norm scales, biases
    return P()


def stack_specs(tree, n: int = 1):
    """``tree``'s specs with ``n`` leading unsharded (stacked-layer) axes."""
    return tree_map(lambda s: P(*([None] * n), *s), tree)
