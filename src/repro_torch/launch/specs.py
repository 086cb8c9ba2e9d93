"""input_specs(): meta-tensor stand-ins for every dry-run cell, with their
mesh-fixed PartitionSpecs (the counterpart of ``repro.launch.specs``).

The reference pairs each ``jax.ShapeDtypeStruct`` with a
``NamedSharding``; the port has no SPMD partitioner, so a spec stays a
:class:`~repro_torch.models.common.PartitionSpec` fixed for the mesh
(:func:`fix_sharding`), and a stand-in is an empty ``meta`` tensor, which
holds no data and allocates nothing.  Token inputs are int64, as the
port's drivers feed them (the reference's are int32).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.api import build_model
from repro_torch.models.common import (P, PartitionSpec, TensorSpec,
                                       dtype_of, tree_map)


def _batch_spec(mesh, *trailing) -> PartitionSpec:
    b = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return P(b, *trailing)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def fix_sharding(shape: tuple[int, ...], spec: PartitionSpec, mesh
                 ) -> PartitionSpec:
    """Make ``spec`` divisibility-correct for ``shape`` on ``mesh``.

    Every sharded dim must divide exactly.  Where a dim does not (e.g.
    kv_heads=2 over an 8-way model axis, or vocab=50280), the offending
    mesh axes are MOVED to the largest dim that can absorb them (appended
    to that dim's existing axes), else dropped.  For decode caches this
    turns head-sharding into sequence-sharding — split-KV decode, where
    attention partial-sums over the cache shards.  The reference's
    arithmetic, entry for entry.
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    homeless: list[str] = []
    for i, (dim, axes) in enumerate(zip(shape, entries)):
        if axes is None:
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        keep: list[str] = []
        for a in tup:
            cur = _axis_size(mesh, tuple(keep) + (a,))
            if dim % cur == 0:
                keep.append(a)
            else:
                homeless.append(a)
        entries[i] = tuple(keep) if keep else None
    for a in homeless:
        # place on the largest dim that can absorb this axis
        cands = []
        for i, dim in enumerate(shape):
            cur = entries[i]
            cur_t = () if cur is None else (
                (cur,) if isinstance(cur, str) else tuple(cur))
            if a in cur_t:
                continue
            combined = _axis_size(mesh, cur_t + (a,))
            if dim % combined == 0:
                cands.append((dim // _axis_size(mesh, cur_t), i, cur_t))
        if cands:
            _, i, cur_t = max(cands)
            entries[i] = cur_t + (a,)
        # else: drop (replicate over that axis)
    cleaned = [e if e is None or isinstance(e, str) else
               (e[0] if len(e) == 1 else e) for e in entries]
    while cleaned and cleaned[-1] is None:
        cleaned.pop()
    return P(*cleaned)


def fix_tree(tree, spec_tree, mesh):
    """The tree of :func:`fix_sharding` specs of ``tree``'s leaves
    (tensors or :class:`TensorSpec`s; a ``TrainState`` or ``AdamWState``
    walked field by field) under ``spec_tree``'s specs — the reference's
    tree of ``NamedSharding``s, without the devices."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, TensorSpec):
        return type(tree)(**{
            f.name: fix_tree(getattr(tree, f.name), getattr(spec_tree, f.name),
                             mesh) for f in dataclasses.fields(tree)})
    return tree_map(lambda leaf, sp: fix_sharding(tuple(leaf.shape), sp, mesh),
                    tree, spec_tree)


def meta(spec: TensorSpec) -> torch.Tensor:
    """An empty ``meta`` tensor of ``spec``'s shape and dtype."""
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """(meta tensor, fixed spec) pairs for one (arch x shape x mesh) cell:
    ``inputs`` and ``labels`` (train), ``inputs`` (prefill), or ``token``
    and ``cache`` (decode), whose pair is (tree of meta tensors, tree of
    fixed specs)."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype, spec):
        return (meta(TensorSpec(shp, dtype)), fix_sharding(shp, spec, mesh))

    def inputs(seq):
        if cfg.input_mode == "embeds":
            return sds((b, seq, cfg.d_model), dtype_of(cfg),
                       _batch_spec(mesh, None, None))
        return sds((b, seq), torch.long, _batch_spec(mesh, None))

    if shape.kind == "train":
        return {"inputs": inputs(s),
                "labels": sds((b, s), torch.long, _batch_spec(mesh, None))}
    if shape.kind == "prefill":
        return {"inputs": inputs(s)}

    # decode: one new token + full cache of seq_len
    model = build_model(cfg)

    def remap(spec: PartitionSpec) -> PartitionSpec:
        """Map 'data' -> ('pod', 'data') batch group on multi-pod meshes."""
        if "pod" not in mesh.axis_names:
            return spec
        return P(*[("pod", "data") if x == "data" else x for x in spec])

    shapes = model.cache_shapes(b, s)
    cache = (tree_map(meta, shapes),
             tree_map(lambda sd, sp: fix_sharding(sd.shape, remap(sp), mesh),
                      shapes, model.cache_specs()))
    return {"token": inputs(1), "cache": cache}
