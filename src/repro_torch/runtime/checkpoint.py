"""Sharded, atomic, step-tagged checkpointing (the counterpart of
``repro.runtime.checkpoint``, in the same on-disk format).

  * each host writes ONLY its local leaves — no gather, no single-writer
    bottleneck;
  * writes go to a temp directory + atomic rename, so a node failure
    mid-write never corrupts the latest-complete pointer;
  * the manifest records each leaf's key path, shape and dtype;
  * retention: keep the last K checkpoints (bounded disk).

The format is the reference's, byte for byte where numpy writes it: one
``<a__b__0>.host{h}.npy`` file per leaf (``np.save`` of the leaf on the
host), ``manifest.host{h}.json``, a ``DONE.host{h}`` marker per host and
``step_%08d`` folders.  Leaves are keyed by the same ``a/b/0`` path
strings (dict keys in sorted order, list and tuple indices, named-tuple
and the fields of a :func:`tree_dataclass` in declaration order, a
``ParamTree`` as its nested dict), so a checkpoint written by either package restores in the other:
a ``train.step.TrainState`` is ``params/...``, ``opt/step``, ``opt/m/...``,
``opt/v/...``, ``step``, as the reference's registered dataclasses.

Restore rebuilds the structure of ``tree_like``: a tensor leaf comes back
on ``like.device`` at ``like.dtype``, a numpy leaf at ``like.dtype``, any
other leaf as a CPU tensor; a ``ParamTree`` comes back as its nested dict.

bfloat16: numpy has no bf16 of its own.  A bf16 leaf is saved as its
16-bit words under the header ``np.save`` writes for the reference's
``ml_dtypes.bfloat16`` array (descr ``<V2``, a two-byte void), with
manifest dtype ``"bfloat16"``: the same bytes.  Restore reads such words
back as bf16 bits.  (The reference cannot restore them: ``np.load``
gives a void array, whose ``astype(bfloat16)`` raises.)

Elastic restore: a sharded leaf (``repro_torch.fft.distributed.
ShardedTensor``) is saved as its gathered array, so the manifest stays
mesh-agnostic, and restored onto the mesh, axis and dim of the ``like``
leaf — a checkpoint saved on one mesh restores onto the shrunk mesh of
``runtime.elastic.elastic_remesh_plan`` (the reference's
``device_put(arr, like.sharding)``).  A replicated leaf
(``ReplicatedTensor``) is saved once and restored onto every slot of the
``like`` leaf's axis, so a sharded train state (``train.sharded``) saved
on one data mesh restores on another, or unsharded.  A leaf placed over
several mesh axes (``PlacedTensor``) is saved gathered too and restored
onto the ``like`` leaf's mesh by its spec: a state saved on a (data,
model) mesh restores on any other, or unsharded.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from repro_torch.fft.distributed import (PlacedTensor, ReplicatedTensor,
                                         ShardedTensor, place, replicate,
                                         shard)
from repro_torch.models.common import ParamTree

#: numpy's dtype for the 16-bit words of a bfloat16 leaf.
BF16_WORDS = np.dtype("V2")
#: The ``.npy`` descr of ``ml_dtypes.bfloat16`` (``np.save`` of a plain
#: void array writes ``|V2``).
BF16_DESCR = "<V2"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


#: Dataclasses walked field by field (:func:`tree_dataclass`).
_TREE_DATACLASSES: set[type] = set()


def tree_dataclass(cls: type) -> type:
    """Class decorator: checkpoints walk instances of the dataclass ``cls``
    field by field, in declaration order, keyed by field name (the
    reference's ``jax.tree_util.register_dataclass``).  Other dataclasses
    are leaves."""
    _TREE_DATACLASSES.add(cls)
    return cls


def _is_dataclass(node) -> bool:
    return type(node) in _TREE_DATACLASSES


def _children(node) -> Iterator[tuple[str, Any]] | None:
    """(key, child) pairs in flatten order, or None for a leaf."""
    if isinstance(node, ParamTree):
        return ((k, node[k]) for k in sorted(node.keys()))
    if isinstance(node, dict):
        return ((str(k), node[k]) for k in sorted(node))
    if _is_namedtuple(node):
        return ((f, getattr(node, f)) for f in node._fields)
    if _is_dataclass(node):
        return ((f.name, getattr(node, f.name))
                for f in dataclasses.fields(node))
    if isinstance(node, (list, tuple, nn.ModuleList)):
        return ((str(i), v) for i, v in enumerate(node))
    return None


def _flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """[(key path, leaf)] in flatten order; ``None`` is an empty subtree."""
    out: list[tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for key, child in kids:
            walk(child, path + (key,))

    walk(tree, ())
    return out


def _rebuild(like, leaves: dict[str, Any], path: tuple = ()):
    """``like``'s structure with each leaf replaced from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, ParamTree):
        return {k: _rebuild(like[k], leaves, path + (k,))
                for k in like.keys()}
    if isinstance(like, nn.ModuleList):
        return [_rebuild(v, leaves, path + (str(i),))
                for i, v in enumerate(like)]
    if isinstance(like, dict):
        return type(like)((k, _rebuild(v, leaves, path + (str(k),)))
                          for k, v in like.items())
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves, path + (f,))
                            for f in like._fields))
    if _is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves, path + (f.name,))
            for f in dataclasses.fields(like)})
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, path + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(path)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """The leaf as the array ``np.save`` writes, and its manifest dtype."""
    if isinstance(leaf, (ShardedTensor, ReplicatedTensor, PlacedTensor)):
        leaf = leaf.gather()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            words = leaf.view(torch.int16).numpy().view(BF16_WORDS)
            return words, "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``; bf16 words under the reference's descr."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_host(arr: np.ndarray) -> torch.Tensor:
    """A saved array as a CPU tensor; 16-bit words as bfloat16 bits."""
    if arr.dtype == BF16_WORDS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _restore_leaf(arr: np.ndarray, like):
    if isinstance(like, ShardedTensor):
        return shard(_from_host(arr).to(like.dtype), like.mesh,
                     like.axis, like.dim)
    if isinstance(like, ReplicatedTensor):
        return replicate(_from_host(arr).to(like.dtype), like.mesh,
                         like.axis)
    if isinstance(like, PlacedTensor):
        return place(_from_host(arr).to(like.dtype), like.mesh, like.spec)
    if isinstance(like, torch.Tensor):
        return _from_host(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return _from_host(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 host_id: int = 0, n_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        tmp = os.path.join(self.dir, f".tmp-{step}-{self.host_id}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for name, leaf in _flatten_with_paths(tree):
            arr, dtype = _to_host(leaf)
            fn = name.replace("/", "__") + f".host{self.host_id}.npy"
            _save(os.path.join(tmp, fn), arr, dtype)
            manifest[name] = {"file": fn, "shape": list(arr.shape),
                              "dtype": dtype}
        with open(os.path.join(tmp, f"manifest.host{self.host_id}.json"),
                  "w") as f:
            json.dump({"step": step, "leaves": manifest,
                       "n_hosts": self.n_hosts}, f)
        # atomic publish (host 0 renames; other hosts move files in)
        os.makedirs(final, exist_ok=True)
        for fn in os.listdir(tmp):
            os.replace(os.path.join(tmp, fn), os.path.join(final, fn))
        shutil.rmtree(tmp, ignore_errors=True)
        # completion marker per host; checkpoint is valid when all present
        open(os.path.join(final, f"DONE.host{self.host_id}"), "w").close()
        self._gc()
        return final

    # ------------------------------------------------------------------
    def _complete(self, path: str) -> bool:
        return all(
            os.path.exists(os.path.join(path, f"DONE.host{h}"))
            for h in range(self.n_hosts))

    def latest_step(self) -> int | None:
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and self._complete(
                    os.path.join(self.dir, d)):
                steps.append(int(d.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, tree_like, step: int | None = None):
        """Restore into the structure (devices and dtypes) of
        ``tree_like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path,
                               f"manifest.host{self.host_id}.json")) as f:
            manifest = json.load(f)["leaves"]
        leaves = {}
        for name, like in _flatten_with_paths(tree_like):
            arr = np.load(os.path.join(path, manifest[name]["file"]))
            leaves[name] = _restore_leaf(arr, like)
        return _rebuild(tree_like, leaves)

    # ------------------------------------------------------------------
    def _gc(self):
        done = sorted(
            d for d in os.listdir(self.dir)
            if d.startswith("step_") and self._complete(
                os.path.join(self.dir, d)))
        for d in done[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
