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
fields), so a checkpoint written by either package restores in the other.

Restore rebuilds the structure of ``tree_like``: a tensor leaf comes back
on ``like.device`` at ``like.dtype``, a numpy leaf at ``like.dtype``, any
other leaf as a CPU tensor.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Iterator

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Iterator[tuple[str, Any]] | None:
    """(key, child) pairs in flatten order, or None for a leaf."""
    if isinstance(node, dict):
        return ((str(k), node[k]) for k in sorted(node))
    if _is_namedtuple(node):
        return ((f, getattr(node, f)) for f in node._fields)
    if isinstance(node, (list, tuple)):
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
    if isinstance(like, dict):
        return type(like)((k, _rebuild(v, leaves, path + (str(k),)))
                          for k, v in like.items())
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves, path + (f,))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, path + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(path)]


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore_leaf(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return torch.from_numpy(arr)


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
            arr = _to_host(leaf)
            fn = name.replace("/", "__") + f".host{self.host_id}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest[name] = {"file": fn, "shape": list(arr.shape),
                              "dtype": str(arr.dtype)}
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
