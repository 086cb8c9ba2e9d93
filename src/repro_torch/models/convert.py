"""Weights carried across between the reference and the port.

``params_from_reference`` turns the reference's parameter pytree (nested
dicts and lists of arrays: numpy, or anything ``np.asarray`` reads) into
the family module of the port, on ``device``; ``params_to_reference``
turns a module (or a nested dict of tensors) back into the reference's
pytree of numpy arrays.  The round trip is bit-identical.

bfloat16 leaves travel as their bits: numpy has no bfloat16 of its own,
so a reference bf16 array (``ml_dtypes.bfloat16``) is read through a
uint16 view, and ``ml_dtypes`` is imported only to hand bf16 back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import (LanguageModel, language_model,
                                    resolve_device)
from repro_torch.models.common import tree_map


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)                   # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def tensors_from_reference(tree, device=None):
    """A reference pytree of arrays (nested dicts and lists) as the same
    tree of tensors on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_from_reference(tree, cfg: ArchConfig, device=None
                          ) -> LanguageModel:
    """The reference's parameter pytree as the port's family module on
    ``device`` (the card unless the caller asks for the CPU)."""
    return language_model(tensors_from_reference(tree, device), cfg)


def params_to_reference(params):
    """A family module (or any nested dict and list of tensors) as the
    reference's pytree of numpy arrays."""
    return tree_map(_to_numpy, params)
