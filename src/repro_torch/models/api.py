"""Unified model API: ``build_model(cfg) -> Model`` (the counterpart of
``repro.models.api``).

The three implementations (transformer / mamba2 / zamba2) expose the same
functions, so the serve driver treats every architecture alike.  Each
function takes ``params`` as the family's module (:class:`TransformerLM`,
:class:`Mamba2LM`, :class:`Zamba2LM`, what ``init`` and
``models.convert.params_from_reference`` return) or as a plain nested
dict of tensors in the reference's layout.

``param_specs`` and ``cache_specs`` give the reference's PartitionSpec
trees on the paths of the parameter tree (``state_dict()`` keys) and of
``cache_shapes``; ``param_shapes`` the parameter tree's shapes and dtypes,
nothing drawn (``jax.eval_shape(model.init, key)``'s place): the dry run
(``launch.dryrun``) reads the three.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2, transformer, zamba2
from repro_torch.models.common import ParamTree, tree_map


def family_module(cfg: ArchConfig) -> ModuleType:
    """The implementation of ``cfg``'s family, as the reference dispatches."""
    if cfg.family == "hybrid":
        return zamba2
    if cfg.family == "ssm":
        return mamba2
    return transformer


class LanguageModel(ParamTree):
    """A family's parameters as an ``nn.Module`` in the reference's layout
    (``state_dict()`` keys are the reference tree's paths joined by
    ``.``), with the family's forward, prefill and decode as methods."""

    impl: ModuleType

    def __init__(self, tree: dict, cfg: ArchConfig):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, inp):
        return self.impl.forward(self, inp, self.cfg)

    def prefill(self, inp):
        return self.impl.prefill_step(self, inp, self.cfg)

    def decode(self, cache, tok):
        return self.impl.decode_step(self, cache, tok, self.cfg)


class TransformerLM(LanguageModel):
    impl = transformer


class Mamba2LM(LanguageModel):
    impl = mamba2


class Zamba2LM(LanguageModel):
    impl = zamba2


_MODULES = {transformer: TransformerLM, mamba2: Mamba2LM, zamba2: Zamba2LM}


def language_model(tree: dict, cfg: ArchConfig) -> LanguageModel:
    """The family module of ``cfg`` holding ``tree``'s tensors."""
    return _MODULES[family_module(cfg)](tree, cfg)


def resolve_device(device) -> torch.device:
    """``device``, else the card; never the CPU unless asked for.  A CUDA
    device raises where there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the model zoo runs on a CUDA device and none is present; "
                "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _init(cfg: ArchConfig, mod: ModuleType, gen: torch.Generator,
          device=None) -> LanguageModel:
    device = resolve_device(device)
    tree = mod.init_params(gen, cfg)
    if gen.device != device:
        tree = tree_map(lambda t: t.to(device), tree)
    return language_model(tree, cfg)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]              # (gen, device=None) -> module
    forward: Callable[..., Any]           # (params, inp) -> (logits, aux)
    prefill: Callable[..., Any]           # (params, inp) -> (logits, cache)
    decode: Callable[..., Any]            # (params, cache, tok) -> (logits,
                                          #   cache)
    forward_hidden: Callable[..., Any]    # (params, inp) -> (hidden, aux)
    unembed: Callable[..., Any]           # (params, hidden) -> logits
    cache_shapes: Callable[..., Any]      # (batch, seq) -> TensorSpec tree
    param_specs: Callable[[], Any]        # () -> PartitionSpec tree
    cache_specs: Callable[[], Any]
    param_shapes: Callable[[], Any]       # () -> TensorSpec tree


def build_model(cfg: ArchConfig) -> Model:
    mod = family_module(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: _init(cfg, mod, gen, device),
        forward=lambda params, inp: mod.forward(params, inp, cfg),
        prefill=lambda params, inp: mod.prefill_step(params, inp, cfg),
        decode=lambda params, cache, tok: mod.decode_step(params, cache,
                                                          tok, cfg),
        forward_hidden=lambda params, inp: mod.forward_hidden(params, inp,
                                                              cfg),
        unembed=lambda params, h: mod.unembed(params, h, cfg),
        cache_shapes=lambda batch, seq: mod.cache_shapes(cfg, batch, seq),
        param_specs=lambda: mod.param_specs(cfg),
        cache_specs=lambda: mod.cache_specs(cfg),
        param_shapes=lambda: mod.param_shapes(cfg),
    )
