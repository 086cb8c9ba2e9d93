"""Kernel-configuration records plans are parameterised by.

The part of ``repro.tune.config`` this slice's plans read:

  tile_b    transforms per thread block of the CUDA kernels (None =
            ``repro_torch.kernels.fft.fft_kernel.pass_launch``'s, and
            ``transforms_per_block``'s for ``fft_c2c_mul``)
  radices   butterfly schedule of every fused pass (None = DEFAULT_RADICES)
  split     the four-step (n1, n2) factorisation for long transforms
            (None = the balanced ``_four_step_split`` heuristic)

Configs are frozen/hashable so plan builders can key their memoisation on
them.  :class:`ConfigKey` identifies what a config was tuned *for*:
``(device, shape, kind, dtype)`` — the same axes the paper sweeps clocks
per (device, length, precision).  The overlap-save ``segment`` axis and
the persisted tuning records come with the autotuner slice of the port.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of the kernel-configuration space (None = heuristic)."""

    tile_b: int | None = None
    radices: tuple[int, ...] | None = None
    split: tuple[int, int] | None = None

    @property
    def is_heuristic(self) -> bool:
        """True when every axis defers to the built-in heuristics."""
        return self.tile_b is None and self.radices is None \
            and self.split is None


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    """What a config was tuned for: (device, shape, kind, dtype)."""

    device: str
    shape: tuple[int, ...]
    kind: str = "c2c"
    dtype: str = "fp32"
