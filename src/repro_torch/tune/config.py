"""Kernel-configuration records the autotuner searches over and persists.

The counterpart of ``repro.tune.config``.  A :class:`KernelConfig` is
everything a plan needs to parameterise its kernel launches away from the
built-in heuristics:

  tile_b    transforms per CUDA thread block of the register-pass kernels
            (``fft_c2c``, ``fft_c2c_t``, ``fft_c2c_axis1``, ``fft_r2c``,
            ``fft_r2c_t``, ``fft_c2r``), and of the shared-memory
            ``fft_c2c_mul`` (None = ``repro_torch.kernels.fft.fft_kernel``'s
            ``pass_launch`` and ``transforms_per_block`` choose)
  radices   butterfly schedule of every fused pass (None = DEFAULT_RADICES)
  split     the four-step (n1, n2) factorisation for long transforms
            (None = the balanced ``_four_step_split`` heuristic)
  segment   overlap-save nfft for the convolution engine (0 = the
            ``select_nfft`` cost-model choice)

Configs are frozen/hashable so plan builders can key their memoisation on
them, and JSON-round-trippable (the reference's JSON form, key for key) so
the on-disk tuning cache can persist them.  :class:`ConfigKey` identifies
what a config was tuned *for*: ``(device, shape, kind, dtype)`` — the same
axes the paper sweeps clocks per (device, length, precision).
"""
from __future__ import annotations

import dataclasses
from typing import Any

#: Where a config came from — surfaced in receipts/benchmarks.
SOURCE_HEURISTIC = "heuristic"
SOURCE_TUNED = "tuned"
SOURCE_COMMON = "common"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of the kernel-configuration space (None = heuristic)."""

    tile_b: int | None = None
    radices: tuple[int, ...] | None = None
    split: tuple[int, int] | None = None
    segment: int = 0
    source: str = SOURCE_HEURISTIC

    @property
    def is_heuristic(self) -> bool:
        """True when every axis defers to the built-in heuristics."""
        return (self.tile_b is None and self.radices is None
                and self.split is None and self.segment == 0)

    def to_dict(self) -> dict[str, Any]:
        return {
            "tile_b": self.tile_b,
            "radices": list(self.radices) if self.radices else None,
            "split": list(self.split) if self.split else None,
            "segment": self.segment,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KernelConfig":
        radices = d.get("radices")
        split = d.get("split")
        return cls(
            tile_b=d.get("tile_b"),
            radices=tuple(int(r) for r in radices) if radices else None,
            split=tuple(int(s) for s in split) if split else None,  # type: ignore[arg-type]
            segment=int(d.get("segment") or 0),
            source=str(d.get("source", SOURCE_TUNED)),
        )


#: The all-heuristic config (what every plan ran before the autotuner).
HEURISTIC = KernelConfig()


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    """What a config was tuned for: (device, shape, kind, dtype)."""

    device: str
    shape: tuple[int, ...]
    kind: str = "c2c"
    dtype: str = "fp32"

    def token(self) -> str:
        """Stable string form used as the JSON cache key."""
        dims = "x".join(str(d) for d in self.shape)
        return f"{self.device}|{dims}|{self.kind}|{self.dtype}"

    @classmethod
    def from_token(cls, token: str) -> "ConfigKey":
        device, dims, kind, dtype = token.split("|")
        shape = tuple(int(d) for d in dims.split("x") if d)
        return cls(device=device, shape=shape, kind=kind, dtype=dtype)
