"""The paper's own workload as a selectable config: batched C2C FFTs (the
counterpart of ``repro.configs.fft_bench``, the same fields and values).

``chip_smoke.py`` phase 12 runs the distributed pencil at
``pencil_n1`` x ``pencil_n2``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FFTBenchConfig:
    name: str = "fft-bench"
    # paper Sec. 4: ~2 GB of complex64 input per batch
    batch_bytes: float = 2e9
    lengths: tuple[int, ...] = tuple(2**k for k in range(5, 23))
    precisions: tuple[str, ...] = ("fp32", "fp64", "fp16")
    # distributed (pencil) case: one transform of n1*n2 points, n1 sharded
    pencil_n1: int = 4096
    pencil_n2: int = 8192
    pencil_batch: int = 64


CONFIG = FFTBenchConfig()
