"""Peaks of the card and the work each roofline counts.

The work is what the function needs, whatever implements it: each input
byte read once and each output byte written once, counted from shapes
(not from the program's own per-pass ledger, which counts its passes and
so measures the implementation).  A roofline share is the least time the
card could take, the larger of bytes over peak bandwidth and operations
over peak rate, over the device time measured.
"""
from __future__ import annotations

import math

#: NVIDIA H100 SXM published peaks (data sheet; at its 700 W power limit):
#: HBM3 bytes/s; float32 FLOP/s outside the tensor cores (an FMA counts
#: two).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

COMPLEX64 = 8
FLOAT32 = 4
#: The transform kinds :func:`fft_work` counts: a unit of one of these
#: kinds is a batch of 1-D FFTs.
FFT_KINDS = ("c2c", "r2c", "c2r")


def fft_work(kind: str, n: int, rows: int) -> tuple[int, float]:
    """(bytes, FLOPs) of ``rows`` transforms of length ``n``.

    C2C reads and writes n complex64 points a row; R2C reads n float32
    and writes n/2+1 complex64 bins; C2R the reverse.  FLOPs are the
    radix-2 count, 5 n log2 n a complex transform and half that a real
    one."""
    bins = n // 2 + 1
    if kind == "c2c":
        nbytes, flops = 2 * n * COMPLEX64, 5.0 * n * math.log2(n)
    elif kind == "r2c":
        nbytes, flops = n * FLOAT32 + bins * COMPLEX64, 2.5 * n * math.log2(n)
    elif kind == "c2r":
        nbytes, flops = bins * COMPLEX64 + n * FLOAT32, 2.5 * n * math.log2(n)
    else:
        raise ValueError(f"unknown transform kind {kind!r}")
    return rows * nbytes, rows * flops


def bound_s(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """Least seconds the card could take, and which bound binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
