"""Mixed-radix machinery shared by the pure-torch and CUDA FFT engines.

A numpy copy of ``repro.fft.radix``: the port imports nothing of the JAX
package, and every table here must stay bit-identical to the reference's
(the parity tests assert ``np.array_equal``), because these tables are the
state that decides the numbers of every transform.

Everything is host-side and memoised: radix schedules, per-stage twiddle
tables, the small DFT matrices of each butterfly, and the R2C/C2R split
twiddles.  Consumers copy the returned arrays to the device once per
(length, device), never per call.

Radix choice: a radix-r Stockham stage decides log2(r) output bits at
once, so a radix-4 + radix-2-tail schedule halves the stage count of the
radix-2 engine (log4 N vs log2 N), and radix-8 cuts it to a third.  Fewer
stages means fewer shared-memory passes per transform — the ``t_cache``
term of the DVFS model (repro_torch.core.perf_model).
"""
from __future__ import annotations

import functools

import numpy as np

#: Default schedule: radix-4 stages with a radix-2 tail.
DEFAULT_RADICES = (4, 2)


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (for n >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


#: Real FLOPs per point per stage of a radix-r DIF butterfly (classic
#: operation counts: 5 N log2 N total for radix-2, 4.25 N log2 N for
#: radix-4, ~4.08 N log2 N for radix-8; each stage decides log2(r) bits).
STAGE_FLOPS_PER_POINT = {2: 5.0, 4: 8.5, 8: 12.25}


@functools.lru_cache(maxsize=None)
def radix_schedule(n: int, radices: tuple[int, ...] = DEFAULT_RADICES
                   ) -> tuple[int, ...]:
    """Greedy largest-first factorisation of ``n`` into allowed radices.

    With 2 in ``radices`` every power of two factors; other lengths raise.
    """
    if n < 1:
        raise ValueError(f"FFT length must be >= 1, got {n}")
    schedule: list[int] = []
    m = n
    allowed = sorted(set(radices), reverse=True)
    while m > 1:
        for r in allowed:
            if m % r == 0:
                schedule.append(r)
                m //= r
                break
        else:
            raise ValueError(
                f"length {n} has no factorisation into radices {radices}")
    # Run the small residual radix (the "tail") FIRST, while the butterfly
    # width h = M/r is still large: a radix-2 stage at h=1 leaves most
    # threads of a block with one strided butterfly each.
    return tuple(sorted(schedule))


def stage_count(n: int, radices: tuple[int, ...] = DEFAULT_RADICES) -> int:
    """Stages a single fused kernel runs for length ``n``."""
    return len(radix_schedule(n, radices))


def mixed_radix_flop_count(n: int,
                           radices: tuple[int, ...] = DEFAULT_RADICES,
                           batch: int = 1) -> float:
    """Real FLOPs actually executed by the mixed-radix engine.

    Lower than the paper's 5 N log2 N reporting convention (Eq. 5) for
    radices above 2 — higher radices do the same transform with fewer
    twiddle multiplies.
    """
    per_point = sum(STAGE_FLOPS_PER_POINT[r] for r in radix_schedule(n, radices))
    return per_point * n * batch


def r2c_flop_count(n: int, radices: tuple[int, ...] = DEFAULT_RADICES,
                   batch: int = 1) -> float:
    """FLOPs of the packed R2C path: an N/2 complex FFT plus the split."""
    m = n // 2
    if m < 1:
        return 0.0
    inner = mixed_radix_flop_count(m, radices) if m > 1 else 0.0
    return (inner + 10.0 * (m + 1)) * batch


@functools.lru_cache(maxsize=None)
def dft_matrix(r: int, inverse: bool = False) -> np.ndarray:
    """The (r, r) DFT matrix of one radix-r butterfly (complex128)."""
    sign = 1.0 if inverse else -1.0
    k = np.arange(r)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / r)


@functools.lru_cache(maxsize=None)
def stage_twiddles(n: int, radices: tuple[int, ...] = DEFAULT_RADICES,
                   inverse: bool = False) -> tuple[np.ndarray, ...]:
    """Per-stage twiddle tables: one (r-1, h) complex128 array per stage.

    Stage with current sub-length M and h = M/r: branch k (1..r-1) gets
    w_M^{k*j}, j in [0, h).  Computed once per (n, radices, sign).
    """
    sign = 1.0 if inverse else -1.0
    tables: list[np.ndarray] = []
    m = n
    for r in radix_schedule(n, radices):
        h = m // r
        j = np.arange(h)
        k = np.arange(1, r)
        tables.append(np.exp(sign * 2j * np.pi * np.outer(k, j) / m))
        m = h
    return tuple(tables)


@functools.lru_cache(maxsize=None)
def packed_stage_twiddles(n: int,
                          radices: tuple[int, ...] = DEFAULT_RADICES
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Forward twiddles packed for the fused kernels: (rows, n) re/im f32.

    Row layout: stages in execution order, branches k = 1..r-1 within a
    stage; each row holds its h = M/r twiddles left-aligned, zero-padded
    to n.  A kernel reads ``[row, :h]`` at offsets fixed by the schedule.
    Inverse transforms conjugate in-kernel (negate the im plane).
    """
    tables = stage_twiddles(n, radices, False)
    rows = sum(t.shape[0] for t in tables)
    re = np.zeros((max(rows, 1), n), np.float32)
    im = np.zeros((max(rows, 1), n), np.float32)
    row = 0
    for t in tables:
        k, h = t.shape
        re[row:row + k, :h] = t.real
        im[row:row + k, :h] = t.imag
        row += k
    return re, im


@functools.lru_cache(maxsize=None)
def rfft_split_twiddles(n: int) -> np.ndarray:
    """W[k] = exp(-2*pi*i*k/n), k = 0..n/2 — the R2C split / C2R merge
    factors (complex128; cast to the working dtype by the consumer)."""
    k = np.arange(n // 2 + 1)
    return np.exp(-2j * np.pi * k / n)
