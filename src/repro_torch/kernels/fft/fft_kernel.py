"""Fused mixed-radix Stockham FFT kernels: CUDA launches and plain twins.

Ten CUDA kernels (``repro_torch/csrc/fft_c2c.cu``, ``fft_real.cu`` and
``transpose.cu``; each file's header note says which TPU kernel each
replaces, what bounds it and what its design does about that) and,
beside each, a plain torch version that runs the same radix schedule, the
same packed twiddle table and the same butterfly arithmetic on float32
re/im planes — the counterpart of the reference's ``_mixed_radix_stages``.

  fft_c2c        (B, N) -> (B, N), pow2 N <= 2**13
  fft_c2c_t      (B, R, C) -> (B, C, R): FFT of each row, written
                 transposed; optional (R, C) twiddle before the write
  fft_c2c_axis1  (B, R, C) -> (B, R, C): FFT of each column, layout
                 kept; optional (C, R) twiddle: out[.., k, j] *= ftw[j, k]
  fft_c2c_mul    (B, N), (T, N) bank -> (B, T, N): FFT of each row times
                 every bank row (the reference's ``_c2c_mul_body``)
  fft_r2c        (B, N) float32 -> (B, N/2+1): packed R2C, pow2
                 4 <= N <= 2**14 (the reference's ``_r2c_tile``)
  fft_r2c_t      (B, R, C) float32 -> (B, C/2+1, R): packed R2C of each
                 row, written transposed
  fft_c2r        (B, N/2+1) -> (B, N) float32: packed C2R, 1/N (the
                 reference's ``_c2r_body``)
  fft_r2c_split  (B, N/2) -> (B, N/2+1): the Hermitian split of the long
                 R2C route, after its N/2-point four-step C2C
  fft_c2r_merge  (B, N/2+1) -> (B, N/2): the Hermitian merge of the long
                 C2R route, before its N/2-point inverse
  transpose      (B, R, C) -> (B, C, R) of 4-, 8- or 16-byte elements,
                 dtype kept

The C2C functions take contiguous complex64 tensors; the real ones take
or return contiguous float32.  The input's device decides: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel and raises if
the launch fails — there is no fallback between the two.  A ``meta``
tensor (a dry run, ``launch.fft_dryrun``) gets an empty meta result of
the kernel's output shape and dtype: the wrapper's shape function, which
computes and launches nothing.  ``LAUNCHES`` counts kernel launches
(only launches; the plain versions and meta calls never count), so a
caller can show that work went through the kernels.

Every FFT kernel but ``fft_c2c_mul`` runs the schedule in
register-resident passes (``csrc/stockham_regs.cuh``) that the host plans
here (:func:`pass_launch`, :func:`pass_table`), reading the same twiddle
numbers from a compact table (:func:`compact_twiddles`); ``fft_c2c`` and
``fft_r2c`` plan each launch once per shape in C (:func:`_plan`).
``fft_r2c_t`` and ``fft_c2c_t`` store their transposed output, and
``fft_c2c_axis1`` loads and stores its columns, through a thread-block
cluster (:func:`r2c_t_cluster`, :func:`c2c_cluster`).  ``fft_c2c_mul``
runs the schedule in shared memory.

The plain R2C/C2R versions run the Hermitian split and merge of the torch
engine (``repro_torch.fft.stockham``), and ``fft_r2c_split`` and
``fft_c2r_merge`` are those two alone; the kernels read its split table.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.fft.radix import (DEFAULT_RADICES, dft_matrix,
                                   packed_stage_twiddles, radix_schedule)
from repro_torch.fft.stockham import _irfft_merge, _rfft_split, _split_factors
from repro_torch.kernels.common import (MAX_SHARED_BYTES, batch_tile,
                                        load_library, round_up)

#: Radices the kernels implement: explicit radix-2/4 butterflies, radix 8
#: through its DFT matrix.  Any other radix in a schedule is rejected.
KERNEL_RADICES = (2, 4, 8)

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"fft_c2c": 0, "fft_c2c_t": 0, "fft_c2c_axis1": 0,
            "fft_c2c_mul": 0, "fft_r2c": 0, "fft_r2c_t": 0, "fft_c2r": 0,
            "transpose": 0, "fft_r2c_split": 0, "fft_c2r_merge": 0}

#: Side of the square tile the transpose kernel moves through shared
#: memory (``csrc/transpose.cu``).
TRANSPOSE_TILE = 32

#: Points k of one row that a block of ``fft_r2c_split`` or
#: ``fft_c2r_merge`` takes, with their mirrors N/2 - k (``kSpanPoints`` in
#: ``csrc/fft_real.cu``).
SPAN_POINTS = 1024

_ELEM_BYTES = 8          # complex64
_BUFFERS = 2             # ping-pong Stockham buffers in shared memory


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def schedule(n: int, radices: tuple[int, ...] = DEFAULT_RADICES
             ) -> tuple[int, ...]:
    """The radix schedule of length ``n``; raises on a radix the kernels
    do not implement."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"FFT length must be a power of two, got {n}")
    sched = radix_schedule(n, tuple(radices))
    bad = sorted(set(sched) - set(KERNEL_RADICES))
    if bad:
        raise ValueError(f"radices {bad} are not implemented by the CUDA "
                         f"kernels (have {KERNEL_RADICES})")
    return sched


def transforms_per_block(points: int, count: int,
                         override: int | None = None) -> int:
    """Transforms one thread block of the shared-memory kernel
    ``fft_c2c_mul`` holds (at most ``count``, the rows of the batch), each
    in two buffers of ``points`` complex values.

    The wrappers in ``ops`` decide it here once and pass it to the launch
    as ``per_block``."""
    tile = min(batch_tile(points, _ELEM_BYTES, buffers=_BUFFERS,
                          override=override), max(count, 1))
    if tile * points * _ELEM_BYTES * _BUFFERS > MAX_SHARED_BYTES:
        raise ValueError(f"{tile} transforms of {points} points per block "
                         f"exceed {MAX_SHARED_BYTES} bytes of shared memory")
    return tile


# ---------------------------------------------------------------------------
# Register-pass plan and launch geometry of fft_c2c and the real kernels
# ---------------------------------------------------------------------------

#: One SM of an H100: threads, registers, shared memory (228 KB) and the
#: shared memory the runtime reserves per block.
SM_THREADS = 2048
SM_REGISTERS = 65536
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_SHARED = 1024

#: Threads per block of the register-pass kernels, and the most a block
#: may run (their ``__launch_bounds__``).
PASS_THREADS = 256
#: Points one thread holds: 16 (n if shorter), and more where a transform
#: would otherwise take more than a block: 32 at n = 8192.
PASS_POINTS = 16
PASS_MAX_POINTS = 2**13 // PASS_THREADS
#: Most stages of one pass (PASS_MAX_POINTS = 2**5: five radix-2 stages).
PASS_STAGES = 5
#: The passes the planner makes, by kernel instance: (points a thread,
#: family), the family being the schedule's largest radix; over every set
#: of radices from (2, 4, 8) and every length.  The kernels compile each
#: instance for its own passes only (``REPRO_PASS_SHAPES`` in
#: ``csrc/stockham_regs.cuh``).
PASS_SHAPES = {
    (2, 2): ((2,),), (4, 2): ((2, 2),), (4, 4): ((4,),),
    (8, 2): ((2, 2, 2),), (8, 4): ((2, 4),), (8, 8): ((8,),),
    (16, 2): ((2,), (2, 2), (2, 2, 2), (2, 2, 2, 2)),
    (16, 4): ((4,), (2, 4), (4, 4)),
    (16, 8): ((4,), (8,), (2, 2), (2, 8)),
    (32, 2): ((2, 2, 2), (2, 2, 2, 2, 2)),
    (32, 4): ((4, 4), (2, 4, 4)),
    (32, 8): ((8,), (2, 8)),
}
#: Ints per pass in the plan table the launch reads (``csrc/
#: stockham_regs.cuh``, ``make_reg_plan``): log2 R, log2 H, stages, the
#: radix of each stage, the twiddle offset of each stage.
PASS_FIELDS = 3 + 2 * PASS_STAGES
#: Blocks per SM the launch bound of each kernel instance (points a
#: thread, family) sizes the registers for, 65536 / (256 * blocks) a
#: thread: 85 at 3, 128 at 2 (32 points take 64), 255 at 1.  The most at
#: which no instance spills (``pass_min_blocks`` in
#: ``csrc/stockham_regs.cuh``); 3 where not listed.  The radix-8
#: butterflies need more registers.
PASS_MIN_BLOCKS = {(16, 8): 2, (32, 2): 2, (32, 4): 2, (32, 8): 1}


def pass_registers(points: int, family: int) -> int:
    """Registers a thread of instance (points, family) may use."""
    blocks = PASS_MIN_BLOCKS.get((points, family), 3)
    return min(SM_REGISTERS // (PASS_THREADS * blocks), 255)


def pass_points(n: int) -> int:
    """Points one thread holds in a length-``n`` transform."""
    return max(min(n, PASS_POINTS), n // PASS_THREADS)


def padded(n: int) -> int:
    """Shared-memory slots of one transform's exchange buffer: one pad
    slot after every 16 points (``csrc/stockham_regs.cuh``, ``pad``)."""
    return n + n // 16


def line_slots(n: int, per_block: int) -> int:
    """Slots from one line's buffer to the next in ``fft_c2c_t`` and
    ``fft_c2c_axis1`` (``line_slots`` in ``csrc/stockham_regs.cuh``):
    :func:`padded` ``(n)``, raised to 16 / per_block mod 16 (to an odd
    number from 16 lines a block), so that the strided side's half-warps,
    which take ``per_block`` lines of consecutive points, hit 16 different
    banks."""
    if per_block == 1:
        return padded(n)
    if per_block >= 16:
        return padded(n) | 1
    return padded(n) + (16 // per_block - padded(n)) % 16


def split_slots(n: int) -> int:
    """Slots of one transform's buffer in the real kernels: the exchange
    buffer, which also holds the n + 1 bins of the Hermitian split or
    merge in natural order (``split_slots`` in ``csrc/stockham_regs.cuh``;
    more than :func:`padded` for n <= 8)."""
    return max(padded(n), n + 1)


@functools.lru_cache(maxsize=None)
def register_passes(n: int, radices: tuple[int, ...] = DEFAULT_RADICES
                    ) -> tuple[tuple[int, ...], ...]:
    """The stages of ``schedule(n, radices)`` grouped into register passes,
    front first: each pass takes the next stages while their radices
    multiply to at most the points a thread holds."""
    points = pass_points(n)
    passes: list[tuple[int, ...]] = []
    cur: list[int] = []
    prod = 1
    for r in schedule(n, tuple(radices)):
        if prod * r > points:
            passes.append(tuple(cur))
            cur, prod = [], 1
        cur.append(r)
        prod *= r
    if cur:
        passes.append(tuple(cur))
    return tuple(passes)


@functools.lru_cache(maxsize=None)
def pass_table(n: int, radices: tuple[int, ...] = DEFAULT_RADICES
               ) -> np.ndarray:
    """The plan the kernel runs: one row of ``PASS_FIELDS`` ints a pass.

    A pass of radices (r1, .., rk), R = r1*..*rk points an item, starts at
    sub-length M and leaves H = M / R.  Item (li, jj), jj < H, holds the R
    points li*M + q*H + jj; stage i butterflies the digit of q at register
    stride S_i = r_{i+1}*..*rk, with twiddle column b*H + jj (b the lower
    digits) read at the stage's offset in :func:`compact_twiddles`.  The
    point in register q = k1*S_1 + .. + kk*S_k goes to
    item + (k1 + r1*k2 + r1*r2*k3 + ..) * n / R: the Stockham order.  The
    kernel knows the strides and output offsets of each pass's radices at
    compile time; the row gives the radices, R, H and the offsets."""
    passes = register_passes(n, tuple(radices))
    table = np.zeros((len(passes), PASS_FIELDS), np.int32)
    m, tw = n, 0
    for row, radix in zip(table, passes):
        r_all = int(np.prod(radix))
        h = m // r_all
        row[0] = r_all.bit_length() - 1
        row[1] = h.bit_length() - 1
        row[2] = len(radix)
        row[3:3 + len(radix)] = radix
        for i, r in enumerate(radix):
            row[3 + PASS_STAGES + i] = tw
            tw += (r - 1) * int(np.prod(radix[i + 1:])) * h   # r - 1 rows
        m = h
    assert tw == n - 1 and m == 1
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=None)
def compact_twiddles(n: int, radices: tuple[int, ...],
                     device: torch.device) -> torch.Tensor:
    """The stage twiddles the pass kernels read, as one complex64 table of
    n - 1 entries: stage after stage, branch k = 1..r-1 after branch, the
    h = M/r columns of each — the first h entries of each row of
    :func:`stage_tables`, the same float32 numbers."""
    twr, twi = packed_stage_twiddles(n, tuple(radices))
    re, im = [], []
    row, m = 0, n
    for r in schedule(n, tuple(radices)):
        h = m // r
        for k in range(r - 1):
            re.append(twr[row + k, :h])
            im.append(twi[row + k, :h])
        row += r - 1
        m = h
    re = np.concatenate(re) if re else np.zeros(1, np.float32)
    im = np.concatenate(im) if im else np.zeros(1, np.float32)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


@dataclasses.dataclass(frozen=True)
class PassLaunch:
    """Launch geometry of a register-pass kernel (``fft_c2c``;
    ``fft_c2c_t`` and ``fft_c2c_axis1`` at ``buffer``; the real kernels
    ``fft_r2c``, ``fft_r2c_t``, ``fft_c2r`` at ``split``) for ``n`` complex
    points a transform (N/2 for the real ones)."""

    n: int
    passes: tuple[tuple[int, ...], ...]
    points: int            # points a thread holds
    per_block: int         # transforms a block runs
    threads: int           # threads a block runs: per_block * n / points
    shared_bytes: int      # the block's exchange buffers
    blocks: int

    @property
    def family(self) -> int:
        """The schedule's largest radix: with ``points``, the kernel
        instance that runs the plan."""
        return max(max(p) for p in self.passes)

    @property
    def exchanges(self) -> int:
        """Round trips through shared memory between passes."""
        return len(self.passes) - 1

    @property
    def resident_blocks(self) -> int:
        """Blocks one SM can hold at once, from the thread, register
        (:func:`pass_registers` a thread) and shared-memory budgets; the
        card's own count comes from
        ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
        (:func:`resident_blocks`)."""
        fits = [SM_THREADS // self.threads,
                SM_REGISTERS // (self.threads
                                 * pass_registers(self.points, self.family))]
        if self.shared_bytes:
            fits.append(SM_SHARED_BYTES
                        // (self.shared_bytes + BLOCK_RESERVED_SHARED))
        return min(fits)


@functools.lru_cache(maxsize=1024)
def pass_launch(n: int, count: int,
                radices: tuple[int, ...] = DEFAULT_RADICES,
                override: int | None = None, *,
                split: bool = False, buffer: bool = False) -> PassLaunch:
    """Launch geometry of ``count`` length-``n`` transforms: ``n / points``
    threads a transform, ``PASS_THREADS`` a block (one transform a block
    from n = 4096), at most ``count`` transforms a block.  ``override``
    (the ``tile_b`` tuning axis) sets the transforms per block, validated
    against the thread and shared-memory limits.
    Shared memory holds one padded buffer a transform when the plan has an
    exchange; with ``buffer`` (``fft_c2c_t`` and ``fft_c2c_axis1``, whose
    strided side goes through it) always; with ``split`` (the real
    kernels, whose Hermitian split or merge reads bins k and n - k
    together) always, of :func:`split_slots` ``(n)`` slots."""
    if n < 2:
        raise ValueError(f"register-pass kernels need n >= 2, got {n}")
    passes = register_passes(n, tuple(radices))
    points = pass_points(n)
    per_transform = n // points
    if override is not None and override < 1:
        raise ValueError(f"batch tile override must be >= 1, got {override}")
    tile = min(override or max(PASS_THREADS // per_transform, 1),
               max(count, 1))
    threads = tile * per_transform
    if split:
        shared = tile * split_slots(n) * _ELEM_BYTES
    elif buffer:
        shared = tile * line_slots(n, tile) * _ELEM_BYTES
    else:
        shared = tile * padded(n) * _ELEM_BYTES if len(passes) > 1 else 0
    if threads > PASS_THREADS:
        raise ValueError(f"{tile} transforms of {n} points per block need "
                         f"{threads} threads (at most {PASS_THREADS})")
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"{tile} transforms of {n} points per block "
                         f"exceed {MAX_SHARED_BYTES} bytes of shared memory")
    family = max(max(p) for p in passes)
    if not set(passes) <= set(PASS_SHAPES.get((points, family), ())):
        raise ValueError(f"the {n}-point plan {passes} has a pass the "
                         f"kernels do not compile for {points} points a "
                         f"thread and family {family}")
    return PassLaunch(n=n, passes=passes, points=points, per_block=tile,
                      threads=threads, shared_bytes=shared,
                      blocks=blocks(count, tile))


#: Rows of one batch entry that a cluster of ``fft_r2c_t`` blocks stores
#: together: one bin of them is one contiguous run of R2C_T_ROWS * 8 bytes
#: (32 B, one sector).  The fastest of 1, 4 and 8 at (16, 4096, 8192) on
#: an H100 (``chip_smoke.py``, ``phase3_rows_per_block``).
R2C_T_ROWS = 4
#: Rows (``fft_c2c_t``) or columns (``fft_c2c_axis1``) of one batch entry
#: that a cluster of those kernels' blocks moves together: one point of
#: them is one contiguous run of C2C_CLUSTER_LINES * 8 bytes (32 B, one
#: sector).  The fastest of 1, 4 and 8 at (16, 4096, 4096) and (238,
#: 1024, 1024) on an H100 (``chip_smoke.py``, ``phase3_rows_per_block``).
C2C_CLUSTER_LINES = 4
#: The same where a batch entry's lines are no multiple of four (rfft2's
#: 4097 bin rows): each run then starts inside a sector, and one of 4
#: lines straddles two sectors, one of 8 at most three.  The fastest of
#: 1, 4 and 8 at (16, 4097, 4096).
C2C_UNALIGNED_LINES = 8
#: Bytes of one sector of device memory.
_SECTOR_BYTES = 32
#: Most blocks of a cluster (the portable limit).
MAX_CLUSTER = 8


def r2c_t_cluster(per_block: int, rows: int,
                  cluster_rows: int = R2C_T_ROWS) -> int:
    """Blocks G of one cluster of a clustered kernel (``fft_r2c_t`` by
    default): ``cluster_rows`` rows of ``per_block`` a block, at most
    ``MAX_CLUSTER`` and no more blocks than the ``rows`` of a batch entry
    fill."""
    if cluster_rows < 1:
        raise ValueError(f"cluster rows must be >= 1, got {cluster_rows}")
    return max(1, min(cluster_rows // per_block, MAX_CLUSTER,
                      -(-rows // per_block)))


def c2c_cluster(per_block: int, count: int,
                cluster_lines: int | None = None) -> int:
    """Blocks G of one ``fft_c2c_t`` or ``fft_c2c_axis1`` cluster:
    ``cluster_lines`` rows or columns of ``per_block`` a block (by default
    C2C_CLUSTER_LINES, or C2C_UNALIGNED_LINES where the ``count`` rows or
    columns of a batch entry do not fill whole sectors), at most
    ``MAX_CLUSTER``, and no more blocks than ``count`` fills."""
    if cluster_lines is None:
        cluster_lines = (C2C_CLUSTER_LINES
                         if count * _ELEM_BYTES % _SECTOR_BYTES == 0
                         else C2C_UNALIGNED_LINES)
    return r2c_t_cluster(per_block, count, cluster_lines)


def clustered_blocks(b: int, count: int, per_block: int,
                     cluster: int) -> int:
    """Thread blocks of a clustered launch (``fft_r2c_t``, ``fft_c2c_t``,
    ``fft_c2c_axis1``), masked ones included: ``b`` batch entries, each
    cut into tiles of ``per_block * cluster`` rows or columns out of
    ``count``, ``cluster`` blocks a tile."""
    return blocks(count, per_block * cluster, b) * cluster


def blocks(count: int, per_block: int, outer: int = 1) -> int:
    """Thread blocks of a launch: ``outer`` batch entries, each cut into
    blocks of ``per_block`` transforms out of ``count``."""
    return outer * (round_up(count, per_block) // per_block)


def span_blocks(b: int, n: int) -> int:
    """Blocks of a ``fft_r2c_split`` or ``fft_c2r_merge`` launch over ``b``
    rows of the real length ``n``: the N/4 points k of a row in spans of
    :data:`SPAN_POINTS`."""
    return b * -(-(n // 4) // SPAN_POINTS)


def transpose_blocks(b: int, r: int, c: int) -> int:
    """Thread blocks of a transpose launch: one per tile of each plane."""
    return blocks(r, TRANSPOSE_TILE, b) * blocks(c, TRANSPOSE_TILE)


# ---------------------------------------------------------------------------
# Tables on the device (once per length, radices and device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def stage_tables(n: int, radices: tuple[int, ...],
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed forward twiddle table as (rows, n) float32 re/im planes."""
    twr, twi = packed_stage_twiddles(n, tuple(radices))
    return (torch.from_numpy(twr).to(device), torch.from_numpy(twi).to(device))


@functools.lru_cache(maxsize=None)
def _dft8(inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    d = dft_matrix(8, inverse)
    return (np.ascontiguousarray(d.real, np.float32),
            np.ascontiguousarray(d.imag, np.float32))


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the card's reference in checks)
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    """Complex multiply on split planes: (ar + i*ai) * (br + i*bi)."""
    return ar * br - ai * bi, ar * bi + ai * br


def _stages_plain(re: torch.Tensor, im: torch.Tensor, n: int,
                  radices: tuple[int, ...], inverse: bool):
    """Run the full radix schedule on (B, N) float32 re/im planes."""
    b = re.shape[0]
    sched = schedule(n, radices)
    if n == 1:
        return re, im
    twr, twi = stage_tables(n, tuple(radices), re.device)
    sign = 1.0 if inverse else -1.0
    if inverse:
        twi = -twi
    re = re.reshape(b, 1, n)
    im = im.reshape(b, 1, n)
    l, m, row = 1, n, 0
    for r in sched:
        h = m // r
        ws = [(twr[row + k, :h], twi[row + k, :h]) for k in range(r - 1)]
        parts = [(re[..., p * h:(p + 1) * h], im[..., p * h:(p + 1) * h])
                 for p in range(r)]
        if r == 2:
            (ar, ai), (br, bi) = parts
            outs = [(ar + br, ai + bi)]
            branches = [(ar - br, ai - bi)]
        elif r == 4:
            (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r, x3i) = parts
            t0r, t0i = x0r + x2r, x0i + x2i
            t1r, t1i = x0r - x2r, x0i - x2i
            t2r, t2i = x1r + x3r, x1i + x3i
            t3r, t3i = x1r - x3r, x1i - x3i
            # b1/b3 = t1 -+ i*t3 (forward); sign flips for the inverse.
            u3r, u3i = -sign * t3i, sign * t3r
            outs = [(t0r + t2r, t0i + t2i)]
            branches = [(t1r + u3r, t1i + u3i),
                        (t0r - t2r, t0i - t2i),
                        (t1r - u3r, t1i - u3i)]
        else:
            # Radix 8 through its DFT matrix, in the kernel's order.
            dr, di = _dft8(inverse)
            accr, acci = parts[0]
            for pr, pi in parts[1:]:
                accr, acci = accr + pr, acci + pi
            outs = [(accr, acci)]
            branches = []
            for k in range(1, r):
                accr, acci = parts[0]
                for p in range(1, r):
                    cr, ci = float(dr[p, k]), float(di[p, k])
                    pr, pi = parts[p]
                    accr = accr + pr * cr - pi * ci
                    acci = acci + pr * ci + pi * cr
                branches.append((accr, acci))
        for k, (vr, vi) in enumerate(branches):
            wr, wi = ws[k]
            outs.append(_cmul(vr, vi, wr, wi))
        re = torch.stack([o[0] for o in outs], dim=1).reshape(b, r * l, h)
        im = torch.stack([o[1] for o in outs], dim=1).reshape(b, r * l, h)
        row += r - 1
        l, m = r * l, h
    re = re.reshape(b, n)
    im = im.reshape(b, n)
    if inverse:
        re, im = re / n, im / n
    return re, im


def _planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    v = torch.view_as_real(x)
    return v[..., 0], v[..., 1]


def _join(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re.contiguous(), im.contiguous())


def _twiddle_plain(re, im, ftw: torch.Tensor | None):
    if ftw is None:
        return re, im
    wr, wi = _planes(ftw)
    return _cmul(re, im, wr, wi)


def fft_c2c_plain(x: torch.Tensor, *, inverse: bool = False,
                  radices: tuple[int, ...] = DEFAULT_RADICES) -> torch.Tensor:
    """Plain torch version of :func:`fft_c2c`."""
    b, n = x.shape
    re, im = _planes(x)
    re, im = _stages_plain(re, im, n, radices, inverse)
    return _join(re, im)


def fft_c2c_t_plain(x: torch.Tensor, twiddle: torch.Tensor | None = None, *,
                    inverse: bool = False,
                    radices: tuple[int, ...] = DEFAULT_RADICES
                    ) -> torch.Tensor:
    """Plain torch version of :func:`fft_c2c_t`."""
    b, r, c = x.shape
    re, im = _planes(x.reshape(b * r, c))
    re, im = _stages_plain(re, im, c, radices, inverse)
    re, im = _twiddle_plain(re.reshape(b, r, c), im.reshape(b, r, c), twiddle)
    return _join(re.transpose(1, 2), im.transpose(1, 2))


def fft_c2c_axis1_plain(x: torch.Tensor, twiddle: torch.Tensor | None = None,
                        *, inverse: bool = False,
                        radices: tuple[int, ...] = DEFAULT_RADICES
                        ) -> torch.Tensor:
    """Plain torch version of :func:`fft_c2c_axis1`."""
    b, r, c = x.shape
    re, im = _planes(x.transpose(1, 2).reshape(b * c, r))
    re, im = _stages_plain(re, im, r, radices, inverse)
    re, im = _twiddle_plain(re.reshape(b, c, r), im.reshape(b, c, r), twiddle)
    return _join(re.transpose(1, 2), im.transpose(1, 2))


def fft_c2c_mul_plain(x: torch.Tensor, bank: torch.Tensor, *,
                      inverse: bool = False,
                      radices: tuple[int, ...] = DEFAULT_RADICES
                      ) -> torch.Tensor:
    """Plain torch version of :func:`fft_c2c_mul`."""
    b, n = x.shape
    re, im = _stages_plain(*_planes(x), n, radices, inverse)
    br, bi = _planes(bank)
    return _join(*_cmul(re[:, None, :], im[:, None, :], br[None], bi[None]))


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`transpose`."""
    return x.transpose(1, 2).contiguous()


def _real_length(n: int) -> int:
    """The half length of a packed real transform (pow2 N >= 4)."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"packed R2C/C2R length must be a power of two "
                         f">= 4, got {n}")
    return n // 2


def fft_r2c_plain(x: torch.Tensor, *,
                  radices: tuple[int, ...] = DEFAULT_RADICES) -> torch.Tensor:
    """Plain torch version of :func:`fft_r2c`."""
    b, n = x.shape
    m = _real_length(n)
    v = x.reshape(b, m, 2)
    return _rfft_split(_join(*_stages_plain(v[..., 0], v[..., 1], m, radices,
                                            False)), n)


def fft_r2c_t_plain(x: torch.Tensor, *,
                    radices: tuple[int, ...] = DEFAULT_RADICES
                    ) -> torch.Tensor:
    """Plain torch version of :func:`fft_r2c_t`."""
    b, r, c = x.shape
    y = fft_r2c_plain(x.reshape(b * r, c), radices=radices)
    return y.reshape(b, r, c // 2 + 1).transpose(1, 2).contiguous()


def fft_c2r_plain(x: torch.Tensor, *,
                  radices: tuple[int, ...] = DEFAULT_RADICES) -> torch.Tensor:
    """Plain torch version of :func:`fft_c2r`."""
    b, m1 = x.shape
    m = _real_length(2 * (m1 - 1))
    zr, zi = _stages_plain(*_planes(_irfft_merge(x, 2 * m)), m, radices, True)
    return torch.stack([zr, zi], dim=-1).reshape(b, 2 * m)


def fft_r2c_split_plain(z: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of :func:`fft_r2c_split`."""
    return _rfft_split(z, n)


def fft_c2r_merge_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of :func:`fft_c2r_merge`."""
    return _irfft_merge(x, n)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fft_c2c")
    lib.repro_fft_error_string.argtypes = [_I]
    lib.repro_fft_error_string.restype = ctypes.c_char_p
    _pass_plan_types(lib)
    lib.repro_fft_c2c_plan.argtypes = [_P, _I, _I, _I, _P, _I, _I, _P, _P,
                                       _P]
    lib.repro_fft_c2c_plan.restype = _I
    lib.repro_fft_c2c_run.argtypes = [_P, _P, _P, _LL, _P]
    lib.repro_fft_c2c_run.restype = _I
    lib.repro_fft_c2c_resident_blocks.argtypes = [_I, _I, _I, _LL]
    lib.repro_fft_c2c_resident_blocks.restype = _I
    lib.repro_fft_c2c_mul.argtypes = [_P, _P, _LL, _I, _I, _I, _P, _P, _I,
                                      _I, _P, _P, _P, _P, _P]
    lib.repro_fft_c2c_mul.restype = _I
    for fn in (lib.repro_fft_c2c_t, lib.repro_fft_c2c_axis1):
        fn.argtypes = [_P, _P, _LL, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                       _P, _P, _P]
        fn.restype = _I
    lib.repro_fft_c2c_active_clusters.argtypes = [_I, _I, _I, _I, _LL, _I]
    lib.repro_fft_c2c_active_clusters.restype = _I
    return lib


@functools.cache
def _real_library() -> ctypes.CDLL:
    lib = load_library("fft_real")
    lib.repro_fft_error_string.argtypes = [_I]
    lib.repro_fft_error_string.restype = ctypes.c_char_p
    _pass_plan_types(lib)
    lib.repro_fft_r2c_plan.argtypes = [_P, _I, _I, _I, _P, _I, _P, _P, _P,
                                       _P]
    lib.repro_fft_r2c_plan.restype = _I
    lib.repro_fft_r2c_run.argtypes = [_P, _P, _P, _LL, _P]
    lib.repro_fft_r2c_run.restype = _I
    lib.repro_fft_c2r.argtypes = [_P, _P, _LL, _I, _I, _I, _P, _I, _P, _P,
                                  _P, _P, _P]
    lib.repro_fft_c2r.restype = _I
    lib.repro_fft_r2c_t.argtypes = [_P, _P, _LL, _I, _I, _I, _I, _I, _P,
                                    _I, _P, _P, _P, _P, _P]
    lib.repro_fft_r2c_t.restype = _I
    lib.repro_fft_real_resident_blocks.argtypes = [_I, _I, _I, _I, _LL]
    lib.repro_fft_real_resident_blocks.restype = _I
    lib.repro_fft_r2c_t_active_clusters.argtypes = [_I, _I, _I, _LL, _I]
    lib.repro_fft_r2c_t_active_clusters.restype = _I
    for fn in (lib.repro_fft_r2c_split, lib.repro_fft_c2r_merge):
        fn.argtypes = [_P, _P, _LL, _I, _P, _P]
        fn.restype = _I
    return lib


def _pass_plan_types(lib: ctypes.CDLL) -> None:
    """The C types of the planned launches' shared entries
    (``csrc/stockham_regs.cuh``)."""
    lib.repro_pass_plan_bytes.argtypes = []
    lib.repro_pass_plan_bytes.restype = _I
    lib.repro_pass_noop.argtypes = [_P, _P, _P, _LL, _P]
    lib.repro_pass_noop.restype = _I


@functools.cache
def _transpose_library() -> ctypes.CDLL:
    lib = load_library("transpose")
    lib.repro_fft_error_string.argtypes = [_I]
    lib.repro_fft_error_string.restype = ctypes.c_char_p
    lib.repro_transpose.argtypes = [_P, _P, _LL, _I, _I, _I, _P]
    lib.repro_transpose.restype = _I
    return lib


def _check(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.dtype != torch.complex64 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous {ndim}-D complex64 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: no kernel for device {x.device}")


def _check_twiddle(ftw: torch.Tensor | None, shape: tuple[int, int],
                   x: torch.Tensor) -> None:
    if ftw is None:
        return
    if (tuple(ftw.shape) != shape or ftw.dtype != torch.complex64
            or not ftw.is_contiguous() or ftw.device != x.device):
        raise ValueError(f"twiddle must be a contiguous complex64 {shape} "
                         f"tensor on {x.device}, got {tuple(ftw.shape)} "
                         f"{ftw.dtype} on {ftw.device}")


def _current(device: torch.device):
    """A context in which ``device`` is the current CUDA device: entered
    only where another one is current (entering costs host time on every
    call)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, for a launch: PyTorch's
    raw lookup, which builds no ``torch.cuda.Stream`` (a few µs of host
    time on every call; ``chip_smoke.py``, ``phase3_host_gap``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """A planned launch of ``fft_c2c`` or ``fft_r2c`` (``repro_fft_*_plan``
    in ``csrc/``): the address of its C plan, with the buffer that holds
    it and the tables it points into kept alive here."""

    address: int
    keep: tuple


@functools.lru_cache(maxsize=1024)
def _plan(name: str, n: int, count: int, radices: tuple[int, ...],
          per_block: int, inverse: bool, device: torch.device) -> _Plan:
    """The C plan of ``count`` transforms of length ``n`` (the real length
    for ``fft_r2c``), ``per_block`` a block, made once per shape and
    device: the plan table checked, the geometry sized, the instance's
    shared-memory limit raised.  A call then spends its host time on the
    launch alone."""
    m = n if name == "fft_c2c" else n // 2
    launch = pass_launch(m, count, radices, per_block,
                         split=name != "fft_c2c")
    table = pass_table(m, radices)
    dr, di = _dft8(inverse)
    tw = compact_twiddles(m, radices, device)
    keep: tuple = (table, dr, di, tw)
    if name == "fft_c2c":
        lib = _library()
        make, tail = lib.repro_fft_c2c_plan, (int(inverse), dr.ctypes.data,
                                              di.ctypes.data, tw.data_ptr())
    else:
        lib = _real_library()
        sw = _split_factors(n, device, torch.complex64)
        keep += (sw,)
        make, tail = lib.repro_fft_r2c_plan, (dr.ctypes.data, di.ctypes.data,
                                              tw.data_ptr(), sw.data_ptr())
    buf = ctypes.create_string_buffer(lib.repro_pass_plan_bytes())
    with _current(device):
        err = make(buf, n, launch.points, launch.per_block,
                   table.ctypes.data, len(table), *tail)
    if err:
        raise RuntimeError(f"CUDA kernel {name}: its launch of {count} x {n} "
                           f"could not be planned: "
                           f"{lib.repro_fft_error_string(err).decode()}")
    return _Plan(ctypes.addressof(buf), (buf,) + keep)


@functools.lru_cache(maxsize=1024)
def _pass_args(n: int, count: int, radices: tuple[int, ...],
               per_block: int, inverse: bool,
               device: torch.device) -> tuple:
    """The C arguments of an ``fft_c2r`` or ``fft_r2c_t`` launch between
    its shape and its stream, for ``count`` transforms of the half length
    ``n``, cached per shape: the launch's geometry and plan table, the
    radix-8 matrix of the direction (``inverse``: C2R), the compact table
    and the split table of the full length, with the tables they point
    into (kept alive here)."""
    launch = pass_launch(n, count, radices, per_block, split=True)
    table = pass_table(n, radices)
    dr, di = _dft8(inverse)
    tw = compact_twiddles(n, radices, device)
    sw = _split_factors(2 * n, device, torch.complex64)
    return ((launch.points, launch.per_block, table.ctypes.data, len(table),
             dr.ctypes.data, di.ctypes.data, tw.data_ptr(), sw.data_ptr()),
            (table, dr, di, tw, sw))


def _schedule_args(n: int, radices: tuple[int, ...], inverse: bool,
                   device: torch.device):
    """The C arguments of an ``fft_c2c_mul`` launch's schedule (kept alive
    by the caller)."""
    sched = np.asarray(schedule(n, radices), np.int32)
    dr, di = _dft8(inverse)
    twr, twi = stage_tables(n, tuple(radices), device)
    return sched, dr, di, twr, twi


def fft_c2c(x: torch.Tensor, *, inverse: bool = False,
            radices: tuple[int, ...] = DEFAULT_RADICES,
            per_block: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Batched pow2 C2C FFT over the last axis of a (B, N) tensor in
    register passes (:func:`pass_launch`), ``per_block`` transforms per
    thread block, into ``out`` where given (a contiguous (B, N) complex64
    tensor on ``x``'s device; ``x`` itself in place: a transform's threads
    load all its points before the first exchange and store after the
    last, and no two transforms share a point)."""
    _check(x, 2, "fft_c2c")
    b, n = x.shape
    dev = x.device
    if out is not None:
        _check(out, 2, "fft_c2c's out")
        if out.shape != x.shape or out.device != dev:
            raise ValueError(f"fft_c2c's out must be {tuple(x.shape)} on "
                             f"{dev}, got {tuple(out.shape)} on {out.device}")
    if dev.type == "cpu":
        y = fft_c2c_plain(x, inverse=inverse, radices=radices)
        return y if out is None else out.copy_(y)
    y = torch.empty_like(x) if out is None else out
    if b == 0 or dev.type == "meta":         # meta: the shape alone
        return y
    plan = _plan("fft_c2c", n, b, tuple(radices), per_block, inverse, dev)
    lib = _library()
    with _current(dev):
        err = lib.repro_fft_c2c_run(plan.address, x.data_ptr(), y.data_ptr(),
                                    b, _stream(dev))
    _raise_on(err, "fft_c2c", lib)
    return y


def fft_c2c_t(x: torch.Tensor, twiddle: torch.Tensor | None = None, *,
              inverse: bool = False,
              radices: tuple[int, ...] = DEFAULT_RADICES,
              per_block: int, cluster: int = 1) -> torch.Tensor:
    """Row FFT of a (B, R, C) tensor written transposed to (B, C, R) in
    register passes (:func:`pass_launch`), ``per_block`` rows per thread
    block, in clusters of ``cluster`` blocks that store their rows
    together (:func:`c2c_cluster`)."""
    _check(x, 3, "fft_c2c_t")
    b, r, c = x.shape
    _check_twiddle(twiddle, (r, c), x)
    _check_cluster(cluster, "fft_c2c_t")
    if x.device.type == "cpu":
        return fft_c2c_t_plain(x, twiddle, inverse=inverse, radices=radices)
    y = torch.empty((b, c, r), dtype=x.dtype, device=x.device)
    if b * r == 0 or x.device.type == "meta":
        return y
    return _launch_strided("fft_c2c_t", x, y, c, r, twiddle, inverse,
                           radices, per_block, cluster)


def fft_c2c_axis1(x: torch.Tensor, twiddle: torch.Tensor | None = None, *,
                  inverse: bool = False,
                  radices: tuple[int, ...] = DEFAULT_RADICES,
                  per_block: int, cluster: int = 1) -> torch.Tensor:
    """Column FFT of a (B, R, C) tensor, layout kept, in register passes
    (:func:`pass_launch`), ``per_block`` columns per thread block, in
    clusters of ``cluster`` blocks that load and store their columns
    together (:func:`c2c_cluster`)."""
    _check(x, 3, "fft_c2c_axis1")
    b, r, c = x.shape
    _check_twiddle(twiddle, (c, r), x)
    _check_cluster(cluster, "fft_c2c_axis1")
    if x.device.type == "cpu":
        return fft_c2c_axis1_plain(x, twiddle, inverse=inverse,
                                   radices=radices)
    y = torch.empty_like(x)
    if b * c == 0 or x.device.type == "meta":
        return y
    return _launch_strided("fft_c2c_axis1", x, y, r, c, twiddle, inverse,
                           radices, per_block, cluster)


def fft_c2c_mul(x: torch.Tensor, bank: torch.Tensor, *,
                inverse: bool = False,
                radices: tuple[int, ...] = DEFAULT_RADICES,
                per_block: int) -> torch.Tensor:
    """Batched pow2 C2C FFT of a (B, N) tensor times every row of a (T, N)
    complex64 bank -> (B, T, N), ``per_block`` transforms per thread
    block."""
    _check(x, 2, "fft_c2c_mul")
    b, n = x.shape
    if (bank.dtype != torch.complex64 or bank.ndim != 2
            or bank.shape[1] != n or bank.shape[0] < 1
            or not bank.is_contiguous() or bank.device != x.device):
        raise ValueError(f"filter bank must be a contiguous complex64 "
                         f"(T, {n}) tensor on {x.device}, got "
                         f"{tuple(bank.shape)} {bank.dtype} on {bank.device}")
    if x.device.type == "cpu":
        return fft_c2c_mul_plain(x, bank, inverse=inverse, radices=radices)
    t = bank.shape[0]
    y = torch.empty((b, t, n), dtype=x.dtype, device=x.device)
    if b == 0 or x.device.type == "meta":
        return y
    sched, dr, di, twr, twi = _schedule_args(n, radices, inverse, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().repro_fft_c2c_mul(
            x.data_ptr(), y.data_ptr(), b, n, per_block, t, bank.data_ptr(),
            sched.ctypes.data, len(sched), int(inverse), dr.ctypes.data,
            di.ctypes.data, twr.data_ptr(), twi.data_ptr(), stream)
    _raise_on(err, "fft_c2c_mul", _library())
    return y


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(B, R, C) -> (B, C, R) of any dtype of 4, 8 or 16 bytes (kept)."""
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"transpose takes a contiguous 3-D tensor, got "
                         f"{tuple(x.shape)} (contiguous "
                         f"{x.is_contiguous()})")
    size = x.element_size()
    if size not in (4, 8, 16):
        raise ValueError(f"transpose moves 4-, 8- or 16-byte elements, got "
                         f"{x.dtype}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"transpose: no kernel for device {x.device}")
    if x.device.type == "cpu":
        return transpose_plain(x)
    if x.data_ptr() % size:
        raise ValueError(f"transpose: the input must be {size}-byte aligned")
    b, r, c = x.shape
    y = torch.empty((b, c, r), dtype=x.dtype, device=x.device)
    if x.numel() == 0 or x.device.type == "meta":
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _transpose_library().repro_transpose(
            x.data_ptr(), y.data_ptr(), b, r, c, size, stream)
    _raise_on(err, "transpose", _transpose_library())
    return y


def _check_cluster(cluster: int, what: str) -> None:
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"{what}: a cluster takes 1..{MAX_CLUSTER} blocks, "
                         f"got {cluster}")


@functools.lru_cache(maxsize=1024)
def _strided_args(n: int, count: int, radices: tuple[int, ...],
                  per_block: int, inverse: bool,
                  device: torch.device) -> tuple:
    """The geometry of an ``fft_c2c_t`` or ``fft_c2c_axis1`` launch of
    ``count`` transforms of length ``n``, and its C arguments between the
    cluster size and the four-step twiddle, cached per shape (with the
    tables they point into, kept alive here)."""
    launch = pass_launch(n, count, radices, per_block, buffer=True)
    table = pass_table(n, radices)
    dr, di = _dft8(inverse)
    tw = compact_twiddles(n, radices, device)
    return (launch, (launch.points, launch.per_block, table.ctypes.data,
                     len(table), int(inverse), dr.ctypes.data,
                     di.ctypes.data, tw.data_ptr()), (table, dr, di, tw))


def _launch_strided(name: str, x: torch.Tensor, y: torch.Tensor, n: int,
                    count: int, twiddle: torch.Tensor | None, inverse: bool,
                    radices: tuple[int, ...], per_block: int,
                    cluster: int) -> torch.Tensor:
    """Launch ``fft_c2c_t`` or ``fft_c2c_axis1`` on (B, R, C) ``x``:
    ``count`` transforms of length ``n`` a batch entry (R of C for ``t``,
    C of R for ``axis1``)."""
    b, r, c = x.shape
    dev = x.device
    launch, args, _ = _strided_args(n, count, tuple(radices), per_block,
                                    inverse, dev)
    if active_clusters(launch, cluster, name) < 1:
        raise RuntimeError(
            f"{name}: cudaOccupancyMaxActiveClusters is 0 for clusters of "
            f"{cluster} blocks of {launch.threads} threads and "
            f"{launch.shared_bytes} bytes of shared memory: the card cannot "
            f"place one")
    lib = _library()
    ftw = twiddle.data_ptr() if twiddle is not None else None
    with _current(dev):
        err = getattr(lib, f"repro_{name}")(
            x.data_ptr(), y.data_ptr(), b, r, c, cluster, *args, ftw,
            _stream(dev))
    _raise_on(err, name, lib)
    return y


def _check_real(x: torch.Tensor, what: str, ndim: int = 2) -> None:
    if x.dtype != torch.float32 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous {ndim}-D float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 8:
        # The kernel reads pairs of reals as one float2; a contiguous slice
        # at an odd element offset is legal in torch but not 8-byte aligned.
        raise ValueError(f"{what}: the input must be 8-byte aligned (a "
                         f"slice at an odd element offset is not); copy it")


def fft_r2c(x: torch.Tensor, *, radices: tuple[int, ...] = DEFAULT_RADICES,
            per_block: int) -> torch.Tensor:
    """Batched packed R2C FFT of a (B, N) float32 tensor -> (B, N/2+1)
    complex64: the N/2-point C2C in register passes (:func:`pass_launch`),
    then the Hermitian split, ``per_block`` transforms per thread block."""
    _check_real(x, "fft_r2c")
    b, n = x.shape
    m = _real_length(n)
    dev = x.device
    if dev.type == "cpu":
        return fft_r2c_plain(x, radices=radices)
    y = torch.empty((b, m + 1), dtype=torch.complex64, device=dev)
    if b == 0 or dev.type == "meta":
        return y
    plan = _plan("fft_r2c", n, b, tuple(radices), per_block, False, dev)
    lib = _real_library()
    with _current(dev):
        err = lib.repro_fft_r2c_run(plan.address, x.data_ptr(), y.data_ptr(),
                                    b, _stream(dev))
    _raise_on(err, "fft_r2c", lib)
    return y


def fft_r2c_t(x: torch.Tensor, *, radices: tuple[int, ...] = DEFAULT_RADICES,
              per_block: int, cluster: int = 1) -> torch.Tensor:
    """Packed R2C of each row of a (B, R, C) float32 tensor, written
    transposed to (B, C/2+1, R) complex64: the C/2-point C2C in register
    passes (:func:`pass_launch`), ``per_block`` rows per thread block, in
    clusters of ``cluster`` blocks that store their rows together
    (:func:`r2c_t_cluster`)."""
    _check_real(x, "fft_r2c_t", ndim=3)
    b, r, c = x.shape
    m = _real_length(c)
    _check_cluster(cluster, "fft_r2c_t")
    if x.device.type == "cpu":
        return fft_r2c_t_plain(x, radices=radices)
    y = torch.empty((b, m + 1, r), dtype=torch.complex64, device=x.device)
    if b * r == 0 or x.device.type == "meta":
        return y
    args, _ = _pass_args(m, r, tuple(radices), per_block, False, x.device)
    launch = pass_launch(m, r, tuple(radices), per_block, split=True)
    if active_clusters(launch, cluster) < 1:
        raise RuntimeError(
            f"fft_r2c_t: cudaOccupancyMaxActiveClusters is 0 for clusters "
            f"of {cluster} blocks of {launch.threads} threads and "
            f"{launch.shared_bytes} bytes of shared memory: the card cannot "
            f"place one")
    lib = _real_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_fft_r2c_t(x.data_ptr(), y.data_ptr(), b, r, c,
                                  cluster, *args, stream)
    _raise_on(err, "fft_r2c_t", lib)
    return y


def fft_c2r(x: torch.Tensor, *, radices: tuple[int, ...] = DEFAULT_RADICES,
            per_block: int) -> torch.Tensor:
    """Batched packed C2R inverse of a (B, N/2+1) complex64 tensor ->
    (B, N) float32 (1/N normalised): the Hermitian merge in the first
    register pass's reads, the N/2-point inverse in register passes
    (:func:`pass_launch`), ``per_block`` transforms per thread block."""
    _check(x, 2, "fft_c2r")
    b, m1 = x.shape
    m = _real_length(2 * (m1 - 1))
    if x.device.type == "cpu":
        return fft_c2r_plain(x, radices=radices)
    y = torch.empty((b, 2 * m), dtype=torch.float32, device=x.device)
    if b == 0 or x.device.type == "meta":
        return y
    args, _ = _pass_args(m, b, tuple(radices), per_block, True, x.device)
    lib = _real_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_fft_c2r(x.data_ptr(), y.data_ptr(), b, 2 * m,
                                *args, stream)
    _raise_on(err, "fft_c2r", lib)
    return y


def _hermitian(name: str, x: torch.Tensor, n: int, out: int,
               plain) -> torch.Tensor:
    """``fft_r2c_split`` or ``fft_c2r_merge`` (``name``) of the (B, *)
    complex64 ``x`` of the real length ``n``: ``plain`` on the CPU, else
    the kernel into a new (B, out) complex64 tensor."""
    _check(x, 2, name)
    _real_length(n)
    if x.device.type == "cpu":
        return plain(x, n)
    b = x.shape[0]
    dev = x.device
    y = torch.empty((b, out), dtype=torch.complex64, device=dev)
    if b == 0 or dev.type == "meta":
        return y
    sw = _split_factors(n, dev, torch.complex64)
    lib = _real_library()
    with _current(dev):
        err = getattr(lib, f"repro_{name}")(x.data_ptr(), y.data_ptr(), b, n,
                                            sw.data_ptr(), _stream(dev))
    _raise_on(err, name, lib)
    return y


def fft_r2c_split(z: torch.Tensor, n: int) -> torch.Tensor:
    """The Hermitian split of a (B, N/2) complex64 tensor, the N/2-point
    spectra of B rows of N packed reals, -> (B, N/2+1) complex64 bins."""
    if z.ndim != 2 or 2 * z.shape[-1] != n:
        raise ValueError(f"fft_r2c_split of length {n} takes (B, {n // 2}), "
                         f"got {tuple(z.shape)}")
    return _hermitian("fft_r2c_split", z, n, n // 2 + 1, fft_r2c_split_plain)


def fft_c2r_merge(x: torch.Tensor, n: int) -> torch.Tensor:
    """The Hermitian merge of a (B, N/2+1) complex64 half-spectrum of
    length N -> the (B, N/2) packed input of its N/2-point inverse."""
    if x.ndim != 2 or 2 * (x.shape[-1] - 1) != n:
        raise ValueError(f"fft_c2r_merge of length {n} takes "
                         f"(B, {n // 2 + 1}), got {tuple(x.shape)}")
    return _hermitian("fft_c2r_merge", x, n, n // 2, fft_c2r_merge_plain)


#: Kernel ids of ``repro_fft_real_resident_blocks`` (``csrc/fft_real.cu``).
_REAL_KERNELS = {"fft_r2c": 0, "fft_c2r": 1, "fft_r2c_t": 2}


def resident_blocks(name: str, launch: PassLaunch) -> int:
    """Blocks of ``launch`` that one SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) for the pass
    kernel ``name`` (``fft_c2c``, ``fft_r2c``, ``fft_c2r`` or
    ``fft_r2c_t``)."""
    shape = (launch.points, launch.family, launch.threads,
             launch.shared_bytes)
    if name == "fft_c2c":
        got = _library().repro_fft_c2c_resident_blocks(*shape)
    else:
        got = _real_library().repro_fft_real_resident_blocks(
            _REAL_KERNELS[name], *shape)
    if got < 0:
        raise RuntimeError(f"occupancy query of {name} failed for {launch}")
    return got


#: Kernel ids of ``repro_fft_c2c_active_clusters`` (``csrc/fft_c2c.cu``).
_STRIDED_KERNELS = {"fft_c2c_t": 0, "fft_c2c_axis1": 1}


@functools.lru_cache(maxsize=256)
def _active_clusters(name: str, device: int, points: int, family: int,
                     threads: int, shared_bytes: int, cluster: int) -> int:
    shape = (points, family, threads, shared_bytes, cluster)
    if name == "fft_r2c_t":
        got = _real_library().repro_fft_r2c_t_active_clusters(*shape)
    else:
        got = _library().repro_fft_c2c_active_clusters(
            _STRIDED_KERNELS[name], *shape)
    if got < 0:
        raise RuntimeError(f"cluster occupancy query of {name} failed "
                           f"({cluster} blocks of {threads} threads, "
                           f"{shared_bytes} bytes)")
    return got


def active_clusters(launch: PassLaunch, cluster: int,
                    name: str = "fft_r2c_t") -> int:
    """Clusters of ``cluster`` blocks of ``launch`` of the clustered
    kernel ``name`` (``fft_r2c_t``, ``fft_c2c_t`` or ``fft_c2c_axis1``)
    that the current card runs at once
    (``cudaOccupancyMaxActiveClusters``; cached per card and shape)."""
    return _active_clusters(name, torch.cuda.current_device(),
                            launch.points, launch.family, launch.threads,
                            launch.shared_bytes, cluster)


def _raise_on(err: int, name: str, lib: ctypes.CDLL) -> None:
    """Raise if the launch failed, with ``lib``'s message; else count it."""
    if err:
        msg = lib.repro_fft_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")
    LAUNCHES[name] += 1
