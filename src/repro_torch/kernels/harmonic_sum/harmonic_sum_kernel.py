"""Harmonic summing: the CUDA launches and their plain torch twins.

Both functions build the doubling ladder S_h[k] = sum_{j <= h} P[j * k]
(0 for j * k >= N), h = 1, 2, 4, ..., H, over the last axis of a (B, N)
float32 power tensor:

  harmonic_sum_plane  -> ((B, N) best statistic, (B, N) int32 rung): each
                         rung normalised to z_h = (S_h - h) * (1/sqrt(h))
                         and max-reduced, the earliest rung winning ties
  harmonic_sum        -> (B, L, N), every rung written (L = log2 H + 1)

A CPU tensor runs the plain version; a CUDA tensor launches the kernel of
``repro_torch/csrc/harmonic_sum.cu`` (its header says which TPU kernels
they replace, what bounds them and what their design does about that) and
raises if the launch fails.  The plain versions add the rungs in the
kernels' (and the reference's) order, decimation by decimation, so the
kernels are bit-identical to them.  ``LAUNCHES`` counts kernel launches
only.

Both kernels run one staged body: a block takes a tile of K bins [k0, k0
+ K) and stages the values they read, P[j k] for each decimation j, in
shared memory with asynchronous copies, all at once, before it adds
them; the plane normalises and max-reduces each rung, the ladder stores
it.  :func:`plane_bins` chooses the plane's K for H (the ladder takes
LADDER_BINS), and :func:`stages` splits a tile's decimations into the
stage buffer's stages as the kernels do (the CPU tests emulate the
kernels from it).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels.common import load_library

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"harmonic_sum_plane": 0, "harmonic_sum": 0}

#: Threads of a block of either kernel, and the bins a block may take (the
#: compiled instances: 1, 2, 4 or 8 bins a thread).
PLANE_THREADS = 256
PLANE_BINS = (256, 512, 1024, 2048)
#: Values the stage buffer holds (64 KB: three blocks an SM).
PLANE_BUFFER = 16384
#: K of the ladder: the fastest of ``chip_smoke.py``'s sweep of
#: PLANE_BINS at the Sec. 5.3 demo's (32, 2**20), H = 32 (on an H100).
LADDER_BINS = 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def levels(n_harmonics: int) -> int:
    """Rungs of the ladder up to ``n_harmonics`` (a power of two)."""
    return int(math.log2(n_harmonics)) + 1


def plane_bins(n_harmonics: int) -> int:
    """K for H: PLANE_BUFFER / H within [256, 2048], so that up to H =
    64 every decimation goes through one stage."""
    return min(max(PLANE_BUFFER // n_harmonics, PLANE_BINS[0]),
               PLANE_BINS[-1])


def per_stage(n_harmonics: int, bins: int) -> int:
    """Decimations the stage buffer takes at once for K = ``bins``."""
    return min(n_harmonics, PLANE_BUFFER // bins)


def shared_bytes(n_harmonics: int, bins: int) -> int:
    """Bytes of the stage buffer of one block."""
    return 4 * bins * per_stage(n_harmonics, bins)


def plane_blocks(batch: int, n: int, bins: int) -> int:
    """Thread blocks of one launch of either kernel at K = ``bins``."""
    return batch * -(-n // bins)


def last_decimation(k0: int, n: int, n_harmonics: int) -> int:
    """The last decimation j with j k0 < n (every j for k0 = 0): no bin of
    the tile at k0 reads past it."""
    return n_harmonics if k0 == 0 else min(n_harmonics, (n - 1) // k0)


def stages(k0: int, n: int, n_harmonics: int, bins: int) -> list[range]:
    """The decimations of the tile of K = ``bins`` at k0, stage by
    stage, in the kernel's order."""
    last = last_decimation(k0, n, n_harmonics)
    per = per_stage(n_harmonics, bins)
    return [range(j0, min(last, j0 + per - 1) + 1)
            for j0 in range(1, last + 1, per)]


@functools.lru_cache(maxsize=None)
def rung_scales(n_levels: int) -> np.ndarray:
    """float32 of the double 1/sqrt(h) for each rung, as the reference
    multiplies by it."""
    return np.array([1.0 / math.sqrt(2 ** lev) for lev in range(n_levels)],
                    np.float32)


def _decimated(p: torch.Tensor, j: int) -> torch.Tensor:
    """P[:, ::j] zero-padded back to (B, N)."""
    n = p.shape[-1]
    q = p[:, ::j]
    return torch.nn.functional.pad(q, (0, n - q.shape[-1]))


def _rungs(p: torch.Tensor, n_harmonics: int):
    """Yield (rung, S_h) for h = 1, 2, 4, ..., n_harmonics."""
    acc = p
    yield 0, acc
    h = 1
    for lev in range(1, levels(n_harmonics)):
        h *= 2
        for j in range(h // 2 + 1, h + 1):
            acc = acc + _decimated(p, j)
        yield lev, acc


def harmonic_sum_plane_plain(p: torch.Tensor, n_harmonics: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`harmonic_sum_plane`."""
    scales = rung_scales(levels(n_harmonics))
    best = p - 1.0                                  # z_1 = S_1 - 1
    best_lev = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    for lev, acc in _rungs(p, n_harmonics):
        if lev == 0:
            continue
        z = (acc - float(2 ** lev)) * float(scales[lev])
        better = z > best
        best = torch.where(better, z, best)
        best_lev = torch.where(better, lev, best_lev)
    return best, best_lev


def harmonic_sum_plain(p: torch.Tensor, n_harmonics: int) -> torch.Tensor:
    """Plain torch version of :func:`harmonic_sum`."""
    return torch.stack([acc for _, acc in _rungs(p, n_harmonics)], dim=1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("harmonic_sum")
    lib.repro_hsum_error_string.argtypes = [ctypes.c_int]
    lib.repro_hsum_error_string.restype = ctypes.c_char_p
    _P = ctypes.c_void_p
    lib.repro_harmonic_sum_plane.argtypes = [
        _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P]
    lib.repro_harmonic_sum_plane.restype = ctypes.c_int
    lib.repro_harmonic_sum_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.repro_harmonic_sum_blocks_per_sm.restype = ctypes.c_int
    lib.repro_harmonic_sum.argtypes = [
        _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P]
    lib.repro_harmonic_sum.restype = ctypes.c_int
    return lib


def _check(p: torch.Tensor, n_harmonics: int, what: str) -> None:
    if p.dtype != torch.float32 or p.ndim != 2 or not p.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 2-D float32 tensor, "
                         f"got {tuple(p.shape)} {p.dtype}")
    if n_harmonics < 1 or n_harmonics & (n_harmonics - 1):
        raise ValueError(
            f"n_harmonics must be a power of two, got {n_harmonics}")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {p.device}")


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _library().repro_hsum_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")
    LAUNCHES[name] += 1


def harmonic_sum_plane(p: torch.Tensor, n_harmonics: int,
                       bins: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) float32 power -> ((B, N) statistic, (B, N) int32 rung).
    ``bins`` (one of PLANE_BINS) overrides :func:`plane_bins` (the chip
    check's sweep)."""
    _check(p, n_harmonics, "harmonic_sum_plane")
    if p.device.type == "cpu":
        return harmonic_sum_plane_plain(p, n_harmonics)
    b, n = p.shape
    stat = torch.empty_like(p)
    lev = torch.empty(p.shape, dtype=torch.int32, device=p.device)
    if p.numel() == 0:
        return stat, lev
    bins = bins or plane_bins(n_harmonics)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _library().repro_harmonic_sum_plane(
            p.data_ptr(), stat.data_ptr(), lev.data_ptr(), b, n,
            levels(n_harmonics), bins, stream)
    _raise_on(err, "harmonic_sum_plane")
    return stat, lev


def blocks_per_sm(bins: int, n_harmonics: int, plane: bool = True) -> int:
    """Blocks of K = ``bins`` of the plane kernel (else the ladder's) that
    one SM of the current card holds at ``n_harmonics``."""
    return _library().repro_harmonic_sum_blocks_per_sm(
        int(plane), bins, shared_bytes(n_harmonics, bins))


def harmonic_sum(p: torch.Tensor, n_harmonics: int,
                 bins: int | None = None) -> torch.Tensor:
    """(B, N) float32 power -> (B, L, N) ladder, L = log2 H + 1.
    ``bins`` (one of PLANE_BINS) overrides LADDER_BINS (the chip check's
    sweep)."""
    _check(p, n_harmonics, "harmonic_sum")
    if p.device.type == "cpu":
        return harmonic_sum_plain(p, n_harmonics)
    b, n = p.shape
    n_levels = levels(n_harmonics)
    out = torch.empty((b, n_levels, n), dtype=torch.float32, device=p.device)
    if p.numel() == 0:
        return out
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _library().repro_harmonic_sum(
            p.data_ptr(), out.data_ptr(), b, n, n_levels,
            bins or LADDER_BINS, stream)
    _raise_on(err, "harmonic_sum")
    return out
