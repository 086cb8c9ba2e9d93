"""FFT planning — pick the algorithm and kernel route per length.

The counterpart of ``repro.fft.plan``.  For 1-D transforms:

  pow2, fits one kernel   -> one fused Stockham pass (``fft_c2c`` kernel)
  pow2, long              -> four-step decomposition: two fused passes
                             (``fft_c2c_axis1`` with the inter-pass
                             twiddle, then ``fft_c2c_t``; the inverse runs
                             the same passes inverse, with the conjugate
                             twiddle)
  non-pow2                -> Bluestein (two routed pow2 FFTs, cached
                             chirp/filter)

and, for real input (``kind="r2c"``, N/2+1 bins out, and its inverse
``kind="c2r"``):

  pow2, N/2 fits a kernel -> one fused packed pass (``fft_r2c`` /
                             ``fft_c2r``: split or merge in the kernel)
  pow2, long              -> pack (a view), the N/2 C2C plan (four-step),
                             then the split (``fft_r2c_split``); or the
                             merge (``fft_c2r_merge``), the N/2 inverse
                             four-step, then unpack (a view)
  non-pow2 r2c            -> the full C2C plan, sliced to N/2+1 bins
                             (non-pow2 c2r raises)

``MAX_SINGLE_PASS`` is the reference's, so ``algorithm`` and ``passes``
(the DVFS model's HBM pass count) agree between the two packages.

The N-D plan graph (``repro_torch.fft.plan_nd``) and the overlap-save
engine (``repro_torch.fft.convolve``) run their passes through the
primitives here: :func:`fft_transposed`, :func:`rfft_transposed`,
:func:`tiled_transpose` and :func:`fft_mul`.

**Routing**: every power-of-two pass of every plan launches a CUDA kernel
on a CUDA tensor, or runs that kernel's plain torch version on a CPU
tensor (``repro_torch.kernels.fft``).  Unlike the reference there is no
``try``/``except`` fallback: a kernel that fails raises through the plan.
The pure-torch engine runs only inside an explicit
:func:`kernels_disabled` block; nothing enters it by itself.  Tests
monkeypatch the module-level ``_kernel_*`` hooks to count or fail kernel
invocations.

**Tuning**: plan construction consults the active
:class:`repro_torch.tune.TuningContext` for a tuned
:class:`repro_torch.tune.KernelConfig` (transforms per block, radix
schedule, four-step split); with no context the heuristic plans apply.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.fft.bluestein import bluestein_fft
from repro_torch.fft.radix import (DEFAULT_RADICES, is_pow2, radix_schedule,
                                   stage_count)
from repro_torch.fft.stockham import (_as_complex, _as_real, _irfft_merge,
                                     _pack_real, _rfft_split,
                                     _stockham_pow2, _unpack_real)
from repro_torch.kernels.fft.ops import (MAX_KERNEL_N, fft_kernel_c2c,
                                         fft_kernel_c2c_axis1,
                                         fft_kernel_c2c_mul,
                                         fft_kernel_c2c_t, fft_kernel_c2r,
                                         fft_kernel_c2r_merge,
                                         fft_kernel_r2c, fft_kernel_r2c_split,
                                         fft_kernel_r2c_t, transpose_kernel)
from repro_torch.obs.trace import count_build, span, tracing
from repro_torch.tune.config import KernelConfig
from repro_torch.tune.context import plan_config as _tuned_plan_config

# Longest transform a single fused pass keeps resident (complex64 in shared
# memory; 2^13 c64 = 64 KiB per transform — the paper's single-kernel range).
MAX_SINGLE_PASS = 2**13

# ---------------------------------------------------------------------------
# Kernel routing (monkeypatchable hooks + explicit disable switch)
# ---------------------------------------------------------------------------

_kernel_fft: Callable = fft_kernel_c2c
_kernel_fft_t: Callable = fft_kernel_c2c_t
_kernel_fft_axis1: Callable = fft_kernel_c2c_axis1
_kernel_rfft: Callable = fft_kernel_r2c
_kernel_irfft: Callable = fft_kernel_c2r
_kernel_rfft_t: Callable = fft_kernel_r2c_t
_kernel_rfft_split: Callable = fft_kernel_r2c_split
_kernel_irfft_merge: Callable = fft_kernel_c2r_merge
_kernel_transpose: Callable = transpose_kernel
_kernel_fft_mul: Callable = fft_kernel_c2c_mul

_KERNELS_OFF = contextvars.ContextVar("repro_torch_kernels_off",
                                      default=False)


def _kernels_enabled() -> bool:
    return not _KERNELS_OFF.get()


@contextlib.contextmanager
def kernels_disabled():
    """Run plans on the pure-torch engine inside the block.

    The counterpart of the reference's ``pallas_disabled``: plans built
    or run inside it launch no hand-written kernel.
    """
    token = _KERNELS_OFF.set(True)
    try:
        yield
    finally:
        _KERNELS_OFF.reset(token)


def _kernel_overrides(config: KernelConfig | None) -> dict:
    """Kwargs a tuned config contributes to a kernel entry-point call."""
    if config is None:
        return {}
    kw = {}
    if config.tile_b:
        kw["tile_b"] = config.tile_b
    if config.radices:
        kw["radices"] = config.radices
    return kw


def _resolve_split(n: int, config: KernelConfig | None) -> tuple[int, int]:
    """The four-step (n1, n2) cut: the tuned one when valid, else balanced."""
    if config is not None and config.split:
        n1, n2 = config.split
        if n1 * n2 == n and is_pow2(n1) and is_pow2(n2):
            return n1, n2
    return _four_step_split(n)


def pow2_fft(x: torch.Tensor, *, inverse: bool = False,
             config: KernelConfig | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """C2C FFT of a pow2 length, routed through the kernels.

    Single-pass lengths run ``fft_c2c``; longer lengths recurse through
    the four-step decomposition so every pow2 pass lands on a kernel, the
    inverse on the passes' own inverse (1/N in all).  ``out``, a
    contiguous complex64 tensor of ``x``'s shape (``x`` itself for the
    transform in place), receives the result: the single-pass kernel
    writes it directly, any other route copies its result into it.
    """
    n = x.shape[-1]
    if n > MAX_SINGLE_PASS:
        n1, n2 = _resolve_split(n, config)
        y = four_step_fft(x, n1, n2, inverse=inverse, config=config)
    elif n <= MAX_KERNEL_N and _kernels_enabled():
        if out is not None:
            return _kernel_fft(x, inverse=inverse, out=out,
                               **_kernel_overrides(config))
        return _kernel_fft(x, inverse=inverse, **_kernel_overrides(config))
    else:
        y = _stockham_pow2(x, inverse=inverse)
    return y if out is None else out.copy_(y)


def fft_mul(x, bank, config: KernelConfig | None = None) -> torch.Tensor:
    """Forward pow2 C2C FFT fused with a (T, N) filter-bank multiply.

    (..., N) in -> (..., T, N) out: out[..., t, :] = FFT(x) * bank[t].
    The overlap-save convolution engine's forward pass: the bank multiply
    rides the ``fft_c2c_mul`` kernel as its epilogue.  With kernels
    disabled, or a length no single pass takes: the routed FFT plus one
    broadcast multiply in torch (one more pass over the plane).
    """
    x = _as_complex(x)
    n = x.shape[-1]
    if is_pow2(n) and 1 < n <= MAX_KERNEL_N and _kernels_enabled():
        return _kernel_fft_mul(x, bank, **_kernel_overrides(config))
    y = pow2_fft(x, config=config)
    return y[..., None, :] * torch.as_tensor(bank, device=y.device).to(
        y.dtype)


# ---------------------------------------------------------------------------
# Fused-epilogue pass primitives (the plan graph's node executors)
# ---------------------------------------------------------------------------

def fft_transposed(x: torch.Tensor, *, twiddle=None, inverse: bool = False,
                   config: KernelConfig | None = None) -> torch.Tensor:
    """C2C FFT along the last axis with the last two axes swapped on write.

    One fused kernel pass: (..., R, C) -> (..., C, R).  ``twiddle`` (an
    (R, C) complex table) is multiplied in the kernel's epilogue.  With
    kernels disabled (or a length no kernel takes): routed FFT + multiply
    + transpose in torch.
    """
    x = _as_complex(x)
    n = x.shape[-1]
    if (is_pow2(n) and 1 < n <= MAX_KERNEL_N and _kernels_enabled()):
        return _kernel_fft_t(x, twiddle=twiddle, inverse=inverse,
                             **_kernel_overrides(config))
    y = _routed_1d(x, n, inverse, config)
    if twiddle is not None:
        y = y * torch.as_tensor(twiddle, device=y.device).to(y.dtype)
    return y.transpose(-1, -2).contiguous()


def _conj_inverse(forward: Callable, x: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """The inverse transform as conj(forward(conj(x))) / n, each pass in a
    span of its own.  Rebinding ``x`` frees each intermediate where the
    single expression would."""
    with span("inverse.conj_in"):
        x = torch.conj_physical(x)
    x = forward(x)
    with span("inverse.conj_out"):
        x = torch.conj_physical(x)
    with span("inverse.scale"):
        return x / n


def _routed_1d(x: torch.Tensor, n: int, inverse: bool,
               config: KernelConfig | None = None) -> torch.Tensor:
    """Last-axis C2C of any length, honouring ``inverse`` (conj trick for
    the non-pow2 plans, which only run forward)."""
    if is_pow2(n):
        return pow2_fft(x, inverse=inverse, config=config)
    plan = plan_for_length(n)
    if inverse:
        return _conj_inverse(plan, x, n)
    return plan(x)


def fft_column(x: torch.Tensor, *, twiddle=None, inverse: bool = False,
               config: KernelConfig | None = None) -> torch.Tensor:
    """C2C FFT over axis -2, layout preserved: (..., R, C) -> (..., R, C).

    One fused kernel pass — the column pass of the four-step algorithm.
    ``twiddle`` is a (C, R) table multiplying output ``[..., k, j]`` by
    ``twiddle[j, k]``.  With kernels disabled: transpose + routed FFT +
    multiply in torch.
    """
    x = _as_complex(x)
    r = x.shape[-2]
    if is_pow2(r) and 1 < r <= MAX_KERNEL_N and _kernels_enabled():
        return _kernel_fft_axis1(x, twiddle=twiddle, inverse=inverse,
                                 **_kernel_overrides(config))
    y = _routed_1d(x.transpose(-1, -2), r, inverse, config)
    if twiddle is not None:
        y = y * torch.as_tensor(twiddle, device=y.device).to(y.dtype)
    return y.transpose(-1, -2).contiguous()


def rfft_transposed(x, config: KernelConfig | None = None) -> torch.Tensor:
    """R2C FFT along the last axis, transposed write: (..., R, C) real ->
    (..., C/2+1, R) — one fused pass (``fft_r2c_t``: pack, half-length
    FFT, Hermitian split and transpose in shared memory).  With kernels
    disabled, or a length no single pass takes: the routed R2C plan, then
    a transpose in torch."""
    x = _as_real(x)
    n = x.shape[-1]
    if (is_pow2(n) and 4 <= n and n // 2 <= MAX_KERNEL_N
            and _kernels_enabled()):
        return _kernel_rfft_t(x, **_kernel_overrides(config))
    y = plan_with_config(n, "r2c", config)(x)
    return y.transpose(-1, -2).contiguous()


def tiled_transpose(x: torch.Tensor) -> torch.Tensor:
    """Swap the last two axes in one tiled kernel pass (``transpose``),
    dtype kept; a torch transpose with kernels disabled."""
    if _kernels_enabled():
        return _kernel_transpose(x)
    return x.transpose(-1, -2).contiguous()


def _four_step_split(n: int) -> tuple[int, int]:
    n1 = 1 << (int(math.log2(n)) // 2)
    return n1, n // n1


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    n: int
    algorithm: str              # "stockham" | "four-step" | "bluestein"
    passes: int                 # HBM read+write passes (DVFS model input)
    fn: Callable[[torch.Tensor], torch.Tensor]
    kind: str = "c2c"           # "c2c" | "r2c" | "c2r"
    stages: int = 0             # butterfly stages per fused pass
    radices: tuple[int, ...] = ()

    def __call__(self, x) -> torch.Tensor:
        if not tracing():
            return self.fn(x)
        with span("fft.plan", x, kind=self.kind, n=self.n,
                  rows=math.prod(x.shape[:-1]), algorithm=self.algorithm):
            return self.fn(x)


@functools.lru_cache(maxsize=None)
def _four_step_twiddle_table(n1: int, n2: int) -> np.ndarray:
    """The (n2, n1) inter-pass twiddle matrix exp(-2*pi*i*j2*k1/n),
    complex128, materialised once per shape (as the reference does)."""
    j = np.arange(n2)[:, None]
    k = np.arange(n1)[None, :]
    return np.exp(-2j * np.pi * (j * k) / (n1 * n2))


@functools.lru_cache(maxsize=None)
def _four_step_twiddle(n1: int, n2: int, device: torch.device, *,
                       inverse: bool) -> torch.Tensor:
    """The inter-pass twiddle as a complex64 tensor (its conjugate for the
    inverse), once per device and direction; on ``meta`` (a dry run) its
    shape alone.  ``inverse`` has no default and is keyword-only, so every
    caller gives the cache the same key for the same table."""
    count_build("four_step_twiddle")
    if device.type == "meta":
        return torch.empty((n2, n1), dtype=torch.complex64, device=device)
    table = _four_step_twiddle_table(n1, n2)
    return torch.from_numpy(np.conj(table) if inverse else table).to(
        device=device, dtype=torch.complex64)


def four_step_fft(x: torch.Tensor, n1: int, n2: int, *,
                  inverse: bool = False,
                  config: KernelConfig | None = None) -> torch.Tensor:
    """Long FFT as (n1 x n2) decomposition — Bailey's four-step algorithm,
    run as TWO fused kernel passes.

    View x as v[j1, j2] (row-major).  With outputs indexed k = k2*n1 + k1:

      pass 1: FFT the columns (length n1) -> V[k1, j2]; multiply the
              inter-pass twiddle exp(-2*pi*i*j2*k1/n) in the epilogue;
              write back in the same layout -> T[k1, j2]
      pass 2: FFT the rows of T (length n2) -> Y[k1, k2]; write
              transposed -> out[k2, k1], which flattens to natural order.

    The inverse runs both passes inverse (scaled by 1/n1 and 1/n2) with
    the conjugate twiddle exp(+2*pi*i*j2*k1/n).
    """
    n = n1 * n2
    if x.shape[-1] != n:
        raise ValueError(f"four-step split {n1}x{n2} does not match the "
                         f"length {x.shape[-1]}")
    with span("four_step"):
        batch = x.shape[:-1]
        v = x.reshape(*batch, n1, n2)
        tw = _four_step_twiddle(n1, n2, x.device,
                                inverse=inverse)      # (n2, n1)
        v = fft_column(v, twiddle=tw, inverse=inverse,
                       config=config)                 # (..., n1, n2)
        v = fft_transposed(v, inverse=inverse, config=config)  # (.., n2, n1)
        return v.reshape(*batch, n)


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------

def _c2c_fn(x, config: KernelConfig | None = None) -> torch.Tensor:
    return pow2_fft(_as_complex(x), config=config)


def _r2c_fn(x, n: int, config: KernelConfig | None = None) -> torch.Tensor:
    """Routed R2C: the fused kernel when the packed length fits, else pack
    -> routed pow2 C2C -> split, each pass a kernel."""
    x = _as_real(x)
    m = n // 2
    if 4 <= n and m <= MAX_KERNEL_N and _kernels_enabled():
        return _kernel_rfft(x, **_kernel_overrides(config))
    if m < 1:
        return _as_complex(x)
    with span("r2c.pack"):
        z = _pack_real(x.to(torch.float32))
    z = pow2_fft(z, config=config)
    if 4 <= n and _kernels_enabled():
        return _kernel_rfft_split(z, n)
    return _rfft_split(z, n)


def _c2r_fn(x, n: int, config: KernelConfig | None = None) -> torch.Tensor:
    """Routed C2R inverse of :func:`_r2c_fn` (1/N normalised)."""
    x = _as_complex(x)
    if 4 <= n and _kernels_enabled():
        if n // 2 <= MAX_KERNEL_N:
            return _kernel_irfft(x, **_kernel_overrides(config))
        z = _kernel_irfft_merge(x, n)
    else:
        z = _irfft_merge(x, n)
    z = pow2_fft(z, inverse=True, config=config)
    with span("c2r.unpack"):
        return _unpack_real(z)


def plan_for_length(n: int, kind: str = "c2c") -> FFTPlan:
    """Build (or return the memoised) plan for length ``n``.

    ``kind`` selects the transform: ``"c2c"`` (default), ``"r2c"`` (real
    input, N/2+1 bins out) or ``"c2r"`` (the inverse, 1/N normalised).

    The active :class:`repro_torch.tune.TuningContext` (if any) supplies
    the tuned kernel config; with none, the heuristic plan applies.
    """
    return _plan_for_length(int(n), kind, _tuned_plan_config((n,), kind))


def plan_with_config(n: int, kind: str = "c2c",
                     config: KernelConfig | None = None) -> FFTPlan:
    """Build the plan for an *explicit* config, bypassing the active
    tuning context.  A heuristic-equivalent config collapses onto the
    heuristic plan."""
    if config is not None and config.is_heuristic:
        config = None
    return _plan_for_length(int(n), kind, config)


@functools.lru_cache(maxsize=None)
def _plan_for_length(n: int, kind: str,
                     config: KernelConfig | None) -> FFTPlan:
    count_build("plan")
    if kind not in ("c2c", "r2c", "c2r"):
        raise ValueError(f"unknown transform kind {kind!r}")
    if kind != "c2c":
        return _real_plan(n, kind, config)
    radices = (config.radices if config is not None and config.radices
               else DEFAULT_RADICES)
    if is_pow2(n):
        schedule = radix_schedule(min(n, MAX_SINGLE_PASS), radices)
        if n <= MAX_SINGLE_PASS:
            return FFTPlan(n, "stockham", 1,
                           functools.partial(_c2c_fn, config=config),
                           stages=len(schedule), radices=schedule)
        n1, n2 = _resolve_split(n, config)
        return FFTPlan(
            n, "four-step", 2,
            lambda x, n1=n1, n2=n2, c=config: four_step_fft(
                _as_complex(x), n1, n2, config=c),
            stages=stage_count(n1, radices) + stage_count(n2, radices),
            radices=radix_schedule(n1, radices),
        )
    # Bluestein: the filter spectrum is precomputed and cached per length,
    # so only 2 pow2 FFTs of length m >= 2n-1 run per call, plus pointwise
    # chirp passes.
    m = 1 << (2 * n - 2).bit_length()
    inner = _plan_for_length(m, "c2c", config)
    fn = (bluestein_fft if config is None
          else functools.partial(bluestein_fft, config=config))
    return FFTPlan(n, "bluestein", 2 * inner.passes + 1, fn,
                   stages=inner.stages, radices=inner.radices)


def _real_plan(n: int, kind: str, config: KernelConfig | None) -> FFTPlan:
    if not is_pow2(n):
        if kind == "c2r":
            raise ValueError(
                f"c2r plans need a power-of-two length, got {n}")
        # r2c of any other length: the full C2C plan, sliced to the half
        # spectrum.
        inner = _plan_for_length(n, "c2c", config)
        return FFTPlan(
            n, inner.algorithm, inner.passes,
            lambda x: inner.fn(_as_complex(x))[..., :n // 2 + 1],
            kind="r2c", stages=inner.stages, radices=inner.radices)
    m = max(n // 2, 1)
    inner = _plan_for_length(m, "c2c", config) if m > 1 else None
    passes = inner.passes if inner else 1
    stages = inner.stages if inner else 0
    radices = inner.radices if inner else ()
    alg = inner.algorithm if inner else "stockham"
    fn = (functools.partial(_r2c_fn, n=n, config=config) if kind == "r2c"
          else functools.partial(_c2r_fn, n=n, config=config))
    return FFTPlan(n, alg, passes, fn, kind=kind, stages=stages,
                   radices=radices)
