"""Public wrappers for the fused mixed-radix Stockham FFT kernels.

The counterparts of ``repro.kernels.fft.ops``'s entry points, with the
same ledger names (``fft-c2c``, ``fft-c2c-t``, ``fft-c2c-axis1``,
``fft-c2c-mul``, ``fft-r2c``, ``fft-r2c-t``, ``fft-c2r``,
``transpose``), the same logical ``shape`` and the same ``bytes_moved``
formulas, except that the reference counts its padded batch where the
port counts the batch itself.  ``fft-r2c-split`` and ``fft-c2r-merge``,
the Hermitian split and merge of the long real plans, are the port's
own: the reference runs those steps as jnp ops.  ``grid`` and ``tile``
describe the CUDA launch (thread blocks; transforms per block and
transform length, or the transpose's square tile), not a VMEM tile, and
there is no padding: the kernels mask a ragged batch or edge themselves.

Complex input is cast to complex64 and real input to float32 (wider
types included, as the reference's wrappers do) — except by the
transpose, which keeps the dtype, as the reference's does.  Each runs on
its own device: the plain torch version on the CPU, the CUDA kernel on
the card.

Each launch runs in a span ``kernel.<ledger name>`` (``obs.trace.span``)
whose ``kind``, ``n`` and ``rows`` name the transforms it computes; the
transpose's give its matrices (``n`` elements each, of ``itemsize``
bytes) and ``fft-c2c-mul``'s its filter bank (``bank`` filters).  They
are what a reader of the spans counts the launch's least work from.
"""
from __future__ import annotations

import torch

from repro_torch.fft import stockham
from repro_torch.fft.radix import DEFAULT_RADICES
from repro_torch.kernels.fft import fft_kernel
from repro_torch.obs.ledger import record_launch
from repro_torch.obs.trace import span

# One fused kernel handles transforms that fit shared memory: the register
# passes of every FFT kernel but fft_c2c_mul, the double-buffered stages of
# fft_c2c_mul.
MAX_KERNEL_N = 2**13


def _check_kernel_length(n: int) -> None:
    if n > MAX_KERNEL_N:
        raise ValueError(
            f"N={n} exceeds the single-pass kernel limit ({MAX_KERNEL_N}); "
            "route long transforms through repro_torch.fft.plan (its "
            "four-step decomposition runs a kernel once per pow2 pass)")


def _complex64(x: torch.Tensor) -> torch.Tensor:
    """Contiguous complex64 with any lazy conjugation resolved."""
    return x.to(torch.complex64).resolve_conj().contiguous()


def _twiddle(twiddle, device: torch.device) -> torch.Tensor | None:
    """An (.., ..) complex table as a complex64 tensor on ``device``."""
    if twiddle is None:
        return None
    return _complex64(torch.as_tensor(twiddle, device=device))


def _batch(shape: torch.Size, keep: int) -> int:
    b = 1
    for d in shape[:-keep]:
        b *= d
    return b


def fft_kernel_c2c(x: torch.Tensor, *, inverse: bool = False,
                   radices: tuple[int, ...] = DEFAULT_RADICES,
                   tile_b: int | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Batched pow2 C2C FFT (..., N) through the ``fft_c2c`` kernel.

    Longer-than-one-pass transforms go through ``repro_torch.fft.plan``.
    ``tile_b`` overrides the transforms per thread block (autotuner hook);
    the kernel runs register passes (``fft_kernel.pass_launch``).  ``out``
    (contiguous complex64, ``x``'s shape; ``x`` itself in place) receives
    the result.
    """
    x = _complex64(x)
    n = x.shape[-1]
    _check_kernel_length(n)
    if n == 1:
        # The length-1 DFT is the identity both ways.
        return x if out is None else out.copy_(x)
    lead = x.shape[:-1]
    b = _batch(x.shape, 1)
    launch = fft_kernel.pass_launch(n, b, tuple(radices), tile_b)
    with span("kernel.fft-c2c", x, kind="c2c", n=n, rows=b):
        y = fft_kernel.fft_c2c(
            x.reshape(b, n), inverse=inverse, radices=radices,
            per_block=launch.per_block,
            out=None if out is None else out.view(b, n))
    record_launch("fft-c2c", grid=(launch.blocks,),
                  tile=(launch.per_block, n), bytes_moved=16 * b * n,
                  shape=(b, n))
    return y.reshape(*lead, n) if out is None else out


def fft_kernel_c2c_t(x: torch.Tensor, *, twiddle=None, inverse: bool = False,
                     radices: tuple[int, ...] = DEFAULT_RADICES,
                     tile_b: int | None = None) -> torch.Tensor:
    """Fused C2C FFT + transposed write: (..., R, C) -> (..., C, R).

    ``twiddle`` (optional, an (R, C) complex table) is multiplied in the
    kernel's epilogue, before the transposed write.  The row FFTs run in
    register passes (``fft_kernel.pass_launch``; ``tile_b`` overrides the
    rows per thread block), and clusters of blocks
    (``fft_kernel.c2c_cluster``) store their rows' points together.
    """
    x = _complex64(x)
    r, c = x.shape[-2:]
    _check_kernel_length(c)
    lead = x.shape[:-2]
    b = _batch(x.shape, 2)
    launch = fft_kernel.pass_launch(c, r, tuple(radices), tile_b,
                                    buffer=True)
    tile = launch.per_block
    cluster = fft_kernel.c2c_cluster(tile, r)
    tw = _twiddle(twiddle, x.device)
    with span("kernel.fft-c2c-t", x, kind="c2c", n=c, rows=b * r):
        y = fft_kernel.fft_c2c_t(x.reshape(b, r, c), tw, inverse=inverse,
                                 radices=radices, per_block=tile,
                                 cluster=cluster)
    record_launch("fft-c2c-t",
                  grid=(fft_kernel.clustered_blocks(b, r, tile, cluster),),
                  tile=(tile, c), bytes_moved=16 * b * r * c,
                  shape=(b, r, c))
    return y.reshape(*lead, c, r)


def fft_kernel_c2c_axis1(x: torch.Tensor, *, twiddle=None,
                         inverse: bool = False,
                         radices: tuple[int, ...] = DEFAULT_RADICES,
                         tile_b: int | None = None) -> torch.Tensor:
    """C2C FFT over axis -2, layout preserved: (..., R, C) -> (..., R, C).

    The four-step column pass.  ``twiddle`` is a (C, R) complex table;
    output ``[..., k, j]`` is multiplied by ``twiddle[j, k]``.  The column
    FFTs run in register passes (``fft_kernel.pass_launch``; ``tile_b``
    overrides the columns per thread block), and clusters of blocks
    (``fft_kernel.c2c_cluster``) load and store their columns together.
    """
    x = _complex64(x)
    r, c = x.shape[-2:]
    _check_kernel_length(r)
    lead = x.shape[:-2]
    b = _batch(x.shape, 2)
    launch = fft_kernel.pass_launch(r, c, tuple(radices), tile_b,
                                    buffer=True)
    tile = launch.per_block
    cluster = fft_kernel.c2c_cluster(tile, c)
    tw = _twiddle(twiddle, x.device)
    with span("kernel.fft-c2c-axis1", x, kind="c2c", n=r, rows=b * c):
        y = fft_kernel.fft_c2c_axis1(x.reshape(b, r, c), tw,
                                     inverse=inverse, radices=radices,
                                     per_block=tile, cluster=cluster)
    record_launch("fft-c2c-axis1",
                  grid=(fft_kernel.clustered_blocks(b, c, tile, cluster),),
                  tile=(tile, r), bytes_moved=16 * b * r * c,
                  shape=(b, r, c))
    return y.reshape(*lead, r, c)


def fft_kernel_c2c_mul(x: torch.Tensor, bank, *, inverse: bool = False,
                       radices: tuple[int, ...] = DEFAULT_RADICES,
                       tile_b: int | None = None) -> torch.Tensor:
    """Fused pow2 C2C FFT + (T, N) filter-bank multiply epilogue.

    (..., N) in -> (..., T, N) out with out[..., t, :] = FFT(x) * bank[t].
    ``bank`` is a (T, N) complex array or tensor (the cached filter
    spectra of ``repro_torch.fft.convolve``, already on the device).
    """
    x = _complex64(x)
    n = x.shape[-1]
    _check_kernel_length(n)
    bank = _twiddle(bank, x.device)
    if bank.ndim != 2 or bank.shape[-1] != n:
        raise ValueError(f"filter bank must be (T, {n}), got "
                         f"{tuple(bank.shape)}")
    t = bank.shape[0]
    lead = x.shape[:-1]
    b = _batch(x.shape, 1)
    tile = fft_kernel.transforms_per_block(n, b, tile_b)
    with span("kernel.fft-c2c-mul", x, kind="c2c-mul", n=n, rows=b, bank=t):
        y = fft_kernel.fft_c2c_mul(x.reshape(b, n), bank, inverse=inverse,
                                   radices=radices, per_block=tile)
    record_launch("fft-c2c-mul", grid=(fft_kernel.blocks(b, tile),),
                  tile=(tile, n), bytes_moved=8 * n * (b + t + b * t),
                  shape=(b, t, n))
    return y.reshape(*lead, t, n)


def transpose_kernel(x: torch.Tensor) -> torch.Tensor:
    """Tiled last-two-axes transpose: (..., R, C) -> (..., C, R), one pass,
    in the input's dtype (4-, 8- or 16-byte elements)."""
    x = x.resolve_conj().resolve_neg().contiguous()
    r, c = x.shape[-2:]
    lead = x.shape[:-2]
    b = _batch(x.shape, 2)
    with span("kernel.transpose", x, kind="transpose", n=r * c, rows=b,
              itemsize=x.element_size()):
        y = fft_kernel.transpose(x.reshape(b, r, c))
    tile = fft_kernel.TRANSPOSE_TILE
    record_launch("transpose", grid=(fft_kernel.transpose_blocks(b, r, c),),
                  tile=(tile, tile),
                  bytes_moved=2 * b * r * c * x.element_size(),
                  shape=(b, r, c))
    return y.reshape(*lead, c, r)


def _real32(x: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 (the real part of complex input), 8-byte
    aligned: the kernel reads pairs of reals as one float2."""
    if x.is_complex():
        x = x.real
    x = x.to(torch.float32).contiguous()
    if x.data_ptr() % 8:
        x = x.clone()
    return x


def fft_kernel_r2c(x: torch.Tensor, *,
                   radices: tuple[int, ...] = DEFAULT_RADICES,
                   tile_b: int | None = None) -> torch.Tensor:
    """Batched pow2 R2C FFT: (..., N) real -> (..., N/2+1) complex64.

    Packs N reals as N/2 complex points, so it takes N up to
    2 * MAX_KERNEL_N; the N/2-point FFT runs in register passes
    (``fft_kernel.pass_launch``) and the Hermitian split inside the kernel.
    """
    x = _real32(x)
    n = x.shape[-1]
    _check_kernel_length(max(n // 2, 1))
    if n < 4:
        return stockham.rfft(x)
    lead = x.shape[:-1]
    b = _batch(x.shape, 1)
    launch = fft_kernel.pass_launch(n // 2, b, tuple(radices), tile_b,
                                    split=True)
    with span("kernel.fft-r2c", x, kind="r2c", n=n, rows=b):
        y = fft_kernel.fft_r2c(x.reshape(b, n), radices=radices,
                               per_block=launch.per_block)
    record_launch("fft-r2c", grid=(launch.blocks,),
                  tile=(launch.per_block, n),
                  bytes_moved=4 * b * (n + 2 * (n // 2 + 1)), shape=(b, n))
    return y.reshape(*lead, n // 2 + 1)


def fft_kernel_r2c_t(x: torch.Tensor, *,
                     radices: tuple[int, ...] = DEFAULT_RADICES,
                     tile_b: int | None = None) -> torch.Tensor:
    """Fused R2C + transposed write: (..., R, C) real -> (..., C/2+1, R)
    complex64, pow2 4 <= C <= 2 * MAX_KERNEL_N.  The C/2-point FFT runs in
    register passes (``fft_kernel.pass_launch``; ``tile_b`` overrides the
    rows per thread block), and clusters of blocks
    (``fft_kernel.r2c_t_cluster``) store their rows' bins together."""
    x = _real32(x)
    r, c = x.shape[-2:]
    _check_kernel_length(max(c // 2, 1))
    if c < 4:
        raise ValueError(f"fused R2C needs C >= 4, got {c}")
    lead = x.shape[:-2]
    b = _batch(x.shape, 2)
    launch = fft_kernel.pass_launch(c // 2, r, tuple(radices), tile_b,
                                    split=True)
    tile = launch.per_block
    cluster = fft_kernel.r2c_t_cluster(tile, r)
    with span("kernel.fft-r2c-t", x, kind="r2c", n=c, rows=b * r):
        y = fft_kernel.fft_r2c_t(x.reshape(b, r, c), radices=radices,
                                 per_block=tile, cluster=cluster)
    record_launch("fft-r2c-t",
                  grid=(fft_kernel.clustered_blocks(b, r, tile, cluster),),
                  tile=(tile, c),
                  bytes_moved=4 * b * r * (c + 2 * (c // 2 + 1)),
                  shape=(b, r, c))
    return y.reshape(*lead, c // 2 + 1, r)


def fft_kernel_c2r(x: torch.Tensor, *,
                   radices: tuple[int, ...] = DEFAULT_RADICES,
                   tile_b: int | None = None) -> torch.Tensor:
    """Batched pow2 C2R inverse: (..., N/2+1) half-spectrum -> (..., N)
    float32, the exact inverse of :func:`fft_kernel_r2c` (1/N normalised).

    The packed merge reads the imaginary parts of bins 0 and N/2, which
    ``torch.fft.irfft`` ignores: the two agree on a true half-spectrum.
    The merge and the N/2-point inverse run in register passes
    (``fft_kernel.pass_launch``).
    """
    x = _complex64(x)
    m = x.shape[-1] - 1
    n = 2 * m
    _check_kernel_length(max(m, 1))
    if n < 4:
        return stockham.irfft(x)
    lead = x.shape[:-1]
    b = _batch(x.shape, 1)
    launch = fft_kernel.pass_launch(m, b, tuple(radices), tile_b, split=True)
    with span("kernel.fft-c2r", x, kind="c2r", n=n, rows=b):
        y = fft_kernel.fft_c2r(x.reshape(b, m + 1), radices=radices,
                               per_block=launch.per_block)
    record_launch("fft-c2r", grid=(launch.blocks,),
                  tile=(launch.per_block, n), bytes_moved=4 * b * (2 * (m + 1) + n),
                  shape=(b, n))
    return y.reshape(*lead, n)


def fft_kernel_r2c_split(z: torch.Tensor, n: int) -> torch.Tensor:
    """The Hermitian split of the long R2C route: (..., N/2) complex, the
    N/2-point spectra of N packed reals, -> (..., N/2+1) complex64 bins,
    pow2 N >= 4; one pass (``fft_r2c_split``)."""
    z = _complex64(z)
    m = z.shape[-1]
    lead = z.shape[:-1]
    b = _batch(z.shape, 1)
    with span("kernel.fft-r2c-split", z, kind="r2c-split", n=n, rows=b):
        y = fft_kernel.fft_r2c_split(z.reshape(b, m), n)
    record_launch("fft-r2c-split", grid=(fft_kernel.span_blocks(b, n),),
                  tile=(fft_kernel.SPAN_POINTS, n),
                  bytes_moved=8 * b * (2 * m + 1), shape=(b, n))
    return y.reshape(*lead, m + 1)


def fft_kernel_c2r_merge(x: torch.Tensor, n: int) -> torch.Tensor:
    """The Hermitian merge of the long C2R route: (..., N/2+1) complex
    half-spectra -> (..., N/2) complex64, the packed input of the
    N/2-point inverse, pow2 N >= 4; one pass (``fft_c2r_merge``)."""
    x = _complex64(x)
    m = n // 2
    lead = x.shape[:-1]
    b = _batch(x.shape, 1)
    with span("kernel.fft-c2r-merge", x, kind="c2r-merge", n=n, rows=b):
        y = fft_kernel.fft_c2r_merge(x.reshape(b, x.shape[-1]), n)
    record_launch("fft-c2r-merge", grid=(fft_kernel.span_blocks(b, n),),
                  tile=(fft_kernel.SPAN_POINTS, n),
                  bytes_moved=8 * b * (2 * m + 1), shape=(b, n))
    return y.reshape(*lead, m)
