"""An emulation of the Hermitian split and merge kernels of the long real
plans (``fft_r2c_split_kernel`` and ``fft_c2r_merge_kernel``,
``csrc/fft_real.cu``), block by block, on the addresses the card sees.

Each block takes the points k in [k0, k0 + count) of one row and their
mirrors m - k: it loads both spans into shared memory (``load_span``), turns
each pair into its two outputs in place, computes the point m/2 where its
span ends there, and stores both spans (``store_span``).  The emulation
follows those steps with the rows at either parity of a 16-byte boundary
(an input at an odd element offset, the odd rows of the (m+1)-point side),
asserts that every 16-byte move is aligned on both sides, that every
output point is written once from the points and split-table entry its
formula names, and holds the values, computed in float32 in the kernel's
order (``split_of``, ``merge_of``), to the plain versions.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.fft.stockham import _split_factors
from repro_torch.kernels.common import CSRC_DIR
from repro_torch.kernels.fft import fft_kernel as K

ROWS = 3
LENGTHS = (4, 8, 64, 4096, 2**13, 2**14, 2**15)   # real N; m = N/2


def _split_of(f, g, w):
    """``split_of`` in float32, in the kernel's order."""
    rr, ri = g.real, -g.imag
    dr, di = f.real - rr, f.imag - ri
    qr, qi = np.float32(0.5) * di, np.float32(-0.5) * dr
    pr, pi = qr * w.real - qi * w.imag, qr * w.imag + qi * w.real
    return (np.float32(0.5) * (f.real + rr) + pr) + 1j * (
        np.float32(0.5) * (f.imag + ri) + pi)


def _merge_of(v, u, w):
    """``merge_of`` in float32, in the kernel's order."""
    rr, ri = u.real, -u.imag
    er, ei = np.float32(0.5) * (v.real + rr), np.float32(0.5) * (v.imag + ri)
    dr, di = v.real - rr, v.imag - ri
    wr, wi = w.real, -w.imag
    hr, hi = np.float32(0.5) * dr, np.float32(0.5) * di
    qr, qi = hr * wr - hi * wi, hr * wi + hi * wr
    return (er - qi) + 1j * (ei + qr)


class Card:
    """Device memory as element addresses (8 bytes each; an even address
    is 16-byte aligned), and what the emulated blocks did to it."""

    def __init__(self, values: np.ndarray, base: int, out_size: int,
                 out_base: int):
        self.values, self.base = values, base
        self.out = np.full(out_size, np.nan + 1j * np.nan, np.complex64)
        self.writes = np.zeros(out_size, np.int64)
        self.out_base = out_base
        self.sources = np.full((out_size, 2), -1, np.int64)

    def load(self, addr: int):
        return self.values[addr - self.base], addr - self.base


def load_span(card: Card, src: int, count: int, size: int):
    """``load_span``: the slots' values and input indices."""
    vals = np.zeros(size, np.complex64)
    idx = np.full(size, -1, np.int64)
    lead = src & 1
    head = min(lead, count)
    pairs = (count - head) >> 1
    for i in range(pairs):
        at, slot = src + head + 2 * i, lead + head + 2 * i
        assert at % 2 == 0 and slot % 2 == 0     # a float4 on both sides
        for d in (0, 1):
            vals[slot + d], idx[slot + d] = card.load(at + d)
    if head:
        vals[lead], idx[lead] = card.load(src)
    if (count - head) & 1:
        vals[lead + count - 1], idx[lead + count - 1] = card.load(
            src + count - 1)
    return lead, vals, idx


def store_span(card: Card, dst: int, vals, srcs, lead: int, count: int):
    """``store_span``: each slot to its output address, counted."""
    head = min(dst & 1, count)
    pairs = (count - head) >> 1
    moved = []
    for i in range(pairs):
        assert (dst + head + 2 * i) % 2 == 0     # a float4 in device memory
        moved += [head + 2 * i, head + 2 * i + 1]
    if head:
        moved.append(0)
    if (count - head) & 1:
        moved.append(count - 1)
    assert sorted(moved) == list(range(count))
    for j in moved:
        at = dst + j - card.out_base
        card.out[at] = vals[lead + j]
        card.sources[at] = srcs[lead + j]
        card.writes[at] += 1


def emulate(split: bool, x: np.ndarray, n: int, in_off: int, out_off: int):
    """The launch over the rows of ``x`` at element offset ``in_off``,
    the output at ``out_off``: (outputs, writes, sources, split-table
    entry of each output)."""
    b = x.shape[0]
    m = n // 2
    half = m // 2
    s_in, s_out = (m, m + 1) if split else (m + 1, m)
    card = Card(x.reshape(-1), in_off, b * s_out, out_off)
    w = _split_factors(n, torch.device("cpu"), torch.complex64).numpy()
    wk = np.full(b * s_out, -1, np.int64)
    tiles = -(-half // K.SPAN_POINTS)
    assert K.span_blocks(b, n) == b * tiles
    size = K.SPAN_POINTS + 2
    fn = _split_of if split else _merge_of
    for block in range(b * tiles):
        row, tile = divmod(block, tiles)
        k0 = tile * K.SPAN_POINTS
        count = min(K.SPAN_POINTS, half - k0)
        lo = m - k0 - count + 1
        wrap = int(k0 == 0)
        src, dst = in_off + row * s_in, out_off + row * s_out
        lf, fv, fi = load_span(card, src + k0, count, size)
        lb, bv, bi = load_span(card, src + lo,
                               count - wrap if split else count, size)
        srcs_f = np.full((size, 2), -1, np.int64)
        srcs_b = np.full((size, 2), -1, np.int64)
        for j in range(count):
            k = k0 + j
            f, g = lf + j, lb + count - 1 - j
            a, ia = fv[f], fi[f]
            bb, ib = (a, ia) if split and k == 0 else (bv[g], bi[g])
            assert ia >= 0 and ib >= 0                # both were loaded
            fv[f], bv[g] = fn(a, bb, w[k]), fn(bb, a, w[m - k])
            srcs_f[f], srcs_b[g] = (ia, ib), (ib, ia)
            wk[row * s_out + k] = k
            if m - k < s_out:
                wk[row * s_out + m - k] = m - k
        if k0 + count == half:
            v, iv = card.load(src + half)
            at = dst + half - out_off
            card.out[at] = fn(v, v, w[half])
            card.sources[at] = (iv, iv)
            card.writes[at] += 1
            wk[at] = half
        store_span(card, dst + k0, fv, srcs_f, lf, count)
        store_span(card, dst + lo, bv, srcs_b, lb,
                   count if split else count - wrap)
    return card.out.reshape(b, s_out), card.writes, card.sources, wk


def _rows(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("out_off", (0, 1))
@pytest.mark.parametrize("in_off", (0, 1))
@pytest.mark.parametrize("kind", ("split", "merge"))
@pytest.mark.parametrize("n", LENGTHS)
def test_spans_write_each_point_once_from_its_pair(n, kind, in_off,
                                                   out_off):
    split = kind == "split"
    m = n // 2
    s_in, s_out = (m, m + 1) if split else (m + 1, m)
    x = _rows(n + in_off, (ROWS, s_in))
    out, writes, sources, wk = emulate(split, x, n, in_off, out_off)
    assert (writes == 1).all()
    rows = np.repeat(np.arange(ROWS), s_out)
    k = np.tile(np.arange(s_out), ROWS)
    # The formula's two input points: X[k] from Z[k], Z[m-k mod m]; Z[k]
    # from X[k], X[m-k]; and the split-table entry W[k].
    want = np.stack([rows * s_in + k % s_in,
                     rows * s_in + (m - k) % (m if split else m + 1)], -1)
    assert (sources == want).all()
    assert (wk == k).all()
    plain = (K.fft_r2c_split_plain if split else K.fft_c2r_merge_plain)(
        torch.from_numpy(x), n)
    ref = plain.numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


def test_span_constants_match_the_kernels():
    src = (CSRC_DIR / "fft_real.cu").read_text()
    const = dict(re.findall(r"constexpr int (kSpan\w+) = (\d+);", src))
    assert int(const["kSpanPoints"]) == K.SPAN_POINTS
    assert int(const["kSpanThreads"]) * 4 == K.SPAN_POINTS
