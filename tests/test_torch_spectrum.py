"""The port's fused power-spectrum wrapper
(``repro_torch.kernels.spectrum``) against the reference's
(``repro.kernels.spectrum``: the Pallas kernel in interpret mode, and its
oracle) on the same numpy spectra: power, row mean and row std within
1e-5 * max |ref| (the variance is E[p^2] - mean^2 in float32, with its
cancellation, on both sides), with lead dims, real input, the empty-axis
guard and the ledger record.

The kernel's segmented reduction (``csrc/spectrum.cu``) emulated on the
CPU: the rows cut as ``spectrum_kernel.segments`` cuts them, each
segment's bins handed to the block's 256 threads as the kernel hands
them (a single bin first where the segment starts 8 bytes past a 16-byte
boundary, then pairs, then a single last bin), each thread's double sums
in its order, the block's fixed tree, and the row's partials combined in
the last block's fixed order.  Every bin is covered once (N = 1, odd N,
N below one segment, B = 1), and the emulation agrees with the plain
version and with a float64 numpy oracle within 1e-5 * max |ref|."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, rand_complex, run_both
from repro.kernels.spectrum import power_spectrum_stats_kernel as ref_stats
from repro.kernels.spectrum.ref import power_spectrum_stats_ref as ref_oracle
from repro_torch.kernels.spectrum import power_spectrum_stats_kernel
from repro_torch.kernels.spectrum import spectrum_kernel
from repro_torch.kernels.spectrum.ref import power_spectrum_stats_ref

RTOL = 1e-5
T = spectrum_kernel.THREADS


def check(x):
    p, mean, std = power_spectrum_stats_kernel(torch.from_numpy(x))
    rp, rmean, rstd = ref_stats(x, interpret=True)
    assert p.dtype == mean.dtype == std.dtype == torch.float32
    assert tuple(mean.shape) == tuple(std.shape) == x.shape[:-1]
    assert_close(p, rp, RTOL)
    assert_close(mean, rmean, RTOL)
    assert_close(std, rstd, RTOL)
    return p, mean, std


@pytest.mark.parametrize("batch", [1, 7, 16])
@pytest.mark.parametrize("n", [64, 1025, 8192])
def test_matches_reference(n, batch):
    x = rand_complex(n + batch, (batch, n))
    check(x)
    xr = np.asarray(x)
    for got, want in zip(
            power_spectrum_stats_ref(torch.from_numpy(xr.real),
                                     torch.from_numpy(xr.imag)),
            ref_oracle(xr.real, xr.imag)):
        assert_close(got, want, RTOL)


def test_lead_dims_and_real_input():
    check(rand_complex(1, (3, 2, 256)))
    real = np.random.default_rng(2).standard_normal((4, 300)).astype(
        np.float32)
    p, _, _ = check(real)
    assert_close(p, real ** 2 / 300, RTOL)


def test_parseval_consistency():
    """mean(power) * N == mean |x|^2 of the time series."""
    x = torch.from_numpy(rand_complex(3, (2, 512)))
    _, mean, _ = power_spectrum_stats_kernel(torch.fft.fft(x))
    assert_close(mean, (x.abs() ** 2).mean(-1).numpy(), 1e-4)


def test_ledger_record():
    x = rand_complex(4, (3, 5, 129))
    _, _, ref_recs, port_recs = run_both(
        lambda: ref_stats(x, interpret=True)[0],
        lambda: power_spectrum_stats_kernel(torch.from_numpy(x)))
    (ref,), (port,) = ref_recs, port_recs
    assert (port.kernel, port.shape) == (ref.kernel, ref.shape) == \
        ("power-spectrum-stats", (15, 129))
    assert port.bytes_moved == 4 * 15 * (3 * 129 + 2)
    assert port.grid == (15,) and port.tile == (1, 129)


def test_plain_version_counts_no_launch():
    spectrum_kernel.reset_launches()
    power_spectrum_stats_kernel(torch.from_numpy(rand_complex(5, (2, 64))))
    assert spectrum_kernel.LAUNCHES == {"power_spectrum_stats": 0}


def test_empty_axis_guard_is_the_references():
    x = np.ones((2, 0), np.complex64)
    with pytest.raises(ValueError) as ref_err:
        ref_stats(x, interpret=True)
    with pytest.raises(ValueError) as port_err:
        power_spectrum_stats_kernel(torch.from_numpy(x))
    assert str(port_err.value) == str(ref_err.value)


def thread_bins(a: int, e: int, odd: bool) -> torch.Tensor:
    """(T, width) bins of the segment [a, e) that each thread adds, in its
    order, -1 where it adds none: thread 0 the single first bin where the
    segment starts odd (8 bytes past a 16-byte boundary), thread i % T
    pair i, thread T - 1 a single last bin."""
    head = odd and a < e
    a1 = a + head
    pairs = (e - a1) // 2
    idx = torch.full((T, 2 + 2 * -(-pairs // T)), -1)
    if head:
        idx[0, 0] = a
    i = torch.arange(pairs)
    idx[i % T, 1 + 2 * (i // T)] = a1 + 2 * i
    idx[i % T, 2 + 2 * (i // T)] = a1 + 2 * i + 1
    if a1 + 2 * pairs < e:
        idx[T - 1, -1] = e - 1
    return idx


def block_sum(v: torch.Tensor) -> torch.Tensor:
    """(..., T) per-thread values -> (...): each warp's shuffle tree, then
    the warps in order, as the kernel's block_sum."""
    w = v.reshape(*v.shape[:-1], T // 32, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    w = w[..., 0]
    out = w[..., 0]
    for k in range(1, w.shape[-1]):
        out = out + w[..., k]
    return out


def in_order(vals: torch.Tensor) -> torch.Tensor:
    """(..., T, width) -> (..., T): each thread's values added in turn."""
    acc = torch.zeros(vals.shape[:-1], dtype=torch.float64)
    for c in range(vals.shape[-1]):
        acc = acc + vals[..., c]
    return acc


def emulate(x: torch.Tensor, wave: int = spectrum_kernel.H100_WAVE,
            offset: int = 0):
    """The kernel's grid on the CPU (see the module docstring) for x whose
    first bin lies ``offset`` x 8 bytes past a 16-byte boundary ->
    (power, mean, variance)."""
    b, n = x.shape
    p = spectrum_kernel.power_spectrum_stats_plain(x)[0]  # the same rounding
    sums = torch.stack([p.double(), (p * p).double()])
    sums = torch.cat([sums, torch.zeros(2, b, 1, dtype=torch.float64)], -1)
    count, seg = spectrum_kernel.segments(b, n, wave)
    partial = torch.empty(2, b, count, dtype=torch.float64)
    seen = torch.zeros(b, n, dtype=torch.int64)
    for row in range(b):
        for s, r in enumerate(spectrum_kernel.segment_bounds(n, count, seg)):
            idx = thread_bins(r.start, r.stop,
                              (offset + row * n + r.start) % 2 == 1)
            bins = idx[idx >= 0]
            seen[row].index_add_(0, bins, torch.ones_like(bins))
            partial[:, row, s] = block_sum(in_order(sums[:, row][:, idx]))
    assert torch.equal(seen, torch.ones_like(seen))       # each bin once
    # The last block: thread t sums partials t, t + T, ... in turn.
    width = -(-count // T) * T
    padded = torch.cat([partial, torch.zeros(2, b, width - count,
                                             dtype=torch.float64)], -1)
    s1, s2 = block_sum(in_order(padded.reshape(2, b, -1, T)
                                .transpose(-1, -2)))
    mean, m2 = (s1 / n).float(), (s2 / n).float()
    return p, mean, m2 - mean * mean


@pytest.mark.parametrize("batch,n", [
    (1, 1), (1, 255), (3, 1025), (7, 1025), (1, 2**20), (4096, 1025),
    (32, 2**20), (2, 257), (5, 3 * 2**14 + 1)])
def test_segments_cover_every_row_once(batch, n):
    """Every bin in exactly one non-empty segment; no segment but the last
    shorter than MIN_SEGMENT unless the row is one segment; B S blocks
    fill at least two waves of the H100 wherever the rows are long enough
    (B = 1 included: (1, 2**20) takes 4096 segments of 256 bins), and
    about WAVES waves where the rows allow it."""
    count, seg = spectrum_kernel.segments(batch, n)
    bounds = spectrum_kernel.segment_bounds(n, count, seg)
    assert [b for r in bounds for b in r] == list(range(n))
    assert all(len(r) for r in bounds)
    assert count == 1 or min(len(r) for r in bounds[:-1]) >= \
        spectrum_kernel.MIN_SEGMENT
    wave, waves = spectrum_kernel.H100_WAVE, spectrum_kernel.WAVES
    if n // spectrum_kernel.MIN_SEGMENT >= 4 * wave / batch:
        assert batch * count >= 2 * wave
    if n // spectrum_kernel.MIN_SEGMENT >= 2 * waves * wave / batch:
        assert waves * wave <= batch * count <= waves * wave + batch
    assert (count, seg) == {(1, 2**20): (4096, 256),
                            (32, 2**20): (198, 5296),
                            (4096, 1025): (2, 513),
                            (1, 1): (1, 1)}.get((batch, n), (count, seg))


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("a,e", [(0, 1), (5, 6), (0, 2), (1, 3), (3, 514),
                                 (0, 4097), (7, 1031), (0, 2 * T)])
def test_threads_take_every_bin_of_a_segment_once(a, e, odd):
    """The head, pairs and tail of a segment, at either alignment: each
    bin once, a pair's bins by one thread in order, lane i % T pair i."""
    idx = thread_bins(a, e, odd)
    bins = idx[idx >= 0]
    assert sorted(bins.tolist()) == list(range(a, e))
    assert (idx[0, 0] == a) == (odd and a < e)
    pair = idx[:, 1:-1].reshape(T, -1, 2)
    full = pair[..., 0] >= 0
    assert torch.equal(pair[..., 1][full], pair[..., 0][full] + 1)
    assert ((pair[..., 0][full] - a - int(odd)) % 2 == 0).all()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("batch,n,wave", [
    (1, 1, spectrum_kernel.H100_WAVE), (3, 1025, spectrum_kernel.H100_WAVE),
    (1, 255, spectrum_kernel.H100_WAVE), (1, 8192, 8), (5, 4097, 4),
    (16, 2048, 1), (2, 3 * T + 7, 300)])
def test_emulated_reduction_matches_plain_and_float64(batch, n, wave, offset):
    """Many segments a row (a small wave) and one; odd N, so rows start
    at either alignment; x at either alignment."""
    x = rand_complex(n * batch + wave, (batch, n))
    p, mean, var = emulate(torch.from_numpy(x), wave, offset)
    wp, wmean, wvar = spectrum_kernel.power_spectrum_stats_plain(
        torch.from_numpy(x))
    assert torch.equal(p, wp)
    assert_close(mean, wmean.numpy(), RTOL)
    assert_close(var, wvar.numpy(), RTOL)
    p64 = x.real.astype(np.float64) ** 2 + x.imag.astype(np.float64) ** 2
    p64 /= n
    mean64 = p64.mean(-1)
    assert_close(p, p64, RTOL)
    assert_close(mean, mean64, RTOL)
    assert_close(var, (p64 * p64).mean(-1) - mean64 ** 2, RTOL)

