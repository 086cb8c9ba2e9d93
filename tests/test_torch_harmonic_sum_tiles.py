"""The tiling of the staged body that the ``harmonic_sum_plane`` and
``harmonic_sum`` kernels share (``csrc/harmonic_sum.cu``) emulated on
the CPU: per tile of K bins, the stage buffer filled as the kernel fills
it (slot (j - j0) K + m holds P[j (k0 + m)] for the stage's decimations
j, where j (k0 + m) < N; nothing elsewhere), every read at the slot the
kernel reads, the decimations stage by stage where they exceed the
buffer, and the rungs handed to the epilogue in the kernel's order.  The
plane's epilogue keeps the best normalised rung; the ladder's stores each
rung, the rungs past a tile's last decimation included, every (rung, bin)
once.  Both emulations are bit-identical to the plain versions at ragged
shapes (odd N, N = 65537, a last tile cut short), for H in {1, 2, 8, 32}
and past one stage (H = 128), at every compiled K; and the copies and
reads of a warp are 32 consecutive slots."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.harmonic_sum.ops import K


def rand_power(seed, shape):
    return torch.from_numpy((3.0 * np.random.default_rng(seed).random(shape))
                            .astype(np.float32))


def slot(j: int, j0: int, m, bins: int):
    """The stage-buffer slot of bin k0 + m's decimation j."""
    return (j - j0) * bins + m


def staged_rungs(p: torch.Tensor, n_harmonics: int, bins: int):
    """The staged body's grid on the CPU (see the module docstring):
    yields (k0, rung, S_h of the tile's K bins) tile by tile, each tile's
    rungs in order, as the kernel hands them to its epilogue."""
    b, n = p.shape
    n_levels = K.levels(n_harmonics)
    m = torch.arange(bins)
    for k0 in range(0, n, bins):
        k = k0 + m
        acc = torch.zeros(b, bins)
        lev = 0
        for js in K.stages(k0, n, n_harmonics, bins):
            assert len(js) <= K.per_stage(n_harmonics, bins)
            buf = torch.full((b, K.shared_bytes(n_harmonics, bins) // 4),
                             float("nan"))
            for j in js:                                   # the copies
                reads = j * k < n
                dst = slot(j, js[0], m[reads], bins)
                assert torch.isnan(buf[:, dst]).all()      # written once
                buf[:, dst] = p[:, j * k[reads]]
            for j in js:                                   # the adds
                reads = j * k < n
                v = buf[:, slot(j, js[0], m[reads], bins)]
                assert not torch.isnan(v).any()            # copied slots
                acc[:, reads] = v if j == 1 else acc[:, reads] + v
                if j & (j - 1) == 0:
                    yield k0, lev, acc.clone()
                    lev += 1
        for lev in range(lev, n_levels):                   # nothing to add
            yield k0, lev, acc.clone()


def emulate_plane(p: torch.Tensor, n_harmonics: int, bins: int):
    """The plane kernel: the staged body with the plane's epilogue."""
    n = p.shape[-1]
    n_levels = K.levels(n_harmonics)
    scales = K.rung_scales(n_levels)
    stat = torch.empty_like(p)
    level = torch.empty(p.shape, dtype=torch.int32)
    for k0, lev, acc in staged_rungs(p, n_harmonics, bins):
        if lev == 0:
            best = acc - 1.0
            best_lev = torch.zeros(acc.shape, dtype=torch.int32)
        else:
            z = (acc - float(2 ** lev)) * float(scales[lev])
            better = z > best
            best = torch.where(better, z, best)
            best_lev = torch.where(better, lev, best_lev)
        if lev == n_levels - 1:
            k = k0 + torch.arange(bins)
            keep = k < n
            stat[:, k[keep]] = best[:, keep]
            level[:, k[keep]] = best_lev[:, keep]
    return stat, level


def emulate_ladder(p: torch.Tensor, n_harmonics: int, bins: int):
    """The ladder kernel: the staged body with the ladder's epilogue,
    which stores rung lev of bin k at out[row, lev, k], each once."""
    b, n = p.shape
    out = torch.full((b, K.levels(n_harmonics), n), float("nan"))
    for k0, lev, acc in staged_rungs(p, n_harmonics, bins):
        k = k0 + torch.arange(bins)
        keep = k < n
        assert torch.isnan(out[:, lev, k[keep]]).all()     # stored once
        out[:, lev, k[keep]] = acc[:, keep]
    assert not torch.isnan(out).any()                      # every rung
    return out


def check(p, h, bins):
    want = K.harmonic_sum_plane_plain(p, h)
    got = emulate_plane(p, h, bins)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h", [1, 2, 8, 32])
@pytest.mark.parametrize("n", [1, 255, 1025, 4097])
def test_emulated_grid_is_the_plain_version(n, h):
    check(rand_power(n + h, (3, n)), h, K.plane_bins(h))


@pytest.mark.parametrize("h", [1, 2, 8, 32])
def test_emulated_grid_at_the_pulsar_row_length(h):
    """N = 65537: rows start 4-byte aligned, the last tile holds 1 bin."""
    check(rand_power(h, (2, 65537)), h, K.plane_bins(h))


@pytest.mark.parametrize("h", [1, 2, 8, 32])
@pytest.mark.parametrize("bins", K.PLANE_BINS)
def test_every_swept_tile_is_the_plain_version(bins, h):
    """Every compiled K (the chip check's sweep at H = 8) at each H: at
    K = 2048 and H = 32 the decimations take four stages."""
    check(rand_power(bins + h, (2, 8193)), h, bins)


@pytest.mark.parametrize("bins", K.PLANE_BINS)
@pytest.mark.parametrize("h", [1, 2, 8, 32, 128])
@pytest.mark.parametrize("n", [1, 255, 1025, 4097, 65537])
def test_emulated_ladder_is_the_plain_version(n, h, bins):
    """The ladder's epilogue on the staged schedule at every compiled K:
    H = 128 takes two stages at K = 256 and more at larger K; N = 1 and
    255 end inside the first tile, 65537 holds one bin in its last."""
    p = rand_power(n + h + bins, (2, n))
    assert torch.equal(emulate_ladder(p, h, bins),
                       K.harmonic_sum_plain(p, h))


def test_decimations_past_one_stage():
    bins = K.plane_bins(128)
    assert bins == 256 and K.per_stage(128, bins) == 64
    assert [list(js)[::63] for js in K.stages(0, 2049, 128, bins)] == \
        [[1, 64], [65, 128]]
    check(rand_power(128, (2, 2049)), 128, bins)


@pytest.mark.parametrize("h", [1, 2, 4, 8, 16, 32, 64, 1024])
def test_default_tiles_fit_three_blocks_an_sm(h):
    bins = K.plane_bins(h)
    assert bins in K.PLANE_BINS and K.PLANE_BUFFER >= bins
    assert 3 * (K.shared_bytes(h, bins) + 1024) <= 233472
    assert K.per_stage(h, bins) == min(h, 64)


def test_stages_of_the_pulsar_tiles():
    """H = 8, K = 2048: the first five tiles (k0 <= N / 8) take all eight
    decimations in one stage; a tile past N / 8 takes fewer (up to the
    last that stays inside the row); one past N / 2 only its own
    values."""
    bins, n = K.plane_bins(8), 65537
    assert bins == 2048 and K.shared_bytes(8, bins) == 65536
    assert K.stages(0, n, 8, bins) == [range(1, 9)]
    assert K.stages(6144, n, 8, bins) == [range(1, 9)]
    assert K.stages(8192, n, 8, bins) == [range(1, 9)]
    assert K.stages(10240, n, 8, bins) == [range(1, 7)]
    assert K.stages(16384, n, 8, bins) == [range(1, 5)]
    assert K.stages(32768, n, 8, bins) == [range(1, 3)]
    assert K.stages(65536, n, 8, bins) == [range(1, 2)]


@pytest.mark.parametrize("j", [1, 2, 3, 8, 31, 64])
def test_a_warp_copies_and_reads_consecutive_slots(j):
    """Lane l of warp w handles bin k0 + 32 w + l (+ 256 b): its slots
    are 32 consecutive words, one a bank, whatever j."""
    bins = K.plane_bins(8)
    for warp in range(K.PLANE_THREADS // 32):
        for b in range(bins // K.PLANE_THREADS):
            m = b * K.PLANE_THREADS + 32 * warp + np.arange(32)
            slots = slot(j, 1, m, bins)
            assert np.array_equal(np.diff(slots), np.ones(31))
            assert sorted(slots % 32) == list(range(32))
