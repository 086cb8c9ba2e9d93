"""The port's harmonic-sum wrappers (``repro_torch.kernels.harmonic_sum``)
against the reference's (``repro.kernels.harmonic_sum``: the Pallas
kernels in interpret mode, and the gather oracles) on the same numpy power
spectra.  Statistics and ladders within 1e-5 * max |ref|; the winning rung
equal wherever the best rung beats the runner-up by more than 1e-5 (two
rungs within rounding of each other may tie either way); the reference's
guards with its messages; the ledger records."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, run_both
from repro.kernels.harmonic_sum import (harmonic_sum_kernel as ref_ladder,
                                        harmonic_sum_plane as ref_plane,
                                        harmonic_sum_plane_ref as ref_plane_o,
                                        harmonic_sum_ref as ref_ladder_o)
from repro_torch.kernels.harmonic_sum import (harmonic_sum_kernel,
                                              harmonic_sum_plane,
                                              harmonic_sum_plane_ref,
                                              harmonic_sum_ref)
from repro_torch.kernels.harmonic_sum.ops import K

RTOL = 1e-5
MARGIN = 1e-5


def rand_power(seed, shape, scale=3.0):
    return (scale * np.random.default_rng(seed).random(shape)).astype(
        np.float32)


def rung_margin(p: np.ndarray, h: int) -> np.ndarray:
    """Best minus runner-up normalised rung, from the reference's ladder."""
    ladder = np.asarray(ref_ladder_o(p, h))
    hs = 2.0 ** np.arange(ladder.shape[-2])
    z = np.sort((ladder - hs[:, None]) / np.sqrt(hs)[:, None], axis=-2)
    if z.shape[-2] == 1:
        return np.full(z.shape[:-2] + z.shape[-1:], np.inf)
    return z[..., -1, :] - z[..., -2, :]


def check_plane(p: np.ndarray, h: int):
    stat, lev = harmonic_sum_plane(torch.from_numpy(p), h)
    assert stat.dtype == torch.float32 and lev.dtype == torch.int32
    assert tuple(stat.shape) == tuple(lev.shape) == p.shape
    clear = rung_margin(p, h) > MARGIN
    for ref_stat, ref_lev in (ref_plane(p, h, interpret=True),
                              ref_plane_o(p, h)):
        assert_close(stat, ref_stat, RTOL)
        assert np.array_equal(lev.numpy()[clear], np.asarray(ref_lev)[clear])
    pstat, plev = harmonic_sum_plane_ref(torch.from_numpy(p), h)
    assert_close(pstat, ref_plane_o(p, h)[0], RTOL)
    assert np.array_equal(plev.numpy()[clear],
                          np.asarray(ref_plane_o(p, h)[1])[clear])
    return stat, lev


@pytest.mark.parametrize("h", [1, 2, 8, 32])
@pytest.mark.parametrize("n", [64, 1025])
def test_plane_matches_reference(n, h):
    check_plane(rand_power(n + h, (5, n)), h)


@pytest.mark.parametrize("h", [1, 2, 8, 32])
@pytest.mark.parametrize("n", [64, 1025])
def test_ladder_matches_reference(n, h):
    p = rand_power(n * h, (5, n))
    got = harmonic_sum_kernel(torch.from_numpy(p), h)
    assert tuple(got.shape) == (5, int(np.log2(h)) + 1, n)
    assert_close(got, ref_ladder(p, h, interpret=True), RTOL)
    assert_close(got, ref_ladder_o(p, h), RTOL)
    assert_close(harmonic_sum_ref(torch.from_numpy(p), h), ref_ladder_o(p, h),
                 RTOL)


def test_odd_length_lead_axes_and_a_prime_batch():
    check_plane(rand_power(1, (11, 3, 129)), 8)
    p = rand_power(2, (7, 2, 129))
    got = harmonic_sum_kernel(torch.from_numpy(p), 4)
    assert tuple(got.shape) == (7, 2, 3, 129)
    assert_close(got, ref_ladder(p, 4, interpret=True), RTOL)


def test_single_harmonic_edge():
    """n_harmonics=1: stat == P - 1 (z_1), level 0; the ladder is P."""
    p = rand_power(3, (2, 64), scale=1.0)
    stat, lev = harmonic_sum_plane(torch.from_numpy(p), 1)
    assert torch.equal(stat, torch.from_numpy(p) - 1.0)
    assert not lev.any()
    assert torch.equal(harmonic_sum_kernel(torch.from_numpy(p), 1)[:, 0],
                       torch.from_numpy(p))


def test_flat_spectrum_counts_in_range_harmonics():
    n = 128
    got = harmonic_sum_kernel(torch.ones(1, n), 4)
    assert got[0, :, 1].tolist() == [1.0, 2.0, 4.0]
    assert got[0, :, n - 1].tolist() == [1.0, 1.0, 1.0]


def test_planted_harmonic_signal_picks_deep_level():
    n, k = 256, 10
    p = torch.ones(1, n)
    for m in (1, 2, 4):
        p[0, m * k] += 30.0
    stat, lev = harmonic_sum_plane(p, 8)
    assert int(lev[0, k]) == 2 and int(stat[0].argmax()) == k


def test_plane_agrees_with_the_ladder():
    p = torch.from_numpy(rand_power(4, (4, 128), scale=2.0))
    ladder = harmonic_sum_kernel(p, 16)
    hs = 2.0 ** torch.arange(ladder.shape[-2])
    z = (ladder - hs[:, None]) / torch.sqrt(hs)[:, None]
    stat, lev = harmonic_sum_plane(p, 16)
    assert_close(stat, z.max(dim=-2).values.numpy(), RTOL)


def test_ledger_records():
    p = rand_power(5, (3, 7, 129))
    _, _, ref_recs, port_recs = run_both(
        lambda: ref_plane(p, 8, interpret=True)[0],
        lambda: harmonic_sum_plane(torch.from_numpy(p), 8))
    (ref,), (port,) = ref_recs, port_recs
    assert (port.kernel, port.shape) == (ref.kernel, ref.shape) == \
        ("harmonic-sum-plane", (21, 129))
    assert port.bytes_moved == 12 * 21 * 129
    # H = 8: a plane block takes 2048 bins (eight a thread).
    assert port.grid == (21,) and port.tile == (1, 2048)
    assert K.plane_blocks(21, 65537, K.plane_bins(8)) == 21 * 33
    _, _, ref_recs, port_recs = run_both(
        lambda: ref_ladder(p, 8, interpret=True),
        lambda: harmonic_sum_kernel(torch.from_numpy(p), 8))
    (ref,), (port,) = ref_recs, port_recs
    assert (port.kernel, port.shape) == (ref.kernel, ref.shape) == \
        ("harmonic-sum", (21, 129))
    assert port.bytes_moved == 4 * 21 * 129 * (1 + 4)
    # The ladder's blocks take 1024 bins whatever H.
    assert port.grid == (21,) and port.tile == (1, 1024)
    assert K.plane_blocks(32, 2**20, K.LADDER_BINS) == 32 * 1024


def test_plain_versions_count_no_launch():
    K.reset_launches()
    p = torch.from_numpy(rand_power(6, (2, 64)))
    harmonic_sum_plane(p, 4)
    harmonic_sum_kernel(p, 4)
    assert K.LAUNCHES == {"harmonic_sum_plane": 0, "harmonic_sum": 0}


def test_rung_scales_are_the_references_float32():
    assert K.rung_scales(4).tolist() == [
        float(np.float32(1.0 / np.sqrt(h))) for h in (1, 2, 4, 8)]


@pytest.mark.parametrize("fn", ["ladder", "plane"])
@pytest.mark.parametrize("x,h", [
    (np.ones((2, 64), np.float32), 12),
    (np.ones((2, 64), np.float32), 0),
    (np.ones((2, 64), np.float32), 3),
    (np.ones((2, 0), np.float32), 8),
    (np.ones((2, 64), np.complex64), 8),
])
def test_guards_are_the_references(fn, x, h):
    ref_fn, port_fn = ((ref_ladder, harmonic_sum_kernel) if fn == "ladder"
                       else (ref_plane, harmonic_sum_plane))
    with pytest.raises(ValueError) as ref_err:
        ref_fn(x, h, interpret=True)
    with pytest.raises(ValueError) as port_err:
        port_fn(torch.from_numpy(x), h)
    assert str(port_err.value) == str(ref_err.value)
