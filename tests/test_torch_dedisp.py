"""The port's dedispersion kernel wrapper (``repro_torch.kernels.dedisp``)
against the reference's (``repro.kernels.dedisp``: the Pallas kernel in
interpret mode, and its ``take_along_axis`` oracle) on the same numpy
filterbanks and delay tables, within 1e-5 * max |ref| (the reference adds
channels that share a delay before the shift, the port in channel order);
the reference's guards with its messages; the ledger record; the device
delay table cached per table."""
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, run_both
from repro.kernels.dedisp import dedisperse_kernel as ref_dedisperse
from repro.kernels.dedisp import dedisperse_ref as ref_oracle
from repro_torch.data.synthetic import (FilterbankSpec, InjectedPulsar,
                                        synthetic_filterbank)
from repro_torch.kernels.dedisp import dedisperse_kernel, dedisperse_ref
from repro_torch.kernels.dedisp import dedisp_kernel, ops

RTOL = 1e-5


def rand_fb(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def rand_delays(seed, ndm, nchan, ntime):
    rng = np.random.default_rng(seed + 1000)
    return rng.integers(0, ntime, size=(ndm, nchan), dtype=np.int64)


def check_parity(fb, delays):
    port = dedisperse_kernel(torch.from_numpy(fb), delays)
    ref = ref_dedisperse(fb, delays, interpret=True)
    assert_close(port, ref, RTOL)
    assert_close(port, ref_oracle(fb, delays), RTOL)
    assert_close(dedisperse_ref(torch.from_numpy(fb), delays),
                 ref_oracle(fb, delays), RTOL)
    return port


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("ndm", [1, 5])
def test_matches_reference(batch, ndm):
    fb = rand_fb(0, (batch, 8, 256))
    port = check_parity(fb, rand_delays(0, ndm, 8, 256))
    assert tuple(port.shape) == (batch, ndm, 256)
    assert port.dtype == torch.float32


@pytest.mark.parametrize("shape,ndm", [
    ((2, 3, 4, 128), 6),         # lead axes
    ((4, 64), 3),                # a rank-2 payload: no batch axis
    ((13, 4, 512), 4),           # a prime batch
    ((2, 5, 1025), 9),           # odd N, DM trials filling no whole block
])
def test_shapes_match_reference(shape, ndm):
    fb = rand_fb(1, shape)
    port = check_parity(fb, rand_delays(1, ndm, shape[-2], shape[-1]))
    assert tuple(port.shape) == (*shape[:-2], ndm, shape[-1])


@pytest.mark.parametrize("seed", range(8))
def test_random_tables_match_reference(seed):
    rng = np.random.default_rng(seed)
    batch, nchan, ndm = (int(v) for v in rng.integers(1, 9, size=3))
    n = int(rng.choice([96, 128, 200]))
    check_parity(rand_fb(seed, (batch, nchan, n)),
                 rand_delays(seed, ndm, nchan, n))


def test_largest_delay_reads_one_sample():
    fb = rand_fb(2, (2, 3, 1025))
    delays = np.array([[1024, 0, 1024], [1024, 1024, 1024]], np.int64)
    port = check_parity(fb, delays)
    assert torch.equal(port[:, 1, 1:], torch.zeros(2, 1024))
    assert torch.equal(port[:, 1, 0],
                       torch.from_numpy(fb[:, :, 1024].sum(1)))


def test_zero_delay_is_channel_sum():
    fb = rand_fb(3, (2, 6, 128))
    got = dedisperse_kernel(torch.from_numpy(fb), np.zeros((1, 6), np.int64))
    assert_close(got[:, 0], fb.sum(axis=1), RTOL)


def test_plan_delays_cancel_injection():
    """Dedispersing at the injected DM's own rounded delays re-aligns the
    pulse: the k0 bin dominates only on the matched trial."""
    spec = FilterbankSpec(nchan=8, ntime=1024)
    dm = 40 * spec.dm_step
    fb = synthetic_filterbank(
        spec, (InjectedPulsar(dm=dm, k0=200, amp=0.5),), noise=0.5, seed=0)
    delays = np.stack([np.zeros(spec.nchan, np.int64),
                       spec.delay_samples(dm)])
    ts = dedisperse_kernel(torch.from_numpy(fb), delays)
    power = torch.fft.rfft(ts - ts.mean(-1, keepdim=True)).abs() ** 2
    assert int(power[1].argmax()) == 200
    assert float(power[1, 200]) > 4 * float(power[0, 200])


def test_ledger_and_launch_geometry():
    fb = rand_fb(4, (13, 4, 512))
    delays = rand_delays(4, 9, 4, 512)
    _, _, ref_recs, port_recs = run_both(
        lambda: ref_dedisperse(fb, delays, interpret=True),
        lambda: dedisperse_kernel(torch.from_numpy(fb), delays))
    (ref,), (port,) = ref_recs, port_recs
    assert (port.kernel, port.shape) == (ref.kernel, ref.shape) == \
        ("dedisperse", (13, 4, 512))
    # The reference counts its padded batch; the port the batch itself.
    assert port.bytes_moved == 4 * 13 * 512 * (4 + 9)
    # A block: 64 trials (eight warps of 8) x 128 samples (32 lanes x 4).
    assert port.grid == (13 * 1 * 4,) and port.tile == (64, 128)
    assert dedisp_kernel.blocks(13, 9, 512) == 13 * 1 * 4
    assert dedisp_kernel.blocks(13, 65, 513) == 13 * 2 * 5
    assert dedisp_kernel.blocks(2, 128, 2**17) == 2 * 2 * 1024


def test_plain_version_counts_no_launch():
    dedisp_kernel.reset_launches()
    dedisperse_kernel(torch.from_numpy(rand_fb(5, (2, 3, 64))),
                      rand_delays(5, 2, 3, 64))
    assert dedisp_kernel.LAUNCHES == {"dedisperse": 0}


def test_tuple_tables_are_cached_per_table_and_device():
    delays = tuple(tuple(int(d) for d in row)
                   for row in rand_delays(6, 4, 3, 64))
    cpu = torch.device("cpu")
    first, lo, hi = ops._device_table(delays, None, cpu)
    again, _, _ = ops._device_table(delays, None, cpu)
    assert again is first and first.dtype == torch.int32
    assert (lo, hi) == (min(map(min, delays)), max(map(max, delays)))
    # An equal but distinct tuple builds its own table.
    copy = tuple(tuple(row) for row in delays)
    assert ops._device_table(copy, None, cpu)[0] is not first
    fb = rand_fb(6, (2, 3, 64))
    assert_close(dedisperse_kernel(torch.from_numpy(fb), delays),
                 ref_oracle(fb, np.asarray(delays)), RTOL)


def _both_raise(fb, delays, match):
    with pytest.raises(ValueError, match=match) as ref_err:
        ref_dedisperse(fb, delays, interpret=True)
    with pytest.raises(ValueError, match=match) as port_err:
        dedisperse_kernel(torch.as_tensor(fb), delays)
    return str(ref_err.value), str(port_err.value)


@pytest.mark.parametrize("fb,delays,match", [
    (np.ones((64,), np.float32), [[0]], "nchan, ntime"),
    (np.ones((2, 4, 64), np.complex64), np.zeros((1, 4), np.int64),
     "must be real"),
    (np.ones((2, 0, 64), np.float32), np.zeros((1, 0), np.int64),
     "non-empty"),
    (np.ones((2, 4, 0), np.float32), np.zeros((1, 4), np.int64),
     "non-empty"),
    (np.ones((2, 4, 64), np.float32), np.zeros((2, 3), np.int64),
     "covers 3 channels"),
    (np.ones((2, 4, 64), np.float32), np.zeros((0, 4), np.int64),
     "no DM trials"),
    (np.ones((2, 4, 64), np.float32), np.zeros((1, 4), np.float32),
     "integer samples"),
    (np.ones((2, 4, 64), np.float32), np.zeros(4, np.int64),
     r"\(n_dm, nchan\) table"),
])
def test_guards_are_the_references(fb, delays, match):
    ref, port = _both_raise(fb, delays, match)
    assert port == ref


@pytest.mark.parametrize("as_tuple", [False, True])
@pytest.mark.parametrize("delays", [((0, 64),), ((-1, 0),), ((3, 70),)])
def test_out_of_range_delays_raise(delays, as_tuple):
    """An array table and a tuple table (the cached path) alike."""
    fb = np.ones((2, 2, 64), np.float32)
    table = delays if as_tuple else np.asarray(delays)
    ref, port = _both_raise(fb, table, r"outside \[0, ntime=64\)")
    assert port == ref
