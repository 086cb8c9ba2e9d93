"""The tiling of the ``dedisperse`` kernel (``csrc/dedisp.cu``) emulated on
the CPU: per trial group and sample tile, the channels staged chunk by
chunk as the kernel stages them (each narrow channel's window
fb[c, t0 + lo, t0 + T + hi) at its slot of the chunk's buffer, zero past
N, nothing elsewhere), every term read at the slot the kernel reads (the
trial's shift from lo), a channel wider than the staged span read from
the filterbank, and the sums in channel order.  The emulation is
bit-identical to the plain version for random tables with a delay of
N - 1, for tables that mix staged and wide channels, and for the pulsar
plan's table, at ragged D, N and B and every swept stage size."""
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import FilterbankSpec
from repro_torch.kernels.dedisp import dedisp_kernel as D
from repro_torch.search import DispersionPlan


def emulate_dedisperse(fb: torch.Tensor, delays: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    """The dedisperse kernel's grid on the CPU (see the module docstring)."""
    b, nchan, n = fb.shape
    ndm = delays.shape[0]
    st = D.staged_table(delays)
    assert D.shared_bytes(st.span_cap, chunk) <= D.MAX_SHARED_BYTES
    t_blk, d_blk = D.SAMPLES_PER_BLOCK, D.TRIALS_PER_BLOCK
    width = t_blk + st.span_cap
    tiles = -(-n // t_blk)
    x = torch.arange(t_blk)                    # lane + 32 s of each thread
    t0 = torch.arange(tiles) * t_blk

    def read(c, pos):                          # fb[:, c, pos], 0 past N
        return torch.where(pos < n, fb[:, c, pos.clamp(max=n - 1)], 0.0)

    out = torch.empty(b, ndm, n)
    for g in range(st.shifts.shape[0]):
        acc = torch.zeros(b, tiles, d_blk, t_blk)
        for c0 in range(0, nchan, chunk):
            cn = min(chunk, nchan - c0)
            buf = torch.full((b, tiles, chunk * width), float("nan"))
            lo, hi = st.lohi[g, c0:c0 + cn].unbind(-1)
            for i in range(cn):                # stage the narrow channels
                span = int(hi[i] - lo[i])
                if span > st.span_cap:
                    continue
                pos = t0[:, None] + int(lo[i]) + torch.arange(t_blk + span)
                buf[:, :, i * width:i * width + t_blk + span] = \
                    read(c0 + i, pos)
            for i in range(cn):                # add the chunk in order
                sh = st.shifts[g, c0 + i].long()
                assert int(sh.min()) >= 0 and int(sh.max()) <= hi[i] - lo[i]
                if hi[i] - lo[i] <= st.span_cap:
                    v = buf[:, :, i * width + sh[:, None] + x]
                else:
                    pos = t0[:, None, None] + int(lo[i]) + sh[:, None] + x
                    v = read(c0 + i, pos)
                assert not torch.isnan(v).any()     # staged slots only
                acc = acc + v
        d = g * d_blk + torch.arange(d_blk)
        keep = d < ndm
        out[:, d[keep]] = acc[:, :, keep].permute(0, 2, 1, 3).reshape(
            b, int(keep.sum()), tiles * t_blk)[..., :n]
    return out


def rand_fb(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def random_table(seed, ndm, nchan, n):
    """Delays anywhere in [0, N), the last trial's all N - 1."""
    table = np.random.default_rng(seed).integers(0, n, size=(ndm, nchan))
    table[-1] = n - 1
    return torch.from_numpy(table.astype(np.int32))


def mixed_table(seed, ndm, nchan, n):
    """Even channels drift by 0-4 samples a trial (staged), odd ones are
    random in [0, N) (wider than SPAN_MAX at N > 1025: read from global
    memory); one delay of N - 1."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 5, size=(ndm, nchan)).cumsum(axis=0)
    table = np.minimum(steps + rng.integers(0, n // 2, size=nchan), n - 1)
    table[:, 1::2] = rng.integers(0, n, size=(ndm, nchan // 2))
    table[-1, 0] = n - 1
    return torch.from_numpy(table.astype(np.int32))


def pulsar_table():
    """The pulsar search's table: 128 trials over 1024 channels of the
    FilterbankSpec band, delays 0-508."""
    spec = FilterbankSpec(nchan=1024, ntime=2**17)
    return torch.from_numpy(DispersionPlan.from_spec(
        spec, n_trials=128).delay_array().astype(np.int32))


def check(fb, table, chunk=D.CHUNK):
    want = D.dedisperse_plain(fb, table)
    assert torch.equal(emulate_dedisperse(fb, table, chunk), want)


@pytest.mark.parametrize("batch,nchan,n,ndm", [
    (1, 1, 1, 1),           # one sample, one trial
    (2, 5, 1025, 9),        # odd N, spans up to 1024: staged, wide windows
    (3, 17, 257, 129),      # a ragged chunk, two trial groups
    (1, 7, 3001, 130),      # spans past SPAN_MAX: every channel wide
])
def test_random_tables(batch, nchan, n, ndm):
    check(rand_fb(n, (batch, nchan, n)), random_table(n, ndm, nchan, n))


@pytest.mark.parametrize("ndm,nchan,n", [(70, 37, 2999), (130, 33, 1025),
                                         (65, 9, 4097)])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_every_instance_on_a_mixed_table(ndm, nchan, n, chunk):
    """Every stage size of the chip check's sweep, on tables that mix
    staged and wide channels at ragged D, C and N."""
    table = mixed_table(chunk + n, ndm, nchan, n)
    st = D.staged_table(table)
    spans = (st.lohi[..., 1] - st.lohi[..., 0])
    assert (spans <= st.span_cap).any() and (spans > st.span_cap).any()
    check(rand_fb(chunk + ndm, (2, nchan, n)), table, chunk)


def test_the_pulsar_table():
    """All 1024 channels staged (no span past the widest staged one), 16
    channels a stage, on 1024 samples."""
    table = pulsar_table()
    st = D.staged_table(table)
    spans = st.lohi[..., 1] - st.lohi[..., 0]
    assert int(spans.max()) == st.span_cap <= D.SPAN_MAX
    assert int(table.max()) == 508 and int(st.lohi[0, :, 0].max()) == 0
    check(rand_fb(7, (1, 1024, 1024)), table, 16)


def test_the_pulsar_table_in_smaller_groups():
    """64 trials a block: the second group's windows start past 0, and
    the spans halve."""
    table = pulsar_table()
    st = D.staged_table(table)
    assert D.TRIALS_PER_BLOCK == 64 and st.shifts.shape == (2, 1024, 64)
    assert int(st.lohi[1, :, 0].max()) > 0 and st.span_cap < 508
    check(rand_fb(8, (2, 1024, 777)), table)


def test_staged_table_of_a_ragged_group():
    """The last group's trials past D repeat its last trial, so its spans
    are those of the real trials."""
    table = random_table(3, 70, 5, 300)
    st = D.staged_table(table)
    assert st.shifts.shape == (2, 5, 64) and st.lohi.shape == (2, 5, 2)
    last = table[64:]
    assert torch.equal(st.lohi[1, :, 0], last.amin(0))
    assert torch.equal(st.lohi[1, :, 1], last.amax(0))
    assert torch.equal(st.shifts[1, :, 6:], (last[-1] - last.amin(0))[:, None]
                       .expand(5, 58))
    assert st.span_cap == int((st.lohi[..., 1] - st.lohi[..., 0]).max())


def test_default_tile_fits_two_blocks_an_sm_on_the_pulsar_table():
    """Two blocks and their 1 KB reserves fill the SM's 228 KB."""
    span = D.staged_table(pulsar_table()).span_cap
    assert D.stage_bytes(span) == 32 * (4 * 64 + 8 + 4 * (128 + span))
    assert 2 * D.shared_bytes(span) + 2048 <= 233472
    # And its widest staged span fits one block.
    assert D.shared_bytes(D.SPAN_MAX) <= D.MAX_SHARED_BYTES


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 17, 24, 31, 32])
def test_every_tile_fits_its_widest_span(chunk):
    """Every stage size up to the wrapper's holds two buffers of the
    widest staged span (the pulsar plan's 508 among them); a wider span
    would not fit at the wrapper's."""
    assert 508 <= D.SPAN_MAX
    assert D.shared_bytes(D.SPAN_MAX, chunk) <= D.MAX_SHARED_BYTES
    assert D.shared_bytes(D.SPAN_MAX + 1, D.CHUNK) > D.MAX_SHARED_BYTES


def test_staged_table_is_made_once_per_table_tensor():
    """The wrapper's staged table is kept while its delay tensor lives
    unchanged, and made anew after the tensor is written to."""
    table = random_table(4, 9, 6, 200)
    first = D._staged(table)
    assert D._staged(table) is first
    assert D._staged(table.clone()) is not first
    table[0, 0] = 199
    again = D._staged(table)
    assert again is not first and int(again.lohi[0, 0, 1]) == 199
