"""The sift's select kernel (``repro_torch.kernels.sift``).

On the CPU: the wrapper's one route (the plain twin, one ``torch.topk``
and the count, on the CPU and for a row that fits in the kernel's
buffer) and its guards, and a model of the
kernel's selection in torch (``_model``: the histograms of the 32-bit
order key, the scans from the strongest bin down, the refinements and the
ties at full resolution, as ``csrc/sift.cu`` runs them), which keeps the
row's strongest cells at or above the floor within the buffer on noise,
ties, an all-equal plane, signed zeros and a pool larger than the row.

Marked ``cuda`` (they skip without a card): the kernel against
``torch.topk`` of the plane at or above the floor and against the count
over the threshold, exactly, its padding marked (index and level -1);
the wrapper refusing a plane of another type than float32 on the card;
and a search block on the card that takes the kernel under
``torch.cuda.set_sync_debug_mode("error")``.  The tests that need a
small buffer set ``sift_kernel.CAPACITY`` to 1, so that a row's buffer
holds ``4 * pool`` cells (``capacity_for``).  On the GPU
machine:

    python -m pytest -q -m cuda tests/test_torch_sift_select.py
"""
import pytest
import torch

from repro_torch.kernels.sift import sift_kernel as K
from repro_torch.kernels.sift import sift_select

MASK = 0xFFFFFFFF


def _keys(x: torch.Tensor) -> torch.Tensor:
    """``csrc/sift.cu``'s key_of, as int64: the floats' order, NaN top."""
    u = x.view(torch.int32).to(torch.int64) & MASK
    key = torch.where(u >= 0x80000000, ~u & MASK, u | 0x80000000)
    return torch.where(torch.isnan(x), torch.full_like(key, MASK), key)


def _model(row: torch.Tensor, pool: int, floor: float | None,
           capacity: int) -> tuple[torch.Tensor, int, int]:
    """The cells of a 1-D row the kernel leaves in its buffer (indices),
    its refinement reads and its reads of the row."""
    keys = _keys(row)
    lo = int(_keys(torch.tensor([floor]))[0]) if floor is not None else 0
    cand = keys >= lo
    hist = torch.bincount(keys[cand] >> 20, minlength=1 << 12)
    if int(hist.sum()) <= capacity:
        return torch.nonzero(cand).flatten(), 0, 1 if floor is not None else 2
    prefix, bits, width, need, above = 0, 0, 12, pool, 0
    for level in range(3):
        desc = hist.flip(0)
        incl = torch.cumsum(desc, 0)
        j = int(torch.nonzero(incl >= need)[0])
        r = int(incl[j] - desc[j])
        a, kept = above + r, above + int(incl[j])
        key = (prefix << width) | (len(hist) - 1 - j)
        rest = 32 - bits - width
        if kept <= capacity:
            cut = max(key << rest, lo)
            return torch.nonzero(keys >= cut).flatten(), level, level + 2
        if rest == 0:
            over = torch.nonzero(keys > key).flatten()
            ties = torch.nonzero(keys == key).flatten()[:need - r]
            assert len(over) == a
            return torch.cat([over, ties]), level, level + 2
        prefix, bits, width, need, above = key, bits + width, 10, need - r, a
        inside = cand & ((keys >> (32 - bits)) == prefix)
        hist = torch.bincount((keys[inside] >> (32 - bits - 10)) & 1023,
                              minlength=1 << 10)
    raise AssertionError("the scans end by the 32nd bit")


def _want(row: torch.Tensor, pool: int, floor: float | None) -> torch.Tensor:
    """The values torch.topk gives for the row's cells at or above the
    floor (-inf standing in for the rest)."""
    if floor is not None:
        row = torch.where(row >= floor, row, -torch.inf)
    return torch.topk(row, min(pool, row.numel())).values


def _noise(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g) * 3.0 + 1.0


MODEL_CASES = {
    "noise": (lambda: _noise(50_000, 1), 300, None, 4096),
    "noise_floor": (lambda: _noise(50_000, 2), 300, 8.0, 4096),
    "floor_overflow": (lambda: _noise(50_000, 3), 300, -2.0, 4096),
    "refine_once": (lambda: _noise(200_000, 4), 50, None, 64),
    "refine_twice": (lambda: 1.0 + _noise(200_000, 5) * 1e-6, 50, None, 64),
    "quantised_ties": (lambda: torch.round(_noise(50_000, 6)), 777, None,
                       1000),
    "all_equal": (lambda: torch.full((40_000,), 2.5), 300, None, 1024),
    "all_equal_floor": (lambda: torch.full((40_000,), 2.5), 300, 2.5, 1024),
    "signed_zeros": (lambda: torch.tensor([0.0, -0.0] * 5000), 99, None, 128),
    "negative": (lambda: -torch.abs(_noise(30_000, 7)), 200, None, 512),
    "pool_over_row": (lambda: _noise(5_000, 8), 8_000, None, 8_192),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_keeps_the_strongest_cells_within_the_buffer(case):
    make, pool, floor, capacity = MODEL_CASES[case]
    row = make().to(torch.float32)
    kept, refines, reads = _model(row, pool, floor, capacity)
    assert len(kept) <= capacity and len(set(kept.tolist())) == len(kept)
    got = torch.full((capacity,), -torch.inf)
    got[:len(kept)] = row[kept]
    assert torch.equal(torch.topk(got, min(pool, row.numel())).values,
                       _want(row, pool, floor))
    if case in ("refine_once", "refine_twice", "all_equal"):
        assert refines == {"refine_once": 1}.get(case, 2)
        assert reads == refines + 2
    if case == "noise_floor":
        assert (refines, reads) == (0, 1)


def test_keys_keep_the_order_of_the_floats():
    x = torch.tensor([-torch.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0,
                      torch.inf, torch.nan])
    k = _keys(x)
    assert torch.all(k[1:] > k[:-1])


def test_plain_route_is_one_topk_and_the_count():
    g = torch.Generator().manual_seed(0)
    stat = torch.randn(2, 3000, generator=g)
    level = torch.randint(0, 4, (2, 3000), generator=g, dtype=torch.int32)
    got = sift_select(stat, level, 64, threshold=1.5)
    vals, idx = torch.topk(stat, 64)
    assert torch.equal(got.vals, vals) and torch.equal(got.idx, idx)
    assert torch.equal(got.level, torch.gather(level, -1, idx))
    assert got.level.dtype == torch.int32
    assert torch.equal(got.over, (stat >= 1.5).sum(-1))
    assert torch.equal(got.counts, torch.zeros(2, 3, dtype=torch.int64))
    assert sift_select(stat, level, 64).over is None
    # A pool larger than the row: the whole row, strongest first.
    whole = sift_select(stat, level, 5000)
    assert torch.equal(whole.vals, torch.sort(stat, descending=True).values)


def test_a_row_longer_than_the_buffer_takes_the_kernels_twin(monkeypatch):
    """Past ``capacity_for(pool)`` cells the wrapper records one launch of
    the kernel, and runs its plain twin on the CPU."""
    from repro_torch.obs.ledger import LaunchLedger
    monkeypatch.setattr(K, "CAPACITY", 1000)
    stat = _noise(2 * 4001, 9).reshape(2, 4001)
    level = torch.zeros((2, 4001), dtype=torch.int32)
    ledger = LaunchLedger()
    with ledger.capture():
        got = sift_select(stat, level, 10, floor=torch.zeros(2),
                          threshold=2.0)
        sift_select(stat[:, :1000], level[:, :1000], 10)
    assert ledger.counts() == {"sift-select": 1}
    (rec,) = ledger.records
    assert rec.shape == (2, 4001)
    assert rec.bytes_moved == 4 * 2 * 4001 + 16 * 2 * 1000
    assert torch.equal(got.vals, torch.topk(stat, 10).values)
    assert torch.equal(got.over, (stat >= 2.0).sum(-1))


def test_a_cpu_plane_of_any_type_takes_the_plain_twin(monkeypatch):
    """A float64 plane past the buffer on the CPU: the plain twin, its
    values and indices torch.topk's, its levels int32."""
    monkeypatch.setattr(K, "CAPACITY", 1)
    stat = _noise(2 * 3001, 11).reshape(2, 3001).double()
    level = torch.randint(0, 4, (2, 3001), dtype=torch.int64)
    got = sift_select(stat, level, 50, floor=torch.zeros(2),
                      threshold=4.0)
    vals, idx = torch.topk(stat, 50)
    assert torch.equal(got.vals, vals) and torch.equal(got.idx, idx)
    assert got.level.dtype == torch.int32
    assert torch.equal(got.level, torch.gather(level, -1, idx).int())
    assert torch.equal(got.over, (stat >= 4.0).sum(-1))


def test_count_over_in_chunks(monkeypatch):
    monkeypatch.setattr(K, "COUNT_CELLS", 7)
    stat = _noise(3 * 101, 10).reshape(3, 101)
    assert torch.equal(K.count_over(stat, 1.0), (stat >= 1.0).sum(-1))


def test_guards():
    stat = torch.zeros(2, 10)
    level = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="one shape"):
        sift_select(stat, level[:, :5], 4)
    with pytest.raises(ValueError, match="one shape"):
        sift_select(stat[0], level[0], 4)
    with pytest.raises(ValueError, match="pool >= 1"):
        sift_select(stat, level, 0)
    with pytest.raises(ValueError, match="2-D float32"):
        K.select(stat.double(), level, 4)
    with pytest.raises(ValueError, match="int32 level"):
        K.select(stat, level.long(), 4)
    with pytest.raises(ValueError, match="pool >= 1"):
        K.select(stat, level, 0)
    with pytest.raises(ValueError, match="float32 floor"):
        K.select(stat, level, 4, floor=torch.zeros(3))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K.select(stat, level, 4)


def test_chunks_fill_the_waves_and_no_block_idles():
    assert K.chunks(1, 1_426_063_700) == K.WAVES * K.H100_WAVE
    assert K.chunks(2, 1_426_063_700) == K.WAVES * K.H100_WAVE // 2
    assert K.chunks(1, 100) == 1
    assert K.chunks(1, 4 * K.THREADS * K.UNROLL * 3) == 3


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.Generator(device="cuda").manual_seed(0)


def _check(stat, level, pool, floor=None, threshold=None):
    """The kernel's selection against topk of the plane at or above the
    floor, its indices and levels naming those cells, its padding marked,
    its count against the plain count; returns the counters."""
    launches = K.LAUNCHES["sift_select"]
    got = K.select(stat, level, pool, floor, threshold)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sift_select"] == launches + 1
    rows, m = stat.shape
    for r in range(rows):
        f = None if floor is None else float(floor[r])
        assert torch.equal(got.vals[r].cpu(), _want(stat[r].cpu(), pool, f))
        real = got.vals[r] > -torch.inf
        idx = got.idx[r][real]
        assert len(set(idx.tolist())) == len(idx)
        assert torch.equal(stat[r][idx], got.vals[r][real])
        assert torch.equal(level[r][idx], got.level[r][real])
        assert (got.idx[r][~real] == -1).all()
        assert (got.level[r][~real] == -1).all()
    if threshold is not None:
        assert torch.equal(got.over, K.count_over(stat, threshold))
    return got.counts.cpu()


def _levels(card, shape):
    return torch.randint(0, 4, shape, generator=card, device="cuda",
                         dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (1, 2))
def test_kernel_on_noise_planes(card, rows):
    m = 3 * 2**20 + 3
    stat = torch.randn((rows, m), generator=card, device="cuda") * 3 + 1
    level = _levels(card, (rows, m))
    counts = _check(stat, level, 1000, threshold=9.0)
    assert counts[:, 1].tolist() == [0] * rows
    assert counts[:, 2].tolist() == [2] * rows
    # With the floor of a full pool: one read, the cells above it kept.
    floor = torch.topk(stat, 700).values[:, -1].contiguous()
    counts = _check(stat, level, 1000, floor=floor, threshold=9.0)
    assert counts[:, 0].tolist() == [700] * rows
    assert counts[:, 2].tolist() == [1] * rows


@pytest.mark.cuda
def test_kernel_on_a_plane_at_an_odd_offset(card):
    m = 2**19 + 1
    buf = torch.randn(2 * m + 1, generator=card, device="cuda")
    stat = buf[1:].view(2, m)
    lbuf = _levels(card, (2 * m + 3,))
    _check(stat, lbuf[3:].view(2, m), 333, threshold=2.5)


@pytest.mark.cuda
def test_kernel_with_many_ties_at_the_boundary(card, monkeypatch):
    monkeypatch.setattr(K, "CAPACITY", 1)
    m = 2**20
    stat = torch.round(torch.randn((2, m), generator=card, device="cuda"))
    level = _levels(card, (2, m))
    # 2.0 holds about 61000 cells a row, the values above it about 6200:
    # the pool ends among the ties, which overflow its buffer of 4 pools.
    above = int((stat > 2.0).sum(-1).max())
    counts = _check(stat, level, above + 7, threshold=3.0)
    assert (counts[:, 1] == 2).all() and (counts[:, 2] == 4).all()


@pytest.mark.cuda
def test_kernel_on_an_all_equal_plane(card, monkeypatch):
    monkeypatch.setattr(K, "CAPACITY", 1)
    stat = torch.full((1, 2**20 + 5), 1.25, device="cuda")
    level = _levels(card, stat.shape)
    counts = _check(stat, level, 500, threshold=1.25)
    assert counts.tolist() == [[500, 2, 4]]
    floor = torch.full((1,), 1.25, device="cuda")
    counts = _check(stat, level, 500, floor=floor)
    assert counts.tolist() == [[500, 2, 4]]


@pytest.mark.cuda
def test_kernel_refines_when_the_floor_lets_too_many_through(card,
                                                            monkeypatch):
    monkeypatch.setattr(K, "CAPACITY", 1)
    m = 2**21
    stat = 1 + torch.randn((2, m), generator=card, device="cuda") * 1e-3
    level = _levels(card, (2, m))
    floor = torch.full((2,), 0.5, device="cuda")
    # Every cell passes the floor and lies in one bin of the first
    # histogram, [1, 1.125): a refinement, whose bins are 1.2e-4 wide,
    # finds the cut, and 400 entries hold the cells above it.
    counts = _check(stat, level, 100, floor=floor, threshold=1.002)
    for r in range(2):
        _, refines, reads = _model(stat[r].cpu(), 100, 0.5, 400)
        assert counts[r, 1:].tolist() == [refines, reads] == [1, 3]
    assert (counts[:, 0] <= 400).all()


@pytest.mark.cuda
def test_kernel_with_a_pool_larger_than_the_plane(card):
    stat = torch.randn((2, 5000), generator=card, device="cuda")
    level = _levels(card, (2, 5000))
    counts = _check(stat, level, 8000, threshold=1.0)
    assert counts.tolist() == [[5000, 0, 2]] * 2


@pytest.mark.cuda
def test_the_card_refuses_a_plane_of_another_type(card, monkeypatch):
    """Past the buffer a float64 plane on the card raises: the kernel takes
    float32, and no plain topk stands in for it there."""
    monkeypatch.setattr(K, "CAPACITY", 1)
    stat = torch.randn((1, 5000), generator=card, device="cuda",
                       dtype=torch.float64)
    with pytest.raises(ValueError, match="2-D float32"):
        sift_select(stat, _levels(card, (1, 5000)), 100)


@pytest.mark.cuda
def test_search_block_takes_the_kernel_without_waiting(card):
    """A block whose sub-blocks outgrow the buffer (4 trials x 9 templates
    x 8193 bins) pools through the kernel, waits for nothing under
    ``set_sync_debug_mode("error")``, and pools the block's strongest
    cells: topk over its whole volume."""
    from repro_torch.data.synthetic import FilterbankSpec, synthetic_filterbank
    from repro_torch.search import DispersionPlan, PulsarSearch, TemplateBank
    spec = FilterbankSpec(nchan=32, ntime=2**14)
    plan = DispersionPlan.from_spec(spec, n_trials=8)
    bank = TemplateBank.linear(4)
    fb = torch.from_numpy(synthetic_filterbank(spec, (), seed=4))[None]
    fb = fb.cuda()
    search = PulsarSearch(plan, bank, n_harmonics=4, pool=2000,
                          threshold=6.0, fdas_block=4)
    search.prepare(fb.device)
    warm = search.block(fb, 0, keep=range(8))
    launches = K.LAUNCHES["sift_select"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = search.block(fb, 0, keep=range(8))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sift_select"] == launches + 2
    assert torch.equal(res.pool.vals, warm.pool.vals)
    # Two reads of the first sub-block's plane, one of the second's.
    assert res.sift[0, 1:].tolist() == [0, 3]
    flat = res.stat.reshape(1, -1)
    vals, idx = torch.topk(flat, 2000)
    assert torch.equal(res.pool.vals, vals)
    assert torch.equal(flat.gather(-1, res.pool.idx), res.pool.vals)
    assert torch.equal(res.over, (flat >= 6.0).sum(-1))
