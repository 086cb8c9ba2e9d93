"""The register-pass plan of the ``fft_c2c``, ``fft_r2c``, ``fft_r2c_t``
and ``fft_c2r`` kernels (``repro_torch.kernels.fft.fft_kernel.
register_passes``, ``pass_table``, ``compact_twiddles``, ``pass_launch``,
``r2c_t_cluster``) and an emulation of the kernels' order
(``csrc/stockham_regs.cuh``, ``csrc/fft_real.cu``).

The emulation runs the plan table the kernel reads, thread by thread and
register by register, with the plain versions' float32 operations: it must
agree with ``fft_c2c_plain``, ``fft_r2c_plain`` and ``fft_c2r_plain`` bit
for bit (``torch.equal``), so an index error shows here, before a run on
the card.  The transposed store of ``fft_r2c_t`` through a thread-block
cluster is emulated as index maps: every output element written once.
"""
import contextlib
import itertools
import re

import numpy as np
import pytest
import torch

from repro_torch.fft.radix import DEFAULT_RADICES
from repro_torch.fft.stockham import _rfft_split, _split_factors
from repro_torch.kernels.common import CSRC_DIR, MAX_SHARED_BYTES
from repro_torch.kernels.fft import fft_kernel as K

LENGTHS = tuple(2**k for k in range(1, 14))          # C2C: 2 .. 8192
REAL_LENGTHS = tuple(2**k for k in range(2, 15))     # R2C: 4 .. 16384
RADIX_SETS = ((4, 2), (8, 4, 2))
BATCH = 3


def _rand(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radices", RADIX_SETS + ((2,),))
@pytest.mark.parametrize("n", LENGTHS)
def test_passes_cover_the_schedule_within_the_budgets(n, radices):
    passes = K.register_passes(n, radices)
    assert sum(passes, ()) == K.schedule(n, radices)
    assert np.prod([np.prod(p) for p in passes]) == n
    for p in passes:
        assert np.prod(p) <= K.pass_points(n) <= K.PASS_MAX_POINTS
        assert 1 <= len(p) <= K.PASS_STAGES
    launch = K.pass_launch(n, 10**6, radices)
    assert set(passes) <= set(K.PASS_SHAPES[launch.points, launch.family])
    assert launch.threads <= K.PASS_THREADS
    assert launch.threads == launch.per_block * n // launch.points
    assert launch.shared_bytes <= MAX_SHARED_BYTES
    if n == 8192:
        assert launch.exchanges <= 3
        assert launch.exchanges == (2 if radices != (8, 4, 2) else 3)


@pytest.mark.parametrize("radices", RADIX_SETS)
@pytest.mark.parametrize("n,split", [(8192, False), (8192, True)])
def test_two_blocks_per_sm_at_the_longest_lengths(n, split, radices):
    """C2C 8192 and R2C 16384 (its half length 8192, split in shared
    memory): a 64 KB transform plus padding on 256 threads of 32 points,
    two blocks on one SM with the default radices.  The radix-8 schedule's
    instance takes up to 255 registers a thread, one block."""
    launch = K.pass_launch(n, 30517, radices, split=split)
    assert launch.shared_bytes == 8 * K.padded(n) < 72 * 2**10
    assert launch.threads == 256 and launch.points == 32
    assert launch.per_block == 1
    assert launch.resident_blocks == (2 if radices == DEFAULT_RADICES else 1)


@pytest.mark.parametrize("radices", RADIX_SETS + ((2,),))
@pytest.mark.parametrize("n", LENGTHS)
def test_pass_table_offsets_stay_inside_the_transform(n, radices):
    table = K.pass_table(n, radices)
    passes = K.register_passes(n, radices)
    assert table.shape == (len(passes), K.PASS_FIELDS)
    for row, radix in zip(table, passes):
        r = 1 << int(row[0])
        assert tuple(row[3:3 + int(row[2])]) == radix and r == np.prod(radix)
        # Output k of an item lands k * n / R past it: a permutation.
        assert sorted(_out(radix, q) for q in range(r)) == list(range(r))
    # Each stage's r - 1 rows of h twiddles follow the last stage's.
    offsets = [int(o) for row in table
               for o in row[3 + K.PASS_STAGES:3 + K.PASS_STAGES + row[2]]]
    assert offsets[0] == 0 and offsets == sorted(offsets)
    assert len(K.compact_twiddles(n, radices, torch.device("cpu"))) \
        == max(n - 1, 1)


@pytest.mark.parametrize("radices", RADIX_SETS)
@pytest.mark.parametrize("n", (2, 64, 8192))
def test_compact_twiddles_are_the_stage_table_rows(n, radices):
    """Bit for bit the first h entries of each packed row."""
    twr, twi = K.stage_tables(n, radices, torch.device("cpu"))
    tw = K.compact_twiddles(n, radices, torch.device("cpu"))
    row, m, at = 0, n, 0
    for r in K.schedule(n, radices):
        h = m // r
        for k in range(r - 1):
            assert torch.equal(tw.real[at:at + h], twr[row + k, :h])
            assert torch.equal(tw.imag[at:at + h], twi[row + k, :h])
            at += h
        row += r - 1
        m = h
    assert at == n - 1


@pytest.mark.parametrize("radices", [c for k in (1, 2, 3) for c in
                                     itertools.combinations((8, 4, 2), k)])
def test_every_radix_set_plans_passes_the_kernels_compile(radices):
    for n in LENGTHS:
        try:
            K.schedule(n, radices)
        except ValueError:
            continue                 # no factorisation into these radices
        launch = K.pass_launch(n, 7, radices)
        assert set(launch.passes) <= set(
            K.PASS_SHAPES[launch.points, launch.family])


def test_pass_shapes_are_the_kernel_source_lists():
    """PASS_SHAPES names the passes REPRO_PASS_SHAPES compiles, and
    REPRO_PASS_INSTANCES its (points, family) instances."""
    src = (CSRC_DIR / "stockham_regs.cuh").read_text()

    def macro(name):
        body = re.search(rf"#define {name}\(X\)(.*?)\n\n", src, re.S)
        return [tuple(int(v) for v in m.split(","))
                for m in re.findall(r"X\(([\d, ]+)\)", body.group(1))]

    shapes = {}
    for p, f, *radix in macro("REPRO_PASS_SHAPES"):
        shapes.setdefault((p, f), []).append(tuple(radix))
    assert {k: sorted(v) for k, v in shapes.items()} \
        == {k: sorted(v) for k, v in K.PASS_SHAPES.items()}
    assert sorted(macro("REPRO_PASS_INSTANCES")) == sorted(K.PASS_SHAPES)


def test_tile_override_is_honoured_and_validated():
    assert K.pass_launch(1024, 1001, override=3).per_block == 3
    assert K.pass_launch(1024, 2, override=3).per_block == 2
    assert K.pass_launch(64, 7).per_block == 7
    with pytest.raises(ValueError, match=">= 1"):
        K.pass_launch(1024, 10, override=0)
    with pytest.raises(ValueError, match="threads"):
        K.pass_launch(8192, 10, override=2)


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _stride(radix, i):
    """Shape::stride: the register stride of stage i's digit."""
    return int(np.prod(radix[i + 1:]))


def _out(radix, q):
    """Shape::out: register q = k1*S_1 + .. holds output k1 + r1*k2 + .."""
    kk, place = 0, 1
    for i, r in enumerate(radix):
        kk += (q // _stride(radix, i)) % r * place
        place *= r
    return kk


def _radix(row):
    return tuple(int(r) for r in row[3:3 + int(row[2])])


def _gather_at(row, i, lane, log_t):
    """gather: register g*R + q reads li*M + q*H + jj of item g."""
    log_r, log_h = int(row[0]), int(row[1])
    g, q = i >> log_r, i & ((1 << log_r) - 1)
    item = lane + (g << log_t)
    base = (((item >> log_h) << log_r) << log_h) + (item & ((1 << log_h) - 1))
    return base + (q << log_h)


def _scatter_at(row, i, lane, log_t, n):
    """scatter: register g*R + q goes to item + out(q) * n/R."""
    log_r = int(row[0])
    g, q = i >> log_r, i & ((1 << log_r) - 1)
    return lane + (g << log_t) + _out(_radix(row), q) * (n >> log_r)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _stage(vr, vi, row, st, twr, twi, lane, log_t, inverse, dft):
    """reg_stage: one stage on every thread's registers, item by item and
    column by column, the twiddles of a column read once."""
    p_pts = vr.shape[-1]
    sign = 1.0 if inverse else -1.0
    log_r, log_h = int(row[0]), int(row[1])
    r = int(row[3 + st])
    s = _stride(_radix(row), st)
    off = int(row[3 + K.PASS_STAGES + st])
    h = s << log_h
    items = p_pts >> log_r
    per = p_pts // (items * r * s)           # butterflies of an item
    hmask = (1 << log_h) - 1
    if items == 1 or log_h <= log_t:
        # Every item's column is lane mod H: one twiddle set for all.
        for b in range(s):
            ws = _twiddles(twr, twi, off, h, r, (b << log_h) + (lane & hmask))
            for a in range(items * per):
                _butterfly(vr, vi, a * r * s + b, r, s, ws, sign, dft)
        return
    for g in range(items):
        jj = (lane + (g << log_t)) & hmask
        for b in range(s):
            ws = _twiddles(twr, twi, off, h, r, (b << log_h) + jj)
            for a in range(per):
                _butterfly(vr, vi, (g * per + a) * r * s + b, r, s, ws,
                           sign, dft)


def _twiddles(twr, twi, off, h, r, j):
    """load_twiddles: branch k's twiddle of column j, k = 1..r-1."""
    return [(twr[off + k * h + j], twi[off + k * h + j])
            for k in range(r - 1)]


def _butterfly(vr, vi, o, r, s, ws, sign, dft):
    """One butterfly of ``reg_stage`` at register o, stride s, with the
    plain version's operations in its order."""
    parts = [(vr[..., o + p * s], vi[..., o + p * s])
             for p in range(r)]
    if r == 2:
        (ar, ai), (br, bi) = parts
        outs = [(ar + br, ai + bi)]
        branches = [(ar - br, ai - bi)]
    elif r == 4:
        (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r, x3i) = parts
        t0r, t0i = x0r + x2r, x0i + x2i
        t1r, t1i = x0r - x2r, x0i - x2i
        t2r, t2i = x1r + x3r, x1i + x3i
        t3r, t3i = x1r - x3r, x1i - x3i
        u3r, u3i = -sign * t3i, sign * t3r
        outs = [(t0r + t2r, t0i + t2i)]
        branches = [(t1r + u3r, t1i + u3i), (t0r - t2r, t0i - t2i),
                    (t1r - u3r, t1i - u3i)]
    else:
        dr, di = dft
        accr, acci = parts[0]
        for pr, pi in parts[1:]:
            accr, acci = accr + pr, acci + pi
        outs = [(accr, acci)]
        branches = []
        for k in range(1, r):
            accr, acci = parts[0]
            for p in range(1, r):
                cr, ci = float(dr[p, k]), float(di[p, k])
                pr, pi = parts[p]
                accr = accr + pr * cr - pi * ci
                acci = acci + pr * ci + pi * cr
            branches.append((accr, acci))
    for k, (br_, bi_) in enumerate(branches):
        outs.append(_cmul(br_, bi_, *ws[k]))
    for k, (outr, outi) in enumerate(outs):
        vr[..., o + k * s] = outr
        vi[..., o + k * s] = outi


def _planes_read(re, im):
    """The first gather of fft_c2c/fft_r2c: the (B, n) planes at ``at``."""
    return lambda at: (re[:, at], im[:, at])


def _emulate(read, b, n, radices, inverse):
    """The kernel on B transforms of length n whose first pass's gather
    reads ``read(at)`` (the float32 planes of the points at the lanes'
    offsets ``at``): returns the planes it stores (before the inverse's
    1/n)."""
    table = K.pass_table(n, radices)
    tw = K.compact_twiddles(n, radices, torch.device("cpu"))
    twr, twi = tw.real, (-tw.imag if inverse else tw.imag)
    dft = K._dft8(inverse)
    p_pts = K.pass_points(n)
    log_t = (n // p_pts).bit_length() - 1
    lane = torch.arange(n // p_pts)
    vr = torch.empty(b, len(lane), p_pts)
    vi = torch.empty(b, len(lane), p_pts)

    def load(read_at, row):
        for i in range(p_pts):
            vr[..., i], vi[..., i] = read_at(_gather_at(row, i, lane, log_t))

    def store(row):
        dst_r = torch.full((b, n), float("nan"))
        dst_i = torch.full((b, n), float("nan"))
        seen = torch.zeros(n, dtype=torch.int64)
        for i in range(p_pts):
            at = _scatter_at(row, i, lane, log_t, n)
            dst_r[:, at], dst_i[:, at] = vr[..., i], vi[..., i]
            seen[at] += 1
        assert torch.equal(seen, torch.ones(n, dtype=torch.int64))
        return dst_r, dst_i

    load(read, table[0])
    for p, row in enumerate(table):
        if p > 0:
            load(lambda at: (buf_r[:, at], buf_i[:, at]),  # noqa: F821
                 row)                                      # last exchange
        for st in range(int(row[2])):
            _stage(vr, vi, row, st, twr, twi, lane, log_t, inverse, dft)
        buf_r, buf_i = store(row)
    return buf_r, buf_i


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices", RADIX_SETS)
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_c2c_is_the_plain_version_bit_for_bit(n, radices, inverse):
    x = _rand(n, (BATCH, n, 2))
    re, im = torch.from_numpy(x[..., 0]), torch.from_numpy(x[..., 1])
    yr, yi = _emulate(_planes_read(re, im), BATCH, n, radices, inverse)
    if inverse:
        yr, yi = yr / n, yi / n
    want = K.fft_c2c_plain(torch.complex(re, im), inverse=inverse,
                           radices=radices)
    assert torch.equal(torch.complex(yr, yi), want)


@pytest.mark.parametrize("radices", RADIX_SETS)
@pytest.mark.parametrize("n", REAL_LENGTHS)
def test_emulated_r2c_is_the_plain_version_bit_for_bit(n, radices):
    """The half-length passes on the packed reals, then the split."""
    x = torch.from_numpy(_rand(n + 1, (BATCH, n)))
    m = n // 2
    v = x.reshape(BATCH, m, 2)
    zr, zi = _emulate(_planes_read(v[..., 0], v[..., 1]), BATCH, m,
                      radices, False)
    got = _rfft_split(torch.complex(zr, zi), n)
    assert torch.equal(got, K.fft_r2c_plain(x, radices=radices))


def _merge_of(v, u, w):
    """``merge_of`` (csrc/fft_real.cu) on float32 planes: Z = Ze + i * Zo
    from v = X[k], u = X[m - k] and w = W[k], in the kernel's order."""
    rr, ri = u[0], -u[1]                                 # conj(X[m-k])
    er, ei = 0.5 * (v[0] + rr), 0.5 * (v[1] + ri)        # Ze
    dr, di = v[0] - rr, v[1] - ri
    wr, wi = w[0], -w[1]                                 # conj(W)
    hr, hi = 0.5 * dr, 0.5 * di
    qr, qi = hr * wr - hi * wi, hr * wi + hi * wr        # Zo
    return er - qi, ei + qr


def _merge_read(x, n):
    """fft_c2r_regs_kernel's merge pass and first gather: point k of the
    staged row, merged in place from bins k and m - k and W[k], is what
    the first pass reads at k.  The merge runs here with the plain
    version's complex operations on the staged (B, m + 1) bins (torch
    rounds its complex products by the tensor's layout, so only the same
    shapes give the same bits), the kernel's index map written out;
    ``merge_of``'s own float order is held to it within rounding."""
    m = n // 2
    k = torch.arange(m + 1)
    rev = torch.conj_physical(x[:, m - k])               # conj(X[m-k])
    wc = torch.conj_physical(_split_factors(n, torch.device("cpu"),
                                            torch.complex64))
    ze = (0.5 * (x + rev))[..., :m]
    zo = (0.5 * wc * (x - rev))[..., :m]
    z = ze + 1j * zo
    at = k[:m]
    planes = (lambda t: (t.real, t.imag))
    fr, fi = _merge_of(planes(x[:, at]), planes(x[:, m - at]),
                       planes(wc.conj()[at]))
    scale = z.abs().max()
    assert (fr - z.real).abs().max() <= 2e-7 * scale
    assert (fi - z.imag).abs().max() <= 2e-7 * scale
    zr, zi = z.real.contiguous(), z.imag.contiguous()
    return lambda at: (zr[:, at], zi[:, at])


@pytest.mark.parametrize("radices", RADIX_SETS)
@pytest.mark.parametrize("n", REAL_LENGTHS)
def test_emulated_c2r_is_the_plain_version_bit_for_bit(n, radices):
    """The merge of the staged bins, read by the first pass's gather,
    the inverse passes of the half length, 1/m, and each Z[k] stored as
    the reals 2k, 2k+1."""
    m = n // 2
    x = _rand(n + 2, (BATCH, m + 1, 2))
    x = torch.complex(torch.from_numpy(x[..., 0]), torch.from_numpy(x[..., 1]))
    zr, zi = _emulate(_merge_read(x, n), BATCH, m, radices, True)
    got = torch.stack([zr / m, zi / m], dim=-1).reshape(BATCH, n)
    assert torch.equal(got, K.fft_c2r_plain(x, radices=radices))


# ---------------------------------------------------------------------------
# The index maps of the real kernels' shared-memory loops and of the
# fft_r2c_t cluster store (csrc/fft_real.cu)
# ---------------------------------------------------------------------------

def _row_loop(threads, width, count):
    """The (row, column) pairs the block's threads visit in the loops
    that step through e = t * width + k (R2C's split, C2R's staging,
    R2C_T's split pairs): t = tid / width, then k += threads, carrying."""
    tid = np.arange(threads)
    t, k = tid // width, tid % width
    seen = []
    while (t < count).any():
        live = t < count
        seen.append(np.stack([t[live], k[live]], axis=1))
        k = k + threads
        t = t + k // width                   # the carrying while loop
        k = k % width
    return np.concatenate(seen) if seen else np.zeros((0, 2), int)


def _walk(k, t, threads, lines, per_block):
    """TileWalk (csrc/stockham_regs.cuh): each thread's (k, t, owner,
    line), step after step, the block's threads added to e = k * lines +
    t at each step and t's (owner block, line) carried, not divided; the
    carried pair must stay t = owner * per_block + line, line < per_block,
    owner < g."""
    k, t = np.asarray(k), np.asarray(t)
    owner, line = t // per_block, t % per_block
    dk, dt = threads // lines, threads % lines
    dq, dr = dt // per_block, dt % per_block
    g = lines // per_block
    while True:
        assert (owner * per_block + line == t).all()
        assert ((0 <= line) & (line < per_block) & (0 <= owner)
                & (owner < g)).all()
        yield k, t, owner, line
        t, k, owner, line = t + dt, k + dk, owner + dq, line + dr
        carry = line >= per_block
        line[carry] -= per_block
        owner[carry] += 1
        wrap = t >= lines
        t[wrap] -= lines
        owner[wrap] -= g
        k[wrap] += 1


def _store_map(threads, lines, per_block, bins):
    """cluster_store's (line t, point k, owner block, its line) of every
    block of a cluster of lines // per_block blocks: block j takes points
    [j * share, ...) of every line, t = tid % lines, k = j * share + tid /
    lines, stepping by the block's threads while k is in its share."""
    g = lines // per_block
    share = -(-bins // g)
    tid = np.arange(threads)
    seen = []
    for j in range(g):
        hi = min(bins, (j + 1) * share)
        for k, t, owner, line in _walk(j * share + tid // lines,
                                       tid % lines, threads, lines,
                                       per_block):
            live = k < hi
            if not live.any():
                break
            seen.append(np.stack([t[live], k[live], owner[live],
                                  line[live]], axis=1))
    return np.concatenate(seen) if seen else np.zeros((0, 4), int)


def _load_map(threads, lines, per_block, n, points):
    """cluster_load's (row k, line t, owner block, its line) of every
    block of a cluster: block j reads the tile's points e = j * per_block
    * n + p * threads + tid, p < points, in row-major order (e = k *
    lines + t)."""
    g = lines // per_block
    tid = np.arange(threads)
    seen = []
    for j in range(g):
        e0 = j * per_block * n + tid
        steps = _walk(e0 // lines, e0 % lines, threads, lines, per_block)
        for _ in range(points):
            seen.append(np.stack(next(steps), axis=1))
    return np.concatenate(seen)


def _once(pairs, shape):
    """Each (row, column) of ``shape`` visited exactly once."""
    hits = np.zeros(shape, np.int64)
    np.add.at(hits, (pairs[:, 0], pairs[:, 1]), 1)
    return bool((hits == 1).all())


@pytest.mark.parametrize("c", REAL_LENGTHS)
def test_real_kernels_row_loops_visit_each_bin_once(c):
    """R2C's split and C2R's staging visit bins 0..m of each live row once,
    R2C_T's split and C2R's merge pairs 0..m/2.  An R2C_T pair (k, m - k)
    reads Z inside the transform and writes X[k], X[m - k], together
    every slot 0..m; a C2R pair reads X[k], X[m - k] and writes Z[k] and,
    for k > 0, Z[m - k] (the same value twice at k = m/2), together every
    point 0..m-1."""
    m = c // 2
    fits3 = 3 * m // K.pass_points(m) <= K.PASS_THREADS
    for tile_b in (None, 1) + ((3,) if fits3 else ()):
        launch = K.pass_launch(m, 1001, override=tile_b, split=True)
        assert launch.shared_bytes == launch.per_block * K.split_slots(m) * 8
        for count in {launch.per_block, max(launch.per_block - 1, 1)}:
            bins = _row_loop(launch.threads, m + 1, count)
            assert _once(bins, (count, m + 1))
            pairs = _row_loop(launch.threads, m // 2 + 1, count)
            assert _once(pairs, (count, m // 2 + 1))
    k = np.arange(m // 2 + 1)
    assert ((m - k) & (m - 1)).max() < m             # reads Z[m - k], Z[0]
    writes = np.concatenate([k, m - k])
    assert sorted(set(writes)) == list(range(m + 1))
    merged = np.concatenate([k, (m - k)[k > 0]])  # pair m/2: Z[m/2] twice
    assert sorted(set(merged)) == list(range(m))
    assert K.split_slots(m) >= m + 1


def _cluster_store_once(b, rows, bins, per_block, g, threads):
    """Whether the grid and cluster store of a clustered kernel write
    every (batch, point, line) of the (b, bins, rows) output exactly once,
    reading each point from a computed (unmasked) line of its owner block:
    fft_r2c_t (bins = m + 1, lines = rows), fft_c2c_t (bins = n, lines =
    rows), fft_c2c_axis1 (bins = n, lines = columns)."""
    lines = g * per_block
    tiles = -(-rows // lines)
    bid = np.arange(b * tiles * g)
    cid, rank = bid // g, bid % g                    # 1-D clusters of g
    batch = cid // tiles
    tile = cid - batch * tiles
    # Every (batch entry, line tile, rank) is one block.
    blocks_once = _once(np.stack([batch * tiles + tile, rank], axis=1),
                        (b * tiles, g))
    # Block `rank` stores points [rank * share, ...) of the cluster's
    # lines: together every (cluster line, point) once, each from the
    # buffer of the line's own block.
    pairs = _store_map(threads, lines, per_block, bins)
    pairs_once = (_once(pairs[:, :2], (lines, bins))
                  and (pairs[:, 2] * per_block + pairs[:, 3]
                       == pairs[:, 0]).all())
    # Cluster line t of tile i is line i * lines + t (written if < rows),
    # held by the block of rank t // per_block (first line r0) as its line
    # t % per_block, which it computed if that is below its count.
    t = np.arange(lines)
    owner = t // per_block
    row = np.arange(tiles)[:, None] * lines + t
    live = row < rows
    r0 = np.arange(tiles)[:, None] * lines + owner * per_block
    computed = t - owner * per_block < np.clip(rows - r0, 0, per_block)
    rows_once = np.array_equal(np.sort(row[live]), np.arange(rows))
    return (blocks_once and pairs_once and rows_once
            and np.array_equal(computed, live)
            and K.clustered_blocks(b, rows, per_block, g) == b * tiles * g)


@pytest.mark.parametrize("rows", (1, 7, 13, 4097))
@pytest.mark.parametrize("c", REAL_LENGTHS)
def test_r2c_t_cluster_store_writes_every_bin_once(c, rows):
    """Every (row, bin) of the (B, C/2+1, R) output written exactly once,
    for each cluster size G the planner chooses (R2C_T_ROWS of one block,
    4 and 8 rows a cluster, with the default and one-row blocks), and no
    masked row written or read."""
    m = c // 2
    sizes = set()
    for tile_b in (None, 1):
        launch = K.pass_launch(m, rows, override=tile_b, split=True)
        for cluster_rows in (launch.per_block, 4, 8):
            g = K.r2c_t_cluster(launch.per_block, rows, cluster_rows)
            assert 1 <= g <= K.MAX_CLUSTER
            assert (launch.per_block * g <= max(cluster_rows,
                                                launch.per_block))
            sizes.add((launch.per_block, g))
    for per_block, g in sorted(sizes):
        threads = per_block * (m // K.pass_points(m))
        assert _cluster_store_once(2, rows, m + 1, per_block, g, threads)
        assert K.clustered_blocks(2, rows, per_block, g) \
            == 2 * -(-rows // (per_block * g)) * g


def test_r2c_t_cluster_sizes():
    """One row a block at C = 8192 and 16384: clusters of R2C_T_ROWS
    blocks; rows past R take no block of their own; blocks of R2C_T_ROWS
    rows or more (C <= 2048) take clusters of one."""
    rows = K.R2C_T_ROWS
    assert K.r2c_t_cluster(1, 4096) == rows
    assert K.r2c_t_cluster(1, 4096, cluster_rows=8) == 8 == K.MAX_CLUSTER
    assert K.r2c_t_cluster(1, 4096, cluster_rows=1) == 1
    assert K.r2c_t_cluster(1, 3) == min(3, rows)
    assert K.r2c_t_cluster(1, 1) == 1 == K.r2c_t_cluster(2, 2)
    assert K.r2c_t_cluster(2, 3, cluster_rows=8) == 2
    assert K.r2c_t_cluster(4, 4096, cluster_rows=8) == 2
    assert K.r2c_t_cluster(rows, 4096) == 1 == K.r2c_t_cluster(8, 4096)
    assert K.r2c_t_cluster(1, 4096, cluster_rows=64) == K.MAX_CLUSTER
    assert K.clustered_blocks(16, 4096, 1, 8) == 16 * 4096
    assert K.clustered_blocks(16, 4097, 1, 8) == 16 * 513 * 8
    with pytest.raises(ValueError, match=">= 1"):
        K.r2c_t_cluster(1, 10, cluster_rows=0)


# ---------------------------------------------------------------------------
# fft_c2c_t and fft_c2c_axis1 (csrc/fft_c2c.cu): the register passes, the
# epilogue, the cluster load of axis1 and the cluster store of both
# ---------------------------------------------------------------------------

def _finish(zr, zi, n, inverse, wr=None, wi=None):
    """store_finished: the last pass's planes scaled by 1/n (the inverse),
    then times the four-step twiddle row (wr, wi), in stockham()'s
    order."""
    if inverse:
        zr, zi = zr * (1.0 / n), zi * (1.0 / n)
    if wr is None:
        return zr, zi
    return _cmul(zr, zi, wr, wi)


def _geometry(n, count, tile_b=None, cluster_lines=None):
    """(per_block, G, threads, lines, tiles) of an fft_c2c_t or
    fft_c2c_axis1 launch of ``count`` lines of ``n`` points a batch
    entry, as the wrappers plan it."""
    launch = K.pass_launch(n, count, override=tile_b, buffer=True)
    pb = launch.per_block
    g = (K.c2c_cluster(pb, count) if cluster_lines is None
         else K.c2c_cluster(pb, count, cluster_lines))
    return pb, g, launch.threads, pb * g, -(-count // (pb * g))


def strided_geometries(n, count):
    """(tile_b, cluster lines) of the emulations: the planner's geometry,
    and one-line blocks in clusters of 8 where that differs from it."""
    planned = _geometry(n, count)[:2]
    return [(None, None)] + ([(1, 8)] if _geometry(n, count, 1, 8)[:2]
                             != planned else [])


def _store_grid(z, count, n, pb, g, threads):
    """The cluster store of every tile: z (B, tiles * lines, n) holds each
    cluster line's finished points; returns the (B, n, count) output and
    checks that each element is written once, from a computed line."""
    lines = pb * g
    tiles = -(-count // lines)
    out = torch.full((z.shape[0], n, count), float("nan"))
    hits = np.zeros((n, count), np.int64)
    smap = _store_map(threads, lines, pb, n)
    for tile in range(tiles):
        t, k, owner, line = smap[smap[:, 0] < count - tile * lines].T
        src = tile * lines + owner * pb + line
        assert (src < count).all()                   # a computed line
        out[:, k, tile * lines + t] = z[:, src, k]
        np.add.at(hits, (k, tile * lines + t), 1)
    assert (hits == 1).all()
    return out


@contextlib.contextmanager
def one_thread():
    """torch on one thread: the emulations run thousands of small ops,
    which lose time to thread start-up when the test workers already
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def emulate_c2c_t(x, twiddle, inverse, radices, tile_b=None,
                  cluster_lines=None):
    """fft_c2c_t_regs_kernel's grid on (B, R, n) ``x``: each live row's
    points straight into the passes, store_finished (1/n, the (R, n)
    twiddle) in natural order, the cluster store transposed.  Rows past R
    are neither loaded nor stored."""
    b, rows, n = x.shape
    pb, g, threads, lines, tiles = _geometry(n, rows, tile_b, cluster_lines)
    re = x.real.reshape(b * rows, n).contiguous()
    im = x.imag.reshape(b * rows, n).contiguous()
    zr, zi = _emulate(_planes_read(re, im), b * rows, n, radices, inverse)
    tw = (None, None) if twiddle is None else (
        twiddle.real.repeat(b, 1), twiddle.imag.repeat(b, 1))
    zr, zi = _finish(zr, zi, n, inverse, *tw)
    pad = tiles * lines - rows                       # masked rows
    zr = torch.nn.functional.pad(zr.reshape(b, rows, n), (0, 0, 0, pad))
    zi = torch.nn.functional.pad(zi.reshape(b, rows, n), (0, 0, 0, pad))
    return torch.complex(_store_grid(zr, rows, n, pb, g, threads),
                         _store_grid(zi, rows, n, pb, g, threads))


def emulate_c2c_axis1(x, twiddle, inverse, radices, tile_b=None,
                      cluster_lines=None):
    """fft_c2c_axis1_regs_kernel's grid on (B, n, C) ``x``: the cluster
    load of each tile of columns into its owners' padded buffers (each
    slot filled once, masked columns zero), the first pass gathered from
    the buffer, the passes, store_finished (1/n, the (C, n) twiddle of
    live columns) and the cluster store."""
    b, n, cols = x.shape
    pb, g, threads, lines, tiles = _geometry(n, cols, tile_b, cluster_lines)
    stride = K.line_slots(n, pb)
    lmap = _load_map(threads, lines, pb, n, K.pass_points(n))
    k, t, owner, line = lmap.T
    slot = (owner * pb + line) * stride + k + k // 16
    assert np.array_equal(np.sort(slot), np.sort(
        (np.arange(lines)[:, None] * stride
         + np.arange(n) + np.arange(n) // 16).ravel()))
    planes = []
    for part in (x.real, x.imag):
        buf = torch.full((b, tiles, lines * stride), float("nan"))
        for tile in range(tiles):
            live = t < cols - tile * lines
            col = np.minimum(tile * lines + t, cols - 1)
            buf[:, tile, slot] = torch.where(
                torch.from_numpy(live), part[:, k, col], torch.zeros(()))
        planes.append(buf.reshape(b * tiles * lines, stride))
    bufr, bufi = planes
    zr, zi = _emulate(lambda at: (bufr[:, at + (at >> 4)],
                                  bufi[:, at + (at >> 4)]),
                      b * tiles * lines, n, radices, inverse)
    zr, zi = _finish(zr, zi, n, inverse)
    if twiddle is not None:
        col = torch.arange(tiles * lines).repeat(b)
        live = (col < cols)[:, None]
        row = col.clamp(max=cols - 1)
        wr, wi = _cmul(zr, zi, twiddle.real[row], twiddle.imag[row])
        zr, zi = torch.where(live, wr, zr), torch.where(live, wi, zi)
    zr = zr.reshape(b, tiles * lines, n)
    zi = zi.reshape(b, tiles * lines, n)
    return torch.complex(_store_grid(zr, cols, n, pb, g, threads),
                         _store_grid(zi, cols, n, pb, g, threads))


def _cluster_load_once(count, n, per_block, g, threads):
    """Whether axis1's cluster load fills every (line, point) slot of
    the cluster's buffers exactly once, from point k of line t, every
    point of the tile's rows read once and lines past ``count`` masked in
    the last tile."""
    lines = g * per_block
    lmap = _load_map(threads, lines, per_block, n, K.pass_points(n))
    k, t, owner, line = lmap.T
    last = count - (-(-count // lines) - 1) * lines  # live lines, last tile
    return (_once(np.stack([owner * per_block + line, k], axis=1),
                  (lines, n))
            and (owner * per_block + line == t).all()
            and _once(lmap[t < last][:, [1, 0]], (last, n)))


C2C_STRIDED_COUNTS = (37, 4097)


@pytest.mark.parametrize("count", C2C_STRIDED_COUNTS)
@pytest.mark.parametrize("n", LENGTHS)
def test_c2c_strided_cluster_maps_write_every_point_once(n, count):
    """fft_c2c_t (count = R rows) and fft_c2c_axis1 (count = C columns):
    for each geometry the planner gives (the default and one-line blocks,
    clusters of one block's lines, 4 and 8 lines), the store writes every
    (point, line) of the output once from a computed line, and axis1's
    load fills every buffer slot once, masking the lines past count."""
    sizes = set()
    for tile_b in (None, 1):
        pb = K.pass_launch(n, count, override=tile_b, buffer=True).per_block
        for lines in (pb, 4, 8):
            sizes.add(_geometry(n, count, tile_b, lines)[:3])
    for pb, g, threads in sorted(sizes):
        assert threads == pb * n // K.pass_points(n) <= K.PASS_THREADS
        assert _cluster_store_once(2, count, n, pb, g, threads)
        assert _cluster_load_once(count, n, pb, g, threads)


def test_c2c_strided_geometry():
    """Always one buffer a transform (the strided side goes through it,
    even for a plan of one pass), of line_slots lines that put a
    half-warp's reads in 16 banks; clusters of C2C_CLUSTER_LINES lines
    (C2C_UNALIGNED_LINES where a line count fills no whole sectors), at
    most MAX_CLUSTER blocks, none past the lines of a batch entry; the
    tile_b override validated."""
    for n in LENGTHS:
        for count in (4096, 4097):
            launch = K.pass_launch(n, count, buffer=True)
            pb = launch.per_block
            stride = K.line_slots(n, pb)
            assert launch.shared_bytes == pb * stride * 8 <= MAX_SHARED_BYTES
            assert stride >= K.padded(n)
            lanes = min(pb, 16)
            banks = {(t * stride + k) % 16 for t in range(lanes)
                     for k in range(16 // lanes)}
            assert pb == 1 or len(banks) == lanes * (16 // lanes)
            assert launch.threads == min(K.PASS_THREADS,
                                         count * n // launch.points)
            lines = (K.C2C_CLUSTER_LINES if count == 4096
                     else K.C2C_UNALIGNED_LINES)
            assert K.c2c_cluster(pb, count) == max(1, lines // pb)
    assert K.pass_launch(16, 7).shared_bytes == 0     # fft_c2c: one pass
    assert K.pass_launch(16, 7, buffer=True).shared_bytes == 7 * 18 * 8
    assert K.line_slots(1024, 4) == 1092 and K.line_slots(4096, 1) == 4352
    assert K.line_slots(256, 16) == 273 and K.line_slots(8, 256) == 9
    assert K.c2c_cluster(1, 4096) == K.C2C_CLUSTER_LINES
    assert K.c2c_cluster(1, 4097) == K.C2C_UNALIGNED_LINES
    assert K.c2c_cluster(1, 4096, 8) == 8 == K.MAX_CLUSTER
    assert K.c2c_cluster(1, 3, 8) == 3 and K.c2c_cluster(4, 4096, 8) == 2
    assert K.c2c_cluster(4, 4096, 1) == 1 == K.c2c_cluster(8, 4096)
    assert K.clustered_blocks(16, 4096, 1, 4) == 16 * 4096
    assert K.clustered_blocks(16, 4097, 1, 8) == 16 * 513 * 8
    with pytest.raises(ValueError, match=">= 1"):
        K.c2c_cluster(1, 10, 0)
    with pytest.raises(ValueError, match="threads"):
        K.pass_launch(8192, 10, override=2, buffer=True)
    with pytest.raises(ValueError, match="cluster"):
        K.fft_c2c_t(torch.zeros(1, 4, 8, dtype=torch.complex64),
                    per_block=1, cluster=9)
