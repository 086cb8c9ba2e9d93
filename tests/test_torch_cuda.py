"""The CUDA kernels themselves, against their plain torch versions on the
card, and the plans through them.  These need an NVIDIA GPU with nvcc;
elsewhere they skip.  On the GPU machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` covers the same ground at the main path's full sizes."""
import dataclasses

import pytest
import torch

from repro_torch.fft import plan as port_plan
from repro_torch.kernels.fft import fft_kernel as K
from repro_torch.kernels.fft import ops
from repro_torch.kernels.fft.ref import fft_ref
from repro_torch.obs.ledger import LaunchLedger

RTOL = 1e-5                    # kernel vs plain: the same f32 schedule


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape):
    return torch.randn(*shape, dtype=torch.complex64, device="cuda",
                       generator=gen)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices", ((4, 2), (2,), (8, 4, 2)))
@pytest.mark.parametrize("n", (2, 64, 1024, 8192))
def test_kernels_match_plain_on_the_card(gen, n, radices, inverse):
    x = _rand(gen, 37, n)
    assert _rel(ops.fft_kernel_c2c(x, inverse=inverse, radices=radices),
                K.fft_c2c_plain(x, inverse=inverse, radices=radices)) <= RTOL
    x3, tw = _rand(gen, 3, 13, n), _rand(gen, 13, n)
    for twiddle in (None, tw):
        assert _rel(ops.fft_kernel_c2c_t(x3, twiddle=twiddle,
                                         inverse=inverse, radices=radices),
                    K.fft_c2c_t_plain(x3, twiddle, inverse=inverse,
                                      radices=radices)) <= RTOL
    xa = _rand(gen, 3, n, 13)
    for twiddle in (None, tw):
        assert _rel(ops.fft_kernel_c2c_axis1(xa, twiddle=twiddle,
                                             inverse=inverse,
                                             radices=radices),
                    K.fft_c2c_axis1_plain(xa, twiddle, inverse=inverse,
                                          radices=radices)) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,expected", [
    (1024, {"fft_c2c": 1}),
    (2**15, {"fft_c2c_axis1": 1, "fft_c2c_t": 1}),
    (139, {"fft_c2c": 2}),
])
def test_plans_launch_the_kernels(gen, n, expected):
    x = _rand(gen, 5, n)
    K.reset_launches()
    ledger = LaunchLedger()
    with ledger.capture():
        y = port_plan.plan_for_length(n)(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == expected
    assert len(ledger.records) == sum(expected.values())
    assert _rel(y, fft_ref(x)) <= (2e-5 if n & (n - 1) == 0 else 1e-4)


#: Every pow2 length of the register-pass kernels.
C2C_LENGTHS = tuple(2**k for k in range(1, 14))
R2C_LENGTHS = tuple(2**k for k in range(2, 15))


def _tiles(n: int) -> tuple:
    """The default transforms per block, and one override that fits."""
    return (None, 3 if 3 * n // K.pass_points(n) <= K.PASS_THREADS
            else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("n", C2C_LENGTHS)
def test_c2c_in_place_is_the_out_of_place_transform(gen, n, inverse):
    """``out=x`` (the overlap-save inverse's) writes the very transform
    the kernel writes to fresh memory."""
    x = _rand(gen, 37, n)
    want = ops.fft_kernel_c2c(x, inverse=inverse)
    y = x.clone()
    got = ops.fft_kernel_c2c(y, inverse=inverse, out=y)
    assert got.data_ptr() == y.data_ptr() and torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("radices", ((4, 2), (8, 4, 2)))
@pytest.mark.parametrize("n", C2C_LENGTHS)
def test_c2c_register_passes_match_plain_at_every_length(gen, n, radices,
                                                         inverse):
    x = _rand(gen, 37, n)                       # ragged against every tile
    want = K.fft_c2c_plain(x, inverse=inverse, radices=radices)
    for tile_b in _tiles(n):
        assert _rel(ops.fft_kernel_c2c(x, inverse=inverse, radices=radices,
                                       tile_b=tile_b), want) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("radices", ((4, 2), (8, 4, 2)))
@pytest.mark.parametrize("n", R2C_LENGTHS)
def test_r2c_register_passes_match_plain_at_every_length(gen, n, radices):
    x = torch.randn(37, n, device="cuda", generator=gen)
    want = K.fft_r2c_plain(x, radices=radices)
    for tile_b in _tiles(n // 2):
        assert _rel(ops.fft_kernel_r2c(x, radices=radices, tile_b=tile_b),
                    want) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("radices", ((4, 2), (8, 4, 2)))
@pytest.mark.parametrize("n", R2C_LENGTHS)
def test_c2r_register_passes_match_plain_at_every_length(gen, n, radices):
    """The merge in the first pass's reads, on any complex input (kernel
    and plain version run the same merge), ragged against every tile."""
    x = _rand(gen, 37, n // 2 + 1)
    want = K.fft_c2r_plain(x, radices=radices)
    for tile_b in _tiles(n // 2):
        assert _rel(ops.fft_kernel_c2r(x, radices=radices, tile_b=tile_b),
                    want) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (7, 13, 4097))
@pytest.mark.parametrize("c", R2C_LENGTHS)
def test_r2c_t_clusters_match_plain_at_every_length(gen, c, rows):
    """Ragged row counts, every cluster size the planner chooses (one
    block's rows, 4 and 8 rows a cluster), default and one-row blocks."""
    x = torch.randn(2, rows, c, device="cuda", generator=gen)
    want = K.fft_r2c_t_plain(x)
    for tile_b in (None, 1):
        launch = K.pass_launch(c // 2, rows, override=tile_b, split=True)
        for cluster_rows in (launch.per_block, 4, 8):
            g = K.r2c_t_cluster(launch.per_block, rows, cluster_rows)
            assert K.active_clusters(launch, g) >= 1
            y = K.fft_r2c_t(x, per_block=launch.per_block, cluster=g)
            assert _rel(y, want) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("count", (37, 4097))
@pytest.mark.parametrize("n", C2C_LENGTHS)
def test_c2c_strided_clusters_match_plain_at_every_length(gen, n, count):
    """fft_c2c_t (count rows) and fft_c2c_axis1 (count columns): both
    radix sets, with and without the twiddle, forward and inverse, every
    geometry the planner gives (default and one-line blocks; clusters of
    one block's lines, 4 and 8 lines), ragged against every tile."""
    x, tw = _rand(gen, 2, count, n), _rand(gen, count, n)
    xa = x.transpose(1, 2).contiguous()
    for radices in ((4, 2), (8, 4, 2)):
        for twiddle in (None, tw):
            for inverse in (False, True):
                cases = (("fft_c2c_t", K.fft_c2c_t, x, K.fft_c2c_t_plain(
                    x, twiddle, inverse=inverse, radices=radices)),
                         ("fft_c2c_axis1", K.fft_c2c_axis1, xa,
                          K.fft_c2c_axis1_plain(xa, twiddle, inverse=inverse,
                                                radices=radices)))
                for tile_b in (None, 1):
                    launch = K.pass_launch(n, count, radices, tile_b,
                                           buffer=True)
                    pb = launch.per_block
                    for g in {K.c2c_cluster(pb, count, lines)
                              for lines in (pb, 4, 8)}:
                        for name, fn, inp, want in cases:
                            assert K.active_clusters(launch, g, name) >= 1
                            y = fn(inp, twiddle, inverse=inverse,
                                   radices=radices, per_block=pb, cluster=g)
                            assert _rel(y, want) <= RTOL, (name, tile_b, g)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,split", [("fft_c2c", 8192, False),
                                          ("fft_r2c", 8192, True),
                                          ("fft_c2r", 8192, True)])
def test_two_blocks_resident_at_the_longest_lengths(gen, name, n, split):
    launch = K.pass_launch(n, 30517, split=split)
    assert K.resident_blocks(name, launch) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("fft_c2c", "fft_r2c"))
def test_cached_plans_survive_other_launches_of_their_instance(gen, name):
    """A plan of fft_c2c / fft_r2c is made once per shape and keeps the
    shared memory it planned (68 KB at 8192 / 16384) after another query
    of the same kernel instance asked for less: the instance's limit is
    the most any block may have, not the last size asked for."""
    n = 8192 if name == "fft_c2c" else 16384
    if name == "fft_c2c":
        x = _rand(gen, 3, n)
        run, plain = (lambda: K.fft_c2c(x, per_block=1),
                      lambda: K.fft_c2c_plain(x))
    else:
        x = _real(gen, 3, n)
        run, plain = (lambda: K.fft_r2c(x, per_block=1),
                      lambda: K.fft_r2c_plain(x))
    want = plain()
    assert _rel(run(), want) <= RTOL            # planned and cached
    launch = K.pass_launch(8192, 3, split=name == "fft_r2c")
    assert launch.shared_bytes > 64 * 2**10
    smaller = dataclasses.replace(launch, shared_bytes=50 * 2**10)
    assert K.resident_blocks(name, smaller) >= 1
    assert _rel(run(), want) <= RTOL            # the cached plan again
    torch.cuda.synchronize()


def _real(gen, *shape):
    return torch.randn(*shape, device="cuda", generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("radices", ((4, 2), (8, 4, 2)))
@pytest.mark.parametrize("n,b", [(4, 1001), (8, 1001), (64, 1001),
                                 (1024, 1001), (16384, 37)])
def test_real_kernels_match_plain_on_the_card(gen, n, b, radices):
    """Ragged batches against every block size; the C2R input is any
    complex tensor (kernel and plain version run the same merge)."""
    x = _real(gen, b, n)
    assert _rel(ops.fft_kernel_r2c(x, radices=radices),
                K.fft_r2c_plain(x, radices=radices)) <= RTOL
    spec = _rand(gen, b, n // 2 + 1)
    assert _rel(ops.fft_kernel_c2r(spec, radices=radices),
                K.fft_c2r_plain(spec, radices=radices)) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_real_input_at_an_odd_offset(gen):
    """A contiguous float32 slice at an odd element offset is not 8-byte
    aligned: the kernel function refuses it, the wrapper copies it."""
    flat = _real(gen, 5 * 1024 + 1)
    x = flat[1:].reshape(5, 1024)
    assert x.is_contiguous() and x.data_ptr() % 8
    with pytest.raises(ValueError, match="8-byte aligned"):
        K.fft_r2c(x, per_block=1)
    assert _rel(ops.fft_kernel_r2c(x), torch.fft.rfft(x)) <= 2e-5
    torch.cuda.synchronize()


#: The long real plans: the four-step pair and the split or merge.
_FOUR_STEP = {"fft_c2c_axis1": 1, "fft_c2c_t": 1}
_LONG_REAL = {"r2c": {**_FOUR_STEP, "fft_r2c_split": 1},
              "c2r": {**_FOUR_STEP, "fft_c2r_merge": 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("n,expected", [
    (1024, "fft_r2c"), (16384, "fft_r2c"), (2**15, _LONG_REAL),
    (2**20, _LONG_REAL),
])
def test_real_plans_launch_the_kernels(gen, n, expected):
    from repro_torch.kernels.fft.ref import irfft_ref, rfft_ref
    x = _real(gen, 6, n)
    for kind in ("r2c", "c2r"):
        want = ({expected.replace("r2c", kind): 1}
                if isinstance(expected, str) else expected[kind])
        inp = x if kind == "r2c" else torch.fft.rfft(x)
        K.reset_launches()
        ledger = LaunchLedger()
        with ledger.capture():
            y = port_plan.plan_for_length(n, kind)(inp)
        torch.cuda.synchronize()
        assert {k: v for k, v in K.LAUNCHES.items() if v} == want
        assert ledger.counts() == {k.replace("_", "-"): v
                                   for k, v in want.items()}
        ref = rfft_ref(inp) if kind == "r2c" else irfft_ref(inp)
        assert _rel(y, ref) <= 2e-5
    back = port_plan.plan_for_length(n, "c2r")(
        port_plan.plan_for_length(n, "r2c")(x))
    assert _rel(back, x) <= 2e-5


#: The split and merge kernels against their plain versions: 1e-6 of
#: max |ref| (the same float32 formulas, in another order of operations).
HERMITIAN_RTOL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("m", (2**14, 2**19))
@pytest.mark.parametrize("b", (1, 3, 476))
def test_split_and_merge_kernels_match_plain_on_the_card(gen, b, m, offset):
    """Rows of m = N/2 points and of m + 1 bins, the input at an odd
    element offset too (not 16-byte aligned: the spans' scalar edges)."""
    n = 2 * m
    for name, width, kernel, plain in (
            ("fft-r2c-split", m, ops.fft_kernel_r2c_split,
             K.fft_r2c_split_plain),
            ("fft-c2r-merge", m + 1, ops.fft_kernel_c2r_merge,
             K.fft_c2r_merge_plain)):
        x = _rand(gen, b * width + offset)[offset:].view(b, width)
        assert x.data_ptr() % 16 == 8 * offset
        ledger = LaunchLedger()
        with ledger.capture():
            got = kernel(x, n)
        assert ledger.counts() == {name: 1}
        assert _rel(got, plain(x, n)) <= HERMITIAN_RTOL
        del got
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2**14, 2**20))
def test_long_inverse_runs_the_inverse_passes(gen, n):
    x = _rand(gen, 3, n)
    K.reset_launches()
    y = port_plan.pow2_fft(x, inverse=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == _FOUR_STEP
    assert _rel(y, torch.fft.ifft(x)) <= 2e-5


@pytest.mark.cuda
def test_service_on_the_card(gen):
    import numpy as np
    from repro_torch.core import TESLA_V100
    from repro_torch.serving import FFTService
    svc = FFTService(TESLA_V100, devices=[torch.device("cuda", 0)])
    rng = np.random.default_rng(0)
    xc = (rng.standard_normal((8, 4096))
          + 1j * rng.standard_normal((8, 4096))).astype(np.complex64)
    xr = rng.standard_normal((16, 4096)).astype(np.float32)
    K.reset_launches()
    reqs = [(svc.submit(xc), torch.fft.fft(torch.from_numpy(xc).cuda())),
            (svc.submit(xr, transform="r2c"),
             torch.fft.rfft(torch.from_numpy(xr).cuda()))]
    svc.drain()
    assert K.LAUNCHES["fft_c2c"] == 1 and K.LAUNCHES["fft_r2c"] == 1
    for req, ref in reqs:
        r = svc.receipt(req)
        assert r.result.device.type == "cuda"
        assert _rel(r.result, ref) <= 2e-5
        assert r.clock_mhz <= TESLA_V100.f_max
        assert r.energy_j <= r.boost_energy_j
    assert svc.report().n_batches == 2


@pytest.mark.cuda
def test_service_stacks_tensor_payloads_on_the_card(gen):
    """Tensor payloads already on the card are stacked there, served, and
    each request gets its own rows back."""
    from repro_torch.core import TESLA_V100
    from repro_torch.serving import FFTService
    svc = FFTService(TESLA_V100, devices=[torch.device("cuda", 0)])
    xs = [torch.randn(b, 1024, device="cuda", generator=gen)
          for b in (3, 5, 8)]
    reqs = [svc.submit(x, transform="r2c") for x in xs]
    svc.drain()
    assert svc.report().n_batches == 1
    for req, x in zip(reqs, xs):
        r = svc.receipt(req)
        assert r.result.device.type == "cuda"
        assert _rel(r.result, torch.fft.rfft(x)) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("radices", ((4, 2), (8, 4, 2)))
@pytest.mark.parametrize("c,rows", [(4, 1001), (64, 1001), (1024, 37),
                                    (8192, 13), (16384, 5)])
def test_r2c_t_kernel_matches_plain_on_the_card(gen, c, rows, radices):
    """Ragged row counts against every block size, up to C = 2**14."""
    x = _real(gen, 3, rows, c)
    y = ops.fft_kernel_r2c_t(x, radices=radices)
    assert tuple(y.shape) == (3, c // 2 + 1, rows)
    assert _rel(y, K.fft_r2c_t_plain(x, radices=radices)) <= RTOL
    assert _rel(y, torch.fft.rfft(x, dim=-1).transpose(1, 2)) <= 2e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_r2c_t_input_at_an_odd_offset(gen):
    """A float32 slice at an odd element offset: the kernel function
    refuses it, the wrapper copies it."""
    flat = _real(gen, 2 * 7 * 256 + 1)
    x = flat[1:].reshape(2, 7, 256)
    assert x.is_contiguous() and x.data_ptr() % 8
    with pytest.raises(ValueError, match="8-byte aligned"):
        K.fft_r2c_t(x, per_block=1)
    y = ops.fft_kernel_r2c_t(x)
    assert _rel(y, torch.fft.rfft(x, dim=-1).transpose(1, 2)) <= 2e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.complex64, torch.complex128))
@pytest.mark.parametrize("shape", [(3, 37, 45), (2, 1, 100), (2, 100, 1),
                                   (1, 1000, 33), (4, 64, 64)])
def test_transpose_kernel_handles_ragged_edges(gen, dtype, shape):
    """Every element width (4, 8, 16 bytes), edges that no 32 x 32 tile
    divides: the kernel moves the exact bits of the plain version."""
    x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    if dtype.is_complex:
        x = x + 1j * torch.randn(*shape, device="cuda", generator=gen)
    y = ops.transpose_kernel(x)
    assert y.dtype == dtype and tuple(y.shape) == (shape[0], shape[2],
                                                   shape[1])
    assert torch.equal(y, K.transpose_plain(x))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("n,templates,rows", [(2048, 85, 37), (64, 1, 1001),
                                              (8192, 9, 5), (256, 9, 301)])
def test_c2c_mul_kernel_matches_plain_on_the_card(gen, n, templates, rows,
                                                  inverse):
    """(2048, 85) is the FDAS bank: 1.39 MB, more than one block's shared
    memory; the kernel streams it from global memory."""
    x = _rand(gen, rows, n)
    bank = _rand(gen, templates, n)
    if n == 2048:
        assert bank.numel() * 8 > K.MAX_SHARED_BYTES
    y = ops.fft_kernel_c2c_mul(x, bank, inverse=inverse)
    assert tuple(y.shape) == (rows, templates, n)
    assert _rel(y, K.fft_c2c_mul_plain(x, bank, inverse=inverse)) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kind,expected", [
    ((64, 128), "c2c", {"fft_c2c_t": 2}),
    ((64, 128), "r2c", {"fft_r2c_t": 1, "fft_c2c_t": 1}),
    ((8, 16, 32), "c2c", {"fft_c2c_t": 3}),
    ((12, 32), "c2c", {"fft_c2c_t": 1, "fft_c2c": 2, "transpose": 1}),
    ((64, 1), "r2c", {"transpose": 1, "fft_c2c_t": 1}),
])
def test_nd_plans_launch_the_kernels(gen, shape, kind, expected):
    from repro_torch.fft.plan_nd import plan_nd
    x = (_rand(gen, 3, *shape) if kind == "c2c"
         else _real(gen, 3, *shape))
    dims = tuple(range(1, len(shape) + 1))
    K.reset_launches()
    y = plan_nd(shape, kind)(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == expected
    ref = (torch.fft.fftn(x, dim=dims) if kind == "c2c"
           else torch.fft.rfftn(x, dim=dims))
    bluestein = any(n & (n - 1) for n in shape)
    assert _rel(y, ref) <= (1e-4 if bluestein else 2e-5)


@pytest.mark.cuda
def test_fdas_plane_launches_one_mul_and_one_inverse(gen):
    from repro_torch.search import TemplateBank, matched_filter_plane
    bank = TemplateBank.linear(zmax=4, n_templates=9)
    spec = _rand(gen, 2, 5000)
    K.reset_launches()
    got = matched_filter_plane(spec, bank)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "fft_c2c_mul": 1, "fft_c2c": 1}
    from repro_torch.fft.plan import kernels_disabled
    with kernels_disabled():
        want = matched_filter_plane(spec, bank)
    assert _rel(got, want) <= 1e-5


@pytest.mark.cuda
def test_service_serves_2d_and_fdas_on_the_card(gen):
    import numpy as np
    from repro_torch.core import TESLA_V100
    from repro_torch.search import TemplateBank, fdas_search
    from repro_torch.serving import FFTService
    svc = FFTService(TESLA_V100, devices=[torch.device("cuda", 0)])
    rng = np.random.default_rng(0)
    x2 = (rng.standard_normal((4, 256, 512))
          + 1j * rng.standard_normal((4, 256, 512))).astype(np.complex64)
    xf = rng.standard_normal((2, 8192)).astype(np.float32)
    r2 = svc.submit(x2, ndim=2)
    rf = svc.submit(xf, kind="fdas", templates=9)
    svc.drain()
    got = svc.receipt(r2).result
    assert _rel(got, torch.fft.fft2(torch.from_numpy(x2).cuda())) <= 2e-5
    bank = TemplateBank.linear(zmax=4, n_templates=9)
    want = fdas_search(torch.from_numpy(xf).cuda(), bank)
    cands = svc.receipt(rf).result
    assert cands.shape == (2, 16, 3)
    assert torch.equal(cands[..., 2], want.candidates.power)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nchan,n,ndm", [
    (1, 1, 1, 1), (3, 5, 1025, 9), (2, 64, 4096, 17), (1, 1024, 2048, 8),
    (2, 17, 127, 127), (1, 33, 129, 129), (3, 16, 4099, 130)])
def test_dedisperse_kernel_matches_plain_on_the_card(gen, batch, nchan, n,
                                                     ndm):
    """Ragged DM tiles and sample tiles (N and D one below, at and above
    the 128 of a block, channels no multiple of a stage's 16), and a delay
    of N - 1 in every channel of the last trial (wide channels past N =
    1025, read from global memory); bit-identical."""
    import numpy as np
    from repro_torch.kernels.dedisp import dedisp_kernel as D
    from repro_torch.kernels.dedisp import dedisperse_kernel, dedisperse_ref
    fb = _real(gen, batch, nchan, n)
    rng = np.random.default_rng(n)
    delays = rng.integers(0, n, size=(ndm, nchan))
    delays[-1] = n - 1
    D.reset_launches()
    got = dedisperse_kernel(fb, delays)
    assert D.LAUNCHES == {"dedisperse": 1}
    table = torch.from_numpy(delays.astype(np.int32)).cuda()
    want = D.dedisperse_plain(fb, table)
    assert _rel(got, want) <= RTOL and torch.equal(got, want)
    assert _rel(got, dedisperse_ref(fb, delays)) <= RTOL
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", (8, 16, 32))
@pytest.mark.parametrize("n", (4097, 127))
def test_dedisperse_tiles_on_the_pulsar_table(gen, n, chunk):
    """Every stage size of the sweep on the pulsar plan's table (all
    channels staged, delays clipped to N - 1 at N = 127) at a ragged N,
    bit-identical to plain; the staged table is made once per table."""
    import numpy as np
    from repro_torch.data.synthetic import FilterbankSpec
    from repro_torch.kernels.dedisp import dedisp_kernel as D
    from repro_torch.search import DispersionPlan
    plan = DispersionPlan.from_spec(FilterbankSpec(nchan=1024, ntime=2**17),
                                    n_trials=128)
    delays = np.minimum(plan.delay_array(), n - 1).astype(np.int32)
    table = torch.from_numpy(delays).cuda()
    fb = _real(gen, 2, 1024, n)
    D.reset_launches()
    got = D.dedisperse(fb, table, chunk)
    assert D.LAUNCHES == {"dedisperse": 1}
    assert torch.equal(got, D.dedisperse_plain(fb, table))
    assert D._staged(table) is D._staged(table)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("h", (1, 2, 8, 32, 64))
@pytest.mark.parametrize("rows,n", [(1, 1), (3, 1025), (37, 4096),
                                    (5, 65537), (2, 2047), (2, 2049)])
def test_harmonic_sum_kernels_match_plain_on_the_card(gen, rows, n, h):
    """Tiles cut short at N (2047, 2049 around the 1024 and 2048 of a
    block), H past the staged decimations (64); both kernels
    bit-identical to their plain versions."""
    import importlib
    from repro_torch.kernels.harmonic_sum import (harmonic_sum_kernel,
                                                  harmonic_sum_plane)
    H = importlib.import_module(
        "repro_torch.kernels.harmonic_sum.harmonic_sum_kernel")
    p = 3.0 * torch.rand(rows, n, device="cuda", generator=gen)
    H.reset_launches()
    stat, lev = harmonic_sum_plane(p, h)
    ladder = harmonic_sum_kernel(p, h)
    assert H.LAUNCHES == {"harmonic_sum_plane": 1, "harmonic_sum": 1}
    want_stat, want_lev = H.harmonic_sum_plane_plain(p, h)
    assert _rel(stat, want_stat) <= RTOL and torch.equal(stat, want_stat)
    assert torch.equal(lev, want_lev)
    assert torch.equal(ladder, H.harmonic_sum_plain(p, h))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("h", (1, 8, 32))
@pytest.mark.parametrize("bins", (256, 512, 1024, 2048))
def test_harmonic_sum_plane_tiles_on_the_card(gen, bins, h):
    """Every compiled plane instance at H = 1, 8 and 32 (several stages
    at K >= 1024) on rows of 65537 bins, bit-identical to plain."""
    import importlib
    H = importlib.import_module(
        "repro_torch.kernels.harmonic_sum.harmonic_sum_kernel")
    p = 3.0 * torch.rand(3, 65537, device="cuda", generator=gen)
    stat, lev = H.harmonic_sum_plane(p, h, bins)
    want_stat, want_lev = H.harmonic_sum_plane_plain(p, h)
    assert torch.equal(stat, want_stat) and torch.equal(lev, want_lev)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("h", (1, 8, 32))
@pytest.mark.parametrize("bins", (256, 512, 1024, 2048))
def test_harmonic_sum_ladder_tiles_on_the_card(gen, bins, h):
    """Every compiled ladder instance at H = 1, 8 and 32 (several stages
    at K >= 1024) on rows of 65537 bins, bit-identical to plain."""
    import importlib
    H = importlib.import_module(
        "repro_torch.kernels.harmonic_sum.harmonic_sum_kernel")
    p = 3.0 * torch.rand(3, 65537, device="cuda", generator=gen)
    assert torch.equal(H.harmonic_sum(p, h, bins),
                       H.harmonic_sum_plain(p, h))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1), (7, 1025), (3, 2**20),
                                    (1, 2**20), (3, 1025), (4096, 1025),
                                    (1, 255)])
def test_power_spectrum_stats_kernel_matches_plain_on_the_card(gen, rows, n):
    """B = 1 (thousands of segments a row), odd N (rows start at either
    alignment), many short rows (one segment each); two calls give the
    same bits."""
    from repro_torch.kernels.spectrum import (power_spectrum_stats_kernel,
                                              spectrum_kernel as S)
    x = _rand(gen, rows, n)
    S.reset_launches()
    p, mean, std = power_spectrum_stats_kernel(x)
    assert S.LAUNCHES == {"power_spectrum_stats": 1}
    wp, wmean, wvar = S.power_spectrum_stats_plain(x)
    assert _rel(p, wp) <= RTOL and _rel(mean, wmean) <= RTOL
    want_std = torch.sqrt(torch.clamp_min(wvar, 0.0))
    # One bin has no spread: both stds are exactly 0.
    assert (torch.equal(std, want_std) if n == 1
            else _rel(std, want_std) <= RTOL)
    again = power_spectrum_stats_kernel(x)
    assert all(torch.equal(a, b) for a, b in zip(again, (p, mean, std)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("count", (1, 2, 7, 67, 1000))
def test_power_spectrum_stats_segments_and_an_odd_offset(gen, count):
    """Each segment count, on a spectrum that starts 8 bytes past a
    16-byte boundary (pairs of p stored one by one), and the default's
    tickets left at zero for the next launch."""
    from repro_torch.kernels.spectrum import spectrum_kernel as S
    flat = _rand(gen, 5 * 4097 + 1)
    x = flat[1:].view(5, 4097)
    assert x.data_ptr() % 16 == 8
    want = S.power_spectrum_stats_plain(x)
    for got in (S.power_spectrum_stats(x, count), S.power_spectrum_stats(x)):
        assert all(_rel(g, w) <= RTOL for g, w in zip(got, want))
    stream = torch.cuda.current_stream().cuda_stream
    assert not S._TICKETS[(x.device.index, stream)].any()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pulsar_search_on_the_card(gen):
    """The small search on the card through every kernel: the CPU run's
    candidates, and its statistic within 1e-4."""
    from repro_torch.data.synthetic import (FilterbankSpec, InjectedPulsar,
                                            synthetic_filterbank)
    from repro_torch.obs.ledger import LaunchLedger
    from repro_torch.search import (DispersionPlan, TemplateBank,
                                    pulsar_search)
    spec = FilterbankSpec(nchan=16, ntime=2048)
    plan = DispersionPlan.from_spec(spec, n_trials=8)
    bank = TemplateBank.linear(zmax=4.0, n_templates=5)
    fb = torch.from_numpy(synthetic_filterbank(
        spec, (InjectedPulsar(dm=plan.dms[3], k0=300, z=2.0, amp=0.12),
               InjectedPulsar(dm=plan.dms[6], k0=611, z=-4.0, amp=0.12)),
        noise=1.0, seed=2))
    ledger = LaunchLedger()
    with ledger.capture():
        got = pulsar_search(fb.cuda(), plan, bank)
    torch.cuda.synchronize()
    assert ledger.counts() == {"dedisperse": 1, "fft-r2c": 1,
                               "fft-c2c-mul": 1, "fft-c2c": 1,
                               "harmonic-sum-plane": 1}
    want = pulsar_search(fb, plan, bank)
    assert _rel(got.stat.cpu(), want.stat) <= 1e-4
    for name in ("dm", "template", "bin"):
        assert torch.equal(getattr(got.candidates, name).cpu(),
                           getattr(want.candidates, name))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("c2c", "r2c"))
def test_pencil_on_four_slots_of_the_card(gen, kind):
    """The pencil on 4 slots of cuda:0: each shard launches fft_c2c_axis1
    and fft_c2c, the result matches torch.fft."""
    from repro_torch.fft.distributed import (assemble_rfft_pencil,
                                             make_mesh, pencil_fft,
                                             untranspose_ref)
    mesh = make_mesh((4,), ("model",), devices=[torch.device("cuda", 0)] * 4)
    n1, n2 = 64, 128
    if kind == "c2c":
        x = _rand(gen, 2, n1, n2)
        want = torch.fft.fft(x.reshape(2, -1))
    else:
        x = torch.randn(2, n1, n2, device="cuda", generator=gen)
        want = torch.fft.rfft(x.reshape(2, -1))
    K.reset_launches()
    y = pencil_fft(x, mesh, n1=n1, n2=n2, kind=kind).gather()
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "fft_c2c_axis1": 4, "fft_c2c": 4}
    got = (untranspose_ref(y, n1, n2) if kind == "c2c"
           else assemble_rfft_pencil(y, n1, n2))
    assert _rel(got, want) <= 2e-5
