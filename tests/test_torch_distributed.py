"""The port's distributed FFT (``repro_torch.fft.distributed``) on meshes
of CPU slots, against the JAX reference ``repro.fft.distributed``.

The reference runs once per module, in one subprocess with eight forced
host devices (as ``tests/test_distributed.py`` runs it); it computes the
pencil C2C and R2C, the batch-parallel C2C and the batch-parallel rank-3
plan graph on seeded numpy inputs and writes them to an ``.npz``.  The
port must match them to 2e-5 of max |ref| in the reference's own
(transposed) layout.  Batch-parallel R2C is held against ``np.fft.rfft``
(the reference's R2C batch test fails under the installed jax).

A mesh here is ``make_mesh(shape, names, devices=[torch.device("cpu")] *
n)``: every shard runs the kernels' plain versions, and every collective
is a copy between CPU tensors.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.fft import distributed as dist
from repro_torch.fft import plan as plan_mod
from repro_torch.fft.distributed import (ShardedTensor, assemble_rfft_pencil,
                                         batch_parallel_fft, make_mesh,
                                         pad_rows, pencil_collective_bytes,
                                         pencil_exchange_bytes, pencil_fft,
                                         shard, untranspose_ref)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RTOL = 2e-5                    # of max |ref|: the pow2 plans' tolerance

#: (name, shape, complex) of the seeded inputs the reference transforms.
CASES = {"pencil_c2c": ((2, 64, 128), True),
         "pencil_r2c": ((2, 32, 64), False),
         "batch_c2c": ((16, 512), True),
         "batch_2d": ((8, 16, 32), True)}

REFERENCE = """
    import sys
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.fft.distributed import batch_parallel_fft, pencil_fft

    inp = np.load(sys.argv[1])
    out = {}
    model = jax.make_mesh((8,), ("model",))
    data = jax.make_mesh((8,), ("data",))
    data4 = Mesh(np.array(jax.devices()[:4]), ("data",))

    def put(x, mesh, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    x = put(inp["pencil_c2c"], model, P(None, "model", None))
    out["pencil_c2c"] = jax.device_get(pencil_fft(x, model, n1=64, n2=128))
    x = put(inp["pencil_r2c"], model, P(None, "model", None))
    out["pencil_r2c"] = jax.device_get(
        pencil_fft(x, model, n1=32, n2=64, kind="r2c"))
    x = put(inp["batch_c2c"], data, P("data", None))
    out["batch_c2c"] = jax.device_get(batch_parallel_fft(x, data))
    x = put(inp["batch_2d"], data4, P("data", None, None))
    out["batch_2d"] = jax.device_get(batch_parallel_fft(x, data4))
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _input(seed: int, shape, is_complex: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if is_complex:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, reference outputs), one subprocess for the module."""
    tmp = tmp_path_factory.mktemp("distributed_ref")
    inputs = {name: _input(i, shape, c)
              for i, (name, (shape, c)) in enumerate(CASES.items())}
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", ""))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    with np.load(tmp / "out.npz") as out:
        return inputs, {k: out[k] for k in out.files}


def cpu_mesh(d: int, name: str = "model"):
    return make_mesh((d,), (name,), devices=[CPU] * d)


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


# ---------------------------------------------------------------------------
# against the JAX reference
# ---------------------------------------------------------------------------

def test_pencil_c2c_matches_reference(ref):
    inputs, out = ref
    x = inputs["pencil_c2c"]
    y = pencil_fft(torch.from_numpy(x), cpu_mesh(8), n1=64, n2=128)
    assert isinstance(y, ShardedTensor) and len(y.shards) == 8
    assert all(s.shape == (2, 8, 128) for s in y.shards)
    got = y.gather().numpy()
    assert_close(got, out["pencil_c2c"])            # the transposed layout
    assert_close(untranspose_ref(y.gather(), 64, 128),
                 np.fft.fft(x.reshape(2, -1), axis=-1))


def test_pencil_r2c_matches_reference(ref):
    inputs, out = ref
    x = inputs["pencil_r2c"]
    y = pencil_fft(torch.from_numpy(x), cpu_mesh(8), n1=32, n2=64,
                   kind="r2c")
    assert all(s.shape == (2, 4, 33) for s in y.shards)
    got = y.gather().numpy()
    assert_close(got, out["pencil_r2c"])            # packed transposed
    assert_close(assemble_rfft_pencil(y.gather(), 32, 64),
                 np.fft.rfft(x.reshape(2, -1), axis=-1))


def test_batch_parallel_c2c_matches_reference(ref):
    inputs, out = ref
    y = batch_parallel_fft(torch.from_numpy(inputs["batch_c2c"]),
                           cpu_mesh(8, "data"))
    assert_close(y, out["batch_c2c"])
    assert_close(y, np.fft.fft(inputs["batch_c2c"], axis=-1))


def test_batch_parallel_plan_graph_matches_reference(ref):
    inputs, out = ref
    y = batch_parallel_fft(torch.from_numpy(inputs["batch_2d"]),
                           cpu_mesh(4, "data"))
    assert_close(y, out["batch_2d"])
    assert_close(y, np.fft.fft2(inputs["batch_2d"], axes=(-2, -1)))


@pytest.mark.parametrize("rows", (5, 17))
def test_batch_parallel_r2c_matches_numpy(rows):
    """Ragged real batches over 4 shards: zero-padded, sliced back."""
    x = _input(rows, (rows, 512), False)
    y = batch_parallel_fft(torch.from_numpy(x), cpu_mesh(4, "data"),
                           kind="r2c")
    assert y.shape == (rows, 257) and y.dtype == torch.complex64
    assert_close(y, np.fft.rfft(x, axis=-1))


@pytest.mark.parametrize("d", (1, 2, 4, 8))
def test_pencil_matches_numpy_on_every_mesh(d):
    """The k2 mirror's roll sits on global row 0 only: D = 8 with n1 = 32,
    n2 = 64 puts four rows on a shard."""
    x = _input(d, (3, 32, 64), False)
    y = pencil_fft(torch.from_numpy(x), cpu_mesh(d), n1=32, n2=64,
                   kind="r2c")
    assert_close(assemble_rfft_pencil(y.gather(), 32, 64),
                 np.fft.rfft(x.reshape(3, -1), axis=-1))
    xc = _input(d + 10, (2, 32, 64), True)
    y = pencil_fft(torch.from_numpy(xc), cpu_mesh(d), n1=32, n2=64)
    assert_close(untranspose_ref(y.gather(), 32, 64),
                 np.fft.fft(xc.reshape(2, -1), axis=-1))


def test_pencil_shards_launch_the_port_kernels(monkeypatch):
    """Each shard's first pass is one fft_c2c_axis1 with its twiddle rows,
    its second one fft_c2c; no other kernel runs."""
    calls = []
    for name in [n for n in vars(plan_mod) if n.startswith("_kernel_")]:
        if name == "_kernel_overrides":
            continue

        def counting(*a, _orig=getattr(plan_mod, name), _name=name, **kw):
            calls.append((_name, kw.get("twiddle") is not None))
            return _orig(*a, **kw)
        monkeypatch.setattr(plan_mod, name, counting)
    x = torch.from_numpy(_input(0, (2, 64, 128), True))
    pencil_fft(x, cpu_mesh(4), n1=64, n2=128)
    assert calls == [("_kernel_fft_axis1", True)] * 4 + [
        ("_kernel_fft", False)] * 4


def test_pencil_accepts_a_sharded_input_on_its_mesh():
    mesh = cpu_mesh(4)
    x = torch.from_numpy(_input(1, (4, 32, 64), True))
    xs = shard(x, mesh, "model", 1)
    a = pencil_fft(xs, mesh, n1=32, n2=64).gather()
    b = pencil_fft(x, mesh, n1=32, n2=64).gather()
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sharded along dim 0"):
        pencil_fft(shard(x, mesh, "model", 0), mesh, n1=32, n2=64)
    with pytest.raises(ValueError, match="this mesh"):
        pencil_fft(xs, cpu_mesh(4), n1=32, n2=64)


# ---------------------------------------------------------------------------
# the collectives, against their definitions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", (1, 2, 4))
@pytest.mark.parametrize("split_dim,concat_dim", ((2, 1), (1, 2), (2, 2),
                                                  (-1, 0)))
def test_all_to_all_definition(d, split_dim, concat_dim):
    mesh = cpu_mesh(d)
    g = torch.Generator().manual_seed(d)
    shards = [torch.randn(2, 4, 8, generator=g) for _ in range(d)]
    out = mesh.all_to_all(shards, split_dim, concat_dim)
    for p in range(d):
        want = torch.cat([s.chunk(d, dim=split_dim)[p] for s in shards],
                         dim=concat_dim)
        assert torch.equal(out[p], want)
    chunk = shards[0].numel() // d * 4
    assert mesh.collective_bytes == (d - 1) * chunk


def test_ppermute_definition():
    mesh = cpu_mesh(4)
    shards = [torch.full((2, 3), float(q)) for q in range(4)]
    out = mesh.ppermute(shards, [(0, 1), (1, 2), (3, 3)])
    assert torch.equal(out[1], shards[0]) and torch.equal(out[2], shards[1])
    assert out[3] is shards[3]                      # kept, not moved
    assert torch.equal(out[0], torch.zeros(2, 3))   # no pair targets it
    assert mesh.collective_bytes == 2 * 6 * 4 / 4   # two blocks, 4 shards
    with pytest.raises(ValueError, match="repeats a source or a dest"):
        mesh.ppermute(shards, [(0, 1), (2, 1)])


def test_all_to_all_rejects_a_ragged_split():
    with pytest.raises(ValueError, match="does not split into 4 chunks"):
        cpu_mesh(4).all_to_all([torch.zeros(2, 6)] * 4, 1, 0)


@pytest.mark.parametrize("d", (1, 2, 4, 8))
@pytest.mark.parametrize("kind", ("c2c", "r2c"))
def test_collective_byte_counter(d, kind):
    """The mesh's counter over one pencil: the reference's analytic bytes
    for C2C; for R2C the exchange bytes, which add the mirror's diagonal
    block and the one-row roll that the analytic model leaves out."""
    mesh = cpu_mesh(d)
    batch, n1, n2 = 2, 32, 64
    x = torch.from_numpy(_input(d, (batch, n1, n2), kind == "c2c"))
    pencil_fft(x, mesh, n1=n1, n2=n2, kind=kind)
    want = pencil_exchange_bytes(batch, n1, n2, d, kind=kind)
    assert mesh.collective_bytes == want
    model = pencil_collective_bytes(batch, n1, n2, d, kind=kind)
    if kind == "c2c" or d == 1:
        assert want == model
    else:
        packed = batch * n1 * n2 / d * 8 / 2
        assert want - model == packed / d + batch * n2 // 2 * 8


# ---------------------------------------------------------------------------
# helpers identical to the reference's
# ---------------------------------------------------------------------------

def test_pencil_collective_bytes_identical_to_reference():
    from repro.fft.distributed import pencil_collective_bytes as ref_bytes
    for batch in (1, 2, 8, 64):
        for n1, n2 in ((32, 64), (64, 128), (4096, 8192), (8, 12)):
            for d in (1, 2, 3, 4, 8):
                for kind in ("c2c", "r2c"):
                    for elem in (8, 16):
                        args = (batch, n1, n2, d, elem, kind)
                        assert (pencil_collective_bytes(*args)
                                == ref_bytes(*args)), args


@pytest.mark.parametrize("n1,n2", ((4, 8), (32, 64), (8, 2)))
def test_layout_helpers_identical_to_reference(n1, n2):
    from repro.fft import distributed as ref
    y = _input(n1 + n2, (3, n1, n2), True)
    assert np.array_equal(untranspose_ref(torch.from_numpy(y), n1, n2),
                          np.asarray(ref.untranspose_ref(y, n1, n2)))
    yr = _input(n1, (2, n1, n2 // 2 + 1), True)
    assert np.array_equal(assemble_rfft_pencil(torch.from_numpy(yr), n1, n2),
                          ref.assemble_rfft_pencil(yr, n1, n2))


# ---------------------------------------------------------------------------
# error paths, mesh and shards
# ---------------------------------------------------------------------------

def test_pencil_error_paths():
    x = torch.zeros(1, 8, 6)
    with pytest.raises(ValueError, match="n2 must be even, got 5"):
        pencil_fft(torch.zeros(1, 8, 5), cpu_mesh(1), n1=8, n2=5,
                   kind="r2c")
    with pytest.raises(ValueError, match=r"n2/2 \(3\) divisible by the "
                       "2-device mesh axis 'model'"):
        pencil_fft(x, cpu_mesh(2), n1=8, n2=6, kind="r2c")
    with pytest.raises(ValueError, match="unknown pencil transform kind"):
        pencil_fft(x, cpu_mesh(2), n1=8, n2=6, kind="c2r")
    with pytest.raises(ValueError, match=r"\(n1, n2\) = \(8, 8\)"):
        pencil_fft(x, cpu_mesh(2), n1=8, n2=8)


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("data",))
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        make_mesh((2, 2), ("data", "model"), devices=[CPU] * 3)
    with pytest.raises(ValueError, match="do not pair up"):
        make_mesh((2,), ("data", "model"), devices=[CPU] * 2)


def test_two_axis_mesh_shards_on_index_zero_of_the_other_axis():
    devs = [torch.device("cpu", i) for i in range(6)]
    mesh = make_mesh((2, 3), ("data", "model"), devices=devs)
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert mesh.axis_devices("data") == [devs[0], devs[3]]
    assert mesh.axis_devices("model") == devs[:3]
    with pytest.raises(KeyError, match="no axis 'pod'"):
        mesh.axis_devices("pod")


def test_shard_gather_round_trip_and_pad_rows():
    mesh = cpu_mesh(4, "data")
    x = torch.arange(24.0).reshape(8, 3)
    xs = shard(x, mesh, "data", 0)
    assert [s.shape for s in xs.shards] == [(2, 3)] * 4
    assert xs.shape == (8, 3) and torch.equal(xs.gather(), x)
    with pytest.raises(ValueError, match="does not divide"):
        shard(x, mesh, "data", 1)
    padded = pad_rows(x, 11)
    assert padded.shape == (11, 3) and not padded[8:].any()
    assert pad_rows(x, 8) is x


def test_batch_parallel_fft_with_fewer_rows_than_shards():
    x = _input(3, (2, 64), True)
    y = batch_parallel_fft(x, cpu_mesh(4, "data"))
    assert y.shape == (2, 64)
    assert_close(y, np.fft.fft(x, axis=-1))


def test_batch_parallel_fft_runs_a_given_fft_fn_on_every_shard():
    seen = []

    def fn(v):
        seen.append(tuple(v.shape))
        return v * 2
    x = torch.arange(10.0).reshape(5, 2)
    y = batch_parallel_fft(x, cpu_mesh(4, "data"), fft_fn=fn)
    assert seen == [(2, 2)] * 4
    assert torch.equal(y, 2 * x)


def test_split_factors_come_from_the_f64_table():
    """The split's factors are built in float64, then rounded once."""
    a, b = dist._split_factors(4, 8, CPU)
    k = np.arange(8)[None, :] * 4 + np.arange(4)[:, None]
    iw = 1j * np.exp(-1j * np.pi * k / 32)
    assert np.array_equal(a.numpy(), (0.5 * (1 - iw)).astype(np.complex64))
    assert np.array_equal(b.numpy(), (0.5 * (1 + iw)).astype(np.complex64))
