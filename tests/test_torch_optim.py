"""The port's optimizer, schedule and token data against the reference's:
``adamw_update`` on mixed trees (2-D, 1-D and stacked-norm leaves; float32
and bf16; clip on and off) within 1e-6 of the largest |leaf|, with the
bf16 promotion trap shown; ``cosine_schedule``; ``SyntheticTokens`` and
``synthetic_batches`` bit for bit; and the reference's claims of
``tests/test_runtime.py`` (quadratic convergence, the schedule's shape,
deterministic sharded data)."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from _model_parity import close, flat, one_torch_thread  # noqa: F401
from repro.data.synthetic import SyntheticTokens as RefTokens
from repro.data.synthetic import synthetic_batches as ref_batches
from repro.optim.adamw import adamw_init as ref_init
from repro.optim.adamw import adamw_update as ref_update
from repro.optim.adamw import global_norm as ref_global_norm
from repro.optim.schedule import cosine_schedule as ref_schedule
from repro_torch.data import SyntheticTokens, synthetic_batches
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import tensors_from_reference
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.adamw import global_norm

OPT_RTOL = 1e-6


def _tree(seed: int, dtype, scale: float = 1.0) -> dict:
    """2-D and 1-D leaves, a stacked norm scale (L, d) and a list."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: (scale * rng.standard_normal(shape)).astype(
        np.float32).astype(dtype)
    return {"w": draw(8, 4), "bias": draw(4),
            "layers": {"ln": draw(3, 4), "w_up": draw(3, 4, 6)},
            "dense": [{"w": draw(4, 4), "b": draw(4)}]}


def _port(tree) -> dict:
    return tensors_from_reference(tree, "cpu")


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_adamw_matches_the_reference(dtype, clip):
    params, grads = _tree(0, dtype), _tree(1, dtype, scale=3.0)
    ref_p, ref_s = params, ref_init(params)
    got_p, got_s = _port(params), adamw_init(_port(params))
    for _ in range(2):
        ref_p, ref_s, ref_n = ref_update(ref_p, grads, ref_s, lr=1e-2,
                                         clip_norm=clip)
        got_p, got_s, got_n = adamw_update(got_p, _port(grads), got_s,
                                           lr=1e-2, clip_norm=clip)
    close(got_n, ref_n, OPT_RTOL)
    assert int(got_s.step) == 2 and got_s.step.dtype == torch.int32
    for got, want in ((got_p, ref_p), (got_s.m, ref_s.m), (got_s.v, ref_s.v)):
        got = tree_map(lambda t: t.float(), got)
        for a, b in zip(flat(got), jax.tree.leaves(want)):
            close(a, np.asarray(b, np.float32), OPT_RTOL)
    assert all(t.dtype == torch.float32 for t in tree_leaves(got_s.m))
    assert got_p["w"].dtype == (torch.bfloat16 if dtype != np.float32
                                else torch.float32)


def test_bf16_gradients_are_cast_before_the_clip_scale():
    """The promotion trap: JAX promotes bf16 x f32 0-d to float32; in torch
    the product stays bf16.  Scaling the bf16 gradient as it is would put
    a bf16 rounding into the moment; the port casts first."""
    params, grads = (_tree(0, ml_dtypes.bfloat16),
                     _tree(1, ml_dtypes.bfloat16, scale=3.0))
    _, want, norm = ref_update(params, grads, ref_init(params), lr=1e-2)
    _, got, _ = adamw_update(_port(params), _port(grads),
                             adamw_init(_port(params)), lr=1e-2)
    close(got.m["w"].numpy(), want.m["w"], OPT_RTOL)
    scale = torch.clamp(1.0 / global_norm(_port(grads)), max=1.0)
    naive = (1 - 0.9) * (_port(grads)["w"] * scale).float()
    assert naive.dtype == torch.float32 and (
        _port(grads)["w"] * scale).dtype == torch.bfloat16
    err = np.abs(naive.numpy() - want.m["w"]).max() / np.abs(want.m["w"]).max()
    assert err > 100 * OPT_RTOL, err


def test_decay_follows_the_stacked_layout():
    """Zero gradients: only the decoupled decay moves a leaf, and it moves
    every leaf with two or more axes (a stacked norm (L, d) too), never a
    1-D one — as in the reference."""
    params = _tree(2, np.float32)
    zeros = jax.tree.map(np.zeros_like, params)
    want, _, _ = ref_update(params, zeros, ref_init(params), lr=0.5)
    got, _, _ = adamw_update(_port(params), _port(zeros),
                             adamw_init(_port(params)), lr=0.5)
    np.testing.assert_array_equal(got["bias"].numpy(), params["bias"])
    np.testing.assert_allclose(got["layers"]["ln"].numpy(),
                               params["layers"]["ln"] * (1 - 0.5 * 0.1),
                               rtol=1e-6)
    for a, b in zip(flat(got), jax.tree.leaves(want)):
        close(a, b, OPT_RTOL)


def test_global_norm_matches_the_reference():
    tree = _tree(3, np.float32)
    close(global_norm(_port(tree)), ref_global_norm(tree), OPT_RTOL)


@pytest.mark.parametrize("step", [0, 50, 100, 5000, 10000])
def test_cosine_schedule_matches_the_reference(step):
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    want = float(ref_schedule(step))
    assert float(got) == pytest.approx(want, rel=OPT_RTOL, abs=0)
    assert float(cosine_schedule(step, peak_lr=1e-2, warmup=10,
                                 total=300, floor=0.2)) == pytest.approx(
        float(ref_schedule(step, peak_lr=1e-2, warmup=10, total=300,
                           floor=0.2)), rel=OPT_RTOL, abs=0)


def test_cosine_schedule_shape():
    """The reference's claims."""
    assert float(cosine_schedule(0)) == 0.0
    assert float(cosine_schedule(100)) == pytest.approx(3e-4, rel=1e-3)
    assert float(cosine_schedule(10000)) == pytest.approx(3e-5, rel=1e-3)


def test_adamw_converges_quadratic():
    """The reference's claim: 200 steps on p^2 from (3, -2)."""
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = tree_map(lambda p: 2 * p, params)
        params, state, _ = adamw_update(params, grads, state, lr=0.05,
                                        weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


@pytest.mark.parametrize("seed,index,host_id,n_hosts", [
    (0, 0, 0, 1), (0, 3, 0, 2), (0, 3, 1, 2), (7, 11, 2, 4), (123, 0, 3, 4)])
def test_synthetic_tokens_are_the_references(seed, index, host_id, n_hosts):
    for vocab, seq, batch in ((256, 16, 8), (151936, 128, 8)):
        got = SyntheticTokens(vocab, seq, batch, seed).batch(
            index, host_id=host_id, n_hosts=n_hosts)
        want = RefTokens(vocab, seq, batch, seed).batch(
            index, host_id=host_id, n_hosts=n_hosts)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_synthetic_batches_are_the_references():
    got = list(synthetic_batches(100, 16, 4, 5, seed=3, host_id=1,
                                 n_hosts=2))
    want = list(ref_batches(100, 16, 4, 5, seed=3, host_id=1, n_hosts=2))
    assert len(got) == len(want) == 5
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi[:, 1:], gl[:, :-1])


def test_synthetic_data_deterministic_and_sharded():
    """The reference's claim."""
    ds = SyntheticTokens(vocab=100, seq_len=16, global_batch=8)
    a = ds.batch(3, host_id=0, n_hosts=2)
    np.testing.assert_array_equal(a, ds.batch(3, host_id=0, n_hosts=2))
    assert a.shape == (4, 17)
    assert not np.array_equal(a, ds.batch(3, host_id=1, n_hosts=2))
    assert a.max() < 100
