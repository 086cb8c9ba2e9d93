"""The port's training step against the reference's for the SSD backbone
(mamba2) and the hybrid (zamba2): the checks of
``_model_parity.TrainParity``; and ``_segsum``'s repair: the port masks
the difference before the ``exp``, so its forward keeps the same bits and
its gradient stays finite where the reference's is NaN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _model_parity import (AUX_WEIGHT, TrainParity, close, flat, load_arch,
                           one_torch_thread)  # noqa: F401
from repro.models.common import chunked_cross_entropy as ref_chunked_ce
from repro.models.mamba2 import _segsum as ref_segsum
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import tensors_from_reference
from repro_torch.models.mamba2 import _segsum
from repro_torch.train.step import loss_fn


@pytest.fixture(scope="module", params=["mamba2-370m", "zamba2-1.2b"])
def arch(request):
    return load_arch(request.param)


class TestTrainParity(TrainParity):
    pass


def _segsum_after_exp(dacum: torch.Tensor) -> torch.Tensor:
    """The reference's order (and the port's before the repair): ``exp``,
    then the mask."""
    q = dacum.shape[-1]
    diff = dacum[..., :, None] - dacum[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool))
    return torch.where(mask, torch.exp(diff), 0.0)


@pytest.mark.parametrize("scale", [0.1, 3.0, 20.0])
def test_segsum_forward_keeps_its_bits(scale):
    dacum = torch.from_numpy(np.cumsum(-scale * np.random.default_rng(
        0).random((2, 3, 16)), -1).astype(np.float32))
    got = _segsum(dacum)
    torch.testing.assert_close(got, _segsum_after_exp(dacum), rtol=0,
                               atol=0)
    # XLA's exp and torch's differ in the last bit here and there, and
    # XLA flushes subnormal results to zero.
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_segsum(jnp.asarray(dacum))),
                               rtol=1e-6, atol=np.finfo(np.float32).tiny)


def test_segsum_gradient_is_finite_where_the_reference_gives_nan():
    """At dacum = -20 * arange(8) a masked difference reaches 140, whose
    ``exp`` overflows float32: the reference's gradient is NaN there, the
    port's finite (each entry's column sum of L minus its row sum)."""
    dacum = -20.0 * np.arange(8, dtype=np.float32)
    ref = np.asarray(jax.grad(lambda d: ref_segsum(d).sum())(
        jnp.asarray(dacum)))
    assert np.isnan(ref).any()
    np.testing.assert_array_equal(np.isnan(ref), [True, True, True, False,
                                                  False, True, True, True])
    d = torch.from_numpy(dacum).requires_grad_()
    (grad,) = torch.autograd.grad(_segsum(d).sum(), d)
    lmat = np.tril(np.exp(np.minimum(dacum[:, None] - dacum[None, :], 0)))
    np.testing.assert_allclose(grad.numpy(), lmat.sum(1) - lmat.sum(0),
                               rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(grad).all())


def test_model_gradients_are_finite_where_the_reference_gives_nan():
    """The reduced mamba2 with a strong decay (A_log 3, dt_bias 1): the
    loss agrees; the reference's gradient is NaN in every leaf the SSM
    reaches, the port's finite, and the two leaves it does not reach
    (``final_norm``, ``lm_head``) agree."""
    arch = load_arch("mamba2-370m")
    params = jax.tree.map(np.array, arch.np_params)
    params["layers"]["A_log"][:] = 3.0
    params["layers"]["dt_bias"][:] = 1.0
    inp, labels = arch.train_batch()

    def ref_loss(p):
        hidden, aux = arch.ref.forward_hidden(p, jnp.asarray(inp))
        return ref_chunked_ce(lambda h: arch.ref.unembed(p, h), hidden,
                              jnp.asarray(labels)) + AUX_WEIGHT * aux

    want, ref_grads = jax.value_and_grad(ref_loss)(
        jax.tree.map(jnp.asarray, params))
    ref_grads = dict(zip(sorted(params), (ref_grads[k]
                                          for k in sorted(params))))
    leaves = tree_map(lambda t: t.requires_grad_(),
                      tensors_from_reference(params, "cpu"))
    loss = loss_fn(arch.model, leaves, torch.from_numpy(inp),
                   torch.from_numpy(labels), aux_weight=AUX_WEIGHT)
    close(loss.detach(), want, 1e-5)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    grads = tree_map(lambda _: next(grads), leaves)
    for g in flat(grads):
        assert np.isfinite(g).all()
    assert all(np.isnan(np.asarray(g)).any()
               for g in jax.tree.leaves(ref_grads["layers"]))
    assert np.isnan(np.asarray(ref_grads["embed"])).any()
    for key in ("final_norm", "lm_head"):
        close(grads[key].numpy(), ref_grads[key])
