"""The port's model zoo against the reference's for the mixtures of experts
(dbrx; deepseek-v2-lite with MLA, shared experts and a dense first layer):
forward, prefill and decode logits and caches, cache shapes, the weights
carried across and back, ``state_dict`` keys, decode = forward and
checkpoints across the packages (the checks of
``_model_parity.ArchParity``)."""
import jax.numpy as jnp
import pytest
import torch

from _model_parity import (DEC_SEQ, ArchParity, close, load_arch, pad_seq,
                           to_torch)


@pytest.fixture(scope="module", params=["dbrx-132b", "deepseek-v2-lite-16b"])
def arch(request):
    return load_arch(request.param)


class TestArchParity(ArchParity):
    pass


def test_capacity_drops_part_the_decode_from_forward_in_both_packages():
    """At the config's capacity factor, ``forward`` over 16 tokens (two
    groups of 8) drops some (token, expert) pairs that a one-token decode
    group keeps: decode then differs from forward at the last position in
    the reference, and the port differs by the same logits."""
    arch = load_arch("dbrx-132b")
    inp = arch.inputs(7, batch=1, seq=DEC_SEQ)
    ref_full, _ = arch.ref.forward(arch.ref_params, jnp.asarray(inp))
    _, cache = arch.ref.prefill(arch.ref_params, jnp.asarray(inp[:, :-1]))
    cache = pad_seq(cache, arch.model.cache_shapes(1, DEC_SEQ - 1),
                    arch.model.cache_shapes(1, DEC_SEQ), 1)
    ref_dec, _ = arch.ref.decode(arch.ref_params, cache,
                                 jnp.asarray(inp[:, -1:]))
    gap = abs(ref_dec[0, 0] - ref_full[0, -1]).max() / abs(
        ref_full[0, -1]).max()
    assert gap > 0.1
    port_full, _ = arch.model.forward(arch.params, torch.from_numpy(inp))
    close(port_full, ref_full)
    port_dec, _ = arch.model.decode(arch.params, to_torch(cache),
                                    torch.from_numpy(inp[:, -1:]))
    close(port_dec, ref_dec)
