"""The port's model building blocks (``repro_torch.models.common``,
``attention``, ``mla``, ``moe`` and the SSD pieces of ``mamba2``) against
the reference's, on the same seeded float32 inputs: within 1e-5 of the
reference's largest |value| (1e-4 for the MoE and MLA blocks, whose
float32 products sum in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mamba2 as ref_mamba
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro_torch.configs import ARCHS
from repro_torch.configs.base import MoEConfig
from repro_torch.models import attention, common, mamba2, mla, moe


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, err


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _j(a) -> jnp.ndarray:
    return jnp.asarray(np.asarray(a))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tree(tree):
    return jax.tree.map(lambda a: _t(a), tree)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 64), _rand(rng, 64)
    _close(common.rms_norm(_t(x), _t(scale), 1e-6),
           ref_common.rms_norm(_j(x), _j(scale), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    q = _rand(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 4000, (2, 9))
    _close(common.rope(_t(q), _t(pos), theta),
           ref_common.rope(_j(q), _j(pos), theta))


# (sq, sk, h, kv, causal offset, window, chunk): GQA, a causal offset, a
# window, and an sk that is not a power of two (the chunk halves to 8).
ATTN_CASES = [
    (16, 16, 4, 2, 0, None, 1024),
    (16, 16, 4, 4, 0, None, 4),
    (4, 20, 6, 2, 16, None, 8),
    (24, 24, 4, 2, 0, 5, 16),
    (24, 24, 4, 1, 0, None, 16),
]


@pytest.mark.parametrize("sq,sk,h,kv,offset,window,chunk", ATTN_CASES)
def test_attention(sq, sk, h, kv, offset, window, chunk):
    rng = np.random.default_rng(sq + sk + h)
    q, k, v = _rand(rng, 2, sq, h, 8), _rand(rng, 2, sk, kv, 8), \
        _rand(rng, 2, sk, kv, 8)
    got = attention.attention(_t(q), _t(k), _t(v), causal_offset=offset,
                              window=window, chunk=chunk)
    want = ref_attn.attention(_j(q), _j(k), _j(v), causal_offset=offset,
                              window=window, chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("cache_len,window", [(None, None), (11, None),
                                              (None, 4), (13, 5)])
def test_decode_attention(cache_len, window):
    rng = np.random.default_rng(7)
    q, k, v = _rand(rng, 2, 1, 4, 8), _rand(rng, 2, 16, 2, 8), \
        _rand(rng, 2, 16, 2, 8)
    got = attention.decode_attention(_t(q), _t(k), _t(v),
                                     cache_len=cache_len, window=window)
    want = ref_attn.decode_attention(_j(q), _j(k), _j(v),
                                     cache_len=cache_len, window=window)
    _close(got, want)


def _moe_cfgs(cf: float, n_shared: int):
    kw = dict(n_experts=4, top_k=2, d_ff_expert=8, n_shared=n_shared,
              group_size=8, capacity_factor=cf)
    return MoEConfig(**kw), RefMoEConfig(**kw)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_block_drops_the_same_tokens(n_shared):
    """At capacity factor 0.5 each expert takes 2 of a group's 16 (token,
    k) pairs: tokens are dropped, and the port drops the same ones."""
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 12, 16)                 # 24 tokens: groups of 8
    pcfg, rcfg = _moe_cfgs(0.5, n_shared)
    ref_params = ref_moe.init_moe(jax.random.PRNGKey(0), 16, rcfg,
                                  jnp.float32)
    want, want_aux = ref_moe.moe_block(ref_params, _j(x), rcfg)
    got, got_aux = moe.moe_block(_tree(ref_params), _t(x), pcfg)
    _close(got, want, 1e-4)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5
    if not n_shared:
        dropped = np.flatnonzero(np.abs(np.asarray(want)).max(-1)
                                 .reshape(-1) == 0)
        assert dropped.size                    # some token lost both slots
        got_dropped = np.flatnonzero(got.abs().amax(-1).reshape(-1) == 0)
        assert dropped.tolist() == got_dropped.tolist()
    full_p, full_r = _moe_cfgs(100.0, n_shared)
    no_drop, _ = ref_moe.moe_block(ref_params, _j(x), full_r)
    assert not np.allclose(np.asarray(no_drop), np.asarray(want))
    _close(moe.moe_block(_tree(ref_params), _t(x), full_p)[0], no_drop, 1e-4)


@pytest.mark.parametrize("s", [7, 12])
def test_causal_conv(s):
    rng = np.random.default_rng(s)
    x, w, b = _rand(rng, 2, s, 24), _rand(rng, 4, 24), _rand(rng, 24)
    _close(mamba2._causal_conv(_t(x), _t(w), _t(b)),
           ref_mamba._causal_conv(_j(x), _j(w), _j(b)))


@pytest.mark.parametrize("s,chunk", [(48, 16), (40, 16), (8, 16)])
def test_ssd_chunked_and_its_final_state(s, chunk):
    """Three chunks; 40 tokens (the chunk halves to 8); one short chunk."""
    rng = np.random.default_rng(s)
    xs = _rand(rng, 2, s, 4, 8)
    dt = np.log1p(np.exp(_rand(rng, 2, s, 4)))
    bm, cm = _rand(rng, 2, s, 16), _rand(rng, 2, s, 16)
    a_log = _rand(rng, 4) * 0.5
    y, final = mamba2._ssd_chunked(_t(xs), _t(dt), _t(bm), _t(cm),
                                   _t(a_log), chunk)
    ry, rfinal = ref_mamba._ssd_chunked(_j(xs), _j(dt), _j(bm), _j(cm),
                                        _j(a_log), chunk)
    _close(y, ry)
    _close(final, rfinal)
    assert final.dtype == torch.float32


def test_segsum_masks_above_the_diagonal():
    rng = np.random.default_rng(5)
    d = np.cumsum(-np.abs(_rand(rng, 3, 6)), -1)
    got = mamba2._segsum(_t(d))
    _close(got, ref_mamba._segsum(_j(d)))
    assert (np.triu(got.numpy()[0], 1) == 0).all()


def test_mla_decode():
    name = "deepseek-v2-lite-16b"
    rcfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    params = ref_mla.init_mla(jax.random.PRNGKey(0), rcfg, jnp.float32)
    rng = np.random.default_rng(11)
    x = _rand(rng, 2, 1, rcfg.d_model)
    cache = {"c_kv": _rand(rng, 2, 10, rcfg.mla.kv_lora_rank),
             "k_rope": _rand(rng, 2, 10, 1, rcfg.mla.qk_rope_head_dim)}
    want, want_cache = ref_mla.mla_decode(params, _j(x),
                                          jax.tree.map(_j, cache), rcfg)
    torch_cache = jax.tree.map(_t, cache)
    got, got_cache = mla.mla_decode(_tree(params), _t(x), torch_cache, pcfg)
    _close(got, want, 1e-4)
    for key in cache:
        _close(got_cache[key], want_cache[key])
        # the input cache is left as it was
        np.testing.assert_array_equal(torch_cache[key].numpy(), cache[key])
    shapes = mla.mla_cache_shape(pcfg, 2, 10, torch.float32)
    want_shapes = ref_mla.mla_cache_shape(rcfg, 2, 10, jnp.float32)
    assert {k: v.shape for k, v in shapes.items()} == \
        {k: v.shape for k, v in want_shapes.items()}


def test_cross_entropy():
    rng = np.random.default_rng(2)
    logits = _rand(rng, 2, 5, 33) * 3
    labels = rng.integers(0, 33, (2, 5))
    _close(common.cross_entropy(_t(logits), _t(labels)),
           ref_common.cross_entropy(_j(logits), _j(labels)))


@pytest.mark.parametrize("s,chunk", [(24, 16), (32, 512), (16, 4)])
def test_chunked_cross_entropy(s, chunk):
    """Chunks of 8 (24 tokens at 16), one chunk, and four."""
    rng = np.random.default_rng(s)
    h, w = _rand(rng, 2, s, 12), _rand(rng, 12, 40)
    labels = rng.integers(0, 40, (2, s))
    got = common.chunked_cross_entropy(lambda hc: hc @ _t(w), _t(h),
                                       _t(labels), chunk=chunk)
    want = ref_common.chunked_cross_entropy(lambda hc: hc @ _j(w), _j(h),
                                            _j(labels), chunk=chunk)
    _close(got, want)
    _close(got, common.cross_entropy(_t(h) @ _t(w), _t(labels)))


def test_matmul_f32_keeps_a_float32_result():
    rng = np.random.default_rng(4)
    a, b = _rand(rng, 2, 3, 8), _rand(rng, 8, 5)
    got = common.matmul_f32(_t(a).bfloat16(), _t(b).bfloat16())
    assert got.dtype == torch.float32
    want = (_t(a).bfloat16().float() @ _t(b).bfloat16().float())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_param_tree_indexes_like_a_dict():
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3)},
            "d": [{"e": torch.ones(1)}, {"e": torch.zeros(1)}]}
    pt = common.ParamTree(tree)
    assert sorted(pt.state_dict()) == ["a", "b.c", "d.0.e", "d.1.e"]
    assert "b" in pt and "x" not in pt and pt.get("x") is None
    assert pt["b"]["c"].shape == (3,)
    back = pt.tree()
    assert isinstance(back["d"], list) and back["d"][1]["e"].item() == 0
    assert not any(p.requires_grad for p in pt.parameters())
    assert dataclasses.is_dataclass(common.TensorSpec((1,), torch.float32))


def test_bf16_weights_round_trip_bit_identical():
    """bf16 leaves (``ml_dtypes.bfloat16`` arrays on the reference's side)
    travel as their bits, both ways."""
    from repro.models import build_model as ref_build
    from repro_torch.models import params_from_reference, params_to_reference
    name = "deepseek-v2-lite-16b"
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(), dtype="bfloat16")
    pcfg = dataclasses.replace(ARCHS[name].reduced(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        ref_build(rcfg).init(jax.random.PRNGKey(0)))
    port = params_from_reference(tree, pcfg, "cpu")
    assert port["embed"].dtype == torch.bfloat16
    assert port["layers"]["moe"]["router"].dtype == torch.float32
    back = params_to_reference(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
