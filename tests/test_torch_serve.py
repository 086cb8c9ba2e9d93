"""The port's serve driver (``repro_torch.launch.serve``) against the
reference's: the same tokens on the reduced qwen2, mamba2, zamba2 and
deepseek with the reference's parameters and prompt carried in; the
reference's decode on a padded cache reproduced; the cache grown on its
sequence axes only; the DVFS report and ``roofline_workload`` on
``TESLA_V100`` field for field."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
from repro.configs import ARCHS as REF_ARCHS
from repro.core.dvfs import sweep as ref_sweep
from repro.core.hardware import TESLA_V100 as REF_V100
from repro.core.scheduler import DVFSScheduler as RefScheduler
from repro.core.scheduler import Stage as RefStage
from repro.core.workloads import roofline_workload as ref_roofline
from repro.models import build_model as ref_build
from repro_torch.configs import ARCHS
from repro_torch.core import DEVICES, H100_SXM, TESLA_V100, roofline_workload
from repro_torch.launch import serve
from repro_torch.models import build_model, params_from_reference
from repro_torch.models.common import tree_map

from _model_parity import close


def _carried(name: str, batch: int, prompt_len: int):
    """The reference main's parameters and prompt (its seeds), and the
    same carried into the port."""
    cfg = REF_ARCHS[name].reduced()
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (batch, prompt_len),
                                0, cfg.vocab)
    port = params_from_reference(jax.tree.map(np.asarray, params),
                                 ARCHS[name].reduced(), "cpu")
    return params, prompt, port, torch.from_numpy(np.array(prompt))


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-370m", "zamba2-1.2b",
                                  "deepseek-v2-lite-16b"])
def test_main_gives_the_reference_tokens(name):
    argv = ["--arch", name, "--reduced"]
    want = ref_serve.main(argv)
    _, _, params, prompt = _carried(name, 4, 32)
    got = serve.main(argv + ["--device", "cpu"], params=params,
                     prompt=prompt)
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_mamba2_at_prompt_len_16_runs_where_the_reference_raises():
    """The reference pads the SSM state's head axis (16 = prompt_len) and
    its decode raises; the port grows no axis of an SSM cache, and its
    tokens are the reference's own prefill-then-decode chain."""
    argv = ["--arch", "mamba2-370m", "--reduced", "--batch", "2",
            "--prompt-len", "16", "--gen", "5"]
    with pytest.raises(TypeError):
        ref_serve.main(argv)
    ref_params, ref_prompt, params, prompt = _carried("mamba2-370m", 2, 16)
    got = serve.main(argv + ["--device", "cpu"], params=params,
                     prompt=prompt)
    model = ref_build(REF_ARCHS["mamba2-370m"].reduced())
    logits, cache = model.prefill(ref_params, ref_prompt)
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
        want.append(np.asarray(tok))
        logits, cache = model.decode(ref_params, cache, tok)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


def test_decode_on_a_padded_cache_reproduces_the_reference():
    """``serve`` pads the cache by ``gen`` slots and decodes at slot S - 1
    against every slot: by 1 slot decode equals ``forward``; by 5 it does
    not, in the reference as in the port, which gives the same logits."""
    name = "qwen2-0.5b"
    ref_params, _, params, _ = _carried(name, 1, 8)
    ref_model = ref_build(REF_ARCHS[name].reduced())
    model = build_model(ARCHS[name].reduced())
    toks = np.random.default_rng(0).integers(0, 256, (1, 9))
    full, _ = model.forward(params, torch.from_numpy(toks))
    _, cache = ref_model.prefill(ref_params, jnp.asarray(toks[:, :8]))
    for pad, faulty in ((1, False), (5, True)):
        padded = jax.tree.map(
            lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, pad), (0, 0), (0, 0)]),
            cache)
        want, _ = ref_model.decode(ref_params, padded,
                                   jnp.asarray(toks[:, 8:]))
        got, _ = model.decode(params, jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)), padded),
            torch.from_numpy(toks[:, 8:]))
        close(got, want)
        gap = (got[0, 0] - full[0, 8]).abs().max() / full[0, 8].abs().max()
        assert (gap > 1e-2) == faulty, gap


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-370m", "zamba2-1.2b",
                                  "gemma3-12b", "deepseek-v2-lite-16b"])
def test_grow_cache_pads_only_sequence_axes(name):
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    # prompt_len 16 equals the reduced mamba2's head count (H = 16)
    _, cache = model.prefill(params, torch.zeros(2, 16, dtype=torch.long))
    grown = serve.grow_cache(model, cache, 2, 16, 3)
    specs = tree_map(lambda s: s.shape, model.cache_shapes(2, 19))
    assert tree_map(lambda a: tuple(a.shape), grown) == specs
    tree_map(lambda a, g: np.testing.assert_array_equal(
        g[tuple(slice(0, n) for n in a.shape)].numpy(), a.numpy()),
        cache, grown)


def test_roofline_workload_is_field_identical_on_v100():
    for kw in (dict(hlo_flops=3e12, hbm_bytes=1e9),
               dict(hlo_flops=1e9, hbm_bytes=2e10, issue_efficiency=0.8),
               dict(hlo_flops=5e11, hbm_bytes=1e8, collective_bytes=1e9,
                    useful_flops=4e11)):
        got = roofline_workload("step", TESLA_V100, **kw)
        want = ref_roofline("step", REF_V100, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-370m"])
def test_dvfs_report_prices_as_the_reference_does(name):
    """The reference's ``--dvfs-report`` computation, run with its own
    functions on its ``TESLA_V100``, equals the port's on the port's."""
    batch, prompt_len, gen = 8, 512, 32
    phases, rep = serve.dvfs_report(name, batch, prompt_len, gen,
                                    dev=TESLA_V100)
    full = REF_ARCHS[name]
    nbytes = full.param_count() * 2
    cache_bytes = (full.n_layers * 2 * full.n_kv_heads
                   * full.resolved_head_dim * (prompt_len + gen) * batch * 2)
    want = [ref_roofline("prefill", REF_V100,
                         hlo_flops=2 * full.param_count() * batch * prompt_len,
                         hbm_bytes=nbytes, issue_efficiency=0.8),
            ref_roofline("decode", REF_V100,
                         hlo_flops=2 * full.param_count() * batch,
                         hbm_bytes=nbytes + cache_bytes,
                         issue_efficiency=0.8)]
    plan = []
    for (prof, res), wprof in zip(phases, want):
        wres = ref_sweep(wprof, REF_V100)
        assert dataclasses.asdict(prof) == dataclasses.asdict(wprof)
        assert prof.regime(TESLA_V100) == wprof.regime(REF_V100)
        assert res.optimal.f == wres.optimal.f
        assert res.power_reduction == wres.power_reduction
        assert res.slowdown == wres.slowdown
        plan.append(RefStage(wprof, wres.optimal.f))
    wrep = RefScheduler(REF_V100).evaluate_pipeline(plan)
    assert (rep.i_ef, rep.slowdown) == (wrep.i_ef, wrep.slowdown)


def test_dvfs_report_prices_the_model_step_at_the_bf16_peak(capsys):
    assert serve.H100_SXM_BF16.peak_flops == 989e12
    assert (dataclasses.replace(serve.H100_SXM_BF16, name=H100_SXM.name,
                                peak_flops=H100_SXM.peak_flops) == H100_SXM)
    assert DEVICES["h100-sxm"] is H100_SXM
    serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3",
                "--dvfs-report"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 3) tokens" in out
    for line in ("[dvfs] prefill: bound=", "[dvfs] decode: bound=",
                 "[dvfs] serve pipeline I_ef="):
        assert line in out


def test_without_a_card_the_entry_points_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ARCHS["qwen2-0.5b"].reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg).init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2-0.5b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference({}, cfg)


def test_an_embeddings_input_model_cannot_be_served_in_either_package():
    """``serve`` feeds each greedy token id back to decode; pixtral takes
    embeddings (its vision frontend is a stub), so the first decode step
    raises in the reference, and in the port, which reproduces its loop."""
    argv = ["--arch", "pixtral-12b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "2"]
    with pytest.raises(TypeError):
        ref_serve.main(argv)
    with pytest.raises(RuntimeError, match="shape"):
        serve.main(argv + ["--device", "cpu"])
