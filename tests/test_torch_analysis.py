"""The port's dry-run analysis against the reference's: FLOPs counted on
``meta`` tensors against ``repro.analysis.hlo.analyze_hlo`` of the
reference's compiled step, the roofline arithmetic float for float, the
collective accounting row by row on hand-worked cases, the byte counter,
and the FFT wrappers' meta branch."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo import analyze_hlo
from repro.analysis.roofline import RooflineTerms as RefTerms
from repro.analysis.roofline import analytic_memory_bytes as ref_memory
from repro.analysis.roofline import model_flops_for as ref_model_flops
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import all_cells as ref_all_cells
from repro.core.hardware import TPU_V5E
from repro.models import build_model as ref_build
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train.step import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.analysis.cost import (ByteCounter, analyze_step,
                                       collective_accounting)
from repro_torch.analysis.roofline import (H100_ROOFLINE, NETWORK_BANDWIDTH,
                                           NVLINK_BANDWIDTH, RooflineTerms,
                                           analytic_memory_bytes,
                                           model_flops_for)
from repro_torch.configs import ARCHS, all_cells
from repro_torch.core.hardware import DeviceSpec
from repro_torch.fft.distributed import Mesh
from repro_torch.kernels.fft import fft_kernel, ops
from repro_torch.launch.specs import meta
from repro_torch.models import build_model
from repro_torch.models.common import P, TensorSpec, matmul_f32, tree_map
from repro_torch.obs.ledger import LaunchLedger
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState, make_train_step

B, S = 2, 64


def ref_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def port_inputs(cfg, seq: int = S):
    if cfg.input_mode == "embeds":
        return meta(TensorSpec((B, seq, cfg.d_model), torch.float32))
    return meta(TensorSpec((B, seq), torch.long))


def ref_inputs(cfg, seq: int = S):
    if cfg.input_mode == "embeds":
        return jax.ShapeDtypeStruct((B, seq, cfg.d_model), jnp.float32)
    return jax.ShapeDtypeStruct((B, seq), jnp.int32)


def both(name):
    ref = ref_build(REF_ARCHS[name].reduced())
    port = build_model(ARCHS[name].reduced())
    return (ref, jax.eval_shape(ref.init, jax.random.PRNGKey(0)), port,
            tree_map(meta, port.param_shapes()))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_meta_forward_flops_equal_the_references_hlo(name):
    ref, ref_params, port, params = both(name)
    want = ref_flops(ref.forward, ref_params, ref_inputs(port.cfg))
    with torch.inference_mode():
        got = analyze_step(port.forward, params, port_inputs(port.cfg))
    assert got["flops"] == want


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-370m"])
def test_meta_prefill_and_decode_flops_equal_the_references_hlo(name):
    ref, ref_params, port, params = both(name)
    cfg = port.cfg
    with torch.inference_mode():
        got = analyze_step(port.prefill, params, port_inputs(cfg))["flops"]
        assert got == ref_flops(ref.prefill, ref_params, ref_inputs(cfg))
        cache = tree_map(meta, port.cache_shapes(B, S))
        got = analyze_step(port.decode, params, cache,
                           port_inputs(cfg, 1))["flops"]
    want = ref_flops(ref.decode, ref_params, ref.cache_shapes(B, S),
                     ref_inputs(cfg, 1))
    assert got == want


def train_excess(cfg) -> int:
    """The port's train step counts more than the reference's HLO by:

    * one unembed product, 2 B S d V, when the cross-entropy is one chunk
      (S <= 512): the reference's chunk scan then has a trip count of 1,
      which XLA unrolls, and the rematerialised forward's unembed merges
      with the forward's (at two chunks or more it counts all four
      products, as the port does);
    * less, for an SSM, 2 B S Q H + 4 B S H P a layer: each SSD einsum
      of three operands multiplies two of them by broadcast first
      (``y_diag``: scores x L over the heads, ``states`` and ``y_off``:
      a decay over the head dim).  ``jnp.einsum`` writes that product as
      a ``dot_general`` without contraction, whose transpose in the
      backward is a ``dot`` that sums the broadcast axis, which the HLO
      count includes; the backward of torch's ``mul`` sums with a
      reduction, which ``FlopCounterMode`` does not count.
    """
    excess = 2 * B * S * cfg.d_model * cfg.vocab if S <= 512 else 0
    if cfg.family == "ssm":
        q, p = cfg.ssm.chunk, cfg.ssm.head_dim
        h = cfg.ssm.expand * cfg.d_model // p
        excess -= cfg.n_layers * (2 * B * S * q * h + 4 * B * S * h * p)
    return excess


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-370m"])
def test_meta_train_step_flops_equal_the_references_up_to_the_excess(name):
    ref, ref_params, port, params = both(name)
    cfg = port.cfg
    ref_state = jax.eval_shape(lambda: RefTrainState(
        params=ref.init(jax.random.PRNGKey(0)),
        opt=ref_adamw_init(ref.init(jax.random.PRNGKey(0))),
        step=jnp.zeros((), jnp.int32)))
    labels = jax.ShapeDtypeStruct((B, S), jnp.int32)
    want = ref_flops(ref_make_train_step(ref), ref_state, ref_inputs(cfg),
                     labels)
    f32 = lambda t: meta(TensorSpec(t.shape, torch.float32))
    i32 = meta(TensorSpec((), torch.int32))
    state = TrainState(params=params, opt=AdamWState(
        step=i32, m=tree_map(f32, params), v=tree_map(f32, params)),
        step=i32)
    got = analyze_step(make_train_step(port), state, port_inputs(cfg),
                       meta(TensorSpec((B, S), torch.long)))["flops"]
    assert got - want == train_excess(cfg)
    assert train_excess(cfg) != 0


# ---------------------------------------------------------------------------
# Roofline arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chips", [256, 512])
def test_model_flops_and_memory_match_float_for_float(chips):
    ref_cells = ref_all_cells()
    cells = all_cells()
    assert [(c.name, s.name) for c, s in cells] == [
        (c.name, s.name) for c, s in ref_cells]
    for (cfg, shape), (rcfg, rshape) in zip(cells, ref_cells):
        assert model_flops_for(cfg, shape) == ref_model_flops(rcfg, rshape)
        assert analytic_memory_bytes(cfg, shape, chips) == ref_memory(
            rcfg, rshape, chips)


def test_roofline_terms_match_the_reference_on_its_device():
    device = DeviceSpec(**{f.name: getattr(TPU_V5E, f.name)
                           for f in dataclasses.fields(DeviceSpec)})
    kw = dict(arch="x", shape="train_4k", mesh="16x16", chips=256,
              hlo_flops=3.1e14, hbm_bytes=7.7e11, collective_bytes=2.3e10,
              model_flops=4.4e16)
    ref, port = RefTerms(**kw), RooflineTerms(**kw, device=device)
    for prop in ("compute_s", "memory_s", "collective_s", "bound", "step_s",
                 "useful_ratio", "roofline_fraction"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.row() == ref.row()


def test_roofline_prices_the_model_axis_on_nvlink_the_rest_on_the_network():
    t = RooflineTerms(arch="x", shape="s", mesh="32x8", chips=256,
                      hlo_flops=989e12, hbm_bytes=3.35e12 / 2,
                      collective_bytes=450e9 + 50e9 / 4,
                      network_bytes=50e9 / 4, model_flops=0.0)
    assert t.device is H100_ROOFLINE
    assert (NVLINK_BANDWIDTH, NETWORK_BANDWIDTH) == (450e9, 50e9)
    assert H100_ROOFLINE.peak_flops == 989e12
    assert t.compute_s == 1.0 and t.memory_s == 0.5
    assert t.collective_s == 1.25 and t.bound == "collective"


# ---------------------------------------------------------------------------
# The collective accounting, row by row, on a hand-worked tree
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
#: (data 2, model 4): shapes small enough to work by hand.
TREE = {"w_in": TensorSpec((16, 32), BF16),        # P("data", "model")
        "w_out": TensorSpec((3, 32, 16), BF16),    # P(None, "model", "data")
        "norm": TensorSpec((16,), torch.float32),  # P()
        "moe": {"w_gate": TensorSpec((2, 4, 16, 8), BF16)}}
SPECS = {"w_in": P("data", "model"), "w_out": P(None, "model", "data"),
         "norm": P(), "moe": {"w_gate": P(None, "model", None, "data")}}


def accounting(kind, mesh_shape=(2, 4), names=("data", "model"), **kw):
    mesh = Mesh([torch.device("meta")] * math.prod(mesh_shape), mesh_shape,
                names)
    return collective_accounting(TREE, SPECS, mesh, kind=kind, tokens=10,
                                 act_bytes=2, top_k=2, **kw)


def test_collectives_of_a_forward():
    by_kind, by_axis = accounting("decode")
    gathered = (16 * 32 * 2 / 4        # w_in over data: bytes / model 4
                + 3 * 32 * 16 * 2 / 4  # w_out
                + 2 * 4 * 16 * 8 * 2 / 4)  # the experts
    tp = 3 * 10 * 16 * 2               # w_out: 3 uses, (10, 16) bf16
    a2a = 2 * 2 * (10 / 4) * 2 * 16 * 2  # 2 layers, dispatch + combine
    assert by_kind == {"all-gather": gathered, "all-reduce": tp,
                       "all-to-all": a2a}
    assert by_axis == {"data": gathered, "model": tp + a2a}


def test_collectives_of_a_train_step():
    by_kind, by_axis = accounting("train")
    local = {"w_in": 16 * 32 * 2 / 8, "w_out": 3 * 32 * 16 * 2 / 8,
             "moe": 2 * 4 * 16 * 8 * 2 / 8, "norm": 16 * 4}
    gathered = 2 * 4 * (local["w_in"] + local["w_out"] + local["moe"]) / 2
    scattered = local["w_in"] + local["w_out"] + local["moe"]
    tp = 3 * 3 * 10 * 16 * 2
    a2a = 3 * 2 * 2 * (10 / 4) * 2 * 16 * 2
    assert by_kind == {"all-gather": gathered,
                       "all-reduce": local["norm"] + tp,
                       "reduce-scatter": scattered, "all-to-all": a2a}
    assert by_axis == {"data": gathered + scattered + local["norm"],
                       "model": tp + a2a}


def test_collectives_over_pods_and_uses():
    """On (pod, data, model) every gradient crosses the pods: the norm's
    all-reduce over (pod, data) and the sharded leaves' over pod are
    charged to the pod axis; a weight's uses scale its TP all-reduce."""
    by_kind, by_axis = accounting(
        "train", (2, 2, 4), ("pod", "data", "model"),
        uses=lambda path, shape: 5 if path == "w_out" else 0)
    sharded = (16 * 32 + 3 * 32 * 16 + 2 * 4 * 16 * 8) * 2 / 8
    assert by_axis["pod"] == sharded + 16 * 4
    assert by_kind["all-reduce"] == sharded + 16 * 4 + 3 * 5 * 10 * 16 * 2


@pytest.mark.parametrize("mesh_shape", [(4, 1), (1, 4)])
def test_no_collective_over_an_axis_of_size_one(mesh_shape):
    """A partitioner emits no collective over one device: on (4, 1) the
    ZeRO gathers, scatters and gradient all-reduces stay on ``data`` and
    nothing is charged to ``model``; on (1, 4) the TP all-reduce and the
    experts' all-to-all stay on ``model`` and nothing is charged to
    ``data``."""
    d, m = mesh_shape
    by_kind, by_axis = accounting("train", mesh_shape)
    nbytes = {"w_in": 16 * 32 * 2, "w_out": 3 * 32 * 16 * 2,
              "moe": 2 * 4 * 16 * 8 * 2, "norm": 16 * 4}
    if m == 1:
        sharded = nbytes["w_in"] + nbytes["w_out"] + nbytes["moe"]
        assert by_kind == {"all-gather": 2 * sharded,
                           "reduce-scatter": sharded / d,
                           "all-reduce": nbytes["norm"]}
        assert by_axis == {"data": 2 * sharded + sharded / d
                           + nbytes["norm"], "model": 0.0}
    else:
        tp = 3 * 3 * 10 * 16 * 2
        a2a = 3 * 2 * 2 * (10 / 4) * 2 * 16 * 2
        assert by_kind == {"all-reduce": tp, "all-to-all": a2a}
        assert by_axis == {"data": 0.0, "model": tp + a2a}


# ---------------------------------------------------------------------------
# The byte counter and the FFT wrappers' meta branch
# ---------------------------------------------------------------------------

def test_byte_counter_counts_the_cards_bf16_unembed():
    """On meta a bf16 unembed takes the card's branch: one product of the
    bf16 operands with a float32 result (plus the views around it)."""
    h = meta(TensorSpec((2, 4, 8), BF16))
    w = meta(TensorSpec((8, 16), BF16))
    counter = ByteCounter()
    with counter:
        out = matmul_f32(h, w)
    assert out.dtype == torch.float32 and out.shape == (2, 4, 16)
    assert counter.bytes == (8 * 8 + 8 * 16) * 2 + 8 * 16 * 4
    cpu = ByteCounter()
    with cpu:
        matmul_f32(torch.zeros(2, 4, 8, dtype=BF16),
                   torch.zeros(8, 16, dtype=BF16))
    # the CPU casts both operands to float32 first
    assert cpu.bytes > counter.bytes


def test_byte_counter_counts_written_arguments_once():
    counter = ByteCounter()
    a, b = meta(TensorSpec((5,), torch.float32)), meta(
        TensorSpec((5,), torch.float32))
    with counter:
        a.copy_(b)
        torch.add(a, b, out=a)
    assert counter.bytes == (20 + 20) + (40 + 20)


WRAPPERS = {
    "fft-c2c": (lambda x: ops.fft_kernel_c2c(x), (3, 64), torch.complex64),
    "fft-c2c-axis1": (lambda x: ops.fft_kernel_c2c_axis1(
        x, twiddle=torch.ones(16, 32, dtype=torch.complex64,
                              device=x.device)), (3, 32, 16),
        torch.complex64),
    "fft-c2c-t": (lambda x: ops.fft_kernel_c2c_t(x), (3, 8, 32),
                  torch.complex64),
    "fft-r2c": (lambda x: ops.fft_kernel_r2c(x), (3, 64), torch.float32),
    "fft-r2c-t": (lambda x: ops.fft_kernel_r2c_t(x), (3, 8, 32),
                  torch.float32),
    "fft-c2r": (lambda x: ops.fft_kernel_c2r(x), (3, 33), torch.complex64),
    "fft-c2c-mul": (lambda x: ops.fft_kernel_c2c_mul(
        x, torch.ones(2, 64, dtype=torch.complex64, device=x.device)),
        (3, 64), torch.complex64),
    "transpose": (lambda x: ops.transpose_kernel(x), (3, 8, 32),
                  torch.complex64),
    "fft-r2c-split": (lambda x: ops.fft_kernel_r2c_split(x, 64), (3, 32),
                      torch.complex64),
    "fft-c2r-merge": (lambda x: ops.fft_kernel_c2r_merge(x, 64), (3, 33),
                      torch.complex64),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_fft_wrappers_on_meta_give_the_cpu_calls_shape_and_ledger(kernel):
    fn, shape, dtype = WRAPPERS[kernel]
    x = torch.zeros(shape, dtype=dtype)
    fft_kernel.reset_launches()
    records = []
    for device in ("cpu", "meta"):
        ledger = LaunchLedger()
        with ledger.capture():
            y = fn(x.to(device))
        assert y.device.type == device
        records.append((tuple(y.shape), y.dtype, ledger.to_dicts()))
    assert records[0] == records[1]
    assert records[1][2][0]["kernel"] == kernel
    assert not any(fft_kernel.LAUNCHES.values())
