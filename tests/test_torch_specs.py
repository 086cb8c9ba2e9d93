"""The port's sharding vocabulary against the reference's: the spec trees
of the ten architectures, ``param_shapes`` against ``jax.eval_shape``,
the train-state specs, ``fix_sharding`` / ``fix_tree`` and the
production mesh.  Everything here is shapes and names: no weight is
drawn."""
import dataclasses
import math

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as REF_ARCHS
from repro.launch.specs import fix_sharding as ref_fix_sharding
from repro.models import build_model as ref_build
from repro.train.step import train_state_specs as ref_train_state_specs
from repro_torch.configs import ARCHS, get_shape
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.launch.specs import fix_sharding, fix_tree, input_specs
from repro_torch.models import build_model
from repro_torch.models.common import P, PartitionSpec, tree_items
from repro_torch.optim import optimizer_specs
from repro_torch.train import train_state_specs

NAMES = sorted(ARCHS)


class FakeMesh:
    """Axis sizes only, for the reference's ``fix_sharding``."""

    def __init__(self, shape):
        self.shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self.shape)


def ref_items(tree) -> dict:
    """{path: leaf} of a reference pytree (PartitionSpecs are leaves)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    for path, leaf in flat:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


def same_specs(port, ref) -> None:
    got, want = dict(tree_items(port)), ref_items(ref)
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert isinstance(spec, PartitionSpec), path
        assert tuple(spec) == tuple(want[path]), (path, spec, want[path])


@pytest.mark.parametrize("name", NAMES)
def test_spec_trees_are_the_references_leaf_for_leaf(name):
    ref, port = ref_build(REF_ARCHS[name]), build_model(ARCHS[name])
    same_specs(port.param_specs(), ref.param_specs())
    same_specs(port.cache_specs(), ref.cache_specs())
    # the specs sit on the parameter tree's and the cache's paths
    assert ([p for p, _ in tree_items(port.param_specs())]
            == [p for p, _ in tree_items(port.param_shapes())])
    assert ([p for p, _ in tree_items(port.cache_specs())]
            == [p for p, _ in tree_items(port.cache_shapes(2, 8))])


@pytest.mark.parametrize("name", NAMES + ["qwen2-0.5b full"])
def test_param_shapes_equal_the_references_eval_shape(name):
    full = name.endswith(" full")
    name = name.split()[0]
    ref_cfg, cfg = REF_ARCHS[name], ARCHS[name]
    if not full:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    want = ref_items(jax.eval_shape(ref_build(ref_cfg).init,
                                    jax.random.PRNGKey(0)))
    got = dict(tree_items(build_model(cfg).param_shapes()))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert spec.shape == tuple(want[path].shape), path
        assert str(spec.dtype) == "torch." + str(want[path].dtype), path


def test_param_shapes_draw_nothing():
    """The shapes come from meta tensors: no generator state advances and
    the full 132B-parameter dbrx tree takes no memory."""
    import torch
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    shapes = build_model(ARCHS["dbrx-132b"]).param_shapes()
    assert sum(math.prod(s.shape) for _, s in tree_items(shapes)) > 1.3e11
    assert torch.equal(gen.get_state(), before)


def test_train_state_specs_mirror_the_reference():
    name = "deepseek-v2-lite-16b"
    ref = ref_train_state_specs(ref_build(REF_ARCHS[name]))
    port = train_state_specs(build_model(ARCHS[name]))
    assert port.step == P() and port.opt.step == P()
    for part in ("m", "v"):
        same_specs(getattr(port.opt, part), getattr(ref.opt, part))
    same_specs(port.params, ref.params)
    assert optimizer_specs({"w": P("data")}).m == {"w": P("data")}


# ---------------------------------------------------------------------------
# fix_sharding: the reference's named cases and a property against it
# ---------------------------------------------------------------------------

MESH_16 = FakeMesh({"data": 16, "model": 16})


@pytest.mark.parametrize("shape, spec, want", [
    ((64, 32), P("data", "model"), P("data", "model")),
    # kv=2 cannot take the 16-way model axis; seq (32768) absorbs it
    ((24, 128, 32768, 2, 64), P(None, "data", None, "model", None),
     P(None, "data", "model")),
    # 50280 % 16 != 0 -> model axis moves to the d dim (1024 % 256 == 0)
    ((50280, 1024), P("model", "data"), P(None, ("data", "model"))),
])
def test_fix_sharding_named_cases(shape, spec, want):
    assert fix_sharding(shape, spec, MESH_16) == want
    assert tuple(fix_sharding(shape, spec, MESH_16)) == tuple(
        ref_fix_sharding(shape, JP(*spec), MESH_16))


def test_fix_sharding_batch_one_dropped():
    got = fix_sharding((1, 524288, 64), P("data", None, "model"), MESH_16)
    # batch axis cannot shard a dim of size 1; moved to seq
    assert got[0] is None or got[0] == ()


def test_fix_sharding_axis_never_duplicated():
    got = fix_sharding((16, 16), P(("data", "model"), "model"), MESH_16)
    flat = [a for e in got if e is not None
            for a in ([e] if isinstance(e, str) else e)]
    assert len(flat) == len(set(flat))


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}
DIMS = st.sampled_from([1, 2, 3, 8, 14, 16, 24, 32, 64, 128, 896, 4096,
                        50280, 151936])


@st.composite
def shape_and_spec(draw, axes):
    shape = tuple(draw(st.lists(DIMS, min_size=1, max_size=5)))
    entries = []
    free = list(axes)
    for _ in range(draw(st.integers(0, len(shape)))):
        pick = draw(st.lists(st.sampled_from(free), max_size=2, unique=True)
                    ) if free else []
        free = [a for a in free if a not in pick]
        entries.append(None if not pick else
                       pick[0] if len(pick) == 1 else tuple(pick))
    return shape, entries


@pytest.mark.parametrize("mesh", sorted(MESHES))
@settings(max_examples=150, deadline=None)
@given(data=st.data())
def test_fix_sharding_property_against_the_reference(mesh, data):
    fake = FakeMesh(MESHES[mesh])
    shape, entries = data.draw(shape_and_spec(tuple(fake.shape)))
    got = fix_sharding(shape, P(*entries), fake)
    assert tuple(got) == tuple(ref_fix_sharding(shape, JP(*entries), fake))


@pytest.mark.parametrize("name", NAMES)
def test_fix_tree_of_the_params_equals_the_references(name):
    ref = ref_build(REF_ARCHS[name]).param_specs()
    port = build_model(ARCHS[name])
    shapes = dict(tree_items(port.param_shapes()))
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        fixed = dict(tree_items(fix_tree(port.param_shapes(),
                                         port.param_specs(), mesh)))
        fake = FakeMesh(mesh.shape)
        for path, spec in ref_items(ref).items():
            want = ref_fix_sharding(shapes[path].shape, spec, fake)
            assert tuple(fixed[path]) == tuple(want), (multi_pod, path)


# ---------------------------------------------------------------------------
# The production mesh and the cells' inputs
# ---------------------------------------------------------------------------

def test_production_meshes_are_h100_nodes():
    import torch
    one, two = (make_production_mesh(multi_pod=mp) for mp in (False, True))
    assert one.shape == {"data": 32, "model": 8} and one.size == 256
    assert two.shape == {"pod": 2, "data": 32, "model": 8}
    assert two.size == 512
    assert set(one.devices) == {torch.device("meta")}
    assert batch_axes(one) == ("data",)
    assert batch_axes(two) == ("pod", "data")


def test_input_specs_of_a_decode_cell():
    """qwen2-0.5b decode_32k on 2x32x8: the batch splits over (pod, data),
    the cache's kv-heads (2) cannot take the 8-way model axis, which moves
    to its sequence (split-KV decode)."""
    cfg = ARCHS["qwen2-0.5b"]
    mesh = make_production_mesh(multi_pod=True)
    specs = input_specs(cfg, get_shape("decode_32k"), mesh)
    token, spec = specs["token"]
    assert token.shape == (128, 1) and token.is_meta
    assert spec == P(("pod", "data"))
    cache, cache_specs = specs["cache"]
    k = cache["layers"]["k"]
    assert k.shape == (24, 128, 32768, 2, 64) and k.is_meta
    assert cache_specs["layers"]["k"] == P(None, ("pod", "data"), "model")
    train = input_specs(dataclasses.replace(cfg, input_mode="embeds"),
                        get_shape("train_4k"), make_production_mesh())
    assert train["inputs"][0].shape == (256, 4096, cfg.d_model)
    assert train["labels"][1] == P("data")
    assert np.dtype(str(train["labels"][0].dtype).split(".")[1]) == np.int64
