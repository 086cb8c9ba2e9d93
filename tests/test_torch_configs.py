"""The port's configs (``repro_torch.configs``) against the reference's:
every field of the ten architectures and of their ``reduced()`` configs,
the parameter counts, the shapes and cells, and the registry's errors."""
import dataclasses

import pytest

import repro.configs as ref
import repro_torch.configs as port

NAMES = sorted(ref.ARCHS)


def _fields(cfg) -> dict:
    """Every field, nested configs as dicts of their fields."""
    return dataclasses.asdict(cfg)


def test_the_registry_lists_the_same_ten_architectures():
    assert list(port.ARCHS) == list(ref.ARCHS)
    assert len(port.ARCHS) == 10


@pytest.mark.parametrize("name", NAMES)
def test_every_field_matches(name):
    assert _fields(port.get_arch(name)) == _fields(ref.get_arch(name))


@pytest.mark.parametrize("name", NAMES)
def test_reduced_matches(name):
    got, want = port.get_arch(name).reduced(), ref.get_arch(name).reduced()
    assert _fields(got) == _fields(want)
    assert got.resolved_head_dim == want.resolved_head_dim


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_parameter_counts_match(name, reduced):
    got, want = port.get_arch(name), ref.get_arch(name)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.resolved_head_dim == want.resolved_head_dim


def test_shapes_match():
    assert ({k: dataclasses.asdict(v) for k, v in port.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()})
    for name in NAMES:
        assert ([s.name for s in port.shapes_for(port.get_arch(name))]
                == [s.name for s in ref.shapes_for(ref.get_arch(name))])
        assert port.get_shape("decode_32k") == port.DECODE_32K


def test_all_cells_match():
    got = [(c.name, s.name) for c, s in port.all_cells()]
    want = [(c.name, s.name) for c, s in ref.all_cells()]
    assert got == want
    assert len(got) == 32                       # 8 x 3 + 2 x 4


@pytest.mark.parametrize("lookup", ["get_arch", "get_shape"])
def test_unknown_names_raise_the_same_error(lookup):
    with pytest.raises(KeyError) as want:
        getattr(ref, lookup)("no-such-thing")
    with pytest.raises(KeyError) as got:
        getattr(port, lookup)("no-such-thing")
    assert str(got.value) == str(want.value)


def test_fft_bench_is_still_exported():
    assert port.CONFIG == port.FFTBenchConfig()
    assert port.CONFIG.name == "fft-bench"
