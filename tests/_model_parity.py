"""Shared checks of the port's model zoo against the reference's, one
reduced float32 architecture at a time: the reference's parameters are
drawn once (``jax.random.PRNGKey(0)``) and carried across with
``params_from_reference``; inputs are drawn with numpy from a seed.

Tolerances: logits and caches within 1e-4 of the reference's largest
|value|, the MoE aux loss within 1e-5.  The test files
``test_torch_models_*.py`` subclass :class:`ArchParity` with a
module-scoped ``arch`` fixture (:func:`load_arch`) over their
architectures, so that ``--dist loadfile`` spreads them over the
workers.

Training (``test_torch_train_*.py``, :class:`TrainParity`): the loss
within 1e-5 of the reference's, each gradient leaf within 1e-4 of its
largest |value| (``jax.value_and_grad`` of the reference's loss), the
moments after one step within 1e-4, the parameters after two steps
within the reference's own ``rtol=2e-2, atol=2e-3``
(``tests/test_runtime.py``); the reference's run is made once an
architecture in a process (:attr:`Arch.ref_train`)."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import build_model as ref_build
from repro.models.common import chunked_cross_entropy as ref_chunked_ce
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.runtime.checkpoint import CheckpointManager as RefCheckpoints
from repro.train.step import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.launch.serve import grow_cache
from repro_torch.models import (build_model, params_from_reference,
                                params_to_reference)
from repro_torch.models.api import family_module
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime.checkpoint import (CheckpointManager,
                                            _flatten_with_paths)
from repro_torch.train.step import (loss_fn, make_train_step,
                                    state_from_reference, state_to_reference)

BATCH, SEQ = 2, 32
#: Decode = forward: prefill DEC_SEQ - 1 tokens, decode the last one.
DEC_SEQ = 16
RTOL = 1e-4
AUX_ATOL = 1e-5
#: Training: batch, sequence, the train step's aux weight, tolerances.
TRAIN_BATCH, TRAIN_SEQ = 2, 16
AUX_WEIGHT = 0.01
LOSS_RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 2e-2, 2e-3


class Arch:
    """One reduced architecture in both packages, with the reference's
    parameters carried across."""

    def __init__(self, name: str):
        self.name = name
        self.ref_cfg = REF_ARCHS[name].reduced()
        self.cfg = ARCHS[name].reduced()
        self.ref = ref_build(self.ref_cfg)
        self.model = build_model(self.cfg)
        self.ref_params = self.ref.init(jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.ref_params)
        self.params = params_from_reference(self.np_params, self.cfg, "cpu")

    def inputs(self, seed: int, batch: int = BATCH, seq: int = SEQ):
        rng = np.random.default_rng(seed)
        if self.cfg.input_mode == "embeds":
            return rng.standard_normal(
                (batch, seq, self.cfg.d_model)).astype(np.float32)
        return rng.integers(0, self.cfg.vocab, (batch, seq))

    def train_batch(self, seed: int = 11, batch: int = TRAIN_BATCH):
        """(inputs, labels) of one training batch."""
        labels = np.random.default_rng(seed + 1).integers(
            0, self.cfg.vocab, (batch, TRAIN_SEQ))
        return self.inputs(seed, batch, TRAIN_SEQ), labels

    def ref_state(self):
        """The reference's initial train state on its parameters."""
        return RefTrainState(params=self.ref_params,
                             opt=ref_adamw_init(self.ref_params),
                             step=jnp.zeros((), jnp.int32))

    @functools.cached_property
    def ref_train(self) -> dict:
        """The reference's loss and gradients on :meth:`train_batch`, and
        the states and metrics after one and two train steps."""
        inp, labels = (jnp.asarray(a) for a in self.train_batch())

        def ref_loss(params):
            hidden, aux = self.ref.forward_hidden(params, inp)
            ce = ref_chunked_ce(lambda h: self.ref.unembed(params, h),
                                hidden, labels)
            return ce + AUX_WEIGHT * aux

        loss, grads = jax.jit(jax.value_and_grad(ref_loss))(self.ref_params)
        step = jax.jit(ref_make_train_step(self.ref))
        s1, m1 = step(self.ref_state(), inp, labels)
        s2, m2 = step(s1, inp, labels)
        return {"loss": loss, "grads": grads, "s1": s1, "m1": m1, "s2": s2,
                "m2": m2}

    def port_state(self):
        """The reference's initial train state carried to the CPU."""
        return state_from_reference(jax.tree.map(np.asarray,
                                                 self.ref_state()), "cpu")

    def port_batch(self, seed: int = 11, batch: int = TRAIN_BATCH):
        return tuple(torch.from_numpy(a) for a in self.train_batch(seed,
                                                                   batch))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for a module's tests: the reduced models'
    ops are small, and the suite runs several workers on the cores, so
    torch's own thread pool only makes their threads contend (on an
    8-core CPU under six workers a 30-step training loop took 74.5 s,
    against 0.85 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def load_arch(name: str) -> Arch:
    """One :class:`Arch` a name in a test process."""
    return Arch(name)


def close(got, want, rel: float = RTOL) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, err
    return err


def ref_paths(tree) -> list[str]:
    """The reference pytree's leaf paths, joined by ``/``."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append("/".join(
            str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
            for k in path))
    return out


def close_trees(got, want, rel: float = RTOL) -> None:
    """Same leaf paths (the reference's flatten order) and leaves."""
    flat = _flatten_with_paths(got)
    assert [p for p, _ in flat] == ref_paths(want)
    for (_, g), w in zip(flat, jax.tree.leaves(want)):
        close(g, w, rel)


def pad_seq(tree, spec_short, spec_long, n: int):
    """The reference's cache padded by ``n`` zero slots on the axes where
    the port's two cache specs differ (its sequence axes)."""
    flat_s = [s for _, s in _flatten_with_paths(spec_short)]
    flat_l = [s for _, s in _flatten_with_paths(spec_long)]
    leaves, treedef = jax.tree.flatten(tree)
    out = []
    for a, s, l in zip(leaves, flat_s, flat_l):
        pad = [(0, n if m != k else 0) for m, k in zip(s.shape, l.shape)]
        out.append(jnp.pad(a, pad))
    return jax.tree.unflatten(treedef, out)


def no_drop(cfg):
    """``cfg`` with a MoE capacity factor at which no expert overflows:
    capacity ``int(Tg * K / E * cf)`` is then at least 2 Tg - 1."""
    if cfg.moe is None:
        return cfg
    cf = 2.0 * cfg.moe.n_experts / cfg.moe.top_k
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


class ArchParity:
    """The checks, run for the ``arch`` fixture (an :class:`Arch`)."""

    def test_forward(self, arch):
        inp = arch.inputs(1)
        want, want_aux = arch.ref.forward(arch.ref_params, jnp.asarray(inp))
        got, aux = arch.model.forward(arch.params, torch.from_numpy(inp))
        assert got.dtype == torch.float32
        close(got, want)
        assert abs(float(aux) - float(want_aux)) <= AUX_ATOL

    def test_prefill_logits_and_cache(self, arch):
        inp = arch.inputs(2)
        want, want_cache = arch.ref.prefill(arch.ref_params, jnp.asarray(inp))
        got, cache = arch.model.prefill(arch.params, torch.from_numpy(inp))
        close(got, want)
        close_trees(cache, want_cache)

    def test_decode_logits_and_cache(self, arch):
        """One decode step from the reference's prefilled cache, grown by
        one slot on its sequence axes; the input cache is left as it is."""
        inp = arch.inputs(3)
        _, cache = arch.ref.prefill(arch.ref_params, jnp.asarray(inp))
        cache = pad_seq(cache, arch.model.cache_shapes(BATCH, SEQ),
                        arch.model.cache_shapes(BATCH, SEQ + 1), 1)
        tok = arch.inputs(4, seq=1)
        want, want_cache = arch.ref.decode(arch.ref_params, cache,
                                           jnp.asarray(tok))
        port_cache = to_torch(cache)
        got, new_cache = arch.model.decode(arch.params, port_cache,
                                           torch.from_numpy(tok))
        close(got, want)
        close_trees(new_cache, want_cache)
        close_trees(port_cache, cache, 0.0)

    def test_cache_shapes(self, arch):
        for batch, seq in ((BATCH, SEQ), (3, 7)):
            got = _flatten_with_paths(arch.model.cache_shapes(batch, seq))
            want = arch.ref.cache_shapes(batch, seq)
            assert [p for p, _ in got] == ref_paths(want)
            assert ([(tuple(s.shape), str(s.dtype).split(".")[-1])
                     for _, s in got]
                    == [(tuple(s.shape), s.dtype.name)
                        for s in jax.tree.leaves(want)])

    def test_prefilled_cache_matches_cache_shapes(self, arch):
        _, cache = arch.model.prefill(arch.params,
                                      torch.from_numpy(arch.inputs(5)))
        got = [(tuple(t.shape), t.dtype) for _, t in
               _flatten_with_paths(cache)]
        want = [(s.shape, s.dtype) for _, s in _flatten_with_paths(
            arch.model.cache_shapes(BATCH, SEQ))]
        assert got == want

    def test_weight_round_trip_is_bit_identical(self, arch):
        back = params_to_reference(arch.params)
        assert ref_paths(back) == ref_paths(arch.np_params)
        for a, b in zip(jax.tree.leaves(back),
                        jax.tree.leaves(arch.np_params)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    def test_state_dict_keys_are_the_reference_paths(self, arch):
        keys = sorted(arch.params.state_dict())
        assert keys == sorted(p.replace("/", ".")
                              for p in ref_paths(arch.np_params))
        assert type(arch.params).impl is family_module(arch.cfg)

    def test_module_methods_match_the_model_functions(self, arch):
        inp = torch.from_numpy(arch.inputs(6, seq=8))
        logits, _ = arch.params(inp)
        torch.testing.assert_close(
            logits, arch.model.forward(arch.params, inp)[0], rtol=0, atol=0)
        torch.testing.assert_close(
            arch.params.prefill(inp)[0],
            arch.model.prefill(arch.params, inp)[0], rtol=0, atol=0)

    def test_decode_matches_forward(self, arch):
        """The reference's ``TestDecodeConsistency``: prefill
        DEC_SEQ - 1 tokens, grow the cache by one slot, decode the last
        token; its logits equal ``forward``'s at that position.

        A MoE model runs at a capacity factor that drops no token
        (:func:`no_drop`): under capacity, ``forward`` may drop the last
        token's (token, expert) pairs, which its one-token group in
        decode never drops, in the reference as in the port."""
        model = build_model(no_drop(arch.cfg))
        inp = torch.from_numpy(arch.inputs(7, batch=1, seq=DEC_SEQ))
        full, _ = model.forward(arch.params, inp)
        _, cache = model.prefill(arch.params, inp[:, :DEC_SEQ - 1])
        cache = grow_cache(model, cache, 1, DEC_SEQ - 1, 1)
        dec, _ = model.decode(arch.params, cache, inp[:, DEC_SEQ - 1:])
        close(dec[0, 0], full[0, DEC_SEQ - 1])

    def test_checkpoints_restore_across_the_packages(self, arch, tmp_path):
        ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
        RefCheckpoints(ref_dir).save(3, arch.ref_params)
        restored = CheckpointManager(ref_dir).restore(arch.params.tree())
        for a, b in zip(jax.tree.leaves(params_to_reference(restored)),
                        jax.tree.leaves(arch.np_params)):
            np.testing.assert_array_equal(a, b)
        CheckpointManager(port_dir).save(4, arch.params.tree())
        assert os.path.isdir(os.path.join(port_dir, "step_00000004"))
        back = RefCheckpoints(port_dir).restore(arch.ref_params)
        for a, b in zip(jax.tree.leaves(back),
                        jax.tree.leaves(arch.np_params)):
            np.testing.assert_array_equal(np.asarray(a), b)



def flat(tree) -> list[np.ndarray]:
    """A port tree's leaves (tensors or numpy arrays) as numpy arrays, in
    the reference's flatten order."""
    return [t.detach().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for _, t in _flatten_with_paths(tree)]


def close_or_zero(got, want, rel: float = RTOL) -> None:
    """:func:`close`, or both all zero (a leaf the loss does not reach)."""
    if np.abs(np.asarray(want)).max() == 0:
        np.testing.assert_array_equal(got, 0)
    else:
        close(got, want, rel)


def assert_same_training(one, sharded, m_one, m_sharded, step: int) -> None:
    """One unsharded and one gathered sharded train state after ``step``
    steps from one state and batch, within TrainParity's tolerances: the
    loss within 1e-5 relative, the grad norm within 1e-4, the same lr; at
    step 1 (lr 0) the parameters unchanged and the moments within 1e-4
    of a leaf's largest |value|; later the parameters and moments within
    ``STEP_RTOL``, ``STEP_ATOL``."""
    close(m_sharded["loss"], m_one["loss"], LOSS_RTOL)
    close(m_sharded["grad_norm"], m_one["grad_norm"])
    assert float(m_sharded["lr"]) == float(m_one["lr"])
    assert int(sharded.step) == int(sharded.opt.step) == step
    if step == 1:
        for a, b in zip(flat(sharded.params), flat(one.params)):
            np.testing.assert_array_equal(a, b)
        for part in ("m", "v"):
            for a, b in zip(flat(getattr(sharded.opt, part)),
                            flat(getattr(one.opt, part))):
                close_or_zero(a, b)
        return
    for got, want in ((sharded.params, one.params),
                      (sharded.opt.m, one.opt.m), (sharded.opt.v, one.opt.v)):
        for a, b in zip(flat(got), flat(want)):
            np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)


class TrainParity:
    """The training checks, run for the ``arch`` fixture (an
    :class:`Arch`)."""

    def test_loss_and_gradients_match_the_reference(self, arch):
        want = arch.ref_train
        leaves = tree_map(lambda t: t.detach().requires_grad_(),
                          arch.port_state().params)
        loss = loss_fn(arch.model, leaves, *arch.port_batch(),
                       aux_weight=AUX_WEIGHT)
        params = tree_leaves(leaves)
        grads = iter(torch.autograd.grad(loss, params, allow_unused=True))
        grads = tree_map(lambda p: next(grads), leaves)
        loss = loss.detach()
        assert abs(float(loss) - float(want["loss"])) <= (
            LOSS_RTOL * abs(float(want["loss"])))
        got = flat(tree_map(lambda g: 0.0 if g is None else g, grads))
        assert len(got) == len(jax.tree.leaves(want["grads"]))
        for g, w in zip(got, jax.tree.leaves(want["grads"])):
            close_or_zero(g, w)

    def test_first_step_moments_match_and_params_stay(self, arch):
        """At step 0 the schedule's lr is 0: the parameters are unchanged
        and the moments hold the clipped gradient."""
        want = arch.ref_train
        state, metrics = make_train_step(arch.model)(arch.port_state(),
                                                     *arch.port_batch())
        assert int(state.step) == int(state.opt.step) == 1
        assert float(metrics["lr"]) == 0.0
        for a, b in zip(flat(state.params), jax.tree.leaves(arch.np_params)):
            np.testing.assert_array_equal(a, b)
        for moment in ("m", "v"):
            for g, w in zip(flat(getattr(state.opt, moment)),
                            jax.tree.leaves(getattr(want["s1"].opt,
                                                    moment))):
                close_or_zero(g, w)
        close(metrics["grad_norm"], want["m1"]["grad_norm"])
        close(metrics["loss"], want["m1"]["loss"], LOSS_RTOL)

    def test_two_steps_match_the_reference(self, arch):
        want = arch.ref_train
        step = make_train_step(arch.model)
        inp, labels = arch.port_batch()
        state, _ = step(arch.port_state(), inp, labels)
        state, metrics = step(state, inp, labels)
        for key in ("loss", "grad_norm", "lr"):
            close(metrics[key], want["m2"][key])
        for got, ref in ((state.params, want["s2"].params),
                         (state.opt.m, want["s2"].opt.m),
                         (state.opt.v, want["s2"].opt.v)):
            for a, b in zip(flat(got), jax.tree.leaves(ref)):
                np.testing.assert_allclose(a, np.asarray(b),
                                           rtol=STEP_RTOL, atol=STEP_ATOL)
        assert int(state.step) == int(want["s2"].step) == 2

    def test_state_round_trip_is_bit_identical(self, arch):
        ref = jax.tree.map(np.asarray, arch.ref_train["s1"])
        back = state_to_reference(state_from_reference(ref, "cpu"))
        assert [p for p, _ in _flatten_with_paths(back)] == ref_paths(ref)
        for a, b in zip(flat(back), jax.tree.leaves(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
