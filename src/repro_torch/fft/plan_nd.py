"""N-D plan-graph FFT execution engine — transpose-free multi-dim plans.

The counterpart of ``repro.fft.plan_nd``: an (axis-lengths, kind) spec
compiles into a **plan graph**, a short sequence of batched kernel passes
where the hand-off transpose between axes rides the FFT pass as its
transposed write (``fft_c2c_t``, ``fft_r2c_t``), and only axes that
cannot fuse (non-pow2 / Bluestein, long four-step, tiny r2c) get an
explicit tiled-transpose node (``transpose``).

Node vocabulary (each node = one batched device pass unless noted):

  fft_t       fused C2C FFT + transposed write      1 HBM pass
  rfft_t      fused R2C + transposed write          1 HBM pass
  fft1d       1-D routed plan on the last axis      plan.passes HBM passes
  transpose   tiled last-two-axes transpose         1 HBM pass

Execution model: the k transform axes are kept trailing; every fused pass
views the tensor as (B, R, C) with C the current last axis, transforms C
and writes (B, C, R) — a cyclic rotation of the transform block.  After k
passes every axis has been transformed *and* the original order is
restored, so a pow2 2-D FFT costs exactly 2 passes and a pow2 3-D FFT 3.

The nodes, ``passes``, ``chain_passes``, ``stages`` and ``out_shape`` are
the reference's.  The 1-D case degenerates to
:func:`repro_torch.fft.plan.plan_with_config`, so the service routes
every transform, of any rank, through this one entry point.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.fft import plan as _plan_mod
from repro_torch.fft.plan import MAX_KERNEL_N, FFTPlan, plan_with_config
from repro_torch.fft.radix import is_pow2
from repro_torch.fft.stockham import _as_tensor
from repro_torch.tune.config import KernelConfig
from repro_torch.tune.context import plan_config as _tuned_plan_config


@dataclasses.dataclass(frozen=True)
class PassNode:
    """One node of the plan graph: a single batched device pass."""

    op: str                     # "fft_t" | "rfft_t" | "fft1d" | "transpose"
    n: int = 0                  # transform length along the processed axis
    kind: str = "c2c"           # transform kind of this pass
    hbm_passes: int = 1         # HBM read+write round trips of the batch
    algorithm: str = "fused"    # 1-D algorithm for fft1d nodes
    stages: int = 0             # butterfly stages the pass runs in shared
    #                             memory


@dataclasses.dataclass(frozen=True)
class NDPlan:
    """A compiled N-D plan: node sequence + analytic pass accounting.

    ``passes`` is the plan graph's total HBM round trips; ``chain_passes``
    is what the per-axis ``movedim`` chain would have paid for the same
    spec.
    """

    shape: tuple[int, ...]      # transform-axes lengths, in axis order
    kind: str                   # "c2c" | "r2c"
    nodes: tuple[PassNode, ...]
    passes: int
    chain_passes: int
    stages: int                 # total butterfly stages across all passes
    out_shape: tuple[int, ...]  # transform-axes lengths of the output
    fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, x) -> torch.Tensor:
        return self.fn(x)

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    @property
    def algorithm(self) -> str:
        return "plan-graph" if len(self.shape) > 1 else self.nodes[0].algorithm


def _fusable_c2c(n: int) -> bool:
    return is_pow2(n) and 1 < n <= MAX_KERNEL_N


def _fusable_r2c(n: int) -> bool:
    return is_pow2(n) and 4 <= n and n // 2 <= MAX_KERNEL_N


def _axis_kind(kind: str, is_last_axis: bool) -> str:
    return "r2c" if (kind == "r2c" and is_last_axis) else "c2c"


def plan_nd(shape: tuple[int, ...], kind: str = "c2c") -> NDPlan:
    """Compile (and memoise) the plan graph for transform-axes ``shape``.

    ``kind="r2c"`` runs R2C on the last axis and C2C on the rest (the
    numpy ``rfftn`` convention).  Transform axes must be the trailing axes
    of the operand, in order; :mod:`repro_torch.fft.multidim` normalises
    arbitrary ``axes=`` arguments before calling in.  The active tuning
    context (if any) supplies the kernel config for the whole graph.
    """
    shape = tuple(shape)
    return _plan_nd(shape, kind, _tuned_plan_config(shape, kind))


def plan_nd_with_config(shape: tuple[int, ...], kind: str = "c2c",
                        config: KernelConfig | None = None) -> NDPlan:
    """The plan graph for an *explicit* config, bypassing the tuning
    context — ``config=None`` is the pure heuristic graph."""
    if config is not None and config.is_heuristic:
        config = None
    return _plan_nd(tuple(shape), kind, config)


@functools.lru_cache(maxsize=None)
def _plan_nd(shape: tuple[int, ...], kind: str,
             config: KernelConfig | None = None) -> NDPlan:
    if kind not in ("c2c", "r2c"):
        raise ValueError(f"unknown N-D transform kind {kind!r}")
    if not shape or any(n < 1 for n in shape):
        raise ValueError(f"bad transform shape {shape!r}")
    if len(shape) == 1:
        return _plan_1d(shape, kind, config)

    nodes: list[PassNode] = []
    chain = 0
    # Axes are processed last-first; each fused pass rotates the transform
    # block one step right, so after k passes the order is restored.
    for step, axis in enumerate(reversed(range(len(shape)))):
        na = shape[axis]
        akind = _axis_kind(kind, axis == len(shape) - 1)
        plan1 = plan_with_config(na, akind, config) if na > 1 else None
        # What the per-axis movedim chain paid: the 1-D plan's passes,
        # plus a movedim there and back for every non-trailing axis.
        chain += (plan1.passes if plan1 else 1) + (0 if step == 0 else 2)
        if na == 1:
            # A length-1 axis transforms to itself; only the rotation is
            # left, and the data may still be real (an r2c last axis).
            nodes.append(PassNode("transpose", n=1, kind=akind))
            continue
        if akind == "r2c" and _fusable_r2c(na):
            nodes.append(PassNode("rfft_t", n=na, kind="r2c",
                                  stages=plan1.stages))
        elif akind == "c2c" and _fusable_c2c(na):
            nodes.append(PassNode("fft_t", n=na, kind="c2c",
                                  stages=plan1.stages))
        else:
            # Non-fusable axis: run the routed 1-D plan in place, then
            # rotate with an explicit tiled transpose so the cycle holds.
            nodes.append(PassNode("fft1d", n=na, kind=akind,
                                  hbm_passes=plan1.passes,
                                  algorithm=plan1.algorithm,
                                  stages=plan1.stages))
            nodes.append(PassNode("transpose", n=na, kind=akind))

    out_shape = tuple(
        n // 2 + 1 if (kind == "r2c" and i == len(shape) - 1 and n > 1)
        else n
        for i, n in enumerate(shape))
    node_t = tuple(nodes)
    return NDPlan(
        shape=shape, kind=kind, nodes=node_t,
        passes=sum(nd.hbm_passes for nd in node_t),
        chain_passes=chain,
        stages=sum(nd.stages for nd in node_t),
        out_shape=out_shape,
        fn=functools.partial(_run_graph, shape=shape, nodes=node_t,
                             config=config),
    )


def _plan_1d(shape: tuple[int, ...], kind: str,
             config: KernelConfig | None = None) -> NDPlan:
    """Rank-1 spec: wrap the 1-D planner as a single-node graph."""
    (n,) = shape
    plan1: FFTPlan = plan_with_config(n, kind, config)
    node = PassNode("fft1d", n=n, kind=kind, hbm_passes=plan1.passes,
                    algorithm=plan1.algorithm, stages=plan1.stages)
    out = (n // 2 + 1 if kind == "r2c" and n > 1 else n,)
    return NDPlan(shape=shape, kind=kind, nodes=(node,),
                  passes=plan1.passes, chain_passes=plan1.passes,
                  stages=plan1.stages, out_shape=out, fn=plan1.fn)


def _run_graph(x, *, shape: tuple[int, ...], nodes: tuple[PassNode, ...],
               config: KernelConfig | None = None) -> torch.Tensor:
    """Execute a compiled node sequence on ``x`` (transform axes trailing).

    The node executors are the routed pass primitives of
    :mod:`repro_torch.fft.plan`, which read the monkeypatchable kernel
    hooks at call time.
    """
    x = _as_tensor(x)
    k = len(shape)
    if tuple(x.shape[-k:]) != shape:
        raise ValueError(f"operand trailing axes {tuple(x.shape[-k:])} != "
                         f"plan shape {shape}")
    lead = x.shape[:-k]
    cur = list(shape)
    b = math.prod(lead)
    for node in nodes:
        r = math.prod(cur[:-1])
        c = cur[-1]
        if node.op == "fft_t":
            x = _plan_mod.fft_transposed(x.reshape(b, r, c), config=config)
            cur = [c] + cur[:-1]
        elif node.op == "rfft_t":
            x = _plan_mod.rfft_transposed(x.reshape(b, r, c), config)
            cur = [c // 2 + 1] + cur[:-1]
        elif node.op == "fft1d":
            x = plan_with_config(c, node.kind, config)(x.reshape(b, r, c))
            cur = cur[:-1] + [x.shape[-1]]
        elif node.op == "transpose":
            x = _plan_mod.tiled_transpose(x.reshape(b, r, c))
            cur = [c] + cur[:-1]
        else:
            raise AssertionError(f"unknown node op {node.op!r}")
    return x.reshape(*lead, *cur)


def nd_pass_summary(shape: tuple[int, ...], kind: str = "c2c"
                    ) -> tuple[int, int, int]:
    """(plan passes, per-axis-chain passes, total stages) for a spec.

    The analytic cost model (``repro_torch.core.workloads.fft_workload``)
    calls this instead of building execution closures itself.
    """
    plan = plan_nd(tuple(shape), kind)
    return plan.passes, plan.chain_passes, plan.stages
