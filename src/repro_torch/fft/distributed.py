"""Distributed FFTs over a device mesh (the counterpart of
``repro.fft.distributed``).

Two parallel regimes, as in the reference:

* **Batch parallel** (:func:`batch_parallel_fft`) — the paper's own setting:
  many independent transforms, the batch split over the ``data`` axis.  No
  collective at all (Sec. 2.3).

* **Pencil / four-step** (:func:`pencil_fft`) — one transform too long for
  a device: view N = n1 * n2, shard n1 across the ``model`` axis, and turn
  the four-step algorithm's transposes into :meth:`Mesh.all_to_all`.

**The mesh is single-controller**, as ``jax.make_mesh``'s is: one process
holds one shard on each device of a named grid (:class:`Mesh`), and the
collectives copy tensors between those devices.  Devices may repeat —
four slots of ``cuda:0`` are a mesh of four shards on one card, whose
all_to_all is an HBM-to-HBM copy of the same bytes — and on a node with
several cards the same copies go peer to peer.  A function that shards
over one axis puts shard p on the device at index p of that axis and
index 0 of every other axis (the reference replicates over the other
axes, which computes the same values).  :class:`ShardedTensor` stands in
for a sharded ``jax.Array``; its :meth:`~ShardedTensor.gather` for
``jax.device_get``.

Every local transform runs through the port's plans, so each shard
launches the port's kernels.  The pencil's first pass is ONE
``fft_c2c_axis1`` launch a shard (the column FFT with the shard's rows of
the f64-built four-step twiddle table in its epilogue), where the
reference swaps axes, transforms and multiplies; its second pass is
``fft_c2c`` on the rows.

The output of :func:`pencil_fft` is in *transposed* layout — element
``[k1, k2]`` of the local (n1_local, n2) block holds bin ``k2 * n1 + k1``
(FFTW's MPI transposed-output convention).  Use :func:`untranspose_ref`
on gathered results when validating.

The mesh keeps two byte counters, in two conventions:

* ``collective_bytes`` — what :meth:`Mesh.all_to_all` and
  :meth:`Mesh.ppermute` move between shards, per shard taking part (a
  chunk that stays on its own shard counts 0).
  :func:`pencil_exchange_bytes` is what the pencil's collectives move;
  :func:`pencil_collective_bytes` is the reference's analytic model,
  equal to it for C2C.
* ``collective_record`` — bytes by (kind, axis) of the training
  collectives :meth:`Mesh.all_gather`, :meth:`Mesh.reduce_scatter`,
  :meth:`Mesh.all_reduce` and :meth:`Mesh.send`
  (``collective-permute``), in the reference's HLO convention: the
  bytes of each result a collective makes on a slot, summed and averaged
  over the mesh's devices (a slot's own chunk counts).  That is what
  ``analysis.cost.collective_accounting`` prices a device; the sharded
  train step (``train.sharded``) is held to it.  Each runs over the line
  of one axis at fixed indices of the others (``at``; 0 where it names
  none), and :meth:`Mesh.line` gives the line's collectives that
  autograd differentiates (:class:`MeshLine`, tensor parallelism).

:class:`PlacedTensor` is a tensor placed over every axis of a mesh by a
partition spec (:func:`place`), the sharded train state's leaf on a mesh
with a model axis.

A training collective's sum runs in float32 (float64 for float64 parts)
whatever the parts' dtype, in slot order, so every slot gets the same
bits; its result comes back in the parts' dtype.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.fft.plan import (_four_step_twiddle, fft_column,
                                  plan_for_length, pow2_fft)


class Mesh:
    """A named grid of torch devices, held by one process.

    ``devices`` is the grid flattened row-major; ``shape`` maps each axis
    name to its size, as ``jax.sharding.Mesh.shape`` does.
    ``collective_bytes`` counts what this mesh's collectives moved
    between shards, per shard taking part.
    """

    def __init__(self, devices: Sequence[torch.device],
                 axis_sizes: Sequence[int], axis_names: Sequence[str]):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in axis_sizes)
        if (len(sizes) != len(self.axis_names)
                or len(set(self.axis_names)) != len(sizes)):
            raise ValueError(f"mesh shape {sizes} and axis names "
                             f"{self.axis_names} do not pair up")
        self.shape = dict(zip(self.axis_names, sizes))
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(
                f"a {tuple(self.shape.values())} mesh needs "
                f"{math.prod(self.shape.values())} devices, got "
                f"{len(self.devices)}")
        self.collective_bytes = 0.0
        self.collective_record: dict[tuple[str, str], float] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_devices(self, axis: str, at: dict[str, int] | None = None
                     ) -> list[torch.device]:
        """The devices of the line of ``axis`` at the indices ``at`` of the
        other axes (0 where ``at`` names none): index p of ``axis``."""
        return [self.devices[p] for p in self.line_slots(axis, at)]

    def line_slots(self, axis: str, at: dict[str, int] | None = None
                   ) -> list[int]:
        """The flat slot numbers (row-major over the mesh) of the line of
        ``axis`` at the indices ``at`` of the other axes."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r}; axes "
                           f"{self.axis_names}")
        return [self.slot_of({**(at or {}), axis: p})
                for p in range(self.shape[axis])]

    def index_of(self, slot: int) -> dict[str, int]:
        """The mesh position (an index an axis) of the flat slot number
        ``slot``."""
        index = {}
        for name in reversed(self.axis_names):
            slot, index[name] = divmod(slot, self.shape[name])
        return {name: index[name] for name in self.axis_names}

    def slot_of(self, index: dict[str, int]) -> int:
        """The flat slot number of the mesh position ``index`` (an index
        an axis; 0 for an axis it does not name)."""
        slot = 0
        for name in self.axis_names:
            i = index.get(name, 0)
            if not 0 <= i < self.shape[name]:
                raise IndexError(f"index {i} out of range for mesh axis "
                                 f"{name!r} of size {self.shape[name]}")
            slot = slot * self.shape[name] + i
        return slot

    def line(self, axis: str, at: dict[str, int] | None = None
             ) -> "MeshLine":
        """The line of ``axis`` at the indices ``at`` of the other axes,
        with collectives that autograd differentiates."""
        return MeshLine(self, axis, dict(at or {}))

    def unique_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def reset_collective_bytes(self) -> None:
        self.collective_bytes = 0.0

    def reset_collective_record(self) -> None:
        self.collective_record = {}

    def collective_totals(self) -> tuple[dict[str, float], dict[str, float]]:
        """The record as ``analysis.cost.collective_accounting`` returns
        its count: (bytes by kind, without zeros; bytes by axis, every
        axis)."""
        by_kind: dict[str, float] = {}
        by_axis = dict.fromkeys(self.axis_names, 0.0)
        for (kind, axis), nbytes in self.collective_record.items():
            by_kind[kind] = by_kind.get(kind, 0.0) + nbytes
            by_axis[axis] += nbytes
        return {k: v for k, v in by_kind.items() if v}, by_axis

    def _record(self, kind: str, axis: str, results) -> None:
        key = (kind, axis)
        self.collective_record[key] = self.collective_record.get(
            key, 0.0) + sum(_nbytes(r) for r in results) / self.size

    def _slots(self, parts: Sequence[torch.Tensor], axis: str,
               at: dict[str, int] | None = None) -> list[torch.device]:
        devices = self.axis_devices(axis, at)
        if len(parts) != len(devices):
            raise ValueError(f"{len(parts)} parts for the {len(devices)} "
                             f"slots of mesh axis {axis!r}")
        return devices

    def all_gather(self, shards: Sequence[torch.Tensor], dim: int, *,
                   axis: str, slot: int, at: dict[str, int] | None = None
                   ) -> torch.Tensor:
        """``jax.lax.all_gather(tiled=True)`` over the line of ``axis`` at
        ``at`` as one slot sees it: shard p lies on slot p; slot ``slot``
        (an index along the axis) gets the shards concatenated along
        ``dim``.  A single controller makes only the result it uses next,
        one replica's."""
        devices = self._slots(shards, axis, at)
        first = shards[0]
        dim %= first.dim()
        shape = list(first.shape)
        shape[dim] = sum(s.shape[dim] for s in shards)
        out = torch.empty(shape, dtype=first.dtype, device=devices[slot])
        at = 0
        for s in shards:
            out.narrow(dim, at, s.shape[dim]).copy_(s)
            at += s.shape[dim]
        self._record("all-gather", axis, [out])
        return out

    def reduce_scatter(self, parts: Sequence[torch.Tensor], dim: int, *,
                       axis: str, at: dict[str, int] | None = None
                       ) -> list[torch.Tensor]:
        """``jax.lax.psum_scatter(tiled=True)`` over the line of ``axis``
        at ``at``: part q lies on slot q; slot p gets chunk p (along
        ``dim``) of the parts' sum."""
        devices = self._slots(parts, axis, at)
        d = len(devices)
        first = parts[0]
        dim %= first.dim()
        if first.shape[dim] % d:
            raise ValueError(
                f"reduce_scatter: dim {dim} of size {first.shape[dim]} "
                f"does not split into {d} chunks")
        c = first.shape[dim] // d
        out = [_sum([q.narrow(dim, p * c, c) for q in parts], dev)
               for p, dev in enumerate(devices)]
        self._record("reduce-scatter", axis, out)
        return out

    def all_reduce(self, parts: Sequence[torch.Tensor], *, axis: str,
                   at: dict[str, int] | None = None, op: str = "sum"
                   ) -> list[torch.Tensor]:
        """``jax.lax.psum`` (``op="max"``: ``pmax``) over the line of
        ``axis`` at ``at``: part q lies on slot q; every slot gets the
        parts' sum (their largest values)."""
        devices = self._slots(parts, axis, at)
        if op == "sum":
            out = [_sum(parts, dev) for dev in devices]
        elif op == "max":
            top = functools.reduce(torch.maximum,
                                   [q.to(devices[0]) for q in parts])
            out = [top.to(dev, copy=True) for dev in devices]
        else:
            raise ValueError(f"all_reduce: unknown op {op!r}")
        self._record("all-reduce", axis, out)
        return out

    def send(self, x: torch.Tensor, *, axis: str, dst: int,
             at: dict[str, int] | None = None) -> torch.Tensor:
        """``jax.lax.ppermute`` of one pair on the line of ``axis`` at
        ``at``: ``x`` (on another slot of the line) copied to slot ``dst``;
        recorded under ``("collective-permute", axis)``."""
        out = x.to(self.axis_devices(axis, at)[dst], copy=True)
        self._record("collective-permute", axis, [out])
        return out

    def all_to_all(self, shards: Sequence[torch.Tensor], split_dim: int,
                   concat_dim: int) -> list[torch.Tensor]:
        """``jax.lax.all_to_all(tiled=True)`` over the shards' devices.

        out[p] is the concatenation along ``concat_dim``, over q, of chunk
        p (along ``split_dim``) of shard q, written on shard p's device.
        Every chunk is copied once, the diagonal one too (it changes
        place); the diagonal one moves no bytes between shards.  One
        shard is returned as it is.
        """
        d = len(shards)
        if d == 1:
            return list(shards)
        first = shards[0]
        split_dim %= first.dim()
        concat_dim %= first.dim()
        if first.shape[split_dim] % d:
            raise ValueError(
                f"all_to_all: dim {split_dim} of size "
                f"{first.shape[split_dim]} does not split into {d} chunks")
        c = first.shape[split_dim] // d
        shape = list(first.shape)
        shape[split_dim] = c
        k = shape[concat_dim]                   # a chunk's width there
        shape[concat_dim] = k * d
        chunk_bytes = first.numel() // d * first.element_size()
        out = []
        for p, dst in enumerate(shards):
            o = torch.empty(shape, dtype=first.dtype, device=dst.device)
            for q, src in enumerate(shards):
                o.narrow(concat_dim, q * k, k).copy_(
                    src.narrow(split_dim, p * c, c))
            out.append(o)
        self.collective_bytes += (d - 1) * chunk_bytes
        return out

    def ppermute(self, shards: Sequence[torch.Tensor],
                 perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
        """``jax.lax.ppermute``: shard ``src`` is copied to shard ``dst``'s
        device for each (src, dst) of ``perm``; a shard no pair targets
        gets zeros.  A pair (p, p) keeps its shard and moves nothing."""
        d = len(shards)
        if (len({src for src, _ in perm}) != len(perm)
                or len({dst for _, dst in perm}) != len(perm)):
            raise ValueError(f"ppermute: {list(perm)} repeats a source or "
                             "a destination")
        out: list[torch.Tensor | None] = [None] * d
        moved = 0
        for src, dst in perm:
            t = shards[src]
            if src == dst:
                out[dst] = t
                continue
            out[dst] = torch.empty(t.shape, dtype=t.dtype,
                                   device=shards[dst].device).copy_(t)
            moved += t.numel() * t.element_size()
        self.collective_bytes += moved / d
        return [o if o is not None else torch.zeros_like(s)
                for o, s in zip(out, shards)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sum(parts: Sequence[torch.Tensor], device: torch.device
         ) -> torch.Tensor:
    """The parts' sum in float32 (float64 parts: in float64), in order, on
    ``device``, in their dtype."""
    wide = torch.promote_types(parts[0].dtype, torch.float32)
    total = parts[0].to(device=device, dtype=wide, copy=True)
    for q in parts[1:]:
        total += q.to(device)
    return total.to(parts[0].dtype)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Sequence[torch.device] | None = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` named ``axis_names``.

    ``devices`` (flattened row-major; repeats allowed) defaults to every
    visible CUDA device, whose count must equal the mesh's size; with no
    card it raises — pass ``devices=[torch.device("cpu")] * n`` to build a
    mesh on the CPU explicitly.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "no CUDA device: a mesh is built on the card; pass "
                "devices=[torch.device('cpu')] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(devices, shape, axis_names)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A tensor split along ``dim`` over the mesh axis ``axis``: shard p
    lives on ``mesh.axis_devices(axis)[p]``."""

    shards: tuple[torch.Tensor, ...]
    mesh: Mesh
    axis: str
    dim: int

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.shards[0].shape)
        shape[self.dim] = sum(s.shape[self.dim] for s in self.shards)
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self) -> torch.Tensor:
        """The global tensor on the first shard's device (one copy of each
        shard)."""
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=self.shards[0].device)
        at = 0
        for s in self.shards:
            k = s.shape[self.dim]
            out.narrow(self.dim, at, k).copy_(s)
            at += k
        return out


def shard(x, mesh: Mesh, axis: str, dim: int) -> ShardedTensor:
    """Split ``x`` into equal pieces along ``dim``, piece p on device p of
    ``axis``.  A piece already on its device is a view of ``x``."""
    x = torch.as_tensor(x)
    dim %= x.dim()
    d = mesh.shape[axis]
    if x.shape[dim] % d:
        raise ValueError(
            f"dim {dim} of size {x.shape[dim]} does not divide over the "
            f"{d}-device mesh axis {axis!r}")
    c = x.shape[dim] // d
    return ShardedTensor(
        tuple(x.narrow(dim, p * c, c).to(dev)
              for p, dev in enumerate(mesh.axis_devices(axis))),
        mesh, axis, dim)


@dataclasses.dataclass(frozen=True, eq=False)
class ReplicatedTensor:
    """A tensor held whole on every slot of the mesh axis ``axis``: copy
    p on ``mesh.axis_devices(axis)[p]`` (a replicated leaf of a sharded
    train state)."""

    copies: tuple[torch.Tensor, ...]
    mesh: Mesh
    axis: str

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.copies[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.copies[0].dtype

    def gather(self) -> torch.Tensor:
        """The tensor (the first slot's copy)."""
        return self.copies[0]


def replicate(x, mesh: Mesh, axis: str) -> ReplicatedTensor:
    """``x`` on every slot of ``axis``; a copy already on its device is
    ``x`` itself."""
    x = torch.as_tensor(x)
    return ReplicatedTensor(tuple(x.to(dev) for dev in
                                  mesh.axis_devices(axis)), mesh, axis)


def _entries(spec, ndim: int) -> list[tuple[str, ...]]:
    """A partition spec's entry for each of ``ndim`` dims as a tuple of
    axis names, major first (``()``: not split)."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in entries]


def _block(shape, entries, mesh: Mesh, index: dict[str, int]
           ) -> tuple[slice, ...]:
    """The block of a tensor of ``shape`` split by ``entries`` that the
    mesh position ``index`` holds."""
    out = []
    for n, axes in zip(shape, entries):
        count, i = 1, 0
        for a in axes:
            count *= mesh.shape[a]
            i = i * mesh.shape[a] + index[a]
        if n % count:
            raise ValueError(f"a dim of size {n} does not split over the "
                             f"mesh axes {axes} ({count} slots)")
        c = n // count
        out.append(slice(i * c, (i + 1) * c))
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class PlacedTensor:
    """A tensor placed on every slot of a mesh by a partition spec
    (``spec``: an entry a dim, ``None``, an axis name or a tuple of names,
    major first, as ``jax.sharding.PartitionSpec``): slot p (row-major
    over the mesh) holds the block at its indices of the axes each dim
    splits over, and the slots that differ only along an axis the spec
    does not name hold copies.  A leaf of the sharded train state on a
    mesh with a model axis (``train.sharded``)."""

    shards: tuple[torch.Tensor, ...]
    mesh: Mesh
    spec: tuple

    @property
    def entries(self) -> list[tuple[str, ...]]:
        return _entries(self.spec, self.shards[0].dim())

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(n * math.prod(self.mesh.shape[a] for a in axes)
                     for n, axes in zip(self.shards[0].shape, self.entries))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self) -> torch.Tensor:
        """The global tensor on the first slot's device (one copy of each
        block)."""
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=self.shards[0].device)
        named = {a for axes in self.entries for a in axes}
        for p, s in enumerate(self.shards):
            index = self.mesh.index_of(p)
            if all(index[a] == 0 for a in index if a not in named):
                out[_block(self.shape, self.entries, self.mesh,
                           index)].copy_(s)
        return out


def place(x, mesh: Mesh, spec) -> PlacedTensor:
    """``x`` placed on ``mesh`` by ``spec``: slot p gets its block (a
    view of ``x`` where it is on the slot's device already)."""
    x = torch.as_tensor(x)
    entries = _entries(spec, x.dim())
    return PlacedTensor(tuple(
        x[_block(x.shape, entries, mesh, mesh.index_of(p))].to(dev)
        for p, dev in enumerate(mesh.devices)), mesh, tuple(spec))


class _AllReduce(torch.autograd.Function):
    """Partial sums on a line's slots -> their sum on every slot; the
    backward all-reduces the cotangents."""

    @staticmethod
    def forward(ctx, line: "MeshLine", *parts):
        ctx.line = line
        return tuple(line.mesh.all_reduce(parts, axis=line.axis,
                                          at=line.at))

    @staticmethod
    def backward(ctx, *grads):
        line = ctx.line
        return (None, *line.mesh.all_reduce(grads, axis=line.axis,
                                            at=line.at))


class _AllGather(torch.autograd.Function):
    """A block on each of a line's slots -> their concatenation along
    ``dim`` on every slot; the backward reduce-scatters the cotangents
    back to the blocks."""

    @staticmethod
    def forward(ctx, line: "MeshLine", dim: int, *blocks):
        ctx.line, ctx.dim = line, dim
        return tuple(line.mesh.all_gather(blocks, dim, axis=line.axis,
                                          slot=p, at=line.at)
                     for p in range(line.size))

    @staticmethod
    def backward(ctx, *grads):
        line = ctx.line
        return (None, None, *line.mesh.reduce_scatter(
            grads, ctx.dim, axis=line.axis, at=line.at))


class _Copy(torch.autograd.Function):
    """A replicated activation onto a line's slots (a copy on each slot's
    device, not recorded: the value is the replica's already); the
    backward sums the slots' cotangents (an all-reduce) onto ``x``."""

    @staticmethod
    def forward(ctx, line: "MeshLine", x):
        ctx.line, ctx.device = line, x.device
        return tuple(x.to(dev, copy=True) for dev in line.devices)

    @staticmethod
    def backward(ctx, *grads):
        line = ctx.line
        total = line.mesh.all_reduce(grads, axis=line.axis, at=line.at)[0]
        return None, total.to(ctx.device)


class MeshLine:
    """The line of one mesh axis at fixed indices of the others
    (:meth:`Mesh.line`): its slots' devices and the collectives of tensor
    parallelism over it, as ``torch.autograd.Function``s whose backward
    is the adjoint collective.  Each forward and backward is recorded on
    the mesh under its (kind, axis).  On a line of one slot each is the
    identity and records nothing."""

    def __init__(self, mesh: Mesh, axis: str, at: dict[str, int]):
        self.mesh, self.axis, self.at = mesh, axis, at
        self.devices = mesh.axis_devices(axis, at)

    @property
    def size(self) -> int:
        return len(self.devices)

    def all_reduce(self, parts: Sequence[torch.Tensor]
                   ) -> list[torch.Tensor]:
        """The parts' sum on every slot (float32 sum, the parts' dtype);
        backward: the all-reduce of the cotangents."""
        if self.size == 1:
            return list(parts)
        return list(_AllReduce.apply(self, *parts))

    def all_reduce_max(self, parts: Sequence[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """The parts' largest values on every slot, without a gradient."""
        if self.size == 1:
            return [q.detach() for q in parts]
        return self.mesh.all_reduce([q.detach() for q in parts],
                                    axis=self.axis, at=self.at, op="max")

    def all_gather(self, blocks: Sequence[torch.Tensor], dim: int
                   ) -> list[torch.Tensor]:
        """The blocks concatenated along ``dim`` on every slot; backward:
        the reduce-scatter of the cotangents."""
        if self.size == 1:
            return list(blocks)
        return list(_AllGather.apply(self, dim, *blocks))

    def copy(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` on every slot; backward: the sum of the slots'
        cotangents."""
        if self.size == 1:
            return [x.to(self.devices[0])]
        return list(_Copy.apply(self, x))


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading (batch) dimension up to ``rows``."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def batch_parallel_fft(x, mesh: Mesh, *, axis: str = "data",
                       fft_fn: Callable | None = None,
                       kind: str = "c2c") -> torch.Tensor:
    """Batched FFT with the batch dimension sharded over ``axis``.

    The batch is zero-padded to the next multiple of the axis size, each
    shard runs ``fft_fn`` on its device, and the result comes back sliced
    to the batch, gathered on the device of shard 0 — the serving layer
    coalesces requests into arbitrary batch sizes, so divisibility cannot
    be assumed.  Only the shards that hold padding are copied to pad them.

    ``fft_fn`` defaults to ``plan_for_length(n, kind)`` for (batch, n)
    input, and to the N-D plan graph ``plan_nd(shape[1:], kind)`` above
    rank 2; ``kind="r2c"`` routes real batches through the R2C plans.
    """
    x = torch.as_tensor(x)
    if fft_fn is None:
        if x.dim() > 2:
            from repro_torch.fft.plan_nd import plan_nd
            fft_fn = plan_nd(tuple(x.shape[1:]), kind)
        else:
            fft_fn = plan_for_length(x.shape[-1], kind)
    b = x.shape[0]
    devices = mesh.axis_devices(axis)
    c = -(-b // len(devices))
    outs = tuple(fft_fn(pad_rows(x[p * c:(p + 1) * c], c).to(dev))
                 for p, dev in enumerate(devices))
    y = ShardedTensor(outs, mesh, axis, 0).gather()
    return y[:b] if y.shape[0] != b else y


def _pencil_body(shards: Sequence[torch.Tensor], mesh: Mesh, n1: int,
                 n2: int) -> list[torch.Tensor]:
    """The four-step pencil on (..., n1/D, n2) shards; returns the
    transposed-layout (..., n1/D, n2) shards."""
    c = n2 // len(shards)
    # ---- transpose 1: gather full n1, scatter n2 ------------------------
    v = mesh.all_to_all(shards, split_dim=-1, concat_dim=-2)  # (.., n1, c)
    # ---- FFT over n1 with the twiddle exp(-2*pi*i*j*k/n), j global -------
    # one fft_c2c_axis1 launch: output [k, j] times table[p*c + j, k]
    for p, s in enumerate(v):
        tw = _four_step_twiddle(n1, n2, s.device,
                                inverse=False)[p * c:(p + 1) * c]
        v[p] = fft_column(s, twiddle=tw)
    # ---- transpose 2: back to n1-sharded --------------------------------
    v = mesh.all_to_all(v, split_dim=-2, concat_dim=-1)    # (.., n1/D, n2)
    # ---- FFT over n2 (rows are contiguous) -------------------------------
    for p, s in enumerate(v):
        v[p] = pow2_fft(s)
    return v


@functools.lru_cache(maxsize=None)
def _split_factors(n1: int, n2p: int, device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The split's factors (1 - i*w)/2 and (1 + i*w)/2, w = w_N^k =
    exp(-i*pi*k/M) at k = k2*n1 + k1: (n1, n2p) complex64 tables built in
    float64, once per device."""
    k = np.arange(n2p)[None, :] * n1 + np.arange(n1)[:, None]
    iw = 1j * np.exp(-1j * np.pi * k / (n1 * n2p))
    return tuple(torch.from_numpy(f).to(device=device, dtype=torch.complex64)
                 for f in (0.5 * (1 - iw), 0.5 * (1 + iw)))


def _pencil_split_body(z: Sequence[torch.Tensor], mesh: Mesh, n1: int,
                       n2p: int) -> list[torch.Tensor]:
    """Distributed Hermitian split of a packed-pencil result.

    ``z``: the transposed-layout C2C pencil transform of the *packed*
    real signal — (..., n1/D, n2p) shards, element [k1, k2] holding
    Z[k2*n1 + k1] of the length M = n1*n2p packed transform.  The split
    needs Z[(M-k) mod M]: a global index reversal, realised as local flips
    plus a shard-reversing ``ppermute`` and a one-row global roll — no
    gather.
    """
    d = len(z)
    length = z[0].shape[-2]
    # ---- G[k1] = Z row (n1 - k1) mod n1: reverse + roll by one; the k2
    # flip of the mirror rides the same copy ------------------------------
    rev = mesh.ppermute([s.flip(-2, -1) for s in z],
                        [(q, d - 1 - q) for q in range(d)])
    last = mesh.ppermute([r[..., -1:, :] for r in rev],
                         [(q, (q + 1) % d) for q in range(d)])
    out = []
    for p, zt in enumerate(z):
        g = torch.cat([last[p], rev[p][..., :-1, :]], dim=-2)
        rev[p] = None
        # ---- k2 mirror: the extra roll on the k1 == 0 row ---------------
        if p == 0:
            g[..., 0, :] = torch.roll(g[..., 0, :], 1, dims=-1)
        # ---- split: X[k] = (Z+Zm)/2 - i/2 * w^k * (Z-Zm), with
        # Zm = conj(G) = Z[(M - k) mod M]*, as Z*(1-iw)/2 + Zm*(1+iw)/2 ---
        a, b = (f[p * length:(p + 1) * length]
                for f in _split_factors(n1, n2p, zt.device))
        y = zt.new_empty((*zt.shape[:-1], n2p + 1))
        x = y[..., :n2p]
        torch.mul(zt, a, out=x)
        x.addcmul_(g.conj(), b)
        del g
        # ---- Nyquist bin X[M] = Re(Z[0]) - Im(Z[0]), shard 0 row 0 ------
        y[..., n2p] = 0
        if p == 0:
            z0 = zt[..., 0, 0]
            y[..., 0, n2p] = z0.real - z0.imag
        out.append(y)
    return out


def _packed(s: torch.Tensor) -> torch.Tensor:
    """Adjacent reals of the last axis as one complex64 value, a view
    where the float32 layout allows it."""
    v = (s.real if s.is_complex() else s).to(torch.float32)
    v = v.reshape(*v.shape[:-1], v.shape[-1] // 2, 2)
    if (v.stride(-1) != 1 or v.storage_offset() % 2
            or any(st % 2 for st in v.stride()[:-1])):
        v = v.contiguous()
    return torch.view_as_complex(v)


def pencil_fft(x, mesh: Mesh, *, n1: int, n2: int, axis: str = "model",
               kind: str = "c2c") -> ShardedTensor:
    """Four-step FFT of length n1*n2 with n1 sharded over ``axis``.

    ``x``: (batch, n1, n2), a :class:`ShardedTensor` split along n1 over
    ``axis``, or a tensor that is split so.

    ``kind="c2c"`` (default) returns the transform in transposed layout
    (see module docstring).  ``kind="r2c"`` takes REAL input and runs the
    packed real algorithm end to end distributed: adjacent reals pack
    into a length-M = n1*n2/2 complex pencil (HALF the FFT work, HBM
    traffic and all_to_all payload of the complex path), then the
    Hermitian split runs sharded — the spectral mirror Z[(M-k) mod M] is
    one shard-reversing ppermute plus a one-row roll, not a gather.  The
    result is (batch, n1/D-sharded n1, n2/2+1): element [k1, k2] holds
    half-spectrum bin X[k2*n1 + k1] for k2 < n2/2 (packed transposed
    layout), and the final column holds the Nyquist bin X[M] in row
    k1 = 0 (zeros elsewhere).  :func:`assemble_rfft_pencil` reorders a
    gathered result into ``torch.fft.rfft`` natural order for validation.
    ``n2/2`` must divide evenly over the mesh axis.
    """
    if not isinstance(x, ShardedTensor):
        x = shard(x, mesh, axis, -2)
    elif (x.mesh is not mesh or x.axis != axis
          or x.dim != len(x.shape) - 2):
        raise ValueError(
            f"pencil_fft: input sharded along dim {x.dim} over axis "
            f"{x.axis!r}, expected dim {len(x.shape) - 2} over {axis!r} "
            "of this mesh")
    if tuple(x.shape[-2:]) != (n1, n2):
        raise ValueError(f"pencil_fft: input shape {tuple(x.shape)} does "
                         f"not end in (n1, n2) = ({n1}, {n2})")
    if kind == "r2c":
        d = mesh.shape[axis]
        if n2 % 2:
            raise ValueError(
                f"pencil r2c packs adjacent reals: n2 must be even, got {n2}")
        if (n2 // 2) % d:
            raise ValueError(
                f"pencil r2c needs n2/2 ({n2 // 2}) divisible by the "
                f"{d}-device mesh axis {axis!r}")
        z = _pencil_body([_packed(s) for s in x.shards], mesh, n1, n2 // 2)
        y = _pencil_split_body(z, mesh, n1, n2 // 2)
        return ShardedTensor(tuple(y), mesh, axis, x.dim)
    if kind != "c2c":
        raise ValueError(f"unknown pencil transform kind {kind!r}")
    return ShardedTensor(tuple(_pencil_body(x.shards, mesh, n1, n2)),
                         mesh, axis, x.dim)


def untranspose_ref(y, n1: int, n2: int) -> torch.Tensor:
    """Reorder a gathered transposed-layout result into natural order."""
    y = torch.as_tensor(y)
    # y[k1, k2] holds bin k2*n1+k1  ->  natural[k] with k = k2*n1+k1
    return y.transpose(-1, -2).reshape(*y.shape[:-2], n1 * n2)


def assemble_rfft_pencil(y, n1: int, n2: int) -> torch.Tensor:
    """Reconstruct ``torch.fft.rfft`` natural order from a gathered r2c
    pencil result (validation helper), on ``y``'s device.

    ``y``: (..., n1, n2/2+1) from ``pencil_fft(..., kind="r2c")`` —
    element [k1, k2] is half-spectrum bin X[k2*n1 + k1] for k2 < n2/2;
    the final column carries the Nyquist bin X[n1*n2/2] in row 0.
    """
    y = torch.as_tensor(y)
    k = torch.arange(n1 * n2 // 2, device=y.device)
    body = y[..., k % n1, k // n1]
    nyq = y[..., 0:1, n2 // 2]
    return torch.cat([body, nyq], dim=-1)


def pencil_collective_bytes(batch: int, n1: int, n2: int,
                            n_devices: int, elem_bytes: int = 8,
                            kind: str = "c2c") -> float:
    """Analytic all_to_all traffic per device for the DVFS/roofline model
    (the reference's formula, float for float).

    C2C: two all_to_alls; each moves the device's local block (minus the
    diagonal chunk that stays put): (D-1)/D of batch*n1*n2/D elements.
    R2C: the same two all_to_alls on the HALF-length packed transform,
    plus the Hermitian-split mirror ppermute (one half-size local block)
    — ~70% of the c2c traffic on top of half the FLOPs and HBM passes.
    """
    local = batch * n1 * n2 / n_devices * elem_bytes
    if kind == "r2c":
        packed = local / 2.0
        return (2.0 * packed + packed) * (n_devices - 1) / n_devices
    return 2.0 * local * (n_devices - 1) / n_devices


def pencil_exchange_bytes(batch: int, n1: int, n2: int, n_devices: int,
                          elem_bytes: int = 8, kind: str = "c2c") -> float:
    """Bytes the pencil's collectives move between shards, per shard: what
    a mesh's ``collective_bytes`` counts over one :func:`pencil_fft`.

    C2C: :func:`pencil_collective_bytes` exactly.  R2C: the two packed
    all_to_alls as there, but the mirror ppermute moves the whole packed
    block of every shard whose partner is another (all of them at even
    D, where the model's (D-1)/D keeps one block in place), and the
    one-row roll moves a (batch, 1, n2/2) row from every shard.
    """
    d = n_devices
    local = batch * n1 * n2 / d * elem_bytes
    if kind != "r2c":
        return 2.0 * local * (d - 1) / d
    packed = local / 2.0
    if d == 1:
        return 0.0
    mirror = packed * (d - d % 2) / d
    row = batch * (n2 // 2) * elem_bytes
    return 2.0 * packed * (d - 1) / d + mirror + row
