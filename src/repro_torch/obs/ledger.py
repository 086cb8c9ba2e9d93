"""The kernel launch ledger: first-class accounting of kernel launches.

Every public kernel wrapper in ``repro_torch.kernels.*.ops`` calls
:func:`record_launch` once per kernel launch — with the kernel's name,
grid, tile and an HBM bytes-moved estimate — under the same names and
``bytes_moved`` formulas as ``repro.obs.ledger``'s callers, so that the
two packages' ledgers can be compared record by record.  The names: the
FFT family (``fft-c2c``, ``fft-c2c-t``, ``fft-c2c-axis1``, ``fft-c2c-mul``,
``fft-r2c``, ``fft-r2c-t``, ``fft-c2r``, ``transpose``) and the pulsar
pipeline's ``dedisperse``, ``harmonic-sum-plane``, ``harmonic-sum`` and
``power-spectrum-stats``; and three the reference has no kernel for, the
long real plans' split and merge (``fft-r2c-split``, ``fft-c2r-merge``)
and the sift's select (``sift-select``).

Recording semantics differ from the reference on purpose.  The reference
records while ``jax.jit`` *traces* a wrapper, so a jitted executable
records once and its later runs replay the captured signature.  The port
runs eagerly: a wrapper records **once per call**, every call.  A capture
therefore counts real launches, and the process-wide signature store
(:meth:`LaunchLedger.signature`) simply keeps the first capture per key.

Recording is a no-op (one truthiness check) when no ledger is actively
capturing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from typing import Any, Iterable

__all__ = ["LaunchRecord", "LaunchLedger", "record_launch",
           "launches_digest"]


def _ints(t) -> tuple[int, ...]:
    if isinstance(t, int):
        return (int(t),)
    return tuple(int(v) for v in t)


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One kernel launch.

    ``grid``/``tile`` describe the CUDA launch: ``grid`` is the number of
    thread blocks and ``tile`` is (transforms per block, transform length)
    — not the reference's VMEM tile.  ``bytes_moved`` is the wrapper's HBM
    traffic estimate (inputs read + outputs written).
    """

    kernel: str                     # e.g. "fft-c2c-t"
    grid: tuple[int, ...] = ()      # thread blocks launched
    tile: tuple[int, ...] = ()      # work per block
    bytes_moved: int = 0            # HBM read+write estimate [bytes]
    shape: tuple[int, ...] = ()     # logical (batch, ...) problem shape

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "grid": list(self.grid),
                "tile": list(self.tile), "bytes_moved": self.bytes_moved,
                "shape": list(self.shape)}


#: Ledgers currently capturing (a stack; normally depth 0 or 1).
_ACTIVE: list["LaunchLedger"] = []

#: Process-wide launch signatures, keyed on capture key (first capture
#: that records anything wins).
_SIGNATURES: dict[Any, tuple[LaunchRecord, ...]] = {}


def record_launch(kernel: str, *, grid=(), tile=(), bytes_moved: int = 0,
                  shape=()) -> None:
    """Record one kernel launch into every actively-capturing ledger.

    Called by the kernel wrappers after the launch returned, so a launch
    that raised never records.  A no-op when nothing is capturing.
    """
    if not _ACTIVE:
        return
    rec = LaunchRecord(kernel=kernel, grid=_ints(grid), tile=_ints(tile),
                       bytes_moved=int(bytes_moved), shape=_ints(shape))
    # dict.fromkeys: a ledger nested inside its own capture records once.
    for ledger in dict.fromkeys(_ACTIVE):
        ledger._record(rec)


class LaunchLedger:
    """An append-only launch log plus per-key launch signatures."""

    def __init__(self) -> None:
        self.records: list[LaunchRecord] = []

    @contextlib.contextmanager
    def capture(self, key: Any = None):
        """Capture launches recorded in the body; yields this ledger.

        With ``key`` set, the first capture *in the process* that records
        anything becomes the key's launch signature.
        """
        mark = len(self.records)
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.remove(self)
            if key is not None and len(self.records) > mark:
                _SIGNATURES.setdefault(key, tuple(self.records[mark:]))

    def _record(self, rec: LaunchRecord) -> None:
        self.records.append(rec)

    def signature(self, key: Any) -> list[LaunchRecord]:
        """The launch signature captured for ``key`` ([] if never seen)."""
        return list(_SIGNATURES.get(key, ()))

    def counts(self, records: Iterable[LaunchRecord] | None = None
               ) -> dict[str, int]:
        """Launches per kernel name over ``records`` (default: all)."""
        out: dict[str, int] = {}
        for r in (self.records if records is None else records):
            out[r.kernel] = out.get(r.kernel, 0) + 1
        return dict(sorted(out.items()))

    def total_bytes(self) -> int:
        return sum(r.bytes_moved for r in self.records)

    def to_dicts(self) -> list[dict]:
        return [r.to_dict() for r in self.records]

    def digest(self) -> str:
        """blake2b over the canonical JSON of every record (reproducible
        across runs that record the same launches in the same order)."""
        payload = json.dumps(self.to_dicts(), sort_keys=True,
                             separators=(",", ":")).encode()
        return hashlib.blake2b(payload, digest_size=16).hexdigest()


def launches_digest(launch_lists: Iterable[Iterable[LaunchRecord]]) -> str:
    """blake2b over per-receipt launch signatures, in receipt order."""
    payload = json.dumps(
        [[rec.to_dict() for rec in launches] for launches in launch_lists],
        sort_keys=True, separators=(",", ":")).encode()
    return hashlib.blake2b(payload, digest_size=16).hexdigest()
