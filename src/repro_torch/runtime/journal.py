"""Crash-consistent write-ahead request journal (append-only JSONL; the
counterpart of ``repro.runtime.journal``, with the same record lines,
checksums and segment files, so either package reads the other's journal).

Barbosa et al. (2016) make *continuity of operations* a first-class SKA
requirement: an edge pipeline is expected to survive years of unattended
operation, which means surviving its own process dying mid-wave.  The
serving layer's in-memory state (pending requests, receipts, breaker and
watchdog health) evaporates with the process; this module is the durable
record it is rebuilt from.

Design — a classic write-ahead log, sized for the chaos harness's 10^6
request streams:

  records     one JSON object per line.  Every record carries a
              monotonically increasing sequence number ``seq`` (the
              journal's identity space — request ids are process-local
              and reset across restarts, journal seqs never do), a type
              tag and a per-record blake2b checksum over
              ``"{seq}:{type}:{canonical-json(data)}"``.
  segments    the log is split into ``seg-NNNNNN.jsonl`` files of at most
              ``segment_records`` records.  Rotation is atomic and
              fsync'd: the outgoing segment is flushed + fsync'd before
              the next one opens, so every *closed* segment is durable
              in full.  Each process incarnation starts a fresh segment
              (closed segments are never appended to again).
  replay      segments are read in order and records are validated
              (checksum, JSON shape, seq continuity).  The first invalid
              record — a torn tail from a crash mid-write, a corrupted
              checksum, a truncated segment — stops replay at the last
              valid record with a structured warning; later records are
              *not* trusted (a corrupt record's successors are garbage
              until proven otherwise).  No exception: a torn tail is the
              expected crash signature, not an error.  Opening for write
              also *repairs*: the torn segment is truncated at the last
              valid record and later segments are quarantined, so the
              new incarnation's appends are reachable by every future
              replay instead of being stranded behind the bad byte.
  snapshots   ``write_snapshot`` persists a JSON state dict atomically
              (tmp file + fsync + rename) next to the segments, stamped
              with the journal seq it covers; ``load_snapshot`` returns
              the newest checksum-valid one.

Record types (the request lifecycle the serving layer logs):

  open      a process incarnation opened the journal
  admit     a request entered the service (write-ahead: logged at
            submit).  The record's ``seq`` is the request's durable
            identity (``FFTRequest.jseq``).
  assign    a coalesced batch was formed (batch id + member seqs)
  served    a request terminated in a served receipt
  shed      a request terminated in a shed receipt

Exactly-once receipts follow from the admit/terminal pairing: a request
whose admit record has no terminal record by replay time was in flight
when the process died and is re-enqueued on recovery; one with a
terminal record is *replayed* (bit-identical status/reason/rung),
never re-executed.  See ``repro_torch.serving.recovery``.

``sync`` policy: ``"rotate"`` (default) fsyncs on rotation, snapshot and
close — the contract the module name promises, at ~10^6-records/minute
append rates; ``"always"`` additionally fsyncs every append (tests,
small control-plane journals).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import time
from typing import Callable, Iterator

from repro_torch.obs.log import get_logger

__all__ = ["ADMIT", "ASSIGN", "SERVED", "SHED", "OPEN", "TERMINAL_TYPES",
           "JournalRecord", "ReplayStats", "RequestJournal",
           "read_segment_records", "read_journal", "process_incarnation"]

# Record types.
OPEN = "open"
ADMIT = "admit"
ASSIGN = "assign"
SERVED = "served"
SHED = "shed"

#: Types that terminate a request's lifecycle (exactly one per request).
TERMINAL_TYPES = (SERVED, SHED)

_TYPES = (OPEN, ADMIT, ASSIGN, SERVED, SHED)

_SEGMENT_RE = re.compile(r"^seg-(\d{6})\.jsonl$")
_SNAPSHOT_RE = re.compile(r"^snap-(\d+)\.json$")

_DIGEST_SIZE = 8                 # 16 hex chars per record checksum


def _canonical(data: dict) -> str:
    return json.dumps(data, sort_keys=True, separators=(",", ":"))


def _checksum(seq: int, rtype: str, data: dict) -> str:
    payload = f"{seq}:{rtype}:{_canonical(data)}".encode()
    return hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).hexdigest()


_PROCESS_INCARNATION: str | None = None


def process_incarnation() -> str:
    """A memoised id for THIS process incarnation (benchmark envelopes).

    Journal-attached services stamp receipts with the journal's own
    deterministic incarnation counter; artifacts emitted by journal-less
    processes (most ``BENCH_*.json``) carry this process-level id so any
    two artifacts can be told apart by which incarnation produced them.
    """
    global _PROCESS_INCARNATION
    if _PROCESS_INCARNATION is None:
        h = hashlib.blake2b(
            f"{os.getpid()}:{time.time_ns()}".encode(), digest_size=6)
        _PROCESS_INCARNATION = f"proc-{h.hexdigest()}"
    return _PROCESS_INCARNATION


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One validated journal record."""

    seq: int
    type: str
    data: dict

    def line(self) -> str:
        return _canonical({"seq": self.seq, "type": self.type,
                           "data": self.data,
                           "c": _checksum(self.seq, self.type, self.data)})


@dataclasses.dataclass
class ReplayStats:
    """What replaying the on-disk journal found."""

    segments: int = 0            # segment files visited
    records: int = 0             # checksum-valid records replayed
    invalid: int = 0             # records rejected (torn/corrupt); replay
    #                              stops at the first one, so this is 0 or 1
    stopped_at_seq: int = -1     # seq of the last valid record (-1: none)
    torn_segment: str | None = None   # file the invalid record was in


def read_segment_records(path: str) -> Iterator[tuple[str, int]]:
    """Yield (raw_line, byte_offset) for each newline-terminated line.

    A final line without a trailing newline is still yielded — whether it
    is a torn tail is the *checksum's* call, not the framing's (a crash
    can tear mid-record but can also happen to stop exactly at a record
    boundary).
    """
    offset = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            yield line, offset
            offset += len(line.encode("utf-8", errors="replace"))


def _parse_record(line: str) -> JournalRecord | None:
    """Validate one raw line; None for anything not checksum-perfect."""
    try:
        obj = json.loads(line)
    except (ValueError, TypeError):
        return None
    if not isinstance(obj, dict):
        return None
    seq, rtype, data, c = (obj.get("seq"), obj.get("type"),
                           obj.get("data"), obj.get("c"))
    if (not isinstance(seq, int) or rtype not in _TYPES
            or not isinstance(data, dict) or not isinstance(c, str)):
        return None
    if _checksum(seq, rtype, data) != c:
        return None
    return JournalRecord(seq=seq, type=rtype, data=data)


def read_journal(path: str, *, log: Callable[..., None] | None = None,
                 sink: Callable[["JournalRecord"], None] | None = None,
                 ) -> tuple[list["JournalRecord"], ReplayStats]:
    """Read-only replay of a journal directory (audit, no side effects).

    Same validation as opening a :class:`RequestJournal` — checksum,
    shape, strict seq continuity, stop at the first bad record with a
    structured warning — but appends nothing: no OPEN record, no new
    segment, no incarnation minted, no repair.  This is what end-of-run
    audits use to prove the exactly-once contract from the durable log
    alone.

    With a ``sink``, each validated record is streamed to the callback
    and the returned list is empty — a 10^6-request journal audits in
    O(1) record memory this way.
    """
    warn = log if log is not None else get_logger("journal").warning
    records: list[JournalRecord] = []
    stats = ReplayStats()
    names = sorted(n for n in os.listdir(path) if _SEGMENT_RE.match(n))
    expect = 0
    for name in names:
        stats.segments += 1
        for line, _ in read_segment_records(os.path.join(path, name)):
            rec = _parse_record(line)
            if rec is None or rec.seq != expect:
                stats.invalid += 1
                stats.torn_segment = name
                warn("journal-torn-record", segment=name,
                     expected_seq=expect, valid_records=stats.records,
                     reason=("checksum-or-framing" if rec is None
                             else "sequence-gap"))
                return records, stats
            if sink is not None:
                sink(rec)
            else:
                records.append(rec)
            stats.records += 1
            stats.stopped_at_seq = rec.seq
            expect = rec.seq + 1
    return records, stats


class RequestJournal:
    """An append-only, checksummed, segment-rotated request journal.

    Opening a journal directory replays whatever is already there (see
    :attr:`recovered` / :attr:`replay_stats`), continues the sequence
    numbering after the last valid record, and starts a *new* segment
    for this incarnation.  ``incarnation`` is ``"i<N>"`` where N counts
    journal opens — deterministic, so a re-run of the same crash
    schedule mints the same incarnation ids.
    """

    def __init__(self, path: str, *, segment_records: int = 100_000,
                 sync: str = "rotate",
                 log: Callable[..., None] | None = None,
                 record_sink: Callable[[JournalRecord], None] | None = None):
        if segment_records < 1:
            raise ValueError(
                f"segment_records must be >= 1, got {segment_records}")
        if sync not in ("rotate", "always"):
            raise ValueError(f"sync must be 'rotate' or 'always', "
                             f"got {sync!r}")
        self.path = path
        self.segment_records = segment_records
        self.sync = sync
        self._warn = log if log is not None else get_logger("journal").warning
        # With a ``record_sink`` replay streams each validated record to
        # the callback and retains nothing (O(1) journal memory at any
        # history length — the 10^6-request harness recovers this way);
        # without one, validated records collect in ``recovered``.
        self._sink = record_sink
        os.makedirs(path, exist_ok=True)
        self.recovered: list[JournalRecord] = []
        self.replay_stats = ReplayStats()
        self._opens = 0
        self._replay()
        self._next_seq = self.replay_stats.stopped_at_seq + 1
        self.incarnation = f"i{self._opens + 1}"
        self._segment_index = self._last_segment_index() + 1
        self._records_in_segment = 0
        self._file = None
        self._open_segment()
        self.append(OPEN, {"incarnation": self.incarnation})

    # ------------------------------------------------------------------ #
    # segments on disk
    # ------------------------------------------------------------------ #

    def _segment_files(self) -> list[str]:
        names = [n for n in os.listdir(self.path) if _SEGMENT_RE.match(n)]
        return sorted(names)

    def _last_segment_index(self) -> int:
        names = self._segment_files()
        if not names:
            return -1
        return int(_SEGMENT_RE.match(names[-1]).group(1))

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.path, f"seg-{index:06d}.jsonl")

    def _open_segment(self) -> None:
        # Line-buffered: every record reaches the kernel as soon as it is
        # written, so a *process* crash (kill -9) loses nothing buffered
        # in userspace — fsync (rotate/flush/close) is what protects
        # against *machine* crashes.
        self._file = open(self._segment_path(self._segment_index), "a",
                          encoding="utf-8", buffering=1)
        self._records_in_segment = 0

    def _close_segment(self, *, fsync: bool = True) -> None:
        if self._file is None:
            return
        self._file.flush()
        if fsync:
            os.fsync(self._file.fileno())
        self._file.close()
        self._file = None

    def rotate(self) -> None:
        """Atomically seal the active segment and open the next one.

        The outgoing segment is flushed and fsync'd *before* the new one
        opens — after rotate() returns, every record written so far is
        durable regardless of what happens to the new segment.
        """
        self._close_segment(fsync=True)
        self._segment_index += 1
        self._open_segment()

    # ------------------------------------------------------------------ #
    # append path
    # ------------------------------------------------------------------ #

    def append(self, rtype: str, data: dict) -> int:
        """Append one record; returns its sequence number."""
        if rtype not in _TYPES:
            raise ValueError(f"unknown record type {rtype!r}; have {_TYPES}")
        if self._file is None:
            raise ValueError("journal is closed")
        if self._records_in_segment >= self.segment_records:
            self.rotate()
        rec = JournalRecord(seq=self._next_seq, type=rtype, data=data)
        self._file.write(rec.line() + "\n")
        if self.sync == "always":
            self._file.flush()
            os.fsync(self._file.fileno())
        self._next_seq += 1
        self._records_in_segment += 1
        return rec.seq

    def flush(self) -> None:
        """Flush + fsync the active segment (durability barrier)."""
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self) -> None:
        self._close_segment(fsync=True)

    def crash(self) -> None:
        """Simulate the owning process dying (chaos-harness hook).

        The active segment is abandoned WITHOUT a durability barrier —
        no fsync, no rotation seal — exactly the on-disk state a
        ``kill -9`` leaves behind with line-buffered writes.  The
        journal object is unusable afterwards; recovery happens by
        opening the directory again.
        """
        if self._file is not None:
            self._file.close()
            self._file = None

    @property
    def next_seq(self) -> int:
        return self._next_seq

    # ------------------------------------------------------------------ #
    # replay
    # ------------------------------------------------------------------ #

    def _replay(self) -> None:
        """Validate every on-disk record, stopping at the first bad one.

        Seq continuity is part of validity: a record whose seq is not
        exactly (last seq + 1) means an earlier record went missing (a
        truncated segment, an out-of-order copy) and everything from the
        gap on is untrusted.

        Repair: the torn segment is truncated at the last valid record
        and any LATER segments are quarantined (renamed out of the
        replay set) — without this, the next incarnation would append
        perfectly good records *behind* the torn tail and every future
        replay would stop at the same bad byte, never reaching them.
        The bad bytes are never silently resurrected; truncation +
        quarantine is logged.
        """
        stats = self.replay_stats
        expect = 0
        names = self._segment_files()
        for idx, name in enumerate(names):
            seg = os.path.join(self.path, name)
            stats.segments += 1
            for line, offset in read_segment_records(seg):
                rec = _parse_record(line)
                if rec is None or rec.seq != expect:
                    stats.invalid += 1
                    stats.torn_segment = name
                    self._warn(
                        "journal-torn-record",
                        segment=name, expected_seq=expect,
                        valid_records=stats.records,
                        reason=("checksum-or-framing" if rec is None
                                else "sequence-gap"))
                    self._repair(name, offset, names[idx + 1:])
                    return
                if rec.type == OPEN:
                    self._opens += 1
                if self._sink is not None:
                    self._sink(rec)
                else:
                    self.recovered.append(rec)
                stats.records += 1
                stats.stopped_at_seq = rec.seq
                expect = rec.seq + 1
            if stats.invalid:
                return

    def _repair(self, torn: str, offset: int, later: list[str]) -> None:
        """Truncate the torn segment; quarantine everything after it."""
        seg = os.path.join(self.path, torn)
        with open(seg, "r+b") as f:
            f.truncate(offset)
            f.flush()
            os.fsync(f.fileno())
        self._warn("journal-truncated", segment=torn, at_byte=offset)
        for name in later:
            src = os.path.join(self.path, name)
            os.replace(src, src + ".quarantine")
            self._warn("journal-segment-quarantined", segment=name)

    # ------------------------------------------------------------------ #
    # snapshots
    # ------------------------------------------------------------------ #

    def write_snapshot(self, state: dict) -> str:
        """Atomically persist a JSON state snapshot covering seqs < now.

        The journal is fsync'd first (a snapshot must never be *ahead* of
        the durable log it summarises), then the snapshot is written to a
        temp file, fsync'd and renamed into place — a crash at any point
        leaves either the old snapshot set or the complete new one.
        """
        self.flush()
        seq = self._next_seq
        body = {"seq": seq, "incarnation": self.incarnation, "state": state}
        payload = _canonical(body)
        doc = _canonical({
            "body": body,
            "c": hashlib.blake2b(payload.encode(),
                                 digest_size=_DIGEST_SIZE).hexdigest()})
        final = os.path.join(self.path, f"snap-{seq}.json")
        tmp = final + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(doc)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final

    def load_snapshot(self) -> dict | None:
        """The newest checksum-valid snapshot body, or None.

        Returns ``{"seq": ..., "incarnation": ..., "state": {...}}``.
        Corrupt snapshot files are skipped with a warning — the journal
        alone is always sufficient to recover, a snapshot only shortcuts
        state reconstruction.
        """
        names = [(int(_SNAPSHOT_RE.match(n).group(1)), n)
                 for n in os.listdir(self.path) if _SNAPSHOT_RE.match(n)]
        for _, name in sorted(names, reverse=True):
            try:
                with open(os.path.join(self.path, name),
                          encoding="utf-8") as f:
                    doc = json.loads(f.read())
                body = doc["body"]
                want = doc["c"]
            except (ValueError, TypeError, KeyError, OSError):
                self._warn("journal-snapshot-corrupt", snapshot=name)
                continue
            got = hashlib.blake2b(_canonical(body).encode(),
                                  digest_size=_DIGEST_SIZE).hexdigest()
            if got != want:
                self._warn("journal-snapshot-corrupt", snapshot=name)
                continue
            return body
        return None

    # ------------------------------------------------------------------ #
    # context manager sugar
    # ------------------------------------------------------------------ #

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
