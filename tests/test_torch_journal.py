"""The port's write-ahead request journal (``repro_torch.runtime.journal``):
the claims of ``tests/test_journal.py`` — checksummed append, segment
rotation, torn-write recovery (truncate mid-record, segment boundary,
corrupt checksum), repair + quarantine, snapshots — and parity with
``repro.runtime.journal``: the same appends give byte-identical segment
files in both packages, and each package reads the other's segments and
snapshots."""
import json
import os

import pytest

import repro.runtime.journal as ref_journal
import repro_torch.runtime.journal as port_journal
from repro_torch.runtime.journal import (ADMIT, ASSIGN, OPEN, SERVED, SHED,
                                         JournalRecord, RequestJournal,
                                         process_incarnation, read_journal,
                                         read_segment_records)


class LogSpy:
    """Captures structured warnings the journal emits."""

    def __init__(self):
        self.events = []

    def __call__(self, event, **kw):
        self.events.append((event, kw))

    def names(self):
        return [e for e, _ in self.events]


def seg_files(path):
    return sorted(n for n in os.listdir(path)
                  if n.startswith("seg-") and n.endswith(".jsonl"))


def fill(journal, n, start=0):
    return [journal.append(ADMIT, {"payload_ref": start + i})
            for i in range(n)]


# ---------------------------------------------------------------------------
# append / replay round trip
# ---------------------------------------------------------------------------

def test_append_replay_roundtrip(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path) as j:
        assert j.incarnation == "i1"
        seqs = fill(j, 5)
    j2 = RequestJournal(path)
    assert j2.incarnation == "i2"
    assert j2.replay_stats.invalid == 0
    # 5 admits + the first incarnation's OPEN record.
    types = [r.type for r in j2.recovered]
    assert types == [OPEN] + [ADMIT] * 5
    assert [r.seq for r in j2.recovered] == [0] + seqs
    assert [r.data["payload_ref"] for r in j2.recovered[1:]] == list(range(5))
    # Seq numbering continues after the last valid record (no reuse).
    assert j2.append(ADMIT, {"payload_ref": 99}) == seqs[-1] + 2  # +OPEN
    j2.close()


def test_append_rejects_unknown_type_and_closed_journal(tmp_path):
    j = RequestJournal(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="unknown record type"):
        j.append("bogus", {})
    j.close()
    with pytest.raises(ValueError, match="closed"):
        j.append(ADMIT, {})


def test_constructor_validation(tmp_path):
    with pytest.raises(ValueError, match="segment_records"):
        RequestJournal(str(tmp_path / "a"), segment_records=0)
    with pytest.raises(ValueError, match="sync"):
        RequestJournal(str(tmp_path / "b"), sync="sometimes")


def test_crash_keeps_line_buffered_records(tmp_path):
    # crash() abandons the fd with no fsync — the kill -9 signature.
    # Line buffering means a *process* crash still loses nothing.
    path = str(tmp_path / "j")
    j = RequestJournal(path)
    fill(j, 3)
    j.crash()
    records, stats = read_journal(path)
    assert stats.invalid == 0
    assert sum(1 for r in records if r.type == ADMIT) == 3


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

def test_segment_rotation_caps_segment_size(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path, segment_records=3) as j:
        fill(j, 8)                       # 9 records with the OPEN
    names = seg_files(path)
    assert len(names) == 3
    for name in names:
        n = sum(1 for _ in read_segment_records(os.path.join(path, name)))
        assert n <= 3
    _, stats = read_journal(path)
    assert stats.records == 9 and stats.invalid == 0


def test_each_incarnation_opens_fresh_segment(tmp_path):
    path = str(tmp_path / "j")
    RequestJournal(path).close()
    RequestJournal(path).close()
    j = RequestJournal(path)
    assert j.incarnation == "i3"
    assert len(seg_files(path)) == 3
    j.close()


def test_incarnations_deterministic_across_reruns(tmp_path):
    for run in range(2):
        path = str(tmp_path / f"j{run}")
        ids = []
        for _ in range(3):
            j = RequestJournal(path)
            ids.append(j.incarnation)
            j.close()
        assert ids == ["i1", "i2", "i3"]


# ---------------------------------------------------------------------------
# torn-write recovery (satellite: mid-record, boundary, bad checksum)
# ---------------------------------------------------------------------------

def test_truncate_mid_record_stops_at_last_valid(tmp_path):
    path = str(tmp_path / "j")
    j = RequestJournal(path)
    fill(j, 4)
    j.crash()
    seg = os.path.join(path, seg_files(path)[-1])
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 7)             # tear the last record mid-line
    spy = LogSpy()
    j2 = RequestJournal(path, log=spy)
    assert [r.data.get("payload_ref") for r in j2.recovered
            if r.type == ADMIT] == [0, 1, 2]     # last admit lost, rest kept
    assert j2.replay_stats.invalid == 1
    assert "journal-torn-record" in spy.names()
    assert "journal-truncated" in spy.names()
    j2.close()


def test_truncation_at_record_boundary_is_clean_loss(tmp_path):
    # A crash can happen to stop exactly at a newline: no invalid record,
    # just fewer of them — the un-fsynced tail simply never happened.
    path = str(tmp_path / "j")
    j = RequestJournal(path)
    fill(j, 4)
    j.crash()
    seg = os.path.join(path, seg_files(path)[-1])
    lines = open(seg, "rb").read().splitlines(keepends=True)
    with open(seg, "wb") as f:
        f.writelines(lines[:-1])
    spy = LogSpy()
    j2 = RequestJournal(path, log=spy)
    assert j2.replay_stats.invalid == 0
    assert spy.names() == []
    assert sum(1 for r in j2.recovered if r.type == ADMIT) == 3
    j2.close()


def test_corrupt_checksum_stops_replay_without_exception(tmp_path):
    path = str(tmp_path / "j")
    j = RequestJournal(path)
    fill(j, 5)
    j.close()
    seg_name = seg_files(path)[-1]
    seg = os.path.join(path, seg_name)
    lines = open(seg, "r", encoding="utf-8").read().splitlines()
    obj = json.loads(lines[3])
    obj["data"]["payload_ref"] = 999     # tamper without re-checksumming
    lines[3] = json.dumps(obj)
    with open(seg, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    spy = LogSpy()
    j2 = RequestJournal(path, log=spy)   # no exception
    assert j2.replay_stats.invalid == 1
    assert j2.replay_stats.torn_segment == seg_name
    names = spy.names()
    assert "journal-torn-record" in names and "journal-truncated" in names
    # The tampered record and everything after it is gone — never
    # resurrected with a wrong payload.
    refs = [r.data["payload_ref"] for r in j2.recovered if r.type == ADMIT]
    assert refs == [0, 1]
    j2.close()


def test_sequence_gap_between_segments_detected(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path, segment_records=3) as j:
        fill(j, 8)
    names = seg_files(path)
    os.remove(os.path.join(path, names[1]))      # lose a middle segment
    spy = LogSpy()
    j2 = RequestJournal(path, log=spy)
    assert j2.replay_stats.invalid == 1
    ev = dict(self_ev for self_ev in spy.events)["journal-torn-record"]
    assert ev["reason"] == "sequence-gap"
    # Replay stopped at the last record of the first surviving segment.
    assert j2.replay_stats.stopped_at_seq == 2
    j2.close()


def test_repair_quarantines_later_segments_and_unstrands_appends(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path, segment_records=3) as j:
        fill(j, 8)
    # Corrupt a record in the FIRST segment: without repair, every
    # future replay would stop at this byte and appends made after it
    # would be stranded forever.
    first = os.path.join(path, seg_files(path)[0])
    lines = open(first, "r", encoding="utf-8").read().splitlines()
    lines[2] = lines[2][:-3] + 'x"}'     # second admit (line 0 is OPEN)
    with open(first, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    spy = LogSpy()
    j2 = RequestJournal(path, segment_records=3, log=spy)
    assert spy.names().count("journal-segment-quarantined") == 2
    quarantined = [n for n in os.listdir(path)
                   if n.endswith(".quarantine")]
    assert len(quarantined) == 2
    fill(j2, 2)
    j2.close()
    # The journal is whole again: a clean audit reaches the new records.
    records, stats = read_journal(path)
    assert stats.invalid == 0
    assert sum(1 for r in records if r.type == ADMIT) == 1 + 2


# ---------------------------------------------------------------------------
# read_journal (audit) and streaming sinks
# ---------------------------------------------------------------------------

def test_read_journal_is_read_only(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path) as j:
        fill(j, 2)
    before = seg_files(path)
    records, stats = read_journal(path)
    assert seg_files(path) == before             # no new segment
    assert sum(1 for r in records if r.type == OPEN) == 1   # no OPEN added
    assert stats.records == 3


def test_read_journal_sink_streams_and_returns_empty_list(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path) as j:
        fill(j, 4)
    eager, _ = read_journal(path)
    streamed = []
    empty, stats = read_journal(path, sink=streamed.append)
    assert empty == []
    assert streamed == eager
    assert stats.records == len(eager)


def test_record_sink_bypasses_recovered_list(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path) as j:
        fill(j, 3)
    streamed = []
    j2 = RequestJournal(path, record_sink=streamed.append)
    assert j2.recovered == []
    assert [r.type for r in streamed] == [OPEN] + [ADMIT] * 3
    assert j2.incarnation == "i2"                # opens still counted
    j2.close()


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def test_snapshot_roundtrip_newest_wins(tmp_path):
    path = str(tmp_path / "j")
    j = RequestJournal(path)
    j.write_snapshot({"gen": 1})
    fill(j, 2)
    j.write_snapshot({"gen": 2})
    body = j.load_snapshot()
    assert body["state"] == {"gen": 2}
    assert body["incarnation"] == "i1"
    assert body["seq"] == j.next_seq
    j.close()


def test_corrupt_snapshot_skipped_with_warning(tmp_path):
    path = str(tmp_path / "j")
    spy = LogSpy()
    j = RequestJournal(path, log=spy)
    j.write_snapshot({"gen": 1})
    fill(j, 1)
    newest = j.write_snapshot({"gen": 2})
    with open(newest, "r+", encoding="utf-8") as f:
        doc = f.read().replace('"gen":2', '"gen":3')   # breaks checksum
        f.seek(0)
        f.write(doc)
        f.truncate()
    body = j.load_snapshot()
    assert body["state"] == {"gen": 1}           # fell back to older valid
    assert "journal-snapshot-corrupt" in spy.names()
    j.close()


def test_no_snapshot_returns_none(tmp_path):
    j = RequestJournal(str(tmp_path / "j"))
    assert j.load_snapshot() is None
    j.close()


# ---------------------------------------------------------------------------
# sync modes / misc
# ---------------------------------------------------------------------------

def test_sync_always_mode_appends_fine(tmp_path):
    path = str(tmp_path / "j")
    with RequestJournal(path, sync="always") as j:
        fill(j, 3)
    _, stats = read_journal(path)
    assert stats.records == 4 and stats.invalid == 0


def test_journal_record_line_is_checksummed_json(tmp_path):
    rec = JournalRecord(seq=7, type=SERVED, data={"rseq": 3})
    obj = json.loads(rec.line())
    assert obj["seq"] == 7 and obj["type"] == SERVED
    assert isinstance(obj["c"], str) and len(obj["c"]) == 16


def test_process_incarnation_is_memoised():
    assert process_incarnation() == process_incarnation()
    assert process_incarnation().startswith("proc-")


# ---------------------------------------------------------------------------
# parity with the reference journal
# ---------------------------------------------------------------------------

def _records():
    """A mixed record stream: admits with nested payloads, an assign,
    terminals with floats, None and strings (the canonical-JSON cases)."""
    out = []
    for i in range(7):
        out.append((ADMIT, {"kind": "fft", "shape": [2, 256], "batch": 2,
                            "latency_budget": None, "payload_ref": i}))
    out.append((ASSIGN, {"batch_id": 0, "rseqs": [1, 2, 3]}))
    out.append((SERVED, {"rseq": 1, "energy_j": 1.2345678901234567e-05,
                         "reason": "fault:clock-lock-failed; x", "rung": 1,
                         "key": {"kind": "fft", "shape": []}}))
    out.append((SHED, {"rseq": 2, "reason": "admission:deadline",
                       "clock_mhz": 0.0, "measured_energy_j": None}))
    return out


def _write(mod, path, records, **kw):
    j = mod.RequestJournal(path, **kw)
    for rtype, data in records:
        j.append(rtype, data)
    j.write_snapshot({"gen": 1, "floats": [0.1, 1e-300, 3.0]})
    j.close()
    return j


@pytest.mark.parametrize("segment_records", [100_000, 4])
def test_same_appends_give_identical_segments(tmp_path, segment_records):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    for _ in range(2):                          # two incarnations each
        _write(ref_journal, ref_dir, _records(),
               segment_records=segment_records)
        _write(port_journal, port_dir, _records(),
               segment_records=segment_records)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    assert any(n.startswith("snap-") for n in names)
    for name in names:
        with open(os.path.join(ref_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            assert f.read() == want, name


def test_record_line_and_checksum_match_reference():
    for seq, (rtype, data) in enumerate(_records()):
        assert JournalRecord(seq, rtype, data).line() == \
            ref_journal.JournalRecord(seq, rtype, data).line()


def test_each_package_reads_the_others_journal(tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _write(ref_journal, ref_dir, _records())
    _write(port_journal, port_dir, _records())
    # the port reads the reference's journal, and the reverse
    recs, stats = read_journal(ref_dir)
    ref_recs, ref_stats = ref_journal.read_journal(port_dir)
    assert stats.invalid == 0 and ref_stats.invalid == 0
    assert [(r.seq, r.type, r.data) for r in recs] == \
        [(r.seq, r.type, r.data) for r in ref_recs]
    j = RequestJournal(ref_dir)                 # the port reopens it
    assert j.incarnation == "i2" and j.replay_stats.invalid == 0
    assert j.load_snapshot()["state"] == {"gen": 1,
                                          "floats": [0.1, 1e-300, 3.0]}
    j.close()
    rj = ref_journal.RequestJournal(port_dir)   # and the reference ours
    assert rj.incarnation == "i2" and rj.replay_stats.invalid == 0
    assert rj.load_snapshot()["state"]["gen"] == 1
    rj.close()
