"""Write-ahead journal with snapshots, and the group committer.

Own copy of ``curvine_tpu/common/journal.py``: ``Journal`` (:29-285) and
``GroupCommitter`` (:287-407), on the port's codec (``rpc/wirepack.py``,
byte-equal to ``msgpack``) where the reference uses ``msgpack``. The
files are the reference's, so either package's master reopens the
other's journal:

- an entry is the frame ``[u32 len][u32 crc32][payload]``, the payload
  ``[seq, op, args, term]``, ``term`` the raft term the entry was
  written in (0 on a single master; a 3-element entry reads as term 0);
- segments are ``edits-<first seq>.log``, rolled at ``SEGMENT_MAX``;
- a snapshot is ``snapshot-<seq>``, the blob
  ``{"__snap__": state, "__last_term__": term}``, written to a temporary
  file and renamed; a snapshot drops the older snapshots and the
  segments it covers;
- on recovery the newest snapshot is loaded and the later entries are
  returned; a torn or corrupt tail is truncated at its first bad frame;
- with the KV metadata store the store is the checkpoint: no snapshot
  is written, and ``gc_covered`` (:203-215) drops the closed segments
  whose entries the store has applied;
- the raft bookkeeping: ``term`` is stamped into every entry, ``term_of``
  answers from a window of the recent entries' terms (16,384, pruned to
  8,192), and ``reset_log`` drops every segment when a snapshot install
  replaces the state."""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import zlib

from curvine_tpu_torch.rpc import wirepack

log = logging.getLogger(__name__)

_ENTRY = struct.Struct(">II")
SEGMENT_MAX = 64 * 1024 * 1024


def _pack(obj) -> bytes:
    return wirepack.packb(obj, use_bin_type=True)


def _unpack(buf):
    return wirepack.unpackb(buf, raw=False, strict_map_key=False)


class Journal:
    def __init__(self, journal_dir: str, fsync: bool = False):
        self.dir = journal_dir
        self.fsync = fsync
        os.makedirs(self.dir, exist_ok=True)
        self.seq = 0                       # last written seq
        self.term = 0                      # current raft term (stamped in)
        self.last_term = 0                 # term of the last entry on disk
        self.last_snapshot_seq = 0         # set by recover()
        self._fh = None
        self._fh_size = 0
        self._unflushed = False
        # seq -> term of the recent entries (log matching); bounded
        self._terms: dict[int, int] = {}

    def note_term(self, seq: int, term: int) -> None:
        self._terms[seq] = term
        if len(self._terms) > 16_384:
            cutoff = seq - 8_192
            self._terms = {s: t for s, t in self._terms.items()
                           if s >= cutoff}

    def term_of(self, seq: int) -> int | None:
        """Term of entry ``seq`` if known (None past the retained window:
        the caller falls back to a snapshot install)."""
        if seq == 0:
            return 0
        return self._terms.get(seq)

    @staticmethod
    def _frame(seq: int, op: str, args: dict, term: int) -> bytes:
        payload = _pack([seq, op, args, term])
        return _ENTRY.pack(len(payload), zlib.crc32(payload)) + payload

    # ---------- write ----------
    def append(self, op: str, args: dict, term: int | None = None,
               flush: bool = True) -> int:
        """Append one entry. With ``flush=False`` the frame lands in the
        stdio buffer only, and a later :meth:`sync` (the group commit
        point) makes it durable: the RPC reply for this entry must not
        leave before that sync returns."""
        self.seq += 1
        t = self.term if term is None else term
        self.last_term = t
        self.note_term(self.seq, t)
        frame = self._frame(self.seq, op, args, t)
        fh = self._writer()
        fh.write(frame)
        self._fh_size += len(frame)
        if flush:
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        else:
            self._unflushed = True
        if self._fh_size >= SEGMENT_MAX:
            self._roll()
        return self.seq

    def append_batch(self, entries: list[tuple]) -> list[int]:
        """Frame N ``(op, args)`` or ``(op, args, term)`` entries into one
        write and one flush (and fsync); an entry without a term takes the
        journal's. The raft follower's ``apply_replicated_batch`` passes
        each entry's own term. Returns the seqs. On a write failure the
        seq, the terms and the file are restored, so no half batch stays
        in the log."""
        if not entries:
            return []
        fh = self._writer()
        seq0, term0 = self.seq, self.last_term
        frames, seqs = [], []
        for e in entries:
            op, args = e[0], e[1]
            term = e[2] if len(e) > 2 and e[2] is not None else self.term
            self.seq += 1
            self.last_term = term
            self.note_term(self.seq, term)
            frames.append(self._frame(self.seq, op, args, term))
            seqs.append(self.seq)
        blob = b"".join(frames)
        try:
            fh.write(blob)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        except Exception:
            for s in seqs:
                self._terms.pop(s, None)
            self.seq, self.last_term = seq0, term0
            try:
                fh.truncate(self._fh_size)
                fh.seek(self._fh_size)
            except OSError:
                pass
            raise
        self._fh_size += len(blob)
        if self._fh_size >= SEGMENT_MAX:
            self._roll()
        return seqs

    def sync(self) -> None:
        """Flush (and fsync) the frames of ``append(flush=False)``."""
        if not self._unflushed:
            return
        self._unflushed = False
        if self._fh is not None:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())

    def _writer(self):
        if self._fh is None:
            path = os.path.join(self.dir, f"edits-{self.seq + 1:020d}.log")
            self._fh = open(path, "ab")
            self._fh_size = self._fh.tell()
        return self._fh

    def _roll(self) -> None:
        if self._fh:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._unflushed = False
            self._fh.close()
            self._fh = None
            self._fh_size = 0

    # ---------- snapshot ----------
    def write_snapshot(self, state: dict) -> str:
        path = os.path.join(self.dir, f"snapshot-{self.seq:020d}")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_pack({"__snap__": state,
                           "__last_term__": self.last_term}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._gc(before_seq=self.seq)
        return path

    def _gc(self, before_seq: int) -> None:
        """Drop the older snapshots and the segments the newest covers
        (a segment goes when the next one also starts at or below it)."""
        snaps = self._list("snapshot-")
        for _s, p in snaps[:-1]:
            os.unlink(p)
        segs = self._list("edits-")
        for i, (start_seq, p) in enumerate(segs[:-1]):
            if segs[i + 1][0] - 1 <= before_seq and start_seq <= before_seq:
                os.unlink(p)

    def reset_log(self) -> None:
        """Drop every log segment (a snapshot install): the entries on
        disk may be of a history the installed snapshot supersedes, and a
        restart would replay them."""
        self._roll()
        for _seq, p in self._list("edits-"):
            os.unlink(p)
        self._terms.clear()

    def gc_covered(self, applied_seq: int) -> None:
        """Drop the closed segments whose entries are all at or below
        ``applied_seq`` (the KV store's checkpoint, which writes no
        snapshot). The open segment is rolled first, so that it goes at
        a later call, once a segment follows it."""
        self._roll()
        segs = self._list("edits-")
        for i, (_start, path) in enumerate(segs[:-1]):
            if segs[i + 1][0] - 1 <= applied_seq:
                os.unlink(path)

    def _list(self, prefix: str) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(prefix) and not name.endswith(".tmp"):
                try:
                    out.append((int(name[len(prefix):].removesuffix(".log")),
                                os.path.join(self.dir, name)))
                except ValueError:
                    continue
        return sorted(out)

    # ---------- recover ----------
    def recover(self):
        """Returns (the snapshot's state or None, the entries after it as
        ``(seq, op, args, term)``), and positions the journal to append
        after the last good entry."""
        snaps = self._list("snapshot-")
        snap_state, snap_seq = None, 0
        if snaps:
            snap_seq, path = snaps[-1]
            with open(path, "rb") as f:
                snap_state = _unpack(f.read())
            if isinstance(snap_state, dict) and "__snap__" in snap_state:
                self.last_term = snap_state.get("__last_term__", 0)
                snap_state = snap_state["__snap__"]
                self.note_term(snap_seq, self.last_term)
        self.last_snapshot_seq = snap_seq
        entries: list = []
        last_seq = snap_seq
        for _, path in self._list("edits-"):
            last_seq = self._read_segment(path, snap_seq, entries, last_seq)
        self.seq = last_seq
        return snap_state, entries

    def _read_segment(self, path: str, snap_seq: int, out: list,
                      last_seq: int) -> int:
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _ENTRY.size <= len(data):
            length, crc = _ENTRY.unpack_from(data, off)
            start = off + _ENTRY.size
            end = start + length
            if end > len(data) or zlib.crc32(data[start:end]) != crc:
                log.warning("journal %s: %s at %d, truncating", path,
                            "torn tail" if end > len(data) else "bad crc",
                            off)
                with open(path, "ab") as f:
                    f.truncate(off)
                break
            rec = _unpack(data[start:end])
            seq, op, args = rec[0], rec[1], rec[2]
            term = rec[3] if len(rec) > 3 else 0
            self.note_term(seq, term)
            if seq > snap_seq:
                out.append((seq, op, args, term))
            if seq >= last_seq:
                last_seq = seq
                self.last_term = term
            off = end
        return last_seq

    def close(self) -> None:
        self._roll()


class GroupCommitter:
    """Coalesces concurrent metadata mutations into one journal flush
    and one KV write batch (the HDFS NameNode's ``logEdit``/``logSync``).

    Mutation handlers journal with ``flush=False``, apply and stage their
    KV writes, then :meth:`note` the committer and ``await sync()`` before
    the reply leaves. The committer's task commits everything noted so
    far in one ``journal.sync()`` and one ``store.commit_applied`` (the
    group's KV batch, tagged with the journal's seq; a store of None, or
    the mem store, has no batch); an ``asyncio.sleep(0)`` a cycle admits
    handlers that are already runnable into the group, so groups form
    under load with no idle latency. When the previous group held more
    than one entry, the group lingers ``window_ms`` more, up to
    ``max_entries``.
    A flush failure marks the committer broken: every waiter fails, later
    mutations are refused, and the master is read-only until a restart
    replays the flushed prefix."""

    def __init__(self, journal: Journal | None, store=None,
                 window_ms: float = 1.0, max_entries: int = 1024):
        self.journal = journal
        self.store = store
        self.window_s = max(0.0, window_ms) / 1000.0
        self.max_entries = max(1, max_entries)
        self.broken: BaseException | None = None
        self.groups = 0            # groups committed
        self.entries = 0           # entries committed
        self._dirty = 0            # entries noted
        self._synced = 0           # entries committed so far
        self._last_group = 0       # size of the previous group
        self._task: asyncio.Task | None = None
        self._waiters: list[tuple[int, asyncio.Future]] = []

    @property
    def accepting(self) -> bool:
        return self.broken is None

    def note(self) -> None:
        """An entry was journaled (unflushed) and applied; schedule a
        commit. With no running loop (a caller driving the filesystem
        directly) it commits inline."""
        self._dirty += 1
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._commit_group()
            return
        if self._task is None or self._task.done():
            self._task = loop.create_task(self._run())

    async def sync(self) -> None:
        """Wait until every entry noted before this call is committed."""
        if self.broken is not None:
            raise self.broken
        target = self._dirty
        if target <= self._synced:
            return
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((target, fut))
        await fut

    def flush_sync(self) -> None:
        """Commit the open group inline (snapshots, shutdown)."""
        if self._dirty > self._synced:
            self._commit_group()

    async def _run(self) -> None:
        while self._dirty > self._synced and self.broken is None:
            await asyncio.sleep(0)
            backlog = self._dirty - self._synced
            if (self.window_s > 0.0 and self._last_group > 1
                    and backlog < self.max_entries):
                await asyncio.sleep(self.window_s)
            try:
                self._commit_group()
            except BaseException:
                return      # the waiters failed; the committer is broken

    def _commit_group(self) -> None:
        target = self._dirty
        n = target - self._synced
        if n <= 0:
            return
        try:
            if self.journal is not None:
                self.journal.sync()
            if self.store is not None:
                self.store.commit_applied(
                    self.journal.seq if self.journal is not None
                    else self.store.get_counter("applied_seq", 0))
        except BaseException as e:
            self.broken = e
            log.critical("group commit failed; master is read-only: %s", e)
            waiters, self._waiters = self._waiters, []
            for _, fut in waiters:
                if not fut.done():
                    fut.set_exception(e)
            raise
        self._synced = target
        self._last_group = n
        self.groups += 1
        self.entries += n
        keep = []
        for tgt, fut in self._waiters:
            if tgt <= self._synced:
                if not fut.done():
                    fut.set_result(None)
            else:
                keep.append((tgt, fut))
        self._waiters = keep
