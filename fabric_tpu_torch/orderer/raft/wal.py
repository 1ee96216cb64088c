"""The raft write-ahead log and its snapshots (the port's copy of
`fabric_tpu/orderer/raft/wal.py`; reference etcdraft/storage.go).

One append-only file, `raft.wal`, of WALRecords (hard states, entries,
snapshot markers), each framed as a 4-byte big-endian length, a 4-byte
big-endian CRC32 and the record, fsynced a batch at a time; `load`
truncates a torn or corrupt tail, as the block store's recovery does.  A
snapshot record marks the log position: on replay the entries at or below
it are dropped.  `maybe_rotate` rewrites the file as its last snapshot
once dead records pass 4 MiB.  The same calls write the same bytes as
the JAX package's, and each package loads the other's directory.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

from fabric_tpu_torch.orderer.raft.raftcore import MemoryLog
from fabric_tpu_torch.protos import orderer as ob

_HDR = struct.Struct(">II")  # length, crc32


class WAL:
    def __init__(self, dir_path: str, metrics=None):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.path = os.path.join(dir_path, "raft.wal")
        self._f = None
        self._garbage = 0  # bytes that the latest snapshot supersedes
        self._metrics = metrics  # common.metrics.RaftMetrics | None

    def set_metrics(self, metrics) -> None:
        self._metrics = metrics

    # -- recovery ----------------------------------------------------------

    def load(self) -> tuple[ob.HardState, MemoryLog, ob.Snapshot | None]:
        """Replay the file: (the last hard state, the log, the latest
        snapshot or None)."""
        hs = ob.HardState()
        log = MemoryLog()
        snap: ob.Snapshot | None = None
        entries: dict[int, ob.Entry] = {}
        good = 0
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
            off = 0
            while off + _HDR.size <= len(data):
                ln, crc = _HDR.unpack_from(data, off)
                end = off + _HDR.size + ln
                if end > len(data):
                    break  # a torn write
                payload = data[off + _HDR.size: end]
                if zlib.crc32(payload) != crc:
                    break  # a corrupt tail
                rec = ob.WALRecord.decode(payload)
                kind = rec.which("payload")
                if kind == "hard_state":
                    hs = rec.hard_state
                elif kind == "entry":
                    entries[rec.entry.index] = rec.entry
                elif kind == "snapshot":
                    snap = rec.snapshot
                off = end
                good = off
            if good < len(data):
                with open(self.path, "r+b") as f:
                    f.truncate(good)
        if snap is not None:
            log.reset_to_snapshot(snap.meta.index, snap.meta.term)
        # the entries above the snapshot, while they are contiguous
        idx = log.snap_index + 1
        chain: list[ob.Entry] = []
        while idx in entries:
            chain.append(entries[idx])
            idx += 1
        log.append(chain)
        self._f = open(self.path, "ab")
        return hs, log, snap

    def _open(self):
        if self._f is None:
            self._f = open(self.path, "ab")
        return self._f

    # -- append ------------------------------------------------------------

    @staticmethod
    def _frame(rec: ob.WALRecord) -> bytes:
        payload = rec.encode()
        return _HDR.pack(len(payload), zlib.crc32(payload)) + payload

    def save(self, hard_state: ob.HardState | None, entries) -> None:
        t0 = time.perf_counter()
        frames = [self._frame(ob.WALRecord(entry=e)) for e in entries]
        if hard_state is not None:
            frames.append(self._frame(ob.WALRecord(hard_state=hard_state)))
        if not frames:
            return
        f = self._open()
        f.write(b"".join(frames))
        f.flush()
        t1 = time.perf_counter()
        os.fsync(f.fileno())
        if self._metrics is not None:
            self._metrics.wal_append.observe(t1 - t0)
            self._metrics.wal_fsync.observe(time.perf_counter() - t1)

    def save_snapshot(self, snap: ob.Snapshot) -> None:
        f = self._open()
        f.write(self._frame(ob.WALRecord(snapshot=snap)))
        f.flush()
        os.fsync(f.fileno())
        self._garbage = f.tell()
        self.maybe_rotate(snap)

    def maybe_rotate(self, snap: ob.Snapshot,
                     keep_bytes: int = 4 << 20) -> None:
        """Rewrite the file as [snapshot] once dead records dominate."""
        if self._garbage < keep_bytes:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self._frame(ob.WALRecord(snapshot=snap)))
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._garbage = 0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


__all__ = ["WAL"]
