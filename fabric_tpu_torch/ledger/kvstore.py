"""Key-value store SPI and its implementations (the port's copy of
`fabric_tpu/ledger/kvstore.py`, single-file layout only).

The reference's common/ledger/util/leveldbhelper, on sqlite: one table of
BLOB keys and values in WAL mode, whose ordered keys give leveldb's range
scans; an in-memory store for ephemeral ledgers; a write-batch collector
that gathers a whole commit group into one transaction; prefixed views.

The namespace-sharded store of the JAX package is not ported: an on-disk
sharded layout or FABRIC_TPU_STORE_SHARDS > 1 raises.  `sqlite3` is
imported when a durable store opens, and its absence raises there.
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Iterator

# the environment variables the port's ledger and commit path read (as the
# JAX package does, with the same defaults and errors)
KNOBS = ("FABRIC_TPU_SQLITE_SYNC", "FABRIC_TPU_WAL_CHECKPOINT",
         "FABRIC_TPU_STORE_SEGMENT", "FABRIC_TPU_RECOVERY_GROUP",
         "FABRIC_TPU_STORE_SHARDS", "FABRIC_TPU_MVCC_POOL",
         "FABRIC_TPU_COLLECT_POOL")


def knob(name: str) -> str:
    """The raw value of one of `KNOBS` in the environment, "" when unset;
    the callers parse it."""
    if name not in KNOBS:
        raise KeyError(f"{name} is not a ledger setting of the port")
    return os.environ.get(name, "")


class KVStore:
    """Ordered byte-key store. Iteration is over a half-open [start, end)
    range in lexicographic key order, like leveldb iterators."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def get_many(self, keys) -> dict[bytes, bytes]:
        """Present keys -> values (absent keys omitted)."""
        out = {}
        for k in keys:
            v = self.get(k)
            if v is not None:
                out[k] = v
        return out

    def write_batch(self, puts: dict[bytes, bytes], deletes=()) -> None:
        raise NotImplementedError

    def write_batch_if_absent(self, puts: dict[bytes, bytes]) -> None:
        """Insert keys that do not exist yet; existing keys keep their
        value."""
        existing = self.get_many(list(puts))
        self.write_batch({k: v for k, v in puts.items() if k not in existing})

    def put(self, key: bytes, value: bytes) -> None:
        self.write_batch({key: value})

    def delete(self, key: bytes) -> None:
        self.write_batch({}, [key])

    def iterate(self, start: bytes = b"",
                end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemKVStore(KVStore):
    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []
        self._lock = threading.RLock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def write_batch(self, puts, deletes=()) -> None:
        with self._lock:
            for k, v in puts.items():
                if k not in self._data:
                    bisect.insort(self._keys, k)
                self._data[k] = v
            for k in deletes:
                if k in self._data:
                    del self._data[k]
                    i = bisect.bisect_left(self._keys, k)
                    if i < len(self._keys) and self._keys[i] == k:
                        self._keys.pop(i)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        with self._lock:
            lo = bisect.bisect_left(self._keys, start)
            hi = (len(self._keys) if end is None
                  else bisect.bisect_left(self._keys, end, lo))
            snapshot = [(k, self._data[k]) for k in self._keys[lo:hi]]
        yield from snapshot


_SQLITE_SYNC_LEVELS = ("OFF", "NORMAL", "FULL", "EXTRA")


def sqlite_sync_level() -> str:
    """PRAGMA synchronous: FABRIC_TPU_SQLITE_SYNC, else NORMAL (in WAL mode NORMAL may lose the last transactions on
    power loss but never corrupts; the block files are written first, so
    recovery replays what the KV store lost)."""
    raw = knob("FABRIC_TPU_SQLITE_SYNC").strip().upper()
    if not raw:
        return "NORMAL"
    if raw not in _SQLITE_SYNC_LEVELS:
        raise ValueError(
            f"FABRIC_TPU_SQLITE_SYNC={raw!r}: expected one of "
            f"{'/'.join(_SQLITE_SYNC_LEVELS)}"
        )
    return raw


def sqlite_wal_checkpoint() -> int:
    """wal_autocheckpoint in pages: FABRIC_TPU_WAL_CHECKPOINT, else
    sqlite's 1000; 0 turns automatic checkpoints off."""
    raw = knob("FABRIC_TPU_WAL_CHECKPOINT").strip()
    if not raw:
        return 1000
    try:
        return max(0, int(raw))
    except ValueError:
        raise ValueError(
            f"FABRIC_TPU_WAL_CHECKPOINT={raw!r} is not an integer page "
            "count (0 disables auto-checkpointing)"
        ) from None


class SqliteKVStore(KVStore):
    """The durable store: one table of BLOB keys and values; a batch is
    one sqlite transaction (WAL journal), atomic as the block store's
    checkpoint and the ledger's recovery need."""

    def __init__(self, path: str):
        import sqlite3

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self.sync_level = sqlite_sync_level()
        self._conn.execute(f"PRAGMA synchronous={self.sync_level}")
        self.wal_autocheckpoint = sqlite_wal_checkpoint()
        self._conn.execute(
            f"PRAGMA wal_autocheckpoint={self.wal_autocheckpoint:d}")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv "
            "(k BLOB PRIMARY KEY, v BLOB NOT NULL)")
        self._conn.commit()
        self._lock = threading.RLock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return None if row is None else row[0]

    def get_many(self, keys) -> dict[bytes, bytes]:
        keys = list(keys)
        out: dict[bytes, bytes] = {}
        with self._lock:
            for off in range(0, len(keys), 500):  # sqlite's variable limit
                chunk = keys[off:off + 500]
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k IN (%s)"
                    % ",".join("?" * len(chunk)), chunk).fetchall()
                out.update(rows)
        return out

    def write_batch(self, puts, deletes=()) -> None:
        with self._lock, self._conn:
            self._conn.executemany(
                "INSERT INTO kv(k, v) VALUES(?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                list(puts.items()))
            self._conn.executemany(
                "DELETE FROM kv WHERE k = ?", [(k,) for k in deletes])

    def write_batch_if_absent(self, puts) -> None:
        # the first occurrence wins within the batch too: the rows run in
        # order and every later conflicting insert is ignored
        with self._lock, self._conn:
            self._conn.executemany(
                "INSERT OR IGNORE INTO kv(k, v) VALUES(?, ?)",
                list(puts.items()))

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        with self._lock:
            if end is None:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k",
                    (start,)).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                    (start, end)).fetchall()
        yield from rows

    def close(self) -> None:
        self._conn.close()


class WriteBatchCollector(KVStore):
    """Buffers every mutation meant for `base`, so that a whole commit
    group (state, history, private data, block index, savepoints) lands
    in one base `write_batch`: one sqlite transaction.  Reads see the
    buffer first, so the MVCC check of block k+1 reads block k's writes
    before the group flushes."""

    def __init__(self, base: KVStore):
        self._base = base
        self._puts: dict[bytes, bytes] = {}
        self._dels: set[bytes] = set()

    def get(self, key: bytes) -> bytes | None:
        if key in self._puts:
            return self._puts[key]
        if key in self._dels:
            return None
        return self._base.get(key)

    def get_many(self, keys) -> dict[bytes, bytes]:
        out: dict[bytes, bytes] = {}
        missing: list[bytes] = []
        for k in keys:
            if k in self._puts:
                out[k] = self._puts[k]
            elif k not in self._dels:
                missing.append(k)
        if missing:
            out.update(self._base.get_many(missing))
        return out

    def write_batch(self, puts, deletes=()) -> None:
        for k, v in puts.items():
            self._dels.discard(k)
            self._puts[k] = v
        for k in deletes:
            self._puts.pop(k, None)
            self._dels.add(k)

    # write_batch_if_absent: KVStore's (get_many, then write_batch) is
    # right here, since get_many sees the buffer

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        """The base's ordered scan with the buffer merged in."""
        ov = iter(sorted(k for k in self._puts
                         if k >= start and (end is None or k < end)))
        ok = next(ov, None)
        for k, v in self._base.iterate(start, end):
            while ok is not None and ok < k:
                yield ok, self._puts[ok]
                ok = next(ov, None)
            if ok == k:
                yield k, self._puts[k]
                ok = next(ov, None)
                continue
            if k in self._dels:
                continue
            yield k, v
        while ok is not None:
            yield ok, self._puts[ok]
            ok = next(ov, None)

    @property
    def pending(self) -> int:
        return len(self._puts) + len(self._dels)

    def flush(self) -> None:
        """Everything buffered into the base in one write_batch, then
        empty."""
        if self._puts or self._dels:
            self._base.write_batch(self._puts, sorted(self._dels))
        self._puts = {}
        self._dels = set()

    def discard(self) -> None:
        """Drop the buffer without touching the base (a failed group)."""
        self._puts = {}
        self._dels = set()


class NamedDB(KVStore):
    """A prefixed view of a shared store (leveldbhelper's
    GetDBHandle(dbName))."""

    _SEP = b"\x00\xff"

    def __init__(self, base: KVStore, name: str):
        self._base = base
        self._prefix = name.encode() + self._SEP

    def rebase(self, base: KVStore) -> "NamedDB":
        """The same prefix over another base (a commit group's
        collector)."""
        c = NamedDB.__new__(NamedDB)
        c._base = base
        c._prefix = self._prefix
        return c

    def _k(self, key: bytes) -> bytes:
        return self._prefix + key

    def get(self, key: bytes) -> bytes | None:
        return self._base.get(self._k(key))

    def get_many(self, keys) -> dict[bytes, bytes]:
        plen = len(self._prefix)
        got = self._base.get_many([self._k(k) for k in keys])
        return {k[plen:]: v for k, v in got.items()}

    def write_batch(self, puts, deletes=()) -> None:
        self._base.write_batch({self._k(k): v for k, v in puts.items()},
                               [self._k(k) for k in deletes])

    def write_batch_if_absent(self, puts) -> None:
        self._base.write_batch_if_absent(
            {self._k(k): v for k, v in puts.items()})

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        pend = (self._prefix + end if end is not None
                else _prefix_end(self._prefix))
        plen = len(self._prefix)
        for k, v in self._base.iterate(self._prefix + start, pend):
            yield k[plen:], v


def _prefix_end(prefix: bytes) -> bytes | None:
    """The smallest key greater than every key with this prefix."""
    p = bytearray(prefix)
    while p:
        if p[-1] != 0xFF:
            p[-1] += 1
            return bytes(p)
        p.pop()
    return None


def wipe_prefix(store: KVStore, prefix: bytes) -> int:
    """Delete every key under `prefix` in one batch; returns the count."""
    keys = [k for k, _ in store.iterate(prefix, _prefix_end(prefix))]
    if keys:
        store.write_batch({}, deletes=keys)
    return len(keys)


_MAX_SHARDS = 64


def store_shards() -> int:
    """FABRIC_TPU_STORE_SHARDS, parsed as the JAX package parses it
    (default 1, clamped to 1-64)."""
    raw = knob("FABRIC_TPU_STORE_SHARDS").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"FABRIC_TPU_STORE_SHARDS={raw!r} is not an integer shard "
            "count (1 = single-file layout)"
        ) from None
    return max(1, min(n, _MAX_SHARDS))


def open_store_root(root_dir: str | None) -> KVStore:
    """A provider's root store: MemKVStore for None, else the single
    sqlite file `index.sqlite`.  The sharded layout is not ported: asking
    for it, or finding it on disk, raises."""
    if root_dir is None:
        return MemKVStore()
    n = store_shards()
    if n > 1:
        raise NotImplementedError(
            f"FABRIC_TPU_STORE_SHARDS={n}: the sharded store is not ported")
    if os.path.exists(os.path.join(root_dir, "state_00.sqlite")):
        raise NotImplementedError(
            f"{root_dir} holds a sharded store (state_00.sqlite), which the "
            "port cannot open")
    return SqliteKVStore(os.path.join(root_dir, "index.sqlite"))


__all__ = [
    "KNOBS", "knob", "KVStore", "MemKVStore", "SqliteKVStore",
    "WriteBatchCollector", "NamedDB", "wipe_prefix",
    "open_store_root", "store_shards", "sqlite_sync_level",
    "sqlite_wal_checkpoint",
]
