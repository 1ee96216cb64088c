"""Key-value store SPI and its implementations (the port's copy of
`fabric_tpu/ledger/kvstore.py`).

The reference's common/ledger/util/leveldbhelper, on sqlite: one table of
BLOB keys and values in WAL mode, whose ordered keys give leveldb's range
scans; an in-memory store for ephemeral ledgers; a write-batch collector
that gathers a whole commit group into one transaction; prefixed views;
and storage engine v2, the namespace-sharded store with its two-phase
group flush (FABRIC_TPU_STORE_SHARDS > 1), whose files each package opens
as the other writes them.  `sqlite3` is imported when a durable store
opens, and its absence raises there.
"""

from __future__ import annotations

import bisect
import heapq
import os
import struct
import threading
import time
import zlib
from typing import Iterator

from fabric_tpu_torch.devtools import faultline, knob_registry
from fabric_tpu_torch.devtools.lockwatch import guarded, named_lock, named_rlock

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
    raw = knob_registry.raw("FABRIC_TPU_SQLITE_SYNC").strip().upper()
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
    raw = knob_registry.raw("FABRIC_TPU_WAL_CHECKPOINT").strip()
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
        # before the transaction: a crash here falls between the
        # block-file fsync and the KV transaction
        faultline.point("kvstore.txn", puts=len(puts))
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


def open_kvstore(path: str | None) -> KVStore:
    """None or ':memory:' -> MemKVStore, else the sqlite file at path."""
    if path in (None, ":memory:"):
        return MemKVStore()
    return SqliteKVStore(path)


# -- storage engine v2: namespace-sharded store, two-phase group flush --------
#
# One sqlite file means one WAL and one fsync stream for every namespace.
# The sharded store splits the STATE entries (``statedb/<lid>`` ``\x02``
# keys, the bulk of a commit's bytes) over N shard files routed by
# top-level chaincode namespace; everything whose atomicity defines the
# crash contract (savepoints, the block index and checkpoint, history, the
# private-data store, metadata) stays in the coordinator file.  A group
# flush has two phases: every touched shard STAGES its mutations in a
# pending table tagged with the flush's epoch, then ONE coordinator
# transaction (the savepoint, index and history writes with the epoch
# record) commits the whole flush.  Reopen rolls prepared-but-uncommitted
# shards back and committed-but-unapplied shards forward.

_STATEDB_RAW_PREFIX = b"statedb/"
# coordinator-file metadata; \x00-leading raw keys sort below every
# NamedDB namespace, so no prefixed view or wipe reaches them
_SHARD_COUNT_KEY = b"\x00storev2\x00shards"
_EPOCH_KEY = b"\x00storev2\x00epoch"

_MAX_SHARDS = 64


def store_shards(override: int | None = None) -> int:
    """The state shard-file count: `override`, else
    FABRIC_TPU_STORE_SHARDS (default 1, the single-file layout), clamped
    to 1-64.  A sharded store pins its count into the coordinator file
    when it is created, and a reopen keeps that count whatever the knob
    says then."""
    if override is not None:
        return max(1, min(int(override), _MAX_SHARDS))
    raw = knob_registry.raw("FABRIC_TPU_STORE_SHARDS").strip()
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


def shard_of_namespace(ns: str, n: int) -> int:
    """The shard a namespace's state entries route to.  Derived namespaces
    (``cc\x00pvt\x00coll``, ``cc\x00hash\x00coll``) ride with their
    chaincode, so its public and private state share a shard."""
    top = ns.split("\x00", 1)[0]
    return zlib.crc32(top.encode()) % n


def state_shard(key: bytes, n: int) -> int | None:
    """The shard of a raw store key, or None for a coordinator key.  Only
    ``statedb/<lid>`` ``\x02`` state entries shard; savepoints (``\x01``),
    indexes (``\x03``/``\x04``), metadata (``\x05``) and every other
    namespace stay in the coordinator."""
    if n <= 1 or not key.startswith(_STATEDB_RAW_PREFIX):
        return None
    sep = key.find(NamedDB._SEP, len(_STATEDB_RAW_PREFIX))
    if sep < 0:
        return None
    inner = key[sep + len(NamedDB._SEP):]
    if not inner.startswith(b"\x02"):
        return None
    nul = inner.find(b"\x00", 1)
    ns = inner[1:nul] if nul > 0 else inner[1:]
    return zlib.crc32(ns) % n


class _ShardStore(SqliteKVStore):
    """One state shard: the kv table, a PENDING table the two-phase flush
    stages into, and the shard's pending epoch.  Pending rows are
    invisible to reads until apply_pending() folds them into kv (a NULL
    value marks a delete)."""

    def __init__(self, path: str):
        super().__init__(path)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS pending (k BLOB PRIMARY KEY, v BLOB)")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS shardmeta "
            "(mk TEXT PRIMARY KEY, mv INTEGER NOT NULL)")
        self._conn.commit()
        # one lockwatch role for every shard's connection lock (no two
        # nest on a thread), ordered under the flush lock
        self._lock = named_rlock("kvstore.shard")

    def stage_pending(self, puts, deletes, epoch: int) -> None:
        """Phase 1, prepare: replace the pending table with this flush's
        mutations and mark the shard's epoch, in one local transaction.
        The leading DELETE makes prepare idempotent and sweeps a stage
        left by a flush that crashed and was rolled back."""
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM pending")
            self._conn.executemany(
                "INSERT INTO pending(k, v) VALUES(?, ?)", list(puts.items()))
            # a delete wins over a put of the same key, as in write_batch
            self._conn.executemany(
                "INSERT OR REPLACE INTO pending(k, v) VALUES(?, NULL)",
                [(k,) for k in deletes])
            self._conn.execute(
                "INSERT INTO shardmeta(mk, mv) VALUES('pending_epoch', ?) "
                "ON CONFLICT(mk) DO UPDATE SET mv = excluded.mv", (epoch,))

    def pending_epoch(self) -> int | None:
        """The epoch of the staged but unapplied flush, None when clean."""
        with self._lock:
            row = self._conn.execute(
                "SELECT mv FROM shardmeta WHERE mk = 'pending_epoch'"
            ).fetchone()
        return None if row is None else row[0]

    def apply_pending(self) -> None:
        """Phase 3, apply (and reopen's roll-forward): fold pending into kv
        and clear the stage, in one local transaction, so a crash in it
        re-applies on the next open."""
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO kv(k, v) "
                "SELECT k, v FROM pending WHERE v IS NOT NULL "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v")
            self._conn.execute(
                "DELETE FROM kv WHERE k IN "
                "(SELECT k FROM pending WHERE v IS NULL)")
            self._conn.execute("DELETE FROM pending")
            self._conn.execute(
                "DELETE FROM shardmeta WHERE mk = 'pending_epoch'")

    def drop_pending(self) -> None:
        """Reopen's roll-back: discard a stage whose flush never reached
        the coordinator."""
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM pending")
            self._conn.execute(
                "DELETE FROM shardmeta WHERE mk = 'pending_epoch'")


class ShardedKVStore(KVStore):
    """The KVStore SPI over one coordinator file (`index.sqlite`) and N
    state shard files (`state_NN.sqlite`).  Reads route per key;
    iteration heap-merges the files' ordered scans (routing is disjoint,
    so the merge is the single file's key order, and exports, digests and
    range reads are the same bytes at every width).  A batch with state
    mutations runs the two-phase flush; one without goes straight to the
    coordinator, as in the single-file store."""

    def __init__(self, root_dir: str, shards: int | None = None):
        self._coord = SqliteKVStore(os.path.join(root_dir, "index.sqlite"))
        raw = self._coord.get(_SHARD_COUNT_KEY)
        if raw is not None:
            # the persisted width wins: routing must never drift
            n = struct.unpack(">I", raw)[0]
        else:
            # A divergence from the JAX package, which mounts the shards
            # over a single-file root's state: its reads of state keys then
            # go to the empty shard files while the savepoint says the
            # state is current, so MVCC validates against nothing.
            if any(state_shard(k, 2) is not None for k, _ in
                   self._coord.iterate(_STATEDB_RAW_PREFIX, b"statedb0")):
                self._coord.close()
                raise ValueError(
                    f"{root_dir} holds state in its single file "
                    "index.sqlite: shard files mounted over it would hide "
                    "that state; open it with FABRIC_TPU_STORE_SHARDS "
                    "unset or 1"
                )
            n = max(2, store_shards(shards))
            self._coord.put(_SHARD_COUNT_KEY, struct.pack(">I", n))
        self.shards = n
        self._stores = [
            _ShardStore(os.path.join(root_dir, f"state_{i:02d}.sqlite"))
            for i in range(n)
        ]
        self.sync_level = self._coord.sync_level
        self.wal_autocheckpoint = self._coord.wal_autocheckpoint
        # serializes the two-phase flushes and guards the epoch
        self._lock = named_lock("kvstore.shard_flush")
        # the per-phase wall splits of the LAST two-phase flush; kvledger
        # folds them into commit_stage_seconds after each group flush
        self.last_stage_seconds: dict[str, float] = {}
        with self._lock:
            raw = self._coord.get(_EPOCH_KEY)
            self._epoch = 0 if raw is None else struct.unpack(">Q", raw)[0]
            self._recover_pending()

    # -- reopen recovery ------------------------------------------------------

    def _recover_pending(self) -> None:
        """Resolve the stages a crash left: a shard whose pending epoch is
        the coordinator's committed epoch lost only its apply phase and
        rolls forward (the coordinator acknowledged the flush); any other
        pending epoch was never committed and rolls back.  Both are
        idempotent, so a crash during recovery re-runs it."""
        for i, s in enumerate(self._stores):
            pe = s.pending_epoch()
            if pe is None:
                continue
            if pe == self._epoch:
                # a guard point: a "skip" rule leaves out the roll-forward
                if faultline.guard("store.shard_recover", shard=i,
                                   epoch=pe):
                    s.apply_pending()
            else:
                s.drop_pending()

    # -- reads ----------------------------------------------------------------

    def _store_for(self, key: bytes) -> KVStore:
        i = state_shard(key, self.shards)
        return self._coord if i is None else self._stores[i]

    def get(self, key: bytes) -> bytes | None:
        return self._store_for(key).get(key)

    def get_many(self, keys) -> dict[bytes, bytes]:
        groups: dict[int | None, list[bytes]] = {}
        for k in keys:
            groups.setdefault(state_shard(k, self.shards), []).append(k)
        out: dict[bytes, bytes] = {}
        for i, ks in groups.items():
            store = self._coord if i is None else self._stores[i]
            out.update(store.get_many(ks))
        return out

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        # each file's scan releases its lock before it yields, so the lazy
        # merge never nests two shard locks
        return heapq.merge(
            self._coord.iterate(start, end),
            *(s.iterate(start, end) for s in self._stores),
        )

    # -- writes ---------------------------------------------------------------

    def _partition(self, puts, deletes):
        shard_puts: dict[int, dict[bytes, bytes]] = {}
        shard_dels: dict[int, list[bytes]] = {}
        coord_puts: dict[bytes, bytes] = {}
        coord_dels: list[bytes] = []
        for k, v in puts.items():
            i = state_shard(k, self.shards)
            if i is None:
                coord_puts[k] = v
            else:
                shard_puts.setdefault(i, {})[k] = v
        for k in deletes:
            i = state_shard(k, self.shards)
            if i is None:
                coord_dels.append(k)
            else:
                shard_dels.setdefault(i, []).append(k)
        return shard_puts, shard_dels, coord_puts, coord_dels

    def write_batch(self, puts, deletes=()) -> None:
        shard_puts, shard_dels, coord_puts, coord_dels = self._partition(
            puts, deletes)
        if not shard_puts and not shard_dels:
            # a coordinator-only batch: no two-phase flush, and no stale
            # phase splits left for the caller
            self.last_stage_seconds = {}
            self._coord.write_batch(coord_puts, coord_dels)
            return
        # the ledger imports the workpool, which imports this module
        from fabric_tpu_torch.common import workpool

        t = time.perf_counter
        with self._lock:
            guarded(self, "_epoch", by="kvstore.shard_flush")
            epoch = self._epoch + 1
            touched = sorted(set(shard_puts) | set(shard_dels))
            wall: dict[str, float] = {}

            def _prep(off, items):
                out = []
                for i in items:
                    t0 = t()
                    p = shard_puts.get(i, {})
                    faultline.point("store.shard_flush", stage="prepare",
                                    shard=i, epoch=epoch, puts=len(p))
                    self._stores[i].stage_pending(
                        p, shard_dels.get(i, ()), epoch)
                    out.append((i, t() - t0))
                return out

            def _apply(off, items):
                out = []
                for i in items:
                    t0 = t()
                    faultline.point("store.shard_flush", stage="apply",
                                    shard=i, epoch=epoch)
                    self._stores[i].apply_pending()
                    out.append((i, t() - t0))
                return out

            # the prepare and apply fan-out (FABRIC_TPU_STORE_POOL, default
            # auto, 0 serial); the width never changes a result
            width = min(workpool.stage_width("FABRIC_TPU_STORE_POOL"),
                        len(touched))
            pool = workpool.default_pool() if width > 1 else None
            t0 = t()
            # phase 1: stage every touched shard
            for i, dt in workpool.run_chunked(pool, _prep, touched,
                                              max(width, 1)):
                wall[f"shard{i}"] = wall.get(f"shard{i}", 0.0) + dt
            t1 = t()
            # phase 2, the commit point: the coordinator's mutations and
            # the epoch record in ONE transaction; a crash on either side
            # of it resolves at reopen (_recover_pending)
            faultline.point("store.shard_flush", stage="commit", epoch=epoch,
                            shards=len(touched))
            coord_puts[_EPOCH_KEY] = struct.pack(">Q", epoch)
            self._coord.write_batch(coord_puts, coord_dels)
            self._epoch = epoch
            t2 = t()
            # phase 3: fold each shard's stage into its kv table
            for i, dt in workpool.run_chunked(pool, _apply, touched,
                                              max(width, 1)):
                wall[f"shard{i}"] = wall.get(f"shard{i}", 0.0) + dt
            t3 = t()
            wall["prepare"] = t1 - t0
            wall["commit"] = t2 - t1
            wall["apply"] = t3 - t2
            self.last_stage_seconds = wall

    def write_batch_if_absent(self, puts) -> None:
        shard_puts, _, coord_puts, _ = self._partition(puts, ())
        if coord_puts:
            self._coord.write_batch_if_absent(coord_puts)
        for i in sorted(shard_puts):
            self._stores[i].write_batch_if_absent(shard_puts[i])

    def close(self) -> None:
        self._coord.close()
        for s in self._stores:
            s.close()


def open_store_root(root_dir: str | None) -> KVStore:
    """A provider's root store: MemKVStore for None; the single sqlite
    file `index.sqlite` unless FABRIC_TPU_STORE_SHARDS asks for more or
    shard files are already on disk: a sharded layout always reopens
    sharded, whatever the knob says now.  A single-file root that holds
    state is refused at a knob above 1 (ShardedKVStore)."""
    if root_dir is None:
        return MemKVStore()
    n = store_shards()
    if n <= 1 and not os.path.exists(
            os.path.join(root_dir, "state_00.sqlite")):
        return SqliteKVStore(os.path.join(root_dir, "index.sqlite"))
    return ShardedKVStore(root_dir, shards=n)


__all__ = [
    "KVStore", "MemKVStore", "SqliteKVStore",
    "ShardedKVStore", "WriteBatchCollector", "NamedDB", "wipe_prefix",
    "open_kvstore", "open_store_root", "store_shards", "shard_of_namespace",
    "state_shard", "sqlite_sync_level", "sqlite_wal_checkpoint",
]
