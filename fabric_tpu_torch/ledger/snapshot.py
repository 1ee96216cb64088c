"""Channel snapshots and joining a channel from one (the port's copy of
`fabric_tpu/ledger/snapshot.py`, without the remote fetch client).

Reference: core/ledger/kvledger/snapshot.go and snapshot_mgmt.go
(generation at commit, request bookkeeping) and kv_ledger_provider.go
CreateFromSnapshot.  A snapshot is a directory of deterministic, ordered
export files:

    public_state.data          raw (key, value) records of the public
                               namespaces, in state-key order
    private_state_hashes.data  the collections' hashed namespaces (key
                               and value hashes; cleartext private data
                               is never exported: a restored peer
                               reconciles it)
    txids.data                 every committed txid (the duplicate guard)
    confighistory.data         the collection-config history
    channel_config.block       the channel's config block
    _snapshot_signable_metadata.json
                               channel id, last block number and hash,
                               and each file's SHA-256

The files' digests come from one `hash_batch` call of the caller's CSP
(`CUDACSP.hash_batch` on the card, whose route picks B4 or hashlib; the
host's hashlib when no CSP is given, as the JAX package's software
provider).  `verify_snapshot` computes them again on import and refuses
a tampered directory.

Requests are kept under the ledger's bookkeeping/snapshot-request
namespace, and the ledger generates a requested snapshot when it commits
that block, on a background thread that `SnapshotManager.close` joins.
A snapshot lands in

    <snapshots_root>/completed/<ledger_id>/<last_block_number>/

through an in_progress directory and one rename, so a crash never leaves
a partial "completed" snapshot.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import struct
import threading
import time

from fabric_tpu_torch.ledger.bookkeeping import (
    SNAPSHOT_REQUEST,
    BookkeepingProvider,
)
from fabric_tpu_torch.ledger.confighistory import ConfigHistoryMgr
from fabric_tpu_torch.ledger.kvstore import KVStore, NamedDB
from fabric_tpu_torch.ledger.pvtdatastorage import PvtDataStore
from fabric_tpu_torch.ledger.statedb import Height, VersionedDB
from fabric_tpu_torch.ledger.txmgmt import key_hash

SNAPSHOT_FORMAT_VERSION = 1

METADATA_FILE = "_snapshot_signable_metadata.json"
PUBLIC_STATE_FILE = "public_state.data"
PVT_HASHES_FILE = "private_state_hashes.data"
TXIDS_FILE = "txids.data"
CONFIG_HISTORY_FILE = "confighistory.data"
CONFIG_BLOCK_FILE = "channel_config.block"

# the data files whose digests enter the metadata, in the order they are
# hashed (sorted, so that the metadata is deterministic)
DATA_FILES = (
    CONFIG_BLOCK_FILE,
    CONFIG_HISTORY_FILE,
    PVT_HASHES_FILE,
    PUBLIC_STATE_FILE,
    TXIDS_FILE,
)

_LEN = struct.Struct(">I")

_log = logging.getLogger("ledger.snapshot")


class SnapshotError(Exception):
    pass


class SnapshotExistsError(SnapshotError):
    """A snapshot of this channel at this height exists already: two
    requests answered by one group flush export at the same height, and
    the first one's snapshot answers both."""


# -- record files --------------------------------------------------------------
#
# Every .data file is a sequence of length-prefixed (key, value) byte-string
# pairs, in the order the source store iterates them (key order).


def _write_record(f, k: bytes, v: bytes) -> None:
    f.write(_LEN.pack(len(k)))
    f.write(k)
    f.write(_LEN.pack(len(v)))
    f.write(v)


def write_records(path: str, records) -> tuple[int, int]:
    """Write (key, value) pairs; returns (record count, byte count)."""
    count = size = 0
    with open(path, "wb") as f:
        for k, v in records:
            _write_record(f, k, v)
            count += 1
            size += 8 + len(k) + len(v)
    return count, size


def read_records(path: str):
    """The (key, value) pairs of a record file; raises SnapshotError on a
    truncated file."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_LEN.size)
            if not hdr:
                return
            if len(hdr) < _LEN.size:
                raise SnapshotError(f"truncated record file {path!r}")
            (klen,) = _LEN.unpack(hdr)
            k = f.read(klen)
            vhdr = f.read(_LEN.size)
            if len(k) < klen or len(vhdr) < _LEN.size:
                raise SnapshotError(f"truncated record file {path!r}")
            (vlen,) = _LEN.unpack(vhdr)
            v = f.read(vlen)
            if len(v) < vlen:
                raise SnapshotError(f"truncated record file {path!r}")
            yield k, v


# -- request bookkeeping -------------------------------------------------------


class SnapshotRequestBookkeeper:
    """Pending snapshot requests that survive a restart (reference
    snapshot_mgmt.go snapshotRequestBookkeeper): one key per requested
    block number."""

    def __init__(self, db):
        self._db = db

    @staticmethod
    def _key(block_number: int) -> bytes:
        return b"%016x" % block_number

    def submit(self, block_number: int) -> None:
        if self.has(block_number):
            raise SnapshotError(
                f"snapshot request for block {block_number} already pending")
        self._db.put(self._key(block_number), b"")

    def cancel(self, block_number: int) -> None:
        if not self.has(block_number):
            raise SnapshotError(
                f"no pending snapshot request for block {block_number}")
        self._db.delete(self._key(block_number))

    def has(self, block_number: int) -> bool:
        return self._db.get(self._key(block_number)) is not None

    def list_pending(self) -> list[int]:
        return [int(k, 16) for k, _ in self._db.iterate(b"", None)]


# -- generation ----------------------------------------------------------------


def _metadata_path(snapshot_dir: str) -> str:
    return os.path.join(snapshot_dir, METADATA_FILE)


def load_metadata(snapshot_dir: str) -> dict:
    path = _metadata_path(snapshot_dir)
    if not os.path.isfile(path):
        raise SnapshotError(f"no snapshot metadata at {path!r}")
    with open(path, "rb") as f:
        return json.loads(f.read().decode("utf-8"))


def _hash_files(snapshot_dir: str, names, csp=None) -> dict[str, str]:
    """Each file's SHA-256 (hex) from one `csp.hash_batch` call over all
    of them; without a CSP, the host's hashlib."""
    blobs = []
    for name in names:
        path = os.path.join(snapshot_dir, name)
        if not os.path.isfile(path):
            raise SnapshotError(f"snapshot file {name!r} is missing")
        with open(path, "rb") as f:
            blobs.append(f.read())
    if csp is not None:
        digests = csp.hash_batch(blobs)
    else:
        digests = [hashlib.sha256(b).digest() for b in blobs]
    return {name: d.hex() for name, d in zip(names, digests)}


def generate_snapshot(ledger, snapshots_root: str, csp=None) -> str:
    """Export the ledger at its durable height into
    <snapshots_root>/completed/<id>/<height - 1>; returns the directory.
    The same ledger state gives the same bytes in every file and the same
    metadata."""
    if not snapshots_root:
        raise SnapshotError("ledger provider has no snapshots directory")
    # the durable height: an open commit group's blocks are neither
    # readable nor sure to survive
    height = ledger.durable_height
    if height == 0:
        raise SnapshotError("cannot snapshot an empty ledger")
    lid = ledger.ledger_id
    last_num = height - 1
    final_dir = os.path.join(snapshots_root, "completed", lid, str(last_num))
    if os.path.exists(final_dir):
        raise SnapshotExistsError(
            f"snapshot for {lid!r} at block {last_num} already exists")
    work = os.path.join(snapshots_root, "in_progress", f"{lid}-{last_num}")
    if os.path.isdir(work):
        shutil.rmtree(work)  # a crashed earlier attempt
    os.makedirs(work)

    store = ledger.block_store
    state: VersionedDB = ledger.state_db

    # one ordered pass over the state, each record to the public or the
    # hashed file; cleartext private namespaces are left out.  The ns/key
    # split cannot tell a collection's pvt namespace from a public key
    # that embeds '\x00pvt\x00', so a record is dropped as private only
    # where its hashed counterpart exists (every committed private write
    # also committed its hash); a look-alike public key rides the public
    # file.  Which of the two exported files a record lands in does not
    # matter to an import, which writes both verbatim.
    with open(os.path.join(work, PUBLIC_STATE_FILE), "wb") as pub_f, \
            open(os.path.join(work, PVT_HASHES_FILE), "wb") as hash_f:
        for raw_key, raw_val in state.export_records():
            ns, key = VersionedDB.split_state_key(raw_key)
            parts = ns.split("\x00")
            if len(parts) == 3 and parts[1] == "pvt":
                hashed_ns = f"{parts[0]}\x00hash\x00{parts[2]}"
                if state.get_state(hashed_ns, key_hash(key).hex()) is not None:
                    continue  # cleartext private data: never exported
            out = hash_f if len(parts) == 3 and parts[1] == "hash" else pub_f
            _write_record(out, raw_key, raw_val)
    write_records(os.path.join(work, TXIDS_FILE),
                  ((t.encode(), b"") for t in store.export_txids()))
    write_records(os.path.join(work, CONFIG_HISTORY_FILE),
                  ledger.config_history.export_entries())
    cfg_raw = store.config_block_bytes()
    if cfg_raw is None:
        blk0 = store.get_block_by_number(0)
        if blk0 is None:
            raise SnapshotError(
                f"ledger {lid!r} has neither a config block nor block 0")
        cfg_raw = blk0.encode()
    with open(os.path.join(work, CONFIG_BLOCK_FILE), "wb") as f:
        f.write(cfg_raw)

    files = _hash_files(work, DATA_FILES, csp)
    last_blk = store.get_block_by_number(last_num)
    sp = state.savepoint()
    meta = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "channel_id": lid,
        "last_block_number": last_num,
        "last_block_hash": ledger.durable_block_hash.hex(),
        # for auditors who check the metadata against the chain; the
        # import does not read it
        "previous_block_hash": (last_blk.header.previous_hash.hex()
                                if last_blk is not None else ""),
        "state_savepoint": [sp.block_num, sp.tx_num] if sp else None,
        "index_defs": {ns: sorted(state.indexes_for(ns))
                       for ns in sorted(state.indexed_namespaces())},
        "files": files,
    }
    with open(_metadata_path(work), "wb") as f:
        f.write(json.dumps(meta, sort_keys=True, indent=2).encode())
    os.makedirs(os.path.dirname(final_dir), exist_ok=True)
    os.replace(work, final_dir)
    return final_dir


# -- verification and import ---------------------------------------------------


def verify_snapshot(snapshot_dir: str, csp=None) -> dict:
    """Compute every data file's digest again (one `hash_batch`) and hold
    it against the metadata; returns the metadata.  Raises SnapshotError
    on a mismatch or a missing file."""
    meta = load_metadata(snapshot_dir)
    if meta.get("version") != SNAPSHOT_FORMAT_VERSION:
        raise SnapshotError(
            f"unsupported snapshot format version {meta.get('version')!r}")
    expected = meta.get("files") or {}
    # a digest for every data file: a metadata that drops one would exempt
    # that file from the check
    missing = [n for n in DATA_FILES if n not in expected]
    if missing:
        raise SnapshotError(
            "snapshot metadata lists no digest for: " + ", ".join(missing))
    names = sorted(expected)
    actual = _hash_files(snapshot_dir, names, csp)
    bad = [n for n in names if actual[n] != expected[n]]
    if bad:
        raise SnapshotError(
            "snapshot file hash mismatch (tampered or corrupt): "
            + ", ".join(bad))
    return meta


IMPORT_IN_PROGRESS = b"in_progress"
IMPORT_DONE = b"done"


def import_marker(kv: KVStore, ledger_id: str) -> bytes | None:
    """The channel's import marker: None (never imported),
    IMPORT_IN_PROGRESS (an import that crashed: the stores hold part of
    the snapshot and must not be served) or IMPORT_DONE."""
    return NamedDB(kv, f"snapimport/{ledger_id}").get(b"state")


def import_snapshot(meta: dict, snapshot_dir: str, store, kv: KVStore,
                    ledger_id: str) -> None:
    """Fill an empty channel's stores from a verified snapshot: the block
    store's bootstrap and txid index, the state DB (public and hashed,
    its savepoint at the snapshot, so that recovery replays nothing), the
    index definitions, the config history and the private-data store's
    bootstrap height.  The caller then opens the KVLedger on the stores.

    The IMPORT_IN_PROGRESS marker lands first and turns IMPORT_DONE only
    when every store is filled, so a crash in between leaves a channel
    that LedgerProvider.open refuses."""
    marker = NamedDB(kv, f"snapimport/{ledger_id}")
    marker.put(b"state", IMPORT_IN_PROGRESS)
    last_num = int(meta["last_block_number"])
    with open(os.path.join(snapshot_dir, CONFIG_BLOCK_FILE), "rb") as f:
        cfg_raw = f.read()
    store.bootstrap(last_num, bytes.fromhex(meta["last_block_hash"]),
                    config_block=cfg_raw)
    store.import_snapshot_txids(
        k.decode() for k, _ in read_records(
            os.path.join(snapshot_dir, TXIDS_FILE)))

    def state_records():
        yield from read_records(os.path.join(snapshot_dir, PUBLIC_STATE_FILE))
        yield from read_records(os.path.join(snapshot_dir, PVT_HASHES_FILE))

    sp = meta.get("state_savepoint")
    savepoint = Height(sp[0], sp[1]) if sp else Height(last_num, 0)
    state = VersionedDB(kv, f"statedb/{ledger_id}")
    state.import_records(state_records(), savepoint)
    for ns, specs in (meta.get("index_defs") or {}).items():
        for spec in specs:
            state.define_index(ns, spec)
    ConfigHistoryMgr(kv, ledger_id).import_entries(
        read_records(os.path.join(snapshot_dir, CONFIG_HISTORY_FILE)))
    PvtDataStore(kv, ledger_id).init_bootstrap_height(last_num + 1)
    marker.put(b"state", IMPORT_DONE)


# -- manager -------------------------------------------------------------------


class SnapshotManager:
    """A ledger's snapshot front end (reference snapshot_mgmt.go
    snapshotMgr): request bookkeeping, generation when a requested block
    commits, and generation on demand.

    Lock order everywhere: the ledger's commit_lock, then this manager's
    lock (the commit-time trigger holds the commit lock already)."""

    def __init__(self, ledger, snapshots_root: str | None, kv: KVStore,
                 csp=None):
        self._ledger = ledger
        self._root = snapshots_root
        self._csp = csp
        self._requests = SnapshotRequestBookkeeper(
            BookkeepingProvider(kv).get_kv(ledger.ledger_id,
                                           SNAPSHOT_REQUEST))
        self._lock = threading.Lock()
        # background generations: how many run (wait_idle), and a spawn /
        # acknowledge handshake: commits wait until every spawned
        # generation holds the commit lock (wait_generation_turn), so that
        # an export runs before state moves past its height
        self._idle = threading.Condition()
        self._inflight = 0
        self._spawn_seq = 0
        self._ack_seq = 0
        self._threads: list[threading.Thread] = []
        # the pending requests in memory: the commit path asks per block
        self._pending = set(self._requests.list_pending())

    # -- requests --------------------------------------------------------------

    def submit_request(self, block_number: int = 0) -> dict:
        """Request a snapshot at `block_number` (0: the last durable
        block).  A request at the last durable block generates at once; a
        later block is recorded and generated when the ledger commits it
        (reference SubmitSnapshotRequest)."""
        with self._ledger.commit_lock:
            with self._lock:
                last = self._ledger.durable_height - 1
                if block_number == 0:
                    if last < 0:
                        raise SnapshotError("ledger has no committed blocks")
                    block_number = last
                if block_number < last:
                    raise SnapshotError(
                        f"requested block {block_number} is already "
                        f"committed (last committed block is {last})")
                if block_number == last:
                    return {"block_number": block_number,
                            "snapshot_dir": self._generate()}
                if block_number < self._ledger.height:
                    # buffered in an open commit group: its flush could
                    # only export at the group's later height
                    raise SnapshotError(
                        f"requested block {block_number} is already "
                        f"buffered in an open commit group (last durable "
                        f"block is {last}); request block 0 for the last "
                        f"durable block, or a block >= "
                        f"{self._ledger.height}")
                self._requests.submit(block_number)
                self._pending.add(block_number)
                return {"block_number": block_number, "snapshot_dir": None}

    def cancel_request(self, block_number: int) -> None:
        with self._lock:
            self._requests.cancel(block_number)
            self._pending.discard(block_number)

    def has_pending_request(self, block_number: int) -> bool:
        """The commit path's per-block probe, in memory."""
        return block_number in self._pending

    def list_pending(self) -> list[int]:
        return self._requests.list_pending()

    # -- generation ------------------------------------------------------------

    def on_block_committed(self, block_number: int) -> None:
        """Called by the ledger's group flush (commit lock held) for each
        block made durable: a pending request for it hands the export to a
        background thread.  The export height is the requested one: the
        streaming committer flushes at a requested block
        (CommitGroup.boundary_hint), submit_request refuses a block an open
        group buffers, and the next commit waits in wait_generation_turn
        until the export holds the commit lock.  A failed export is logged
        and its request dropped: a commit never fails for a snapshot."""
        with self._lock:
            if not self._requests.has(block_number):
                return
            self._requests.cancel(block_number)
            self._pending.discard(block_number)
        with self._idle:
            self._inflight += 1
            self._spawn_seq += 1
            th = threading.Thread(
                target=self._bg_generate, args=(block_number,),
                name=f"snapshot-gen-{self._ledger.ledger_id}", daemon=True)
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(th)
        th.start()

    def wait_generation_turn(self, timeout: float = 30.0) -> None:
        """Wait until every spawned generation holds the commit lock; the
        ledger calls this before it takes the lock for a commit or a
        flush.  Gives up after `timeout` rather than stall commits behind
        a thread that died first."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._ack_seq < self._spawn_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._idle.wait(remaining)

    def _bg_generate(self, block_number: int) -> None:
        try:
            with self._ledger.commit_lock:
                with self._idle:
                    self._ack_seq += 1
                    self._idle.notify_all()
                with self._lock:
                    self._generate()
        except SnapshotExistsError:
            pass  # another request of the same flush exported this height
        except Exception as exc:
            _log.warning("snapshot generation at block %d failed for %r: %s",
                         block_number, self._ledger.ledger_id, exc)
        finally:
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Wait until no background generation runs; False on timeout."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def generate(self) -> str:
        """Generate a snapshot at the durable height."""
        with self._ledger.commit_lock:
            with self._lock:
                return self._generate()

    def _generate(self) -> str:
        return generate_snapshot(self._ledger, self._root, csp=self._csp)

    def close(self) -> None:
        """Join every background generation."""
        with self._idle:
            threads, self._threads = self._threads, []
        for th in threads:
            th.join()


# -- serving a snapshot directory ----------------------------------------------
#
# A completed snapshot streams over any frame transport: each frame is a
# JSON header line (file name, end-of-file mark) and a raw chunk, the first
# frame the manifest.  The receiver rebuilds the directory; verification on
# import computes every digest again, so a torn or tampered stream is
# refused without trusting the transport.

FETCH_CHUNK = 1 << 20


def completed_snapshot_dir(snapshots_root: str, ledger_id: str,
                           block_number: int) -> str:
    """completed/<lid>/<height>; raises when it does not exist."""
    path = os.path.join(snapshots_root, "completed", ledger_id,
                        str(int(block_number)))
    if not os.path.isdir(path):
        raise SnapshotError(
            f"no completed snapshot for {ledger_id!r} at height "
            f"{block_number}")
    return path


def list_completed(snapshots_root: str, ledger_id: str) -> list[int]:
    """A channel's completed snapshot heights, ascending."""
    ldir = os.path.join(snapshots_root, "completed", ledger_id)
    if not os.path.isdir(ldir):
        return []
    return sorted(int(h) for h in os.listdir(ldir) if h.isdigit())


def stream_snapshot_dir(snapshot_dir: str):
    """The frames of a completed snapshot directory: the manifest, then
    per chunk a JSON header line and the raw bytes."""
    names = sorted(n for n in os.listdir(snapshot_dir)
                   if os.path.isfile(os.path.join(snapshot_dir, n)))
    yield json.dumps(
        {"manifest": names, "snapshot": os.path.basename(snapshot_dir)},
        sort_keys=True).encode() + b"\n"
    for name in names:
        with open(os.path.join(snapshot_dir, name), "rb") as f:
            while True:
                chunk = f.read(FETCH_CHUNK)
                eof = len(chunk) < FETCH_CHUNK
                header = json.dumps({"name": name, "eof": eof},
                                    sort_keys=True).encode() + b"\n"
                yield header + chunk
                if eof:
                    break


def receive_snapshot_stream(frames, dest_dir: str) -> str:
    """Rebuild a streamed snapshot directory under `dest_dir` and return
    it.  The caller verifies (create_from_snapshot, verify_snapshot): a
    stream cut midway leaves a partial directory that they refuse."""
    os.makedirs(dest_dir, exist_ok=True)
    open_files: dict = {}
    try:
        it = iter(frames)
        first = next(it, None)
        if first is None:
            raise SnapshotError("empty snapshot stream")
        manifest = json.loads(first.split(b"\n", 1)[0].decode("utf-8"))
        if "manifest" not in manifest:
            raise SnapshotError("snapshot stream missing its manifest")
        for frame in it:
            header_line, chunk = frame.split(b"\n", 1)
            header = json.loads(header_line.decode("utf-8"))
            name = os.path.basename(header["name"])  # no path escapes
            f = open_files.get(name)
            if f is None:
                f = open_files[name] = open(os.path.join(dest_dir, name),
                                            "wb")
            f.write(chunk)
            if header.get("eof"):
                open_files.pop(name).close()
    finally:
        for f in open_files.values():
            f.close()
    return dest_dir


__all__ = [
    "SnapshotError", "SnapshotExistsError", "SnapshotManager",
    "SnapshotRequestBookkeeper", "generate_snapshot", "verify_snapshot",
    "import_snapshot", "import_marker", "IMPORT_IN_PROGRESS", "IMPORT_DONE",
    "load_metadata", "read_records", "write_records", "METADATA_FILE",
    "PUBLIC_STATE_FILE", "PVT_HASHES_FILE", "TXIDS_FILE",
    "CONFIG_HISTORY_FILE", "CONFIG_BLOCK_FILE", "DATA_FILES",
    "SNAPSHOT_FORMAT_VERSION", "completed_snapshot_dir", "list_completed",
    "stream_snapshot_dir", "receive_snapshot_stream", "FETCH_CHUNK",
]
