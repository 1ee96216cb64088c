"""Block storage: preallocated segment files and a KV index (the port's
copy of `fabric_tpu/ledger/blkstorage.py`).

Reference: common/ledger/blkstorage (blockfile_mgr.go's append-only
files, blockindex.go's indexes by number, hash and txid, restart recovery
from a checkpoint and a scan of the tail).  Blocks are stored as a 4-byte
big-endian length and `serialize_block`'s bytes, in files
`blocks_NNNNNN.dat`, each preallocated to FABRIC_TPU_STORE_SEGMENT bytes
(16 MiB) through a temporary file, a rename and a directory fsync.
Records land inside the allocated space at the checkpoint's offset, so
the group's durability barrier is one fdatasync.  A zero length marks the
clean preallocated tail; recovery re-indexes the complete records past
the checkpoint and erases from the first damaged one.  `dir=None` keeps
blocks in memory.  The faultline points are the JAX package's:
``blkstorage.file_append`` (a write point), ``blkstorage.fsync``,
``blkstorage.segment_prealloc``, ``blkstorage.segment_roll`` and the
``blkstorage.recovery_truncate`` guard.

The index, under `blkindex/<name>`:

    cp              ->  >QQQ file, offset after the last indexed record, height
    n + >Q number   ->  >QQ file, offset
    h + header hash ->  >Q number
    t + txid        ->  >QQ number, position (the first occurrence wins;
                        all ones for a txid imported from a snapshot)
    bsi             ->  >Q last block number of the snapshot, its hash
    cfg             ->  the channel's config block, for a store created
                        from a snapshot (it holds no block 0)

A store bootstrapped from a snapshot (reference blkstorage
BootstrapFromSnapshottedTxIDs) starts at the snapshot's height with no
block files below it.
"""

from __future__ import annotations

import os
import struct
import threading

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.devtools import faultline
from fabric_tpu_torch.ledger.kvstore import KVStore, MemKVStore, NamedDB, knob
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos.wire import DecodeError

_LEN = struct.Struct(">I")

DEFAULT_SEGMENT = 16 * 1024 * 1024
_MIN_SEGMENT = 4096
_BSI_KEY = b"bsi"
_CFG_KEY = b"cfg"
# the txid index's location of a transaction from before the snapshot: it
# exists (the duplicate guard sees it) but has no block here
_SNAPSHOT_TX_LOC = struct.pack(">QQ", 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF)


def segment_size(override: int | None = None) -> int:
    """FABRIC_TPU_STORE_SEGMENT: a segment's preallocated size in bytes
    (k and m suffixes accepted; default 16 MiB, at least 4 KiB)."""
    if override is not None:
        return max(_MIN_SEGMENT, int(override))
    raw = knob("FABRIC_TPU_STORE_SEGMENT").strip().lower()
    if not raw:
        return DEFAULT_SEGMENT
    mult = 1
    if raw.endswith("k"):
        mult, raw = 1024, raw[:-1]
    elif raw.endswith("m"):
        mult, raw = 1024 * 1024, raw[:-1]
    try:
        n = int(raw) * mult
    except ValueError:
        raise ValueError(
            f"FABRIC_TPU_STORE_SEGMENT={raw!r} is not a byte size "
            "(integer, optionally with a k/m suffix)"
        ) from None
    return max(_MIN_SEGMENT, n)


class BlockStoreError(Exception):
    pass


def _bsi_height(raw: bytes | None) -> int:
    return 0 if raw is None else struct.unpack(">Q", raw[:8])[0] + 1


def read_bootstrap_height(index_store: KVStore, name: str) -> int:
    """A store's snapshot-bootstrap height read from its index alone,
    without opening the store (no recovery scan, no checkpoint write)."""
    return _bsi_height(NamedDB(index_store, f"blkindex/{name}").get(_BSI_KEY))


class BlockStore:
    def __init__(self, dir: str | None, index_store: KVStore | None = None,
                 name: str = "chain", segment: int | None = None):
        self._dir = dir
        self._index = NamedDB(index_store or MemKVStore(), f"blkindex/{name}")
        self._lock = threading.RLock()
        self._mem_blocks: list[bytes] | None = [] if dir is None else None
        self._height = 0
        self._last_hash = b""
        self._segment = segment_size(segment)
        # the active segment's writer (r+b: records land inside the
        # preallocated space at the checkpoint's offset)
        self._fh = None
        self._fh_idx = -1
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self._recover()
        else:
            _, _, self._height = self._checkpoint()
            raw = self._index.get(_BSI_KEY)
            if self._height and raw is not None:
                self._last_hash = raw[8:]

    # -- files ----------------------------------------------------------------

    def _file_path(self, idx: int) -> str:
        return os.path.join(self._dir, f"blocks_{idx:06d}.dat")

    def _checkpoint(self, index=None) -> tuple[int, int, int]:
        """(file, offset after the last indexed record, height); `index`
        may be a group's buffered view."""
        raw = (index or self._index).get(b"cp")
        if raw is None:
            return (0, 0, 0)
        return struct.unpack(">QQQ", raw)  # type: ignore[return-value]

    def _recover(self) -> None:
        """Re-index the records appended after the checkpoint; erase from
        the first damaged one on (reference blockfile_helper
        scanForLastCompleteBlock).  A group appends several records between
        barriers, so a crash may tear one that is not the last: a record
        that fails to parse, or whose number breaks the chain, ends what
        can be replayed.  A zero length is the clean preallocated tail."""
        file_idx, offset, height = self._checkpoint()
        self._height = height
        scanned: set[int] = set()
        # a crash between the allocation and the rename left a .pre file
        for fn in os.listdir(self._dir):
            if fn.endswith(".pre"):
                os.remove(os.path.join(self._dir, fn))
        while True:
            path = self._file_path(file_idx)
            if not os.path.exists(path):
                break
            size = os.path.getsize(path)
            torn = False
            with open(path, "rb") as f:
                f.seek(offset)
                while True:
                    hdr = f.read(_LEN.size)
                    if len(hdr) < _LEN.size:
                        torn = len(hdr) > 0
                        break
                    (n,) = _LEN.unpack(hdr)
                    if n == 0:
                        break  # the clean preallocated tail
                    raw = f.read(n)
                    if len(raw) < n:
                        torn = True
                        break
                    try:
                        blk = cb.Block.decode(raw)
                    except DecodeError:
                        torn = True
                        break
                    if blk.header.number != self._height:
                        torn = True
                        break  # not the next block: damaged or stale bytes
                    self._index_block(blk, file_idx, offset)
                    offset += _LEN.size + n
                    self._height = blk.header.number + 1
                    scanned.add(file_idx)
            if torn:
                # a guard point: a "skip" rule leaves the torn bytes
                # (the next write overwrites from the checkpoint offset)
                if faultline.guard("blkstorage.recovery_truncate",
                                   file=file_idx):
                    self._erase_tail(path, offset, size)
                scanned.add(file_idx)
            if os.path.exists(self._file_path(file_idx + 1)):
                file_idx += 1
                offset = 0
            else:
                break
        # the re-indexed records may never have been synced: make them
        # durable before the checkpoint below points past them
        self.sync_files(scanned)
        self._last_hash = self._bootstrap_hash_if_empty()
        self._write_checkpoint(file_idx, offset)

    def _bootstrap_hash_if_empty(self) -> bytes:
        """The last block's hash where no block of the height is stored:
        a store bootstrapped from a snapshot keeps it in its bootstrap
        info."""
        if self._height == 0:
            return b""
        last = self.get_block_by_number(self._height - 1)
        if last is not None:
            return protoutil.block_header_hash(last.header)
        raw = self._index.get(_BSI_KEY)
        return raw[8:] if raw is not None else b""

    def _write_checkpoint(self, file_idx: int, offset: int) -> None:
        self._index.put(b"cp", struct.pack(">QQQ", file_idx, offset,
                                           self._height))

    def _erase_tail(self, path: str, offset: int, size: int) -> None:
        """Cut a damaged tail at the last complete record, then extend the
        file back to the segment size with zeros (the clean tail)."""
        with open(path, "r+b") as f:
            f.truncate(offset)
            if offset < self._segment and size >= self._segment:
                f.truncate(self._segment)

    def _sync_dir(self) -> None:
        fd = os.open(self._dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _prealloc_segment(self, idx: int, size: int) -> None:
        """Create segment `idx` at once: allocate and fsync a temporary
        file, rename it into place, fsync the directory."""
        path = self._file_path(idx)
        tmp = path + ".pre"
        fd = os.open(tmp, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        try:
            try:
                os.posix_fallocate(fd, 0, size)
            except (AttributeError, OSError):
                os.ftruncate(fd, size)  # sparse where fallocate is refused
            os.fsync(fd)
        finally:
            os.close(fd)
        faultline.point("blkstorage.segment_prealloc", file=idx, size=size)
        os.rename(tmp, path)
        self._sync_dir()

    def _segment_fh(self, idx: int):
        """The writer of segment `idx`, allocated on first touch."""
        if self._fh is not None and self._fh_idx == idx:
            return self._fh
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        path = self._file_path(idx)
        if not os.path.exists(path):
            self._prealloc_segment(idx, self._segment)
        self._fh = open(path, "r+b")
        self._fh_idx = idx
        return self._fh

    def _seal_segment(self, idx: int, data_size: int) -> None:
        """Roll to the next segment: trim this one to its records and make
        the new size durable."""
        faultline.point("blkstorage.segment_roll", file=idx, size=data_size)
        f = self._segment_fh(idx)
        f.truncate(data_size)
        f.flush()
        os.fsync(f.fileno())
        self._fh.close()
        self._fh = None
        self._fh_idx = -1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
                self._fh_idx = -1

    # -- the index ------------------------------------------------------------

    @staticmethod
    def _parse_txid(raw_env: bytes) -> str | None:
        """An envelope's txid, or None where it has none or does not
        parse."""
        try:
            env = cb.Envelope.decode(raw_env)
            payload = cb.Payload.decode(env.payload)
            chdr = cb.ChannelHeader.decode(payload.header.channel_header)
        except DecodeError:
            return None
        return chdr.tx_id or None

    def _index_block(self, blk: cb.Block, file_idx: int, offset: int,
                     txids: list | None = None,
                     checkpoint: tuple[int, int] | None = None,
                     index=None) -> None:
        """`txids` may carry the validator's txid of each position (a
        position without one is parsed here); `checkpoint` rides the
        number and hash batch, with the height the block makes."""
        num_b = struct.pack(">Q", blk.header.number)
        puts = {
            b"n" + num_b: struct.pack(">QQ", file_idx, offset),
            b"h" + protoutil.block_header_hash(blk.header): num_b,
        }
        if checkpoint is not None:
            puts[b"cp"] = struct.pack(">QQQ", checkpoint[0], checkpoint[1],
                                      blk.header.number + 1)
        data = blk.data.data
        if txids is None or len(txids) != len(data):
            txids = [None] * len(data)
        tx_puts: dict[bytes, bytes] = {}
        for pos, txid in enumerate(txids):
            if txid is None:
                txid = self._parse_txid(data[pos])
            if txid:
                # the first occurrence in the block (setdefault) and across
                # blocks (insert if absent) wins
                tx_puts.setdefault(b"t" + txid.encode(),
                                   num_b + struct.pack(">Q", pos))
        index = index or self._index
        index.write_batch_if_absent(tx_puts)
        index.write_batch(puts)

    # -- public API -----------------------------------------------------------

    @property
    def height(self) -> int:
        return self._height

    @property
    def last_block_hash(self) -> bytes:
        return self._last_hash

    def info(self) -> dict:
        return {"height": self._height, "currentBlockHash": self._last_hash}

    # -- snapshot bootstrap ---------------------------------------------------

    @property
    def bootstrap_height(self) -> int:
        """The height at the snapshot the store was created from (0: not
        created from one).  No block below it exists here."""
        return _bsi_height(self._index.get(_BSI_KEY))

    @property
    def bootstrap_hash(self) -> bytes:
        """The snapshot's last block hash (b"" when not bootstrapped): the
        previous hash the first appended block must carry."""
        raw = self._index.get(_BSI_KEY)
        return raw[8:] if raw is not None else b""

    def bootstrap(self, last_block_num: int, last_block_hash: bytes,
                  config_block: bytes | None = None) -> None:
        """Start an empty store at a snapshot: it reports height
        last_block_num + 1 and takes the next block at that number."""
        with self._lock:
            if self._height:
                raise BlockStoreError(
                    "cannot bootstrap a non-empty block store "
                    f"(height {self._height})")
            self._height = last_block_num + 1
            self._last_hash = last_block_hash
            puts = {_BSI_KEY: struct.pack(">Q", last_block_num)
                    + last_block_hash}
            if config_block is not None:
                puts[_CFG_KEY] = config_block
            self._index.write_batch(puts)
            self._write_checkpoint(0, 0)

    def config_block_bytes(self) -> bytes | None:
        """The config block stored at a snapshot's import (None where the
        config is in block 0)."""
        return self._index.get(_CFG_KEY)

    def import_snapshot_txids(self, txids) -> None:
        """Enter a snapshot's committed txids into the index at the
        sentinel location: tx_ids_exist sees them (the duplicate guard
        spans the snapshot), location queries do not (the reference's
        'details not available from snapshot')."""
        chunk: dict[bytes, bytes] = {}
        for txid in txids:
            chunk[b"t" + txid.encode()] = _SNAPSHOT_TX_LOC
            if len(chunk) >= 10000:
                self._index.write_batch_if_absent(chunk)
                chunk = {}
        if chunk:
            self._index.write_batch_if_absent(chunk)

    def export_txids(self):
        """Every indexed txid, appended and imported ones (so that a
        snapshot of a bootstrapped ledger is whole), in index order."""
        for k, _ in self._index.iterate(b"t", b"u"):
            yield k[1:].decode()

    # -- blocks ---------------------------------------------------------------

    def add_block(self, blk: cb.Block, txids: list | None = None,
                  env_bytes: list | None = None, into=None,
                  sync: bool = True) -> int | None:
        """Append and index; returns the file written (None in memory).
        `txids` and `env_bytes` are the validator's (see CommitAssist).
        `into` (a WriteBatchCollector over the index's store) buffers the
        index and checkpoint into the group's transaction, and
        `sync=False` leaves the fdatasync to `sync_files` at the group's
        boundary, which runs before the transaction."""
        with self._lock:
            if blk.header.number != self._height:
                raise BlockStoreError(
                    f"block number {blk.header.number} != expected "
                    f"{self._height}")
            index = self._index if into is None else self._index.rebase(into)
            raw = protoutil.serialize_block(blk, env_bytes)
            if self._mem_blocks is not None:
                self._mem_blocks.append(raw)
                self._index_block(blk, 0, len(self._mem_blocks) - 1, txids,
                                  checkpoint=(0, len(self._mem_blocks)),
                                  index=index)
                file_idx = None
            else:
                file_idx, offset, _ = self._checkpoint(index)
                rec = _LEN.size + len(raw)
                if offset > 0 and offset + rec > self._segment:
                    self._seal_segment(file_idx, offset)
                    file_idx += 1
                    offset = 0
                f = self._segment_fh(file_idx)
                f.seek(offset)
                # a "torn" rule writes a prefix of the record and
                # crashes: the tear the recovery scan erases
                faultline.write("blkstorage.file_append", f,
                                _LEN.pack(len(raw)), raw,
                                block=blk.header.number)
                f.flush()
                if sync:
                    os.fdatasync(f.fileno())
                self._index_block(blk, file_idx, offset, txids,
                                  checkpoint=(file_idx, offset + rec),
                                  index=index)
            # the height moves after the block's index entry is written,
            # so a lock-free reader (a deliver stream) never sees a height
            # whose block it cannot read (the reference's store moves it
            # first: ROADMAP Queue C)
            self._height += 1
            self._last_hash = protoutil.block_header_hash(blk.header)
            return file_idx

    def truncate_to_checkpoint(self) -> None:
        """Undo the appends that were never indexed: drop the file data
        past the committed checkpoint and restore height and hash from
        it (a failed group, whose index writes are lost)."""
        with self._lock:
            file_idx, offset, height = self._checkpoint()
            if self._mem_blocks is not None:
                del self._mem_blocks[offset:]
            else:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                    self._fh_idx = -1
                i = file_idx + 1
                while os.path.exists(self._file_path(i)):
                    os.remove(self._file_path(i))
                    i += 1
                path = self._file_path(file_idx)
                if os.path.exists(path):
                    self._erase_tail(path, offset, os.path.getsize(path))
            self._height = height
            self._last_hash = self._bootstrap_hash_if_empty()

    def sync_files(self, file_idxs) -> None:
        """One fdatasync per touched segment: the records land inside
        allocated space, so the files' metadata does not change."""
        if self._mem_blocks is not None:
            return
        for idx in sorted(file_idxs):
            faultline.point("blkstorage.fsync", file=idx)
            fd = os.open(self._file_path(idx), os.O_RDONLY)
            try:
                os.fdatasync(fd)
            finally:
                os.close(fd)

    def get_block_by_number(self, num: int) -> cb.Block | None:
        if num >= self._height:
            return None
        loc = self._index.get(b"n" + struct.pack(">Q", num))
        if loc is None:
            return None
        file_idx, offset = struct.unpack(">QQ", loc)
        if self._mem_blocks is not None:
            return cb.Block.decode(self._mem_blocks[offset])
        with open(self._file_path(file_idx), "rb") as f:
            f.seek(offset)
            (n,) = _LEN.unpack(f.read(_LEN.size))
            return cb.Block.decode(f.read(n))

    def get_block_by_hash(self, block_hash: bytes) -> cb.Block | None:
        raw = self._index.get(b"h" + block_hash)
        if raw is None:
            return None
        return self.get_block_by_number(struct.unpack(">Q", raw)[0])

    def get_tx_loc(self, txid: str) -> tuple[int, int] | None:
        raw = self._index.get(b"t" + txid.encode())
        if raw is None or raw == _SNAPSHOT_TX_LOC:
            return None  # not committed, or committed before the snapshot
        num, pos = struct.unpack(">QQ", raw)
        return num, pos

    def tx_ids_exist(self, txids) -> set[str]:
        """The txids of `txids` already in the index, in one round trip."""
        got = self._index.get_many([b"t" + t.encode() for t in txids])
        return {k[1:].decode() for k in got}

    def get_tx_by_id(self, txid: str) -> cb.Envelope | None:
        loc = self.get_tx_loc(txid)
        if loc is None:
            return None
        return protoutil.extract_envelope(self.get_block_by_number(loc[0]),
                                          loc[1])

    def get_tx_validation_code(self, txid: str) -> int | None:
        loc = self.get_tx_loc(txid)
        if loc is None:
            return None
        return protoutil.tx_filter(self.get_block_by_number(loc[0]))[loc[1]]

    def iterator(self, start: int = 0):
        """The blocks from `start` to the height."""
        num = start
        while num < self._height:
            yield self.get_block_by_number(num)
            num += 1


__all__ = ["BlockStore", "BlockStoreError", "read_bootstrap_height",
           "segment_size", "DEFAULT_SEGMENT"]
