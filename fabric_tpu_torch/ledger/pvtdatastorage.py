"""Private-data store: each block's private write sets (the port's copy of
`fabric_tpu/ledger/pvtdatastorage.py`).

Reference: core/ledger/pvtdatastorage/store.go and kv_encoding.go.  Keeps
the cleartext TxPvtReadWriteSets committed with each block, the
collections this peer was eligible for and did not receive ("missing
data", the reconciler's work list), and an expiry index by which each
collection's data is purged after its block-to-live (BTL).
"""

from __future__ import annotations

import json
import struct
import threading

from fabric_tpu_torch.ledger.kvstore import KVStore, NamedDB
from fabric_tpu_torch.protos import rwset as rw
from fabric_tpu_torch.protos.wire import DecodeError

_DATA = b"d"  # d<block:16x><tx:8x> -> TxPvtReadWriteSet
_MISS = b"m"  # m<block:16x><tx:8x> -> json [[ns, coll], ...]
_EXP = b"x"   # x<expiry:16x><block:16x> -> json [[tx, ns, coll], ...]
_BOOT = b"b"  # >Q the height of the snapshot the store was created from


def _dkey(block: int, tx: int) -> bytes:
    return _DATA + b"%016x%08x" % (block, tx)


def _mkey(block: int, tx: int) -> bytes:
    return _MISS + b"%016x%08x" % (block, tx)


def _xkey(expiry: int, block: int) -> bytes:
    return _EXP + b"%016x%016x" % (expiry, block)


def _collections(txpvt: rw.TxPvtReadWriteSet) -> set[tuple[str, str]]:
    return {(nsp.namespace, cp.collection_name)
            for nsp in txpvt.ns_pvt_rwset for cp in nsp.collection_pvt_rwset}


class PvtDataStore:
    def __init__(self, kv: KVStore, ledger_id: str, btl_policy=None):
        """btl_policy(ns, coll) -> blocks to live (0: forever; the
        default, reference pvtdatapolicy.BTLPolicy)."""
        self._db = NamedDB(kv, f"pvtdata/{ledger_id}")
        self._btl = btl_policy or (lambda ns, coll: 0)
        self._lock = threading.Lock()

    # -- commit ---------------------------------------------------------------

    def commit(self, block_num: int, pvt_data: dict[int, bytes],
               missing: list[tuple[int, str, str]] | None = None,
               into=None) -> None:
        """Store the block's private data ({tx_num: TxPvtReadWriteSet
        bytes}) and missing-data records [(tx_num, ns, coll)], then purge
        what expires at this height (reference store.go Commit and
        purgeExpiredData).  `into` (a WriteBatchCollector over this
        store's KV) buffers all of it, the purge included, into the
        group's transaction."""
        db = self._db if into is None else self._db.rebase(into)
        puts: dict[bytes, bytes] = {}
        expiry_adds: dict[int, list[tuple[int, str, str]]] = {}
        for tx_num in sorted(pvt_data):
            raw = pvt_data[tx_num]
            puts[_dkey(block_num, tx_num)] = raw
            for ns, coll in self._collections_of(raw):
                btl = self._btl(ns, coll)
                if btl:
                    expiry_adds.setdefault(block_num + btl + 1, []).append(
                        (tx_num, ns, coll))
        by_tx: dict[int, list[tuple[str, str]]] = {}
        for tx_num, ns, coll in missing or []:
            by_tx.setdefault(tx_num, []).append((ns, coll))
        for tx_num, pairs in by_tx.items():
            puts[_mkey(block_num, tx_num)] = json.dumps(
                pairs, sort_keys=True).encode()
        with self._lock:
            for exp, entries in expiry_adds.items():
                key = _xkey(exp, block_num)
                prior = db.get(key)
                if prior:
                    entries = json.loads(prior) + [list(e) for e in entries]
                puts[key] = json.dumps([list(e) for e in entries],
                                       sort_keys=True).encode()
            db.write_batch(puts)
            self._purge_expired(block_num, db)

    @staticmethod
    def _collections_of(raw: bytes):
        try:
            txpvt = rw.TxPvtReadWriteSet.decode(raw)
        except DecodeError:
            return
        for nsp in txpvt.ns_pvt_rwset:
            for cp in nsp.collection_pvt_rwset:
                yield nsp.namespace, cp.collection_name

    def _purge_expired(self, current_block: int, db) -> None:
        """Drop the collections whose BTL has elapsed (lock held)."""
        deletes: list[bytes] = []
        rewrites: dict[bytes, bytes] = {}
        for key, value in db.iterate(_EXP, _xkey(current_block + 1, 0)):
            block = int(key[len(_EXP) + 16:], 16)
            deletes.append(key)
            by_tx: dict[int, set[tuple[str, str]]] = {}
            for t, n, c in json.loads(value):
                by_tx.setdefault(t, set()).add((n, c))
            for tx_num, colls in by_tx.items():
                dkey = _dkey(block, tx_num)
                raw = rewrites.get(dkey) or db.get(dkey)
                if raw is None:
                    continue
                try:
                    txpvt = rw.TxPvtReadWriteSet.decode(raw)
                except DecodeError:
                    continue  # a corrupt entry cannot be filtered
                kept = []
                for nsp in txpvt.ns_pvt_rwset:
                    keep = [cp for cp in nsp.collection_pvt_rwset
                            if (nsp.namespace, cp.collection_name)
                            not in colls]
                    if keep:
                        kept.append(rw.NsPvtReadWriteSet(
                            namespace=nsp.namespace,
                            collection_pvt_rwset=keep))
                if kept:
                    rewrites[dkey] = rw.TxPvtReadWriteSet(
                        data_model=txpvt.data_model,
                        ns_pvt_rwset=kept).encode()
                else:
                    rewrites.pop(dkey, None)
                    deletes.append(dkey)
        if deletes or rewrites:
            db.write_batch(rewrites, deletes)

    # -- snapshot bootstrap ---------------------------------------------------

    def init_bootstrap_height(self, height: int) -> None:
        """Record that the store was created from a snapshot at `height`
        (reference pvtdatastorage InitLastCommittedBlock): below it there
        is no cleartext, only the hashes in the state DB, until the
        reconciler fetches it from the collection's peers."""
        self._db.put(_BOOT, struct.pack(">Q", height))

    @property
    def bootstrap_height(self) -> int:
        raw = self._db.get(_BOOT)
        return 0 if raw is None else struct.unpack(">Q", raw)[0]

    # -- queries --------------------------------------------------------------

    def get_pvt_data_by_block(self, block_num: int) -> dict[int, bytes]:
        """{tx_num: TxPvtReadWriteSet bytes} (reference
        GetPvtDataByBlockNum)."""
        prefix = _DATA + b"%016x" % block_num
        with self._lock:
            return {int(key[len(prefix):], 16): value for key, value
                    in self._db.iterate(prefix, prefix + b"\xff")}

    def get_missing(self, max_blocks: int | None = None
                    ) -> list[tuple[int, int, str, str]]:
        """[(block, tx, ns, coll)] eligible but missing, oldest first
        (reference GetMissingPvtDataInfoForMostRecentBlocks)."""
        out = []
        blocks_seen: set[int] = set()
        with self._lock:
            for key, value in self._db.iterate(_MISS, _MISS + b"\xff"):
                block = int(key[1:17], 16)
                if max_blocks is not None:
                    blocks_seen.add(block)
                    if len(blocks_seen) > max_blocks:
                        break
                tx = int(key[17:25], 16)
                for ns, coll in json.loads(value):
                    out.append((block, tx, ns, coll))
        return out

    def resolve_missing(self, block_num: int, tx_num: int,
                        pvt_bytes: bytes) -> None:
        """Merge private data the reconciler delivered for an old block and
        clear its missing record (reference CommitPvtDataOfOldBlocks)."""
        with self._lock:
            dkey = _dkey(block_num, tx_num)
            existing = self._db.get(dkey)
            if existing:
                merged = rw.TxPvtReadWriteSet.decode(existing)
                have = _collections(merged)
                nsps = list(merged.ns_pvt_rwset)
                for nsp in rw.TxPvtReadWriteSet.decode(pvt_bytes).ns_pvt_rwset:
                    add = [cp for cp in nsp.collection_pvt_rwset
                           if (nsp.namespace, cp.collection_name) not in have]
                    if not add:
                        continue
                    tgt = next((m for m in nsps
                                if m.namespace == nsp.namespace), None)
                    if tgt is None:
                        tgt = rw.NsPvtReadWriteSet(namespace=nsp.namespace)
                        nsps.append(tgt)
                    tgt.collection_pvt_rwset = (
                        list(tgt.collection_pvt_rwset) + add)
                merged.ns_pvt_rwset = nsps
                pvt_bytes = merged.encode()
            delivered = _collections(rw.TxPvtReadWriteSet.decode(pvt_bytes))
            puts = {dkey: pvt_bytes}
            deletes = []
            mkey = _mkey(block_num, tx_num)
            mraw = self._db.get(mkey)
            if mraw:
                remaining = [(ns, coll) for ns, coll in json.loads(mraw)
                             if (ns, coll) not in delivered]
                if remaining:
                    puts[mkey] = json.dumps(remaining,
                                            sort_keys=True).encode()
                else:
                    deletes.append(mkey)
            self._db.write_batch(puts, deletes)


__all__ = ["PvtDataStore"]
