"""Transient store: endorsement-time private-data staging (reference
core/transientstore/store.go; the port's copy of
`fabric_tpu/ledger/transientstore.py`).

Endorsers persist the cleartext private write sets they produced (or
received from other endorsers), keyed by (txid, endorsement block
height, a uuid); the committer consumes them at commit time and purges
entries by txid or below a height watermark.
"""

from __future__ import annotations

import threading
import uuid as uuid_mod

from fabric_tpu_torch.ledger.kvstore import KVStore, NamedDB


def _key(txid: str, height: int, uid: str) -> bytes:
    return b"%s\x00%016x\x00%s" % (txid.encode(), height, uid.encode())


class TransientStore:
    def __init__(self, kv: KVStore, ledger_id: str):
        self._db = NamedDB(kv, f"transient/{ledger_id}")
        self._lock = threading.Lock()

    def persist(self, txid: str, block_height: int, pvt_bytes: bytes) -> None:
        """Store one TxPvtReadWriteSet seen at an endorsement height
        (reference store.go Persist)."""
        uid = uuid_mod.uuid4().hex
        with self._lock:
            self._db.put(_key(txid, block_height, uid), pvt_bytes)

    def get_tx_pvt_rwsets(self, txid: str) -> list[tuple[int, bytes]]:
        """Every stored (endorsement height, pvt_bytes) of a txid
        (reference GetTxPvtRWSetByTxid)."""
        prefix = txid.encode() + b"\x00"
        out = []
        with self._lock:
            for key, value in self._db.iterate(prefix, prefix + b"\xff"):
                parts = key.split(b"\x00")
                out.append((int(parts[1], 16), value))
        return out

    def purge_by_txids(self, txids) -> None:
        """Remove the entries of committed transactions (reference
        PurgeByTxids)."""
        with self._lock:
            deletes = []
            for txid in txids:
                prefix = txid.encode() + b"\x00"
                deletes.extend(key for key, _ in self._db.iterate(
                    prefix, prefix + b"\xff"))
            if deletes:
                self._db.write_batch({}, deletes)

    def purge_below_height(self, height: int) -> None:
        """Drop the entries endorsed below `height` (reference
        PurgeBelowHeight: the data of transactions that never
        committed)."""
        with self._lock:
            deletes = []
            for key, _ in self._db.iterate():
                parts = key.split(b"\x00")
                if len(parts) >= 2 and int(parts[1], 16) < height:
                    deletes.append(key)
            if deletes:
                self._db.write_batch({}, deletes)

    def min_height(self) -> int | None:
        with self._lock:
            heights = [int(key.split(b"\x00")[1], 16)
                       for key, _ in self._db.iterate()]
        return min(heights) if heights else None


__all__ = ["TransientStore"]
