"""History database: the index of every key's writes (the port's copy of
`fabric_tpu/ledger/history.py`).

Reference: core/ledger/kvledger/history, a leveldb index keyed
(ns, key, blockNum, txNum) that answers GetHistoryForKey."""

from __future__ import annotations

import struct

from fabric_tpu_torch.ledger.kvstore import KVStore, NamedDB

_SEP = b"\x00"
_SAVEPOINT_KEY = b"\x01sp"


def _hkey(ns: str, key: str, block: int, tx: int) -> bytes:
    return (b"\x02" + ns.encode() + _SEP + key.encode() + _SEP
            + struct.pack(">QQ", block, tx))


class HistoryDB:
    def __init__(self, store: KVStore, name: str = "historydb"):
        self._db = NamedDB(store, name)

    def commit(self, block_num: int,
               writes_per_tx: list[list[tuple[str, str]]],
               into=None) -> None:
        """writes_per_tx[tx_num] = [(ns, key), ...] of the valid
        transactions; `into` (a WriteBatchCollector over this DB's store)
        buffers the writes into the group's transaction."""
        db = self._db if into is None else self._db.rebase(into)
        puts = {_SAVEPOINT_KEY: struct.pack(">Q", block_num)}
        for tx_num, writes in enumerate(writes_per_tx):
            for ns, key in writes:
                puts[_hkey(ns, key, block_num, tx_num)] = b""
        db.write_batch(puts)

    def savepoint(self) -> int | None:
        raw = self._db.get(_SAVEPOINT_KEY)
        return None if raw is None else struct.unpack(">Q", raw)[0]

    def get_history_for_key(self, ns: str,
                            key: str) -> list[tuple[int, int]]:
        """[(block_num, tx_num)], ascending."""
        prefix = b"\x02" + ns.encode() + _SEP + key.encode() + _SEP
        return [struct.unpack(">QQ", k[len(prefix):])
                for k, _ in self._db.iterate(prefix, prefix + b"\xff" * 16)]


__all__ = ["HistoryDB"]
