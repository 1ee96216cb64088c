"""Config history store (the port's copy of
`fabric_tpu/ledger/confighistory.py`; reference core/ledger/confighistory):
each chaincode's collection-config package by the block that committed
it, so that the private-data path can ask for the collection config of
namespace X as of block N.
"""

from __future__ import annotations

import struct

from fabric_tpu_torch.ledger.kvstore import KVStore, NamedDB

_MAX = 0xFFFFFFFFFFFFFFFF


def _key(ns: str, block_num: int) -> bytes:
    # descending block order under each namespace: the first entry at or
    # after (ns, ~block) is the most recent config at or below the block
    return ns.encode() + b"\x00" + struct.pack(">Q", _MAX - block_num)


class ConfigHistoryRetriever:
    def __init__(self, db: NamedDB):
        self._db = db

    def most_recent_below(self, ns: str,
                          block_num: int) -> tuple[int, bytes] | None:
        """The most recent collection config committed strictly below
        `block_num` (reference MostRecentCollectionConfigBelow), as
        (committing block, serialized config), or None."""
        start = _key(ns, block_num - 1)
        end = ns.encode() + b"\x01"
        for k, v in self._db.iterate(start, end):
            inv = struct.unpack(">Q", k[len(ns) + 1:])[0]
            return (_MAX - inv, v)
        return None


class ConfigHistoryMgr:
    """Writer and retriever (reference confighistory.Mgr)."""

    def __init__(self, kv: KVStore, ledger_id: str):
        self._db = NamedDB(kv, f"confighistory/{ledger_id}")

    def handle_commit(self, block_num: int, configs: dict[str, bytes]) -> None:
        """configs: {namespace: serialized CollectionConfigPackage}."""
        puts = {_key(ns, block_num): raw for ns, raw in configs.items()}
        if puts:
            self._db.write_batch(puts)

    def retriever(self) -> ConfigHistoryRetriever:
        return ConfigHistoryRetriever(self._db)

    # -- snapshot export and import (reference confighistory db_helper
    # ExportConfigHistory / ImportConfigHistory) ------------------------------

    def export_entries(self):
        """Every (key, value) entry in key order: what a snapshot carries,
        so that a ledger bootstrapped from it still answers
        most_recent_below for blocks before the snapshot."""
        return self._db.iterate(b"", None)

    def import_entries(self, entries) -> None:
        puts = dict(entries)
        if puts:
            self._db.write_batch(puts)


__all__ = ["ConfigHistoryMgr", "ConfigHistoryRetriever"]
