"""The ledger's internal bookkeeping namespaces (the port's copy of
`fabric_tpu/ledger/bookkeeping.py`; reference
core/ledger/kvledger/bookkeeping/provider.go).

Ledger components that keep durable records outside the channel's state
(private-data expiry, metadata hints, snapshot requests) get one
`NamedDB` per ledger and category, under "bookkeeping/<ledger>/<category>"
of the ledger's shared KVStore.
"""

from __future__ import annotations

from fabric_tpu_torch.ledger.kvstore import KVStore, NamedDB

# reference bookkeeping.Category values
PVT_DATA_EXPIRY = "pvtdata-expiry"
METADATA_PRESENCE = "metadata-presence"
SNAPSHOT_REQUEST = "snapshot-request"


class BookkeepingProvider:
    """Durable namespaces per ledger and category."""

    def __init__(self, store: KVStore):
        self._store = store

    def get_kv(self, ledger_id: str, category: str) -> NamedDB:
        return NamedDB(self._store, f"bookkeeping/{ledger_id}/{category}")


__all__ = ["BookkeepingProvider", "PVT_DATA_EXPIRY", "METADATA_PRESENCE",
           "SNAPSHOT_REQUEST"]
