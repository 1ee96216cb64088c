"""The port's ledger (a copy of `fabric_tpu/ledger/`'s commit path): the
KV store SPI on sqlite, the versioned state DB, MVCC validation, the
history DB, the private-data and config-history stores, the block store,
and `KVLedger` with its `LedgerProvider`.  Snapshots, the transaction
simulator and query executor, rich queries and the sharded store are not
ported."""

from fabric_tpu_torch.ledger.kvstore import (
    KVStore,
    MemKVStore,
    NamedDB,
    SqliteKVStore,
    WriteBatchCollector,
)
from fabric_tpu_torch.ledger.statedb import Height, VersionedDB, VersionedValue
from fabric_tpu_torch.ledger.blkstorage import BlockStore, BlockStoreError
from fabric_tpu_torch.ledger.history import HistoryDB
from fabric_tpu_torch.ledger.txmgmt import MVCCValidator
from fabric_tpu_torch.ledger.kvledger import (
    CommitGroup,
    KVLedger,
    LedgerProvider,
    extract_rwsets,
)

__all__ = [
    "KVStore",
    "MemKVStore",
    "SqliteKVStore",
    "NamedDB",
    "WriteBatchCollector",
    "CommitGroup",
    "Height",
    "VersionedDB",
    "VersionedValue",
    "BlockStore",
    "BlockStoreError",
    "HistoryDB",
    "MVCCValidator",
    "KVLedger",
    "LedgerProvider",
    "extract_rwsets",
]
