"""The port's ledger (a copy of `fabric_tpu/ledger/`): the KV store SPI on
sqlite (one file, or the namespace-sharded store with its two-phase
flush), the versioned state DB with rich-query indexes (`richquery`), the
transaction simulator and MVCC validation (its prepare and preload fanned
out per namespace on `common/workpool`), the history DB, the private-data
and config-history stores, the block store, snapshots (export, verify,
import, the request manager, and the remote fetch over comm's RPC,
`snapshot.fetch_snapshot` with its server half `snapshot_fetch_handler`)
with their bookkeeping, and `KVLedger` with its query executor and
`LedgerProvider`, the transient store, chaincode event management and the
offline admin tools (`admin`)."""

from fabric_tpu_torch.ledger.kvstore import (
    KVStore,
    MemKVStore,
    NamedDB,
    ShardedKVStore,
    SqliteKVStore,
    WriteBatchCollector,
    open_kvstore,
)
from fabric_tpu_torch.ledger.statedb import Height, VersionedDB, VersionedValue
from fabric_tpu_torch.ledger.blkstorage import BlockStore, BlockStoreError
from fabric_tpu_torch.ledger.history import HistoryDB
from fabric_tpu_torch.ledger.txmgmt import MVCCValidator, TxSimulator
from fabric_tpu_torch.ledger.snapshot import SnapshotError, SnapshotManager
from fabric_tpu_torch.ledger.kvledger import (
    CommitGroup,
    KVLedger,
    LedgerProvider,
    QueryExecutor,
    extract_rwsets,
)
from fabric_tpu_torch.ledger.transientstore import TransientStore
from fabric_tpu_torch.ledger.cceventmgmt import (
    ChaincodeDefinitionEvent,
    ChaincodeEventMgr,
)
from fabric_tpu_torch.ledger import admin

__all__ = [
    "KVStore",
    "MemKVStore",
    "SqliteKVStore",
    "ShardedKVStore",
    "open_kvstore",
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
    "TxSimulator",
    "SnapshotError",
    "SnapshotManager",
    "KVLedger",
    "LedgerProvider",
    "QueryExecutor",
    "extract_rwsets",
    "TransientStore",
    "ChaincodeDefinitionEvent",
    "ChaincodeEventMgr",
    "admin",
]
