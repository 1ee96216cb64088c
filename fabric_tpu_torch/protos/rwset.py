"""Schemas of packages `rwset` and `kvrwset`: `ledger/rwset/rwset.proto`
and `ledger/rwset/kvrwset/kv_rwset.proto` (field numbers from the JAX
package's `fabric_tpu/protos/ledger/`)."""

from fabric_tpu_torch.protos.wire import (
    BOOL,
    BYTES,
    ENUM,
    MESSAGE,
    STRING,
    UINT32,
    UINT64,
    Field,
    Message,
)


class TxReadWriteSet(Message):
    KV = 0
    FIELDS = (
        Field(1, "data_model", ENUM),
        Field(2, "ns_rwset", MESSAGE, "NsReadWriteSet", repeated=True),
    )


class NsReadWriteSet(Message):
    FIELDS = (
        Field(1, "namespace", STRING),
        Field(2, "rwset", BYTES),
        Field(3, "collection_hashed_rwset", MESSAGE,
              "CollectionHashedReadWriteSet", repeated=True),
    )


class CollectionHashedReadWriteSet(Message):
    FIELDS = (
        Field(1, "collection_name", STRING),
        Field(2, "hashed_rwset", BYTES),
        Field(3, "pvt_rwset_hash", BYTES),
    )


class TxPvtReadWriteSet(Message):
    FIELDS = (
        Field(1, "data_model", ENUM),
        Field(2, "ns_pvt_rwset", MESSAGE, "NsPvtReadWriteSet", repeated=True),
    )


class NsPvtReadWriteSet(Message):
    FIELDS = (
        Field(1, "namespace", STRING),
        Field(2, "collection_pvt_rwset", MESSAGE, "CollectionPvtReadWriteSet",
              repeated=True),
    )


class CollectionPvtReadWriteSet(Message):
    FIELDS = (Field(1, "collection_name", STRING), Field(2, "rwset", BYTES))


class Version(Message):
    FIELDS = (Field(1, "block_num", UINT64), Field(2, "tx_num", UINT64))


class KVRead(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "version", MESSAGE, "Version"))


class KVWrite(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "is_delete", BOOL),
              Field(3, "value", BYTES))


class KVMetadataEntry(Message):
    FIELDS = (Field(1, "name", STRING), Field(2, "value", BYTES))


class KVMetadataWrite(Message):
    FIELDS = (
        Field(1, "key", STRING),
        Field(2, "entries", MESSAGE, "KVMetadataEntry", repeated=True),
    )


class QueryReads(Message):
    FIELDS = (Field(1, "kv_reads", MESSAGE, "KVRead", repeated=True),)


class QueryReadsMerkleSummary(Message):
    FIELDS = (
        Field(1, "max_degree", UINT32),
        Field(2, "max_level", UINT32),
        Field(3, "max_level_hashes", BYTES, repeated=True),
    )


class RangeQueryInfo(Message):
    FIELDS = (
        Field(1, "start_key", STRING),
        Field(2, "end_key", STRING),
        Field(3, "itr_exhausted", BOOL),
        Field(4, "raw_reads", MESSAGE, "QueryReads", oneof="reads_info"),
        Field(5, "reads_merkle_hashes", MESSAGE, "QueryReadsMerkleSummary",
              oneof="reads_info"),
    )


class KVRWSet(Message):
    FIELDS = (
        Field(1, "reads", MESSAGE, "KVRead", repeated=True),
        Field(2, "range_queries_info", MESSAGE, "RangeQueryInfo",
              repeated=True),
        Field(3, "writes", MESSAGE, "KVWrite", repeated=True),
        Field(4, "metadata_writes", MESSAGE, "KVMetadataWrite", repeated=True),
    )


class KVReadHash(Message):
    FIELDS = (Field(1, "key_hash", BYTES),
              Field(2, "version", MESSAGE, "Version"))


class KVWriteHash(Message):
    FIELDS = (Field(1, "key_hash", BYTES), Field(2, "is_delete", BOOL),
              Field(3, "value_hash", BYTES))


class KVMetadataWriteHash(Message):
    FIELDS = (
        Field(1, "key_hash", BYTES),
        Field(2, "entries", MESSAGE, "KVMetadataEntry", repeated=True),
    )


class HashedRWSet(Message):
    FIELDS = (
        Field(1, "hashed_reads", MESSAGE, "KVReadHash", repeated=True),
        Field(2, "hashed_writes", MESSAGE, "KVWriteHash", repeated=True),
        Field(3, "metadata_writes", MESSAGE, "KVMetadataWriteHash",
              repeated=True),
    )
