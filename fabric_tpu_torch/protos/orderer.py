"""Schemas of package `orderer`: `orderer/configuration.proto`'s channel
values, and `raft.proto`'s `SnapshotMeta` (a repeated numeric field, the
codec's packed case; field numbers from the JAX package's
`fabric_tpu/protos/orderer/`)."""

from fabric_tpu_torch.protos.wire import (
    BYTES,
    ENUM,
    STRING,
    UINT32,
    UINT64,
    Field,
    Message,
)


class ConsensusType(Message):
    STATE_NORMAL = 0
    STATE_MAINTENANCE = 1
    FIELDS = (Field(1, "type", STRING), Field(2, "metadata", BYTES),
              Field(3, "state", ENUM))


class BatchSize(Message):
    FIELDS = (
        Field(1, "max_message_count", UINT32),
        Field(2, "absolute_max_bytes", UINT32),
        Field(3, "preferred_max_bytes", UINT32),
    )


class BatchTimeout(Message):
    FIELDS = (Field(1, "timeout", STRING),)


class SnapshotMeta(Message):
    FIELDS = (
        Field(1, "index", UINT64),
        Field(2, "term", UINT64),
        Field(3, "voters", UINT64, repeated=True),
    )
