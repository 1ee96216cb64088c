"""Schemas of package `orderer`: `orderer/configuration.proto`'s channel
values, `ab.proto`'s Broadcast and Deliver messages, and `raft.proto`'s
`SnapshotMeta` (a repeated numeric field, the codec's packed case; field
numbers from the JAX package's `fabric_tpu/protos/orderer/`)."""

from fabric_tpu_torch.protos.wire import (
    BYTES,
    ENUM,
    MESSAGE,
    STRING,
    UINT32,
    UINT64,
    Field,
    Message,
)

_COMMON = "fabric_tpu_torch.protos.common"


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


# -- ab.proto ------------------------------------------------------------------


class BroadcastResponse(Message):
    FIELDS = (Field(1, "status", ENUM), Field(2, "info", STRING))


class SeekNewest(Message):
    FIELDS = ()


class SeekOldest(Message):
    FIELDS = ()


class SeekSpecified(Message):
    FIELDS = (Field(1, "number", UINT64),)


class SeekPosition(Message):
    FIELDS = (
        Field(1, "newest", MESSAGE, "SeekNewest", oneof="Type"),
        Field(2, "oldest", MESSAGE, "SeekOldest", oneof="Type"),
        Field(3, "specified", MESSAGE, "SeekSpecified", oneof="Type"),
    )


class SeekInfo(Message):
    BLOCK_UNTIL_READY = 0  # SeekBehavior
    FAIL_IF_NOT_READY = 1
    STRICT = 0  # SeekErrorResponse
    BEST_EFFORT = 1
    FIELDS = (
        Field(1, "start", MESSAGE, "SeekPosition"),
        Field(2, "stop", MESSAGE, "SeekPosition"),
        Field(3, "behavior", ENUM),
        Field(4, "error_response", ENUM),
    )


class DeliverResponse(Message):
    FIELDS = (
        Field(1, "status", ENUM, oneof="Type"),
        Field(2, "block", MESSAGE, f"{_COMMON}.Block", oneof="Type"),
    )
