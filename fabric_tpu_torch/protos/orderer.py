"""Schemas of package `orderer`: `orderer/configuration.proto`'s channel
values, `ab.proto`'s Broadcast and Deliver messages, and `raft.proto`
(package `orderer.raft`: the consenter set, the raft log, its messages,
the cluster's Step envelope and the WAL's records; field numbers from the
JAX package's `fabric_tpu/protos/orderer/`)."""

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


# -- raft.proto ------------------------------------------------------------------

# EntryType
ENTRY_NORMAL = 0  # data: a marker byte and a marshaled common.Block
ENTRY_CONF_CHANGE = 1  # data: a marshaled ConfChange

# MessageType
MSG_VOTE_REQUEST = 0
MSG_VOTE_RESPONSE = 1
MSG_APPEND = 2  # also the heartbeat (no entries)
MSG_APPEND_RESPONSE = 3
MSG_SNAPSHOT = 4
MSG_PRE_VOTE_REQUEST = 5
MSG_PRE_VOTE_RESPONSE = 6


class Consenter(Message):
    FIELDS = (
        Field(1, "id", UINT64),
        Field(2, "host", STRING),
        Field(3, "port", UINT32),
        Field(4, "client_tls_cert", BYTES),
        Field(5, "server_tls_cert", BYTES),
    )


class Options(Message):
    FIELDS = (
        Field(1, "tick_interval_ms", UINT32),
        Field(2, "election_tick", UINT32),
        Field(3, "heartbeat_tick", UINT32),
        Field(4, "max_inflight_blocks", UINT32),
        Field(5, "snapshot_interval_size", UINT64),
    )


class ConfigMetadata(Message):
    FIELDS = (
        Field(1, "consenters", MESSAGE, "Consenter", repeated=True),
        Field(2, "options", MESSAGE, "Options"),
    )


class Entry(Message):
    FIELDS = (
        Field(1, "index", UINT64),
        Field(2, "term", UINT64),
        Field(3, "type", ENUM),
        Field(4, "data", BYTES),
    )


class ConfChange(Message):
    ADD_NODE = 0  # Action
    REMOVE_NODE = 1
    FIELDS = (Field(1, "action", ENUM),
              Field(2, "consenter", MESSAGE, "Consenter"))


class SnapshotMeta(Message):
    FIELDS = (
        Field(1, "index", UINT64),
        Field(2, "term", UINT64),
        Field(3, "voters", UINT64, repeated=True),
    )


class Snapshot(Message):
    FIELDS = (
        Field(1, "meta", MESSAGE, "SnapshotMeta"),
        Field(2, "block_number", UINT64),
        Field(3, "block_hash", BYTES),
        Field(4, "conf_metadata", BYTES),
    )


class RaftMessage(Message):
    FIELDS = (
        Field(1, "type", ENUM),
        Field(2, "sender", UINT64),
        Field(3, "to", UINT64),
        Field(4, "term", UINT64),
        Field(5, "last_log_index", UINT64),
        Field(6, "last_log_term", UINT64),
        Field(7, "vote_granted", BOOL),
        Field(8, "prev_log_index", UINT64),
        Field(9, "prev_log_term", UINT64),
        Field(10, "entries", MESSAGE, "Entry", repeated=True),
        Field(11, "leader_commit", UINT64),
        Field(12, "success", BOOL),
        Field(13, "match_index", UINT64),
        Field(14, "reject_hint", UINT64),
        Field(15, "snapshot", MESSAGE, "Snapshot"),
    )


class StepRequest(Message):
    FIELDS = (
        Field(1, "channel", STRING),
        Field(2, "consensus", MESSAGE, "RaftMessage", oneof="payload"),
        Field(3, "submit", MESSAGE, "SubmitRequest", oneof="payload"),
    )


class SubmitRequest(Message):
    FIELDS = (
        Field(1, "channel", STRING),
        Field(2, "envelope", BYTES),
        Field(3, "config_seq", UINT64),
        Field(4, "is_config", BOOL),
    )


class StepResponse(Message):
    FIELDS = (
        Field(1, "accepted", BOOL),
        Field(2, "error", STRING),
        Field(3, "leader_hint", UINT64),
    )


class HardState(Message):
    FIELDS = (
        Field(1, "term", UINT64),
        Field(2, "voted_for", UINT64),
        Field(3, "commit", UINT64),
    )


class WALRecord(Message):
    FIELDS = (
        Field(1, "hard_state", MESSAGE, "HardState", oneof="payload"),
        Field(2, "entry", MESSAGE, "Entry", oneof="payload"),
        Field(3, "snapshot", MESSAGE, "Snapshot", oneof="payload"),
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
