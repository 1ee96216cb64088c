"""Schemas of package `gossip`: `gossip/message.proto`, the signed
carrier, membership, block dissemination, pull anti-entropy, state
transfer, leadership, identities, private data and the stream handshake
(field numbers from the JAX package's
`fabric_tpu/protos/gossip/message.proto`).  None of them has a map, so a
message built alike encodes to upb's bytes."""

from fabric_tpu_torch.protos.wire import (
    BOOL,
    BYTES,
    ENUM,
    MESSAGE,
    STRING,
    UINT64,
    Field,
    Message,
)

# PullMsgType
PULL_UNDEFINED = 0
PULL_BLOCK_MSG = 1
PULL_IDENTITY_MSG = 2


class SignedGossipMessage(Message):
    FIELDS = (Field(1, "payload", BYTES), Field(2, "signature", BYTES))


class Member(Message):
    FIELDS = (
        Field(1, "endpoint", STRING),
        Field(2, "pki_id", BYTES),
        Field(3, "identity", BYTES),
    )


class AliveMessage(Message):
    FIELDS = (
        Field(1, "membership", MESSAGE, "Member"),
        Field(2, "inc_number", UINT64),
        Field(3, "seq_num", UINT64),
    )


class MembershipRequest(Message):
    FIELDS = (Field(1, "self_information", MESSAGE, "AliveMessage"),)


class MembershipResponse(Message):
    FIELDS = (
        Field(1, "alive", MESSAGE, "AliveMessage", repeated=True),
        Field(2, "dead", MESSAGE, "AliveMessage", repeated=True),
    )


class DataMessage(Message):
    FIELDS = (Field(1, "seq_num", UINT64), Field(2, "block", BYTES))


class GossipHello(Message):
    FIELDS = (Field(1, "nonce", UINT64), Field(2, "msg_type", ENUM))


class DataDigest(Message):
    FIELDS = (
        Field(1, "nonce", UINT64),
        Field(2, "msg_type", ENUM),
        Field(3, "digests", BYTES, repeated=True),
    )


class DataRequest(Message):
    FIELDS = (
        Field(1, "nonce", UINT64),
        Field(2, "msg_type", ENUM),
        Field(3, "digests", BYTES, repeated=True),
    )


class DataUpdate(Message):
    FIELDS = (
        Field(1, "nonce", UINT64),
        Field(2, "msg_type", ENUM),
        Field(3, "data", MESSAGE, "SignedGossipMessage", repeated=True),
    )


class RemoteStateRequest(Message):
    FIELDS = (Field(1, "start_seq_num", UINT64),
              Field(2, "end_seq_num", UINT64))


class RemoteStateResponse(Message):
    FIELDS = (Field(1, "payloads", MESSAGE, "DataMessage", repeated=True),)


class StateInfo(Message):
    FIELDS = (
        Field(1, "ledger_height", UINT64),
        Field(2, "pki_id", BYTES),
        Field(3, "timestamp", UINT64),
    )


class LeadershipMessage(Message):
    FIELDS = (
        Field(1, "pki_id", BYTES),
        Field(2, "inc_number", UINT64),
        Field(3, "seq_num", UINT64),
        Field(4, "is_declaration", BOOL),
    )


class PeerIdentity(Message):
    FIELDS = (Field(1, "pki_id", BYTES), Field(2, "cert", BYTES))


class PrivateDataMessage(Message):
    FIELDS = (
        Field(1, "channel", STRING),
        Field(2, "tx_id", STRING),
        Field(3, "namespace", STRING),
        Field(4, "collection", STRING),
        Field(5, "block_seq", UINT64),
        Field(6, "rwset", BYTES),
    )


class PrivateDataRequest(Message):
    FIELDS = (
        Field(1, "channel", STRING),
        Field(2, "block_seq", UINT64),
        Field(3, "digests", MESSAGE, "PrivateDigest", repeated=True),
    )


class PrivateDigest(Message):
    FIELDS = (
        Field(1, "tx_id", STRING),
        Field(2, "namespace", STRING),
        Field(3, "collection", STRING),
    )


class PrivateDataResponse(Message):
    FIELDS = (Field(1, "elements", MESSAGE, "PrivateDataMessage",
                    repeated=True),)


_CONTENT = (
    (10, "alive_msg", "AliveMessage"),
    (11, "mem_req", "MembershipRequest"),
    (12, "mem_res", "MembershipResponse"),
    (13, "data_msg", "DataMessage"),
    (14, "hello", "GossipHello"),
    (15, "data_dig", "DataDigest"),
    (16, "data_req", "DataRequest"),
    (17, "data_update", "DataUpdate"),
    (18, "state_request", "RemoteStateRequest"),
    (19, "state_response", "RemoteStateResponse"),
    (20, "state_info", "StateInfo"),
    (21, "leadership_msg", "LeadershipMessage"),
    (22, "peer_identity", "PeerIdentity"),
    (23, "private_data", "PrivateDataMessage"),
    (24, "private_req", "PrivateDataRequest"),
    (25, "private_res", "PrivateDataResponse"),
)


class GossipMessage(Message):
    # Tag
    UNDEFINED = 0
    EMPTY = 1
    ORG_ONLY = 2
    CHAN_ONLY = 3
    CHAN_AND_ORG = 4
    FIELDS = (
        Field(1, "channel", BYTES),
        Field(2, "tag", ENUM),
        Field(3, "nonce", UINT64),
    ) + tuple(Field(num, name, MESSAGE, cls, oneof="content")
              for num, name, cls in _CONTENT)


class ConnEstablish(Message):
    FIELDS = (
        Field(1, "pki_id", BYTES),
        Field(2, "identity", BYTES),
        Field(3, "tls_cert_hash", BYTES),
        Field(4, "signature", BYTES),
        Field(5, "endpoint", STRING),
    )
