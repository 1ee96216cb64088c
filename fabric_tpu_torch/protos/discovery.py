"""Schemas of package `discovery`: `discovery/protocol.proto`, the signed
request, its queries and their results (field numbers from the JAX
package's `fabric_tpu/protos/discovery/protocol.proto`).  Its maps encode
in insertion order, so its messages are compared decoded."""

from fabric_tpu_torch.protos.wire import (
    BYTES,
    MESSAGE,
    STRING,
    UINT32,
    UINT64,
    Field,
    Message,
)


class SignedRequest(Message):
    FIELDS = (Field(1, "payload", BYTES), Field(2, "signature", BYTES))


class Request(Message):
    FIELDS = (
        Field(1, "authentication", MESSAGE, "AuthInfo"),
        Field(2, "queries", MESSAGE, "Query", repeated=True),
    )


class AuthInfo(Message):
    FIELDS = (Field(1, "client_identity", BYTES),
              Field(2, "client_tls_cert_hash", BYTES))


class Query(Message):
    FIELDS = (
        Field(1, "channel", STRING),
        Field(2, "config_query", MESSAGE, "ConfigQuery", oneof="query"),
        Field(3, "peer_query", MESSAGE, "PeerMembershipQuery", oneof="query"),
        Field(4, "cc_query", MESSAGE, "ChaincodeQuery", oneof="query"),
        Field(5, "local_peers", MESSAGE, "LocalPeerQuery", oneof="query"),
    )


class ConfigQuery(Message):
    FIELDS = ()


class PeerMembershipQuery(Message):
    FIELDS = (Field(1, "filter", MESSAGE, "ChaincodeInterest"),)


class LocalPeerQuery(Message):
    FIELDS = ()


class ChaincodeQuery(Message):
    FIELDS = (Field(1, "interests", MESSAGE, "ChaincodeInterest",
                    repeated=True),)


class ChaincodeInterest(Message):
    FIELDS = (Field(1, "chaincodes", MESSAGE, "ChaincodeCall",
                    repeated=True),)


class ChaincodeCall(Message):
    FIELDS = (Field(1, "name", STRING),
              Field(2, "collection_names", STRING, repeated=True))


class Response(Message):
    FIELDS = (Field(1, "results", MESSAGE, "QueryResult", repeated=True),)


class QueryResult(Message):
    FIELDS = (
        Field(1, "error", MESSAGE, "Error", oneof="result"),
        Field(2, "config_result", MESSAGE, "ConfigResult", oneof="result"),
        Field(3, "members", MESSAGE, "PeerMembershipResult", oneof="result"),
        Field(4, "cc_query_res", MESSAGE, "ChaincodeQueryResult",
              oneof="result"),
    )


class Error(Message):
    FIELDS = (Field(1, "content", STRING),)


class ConfigResult(Message):
    FIELDS = (
        Field(1, "msps", BYTES, key=STRING, value=BYTES),
        Field(2, "orderers", MESSAGE, "Endpoints", key=STRING,
              value=MESSAGE),
    )


class Endpoints(Message):
    FIELDS = (Field(1, "endpoint", MESSAGE, "Endpoint", repeated=True),)


class Endpoint(Message):
    FIELDS = (Field(1, "host", STRING), Field(2, "port", UINT32))


class PeerMembershipResult(Message):
    FIELDS = (Field(1, "peers_by_org", MESSAGE, "Peers", key=STRING,
                    value=MESSAGE),)


class Peers(Message):
    FIELDS = (Field(1, "peers", MESSAGE, "Peer", repeated=True),)


class Peer(Message):
    FIELDS = (
        Field(1, "identity", BYTES),
        Field(2, "endpoint", STRING),
        Field(3, "ledger_height", UINT64),
        Field(4, "chaincodes", STRING, repeated=True),
    )


class ChaincodeQueryResult(Message):
    FIELDS = (Field(1, "content", MESSAGE, "EndorsementDescriptor",
                    repeated=True),)


class EndorsementDescriptor(Message):
    FIELDS = (
        Field(1, "chaincode", STRING),
        Field(2, "endorsers_by_groups", MESSAGE, "Peers", key=STRING,
              value=MESSAGE),
        Field(3, "layouts", MESSAGE, "Layout", repeated=True),
    )


class Layout(Message):
    FIELDS = (Field(1, "quantities_by_group", UINT32, key=STRING,
                    value=UINT32),)
