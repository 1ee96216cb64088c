"""Schemas of package `protos` (the peer): `proposal.proto`,
`proposal_response.proto`, `transaction.proto`, `chaincode.proto`,
`chaincode_event.proto`, `events.proto`'s filtered blocks and
`DeliverResponse`, `configuration.proto`'s anchor peers, ACLs and channel
list, `collection.proto`, `chaincode_shim.proto` (the chaincode stream's
messages) and `query.proto` (field numbers from the JAX package's
`fabric_tpu/protos/peer/`)."""

from fabric_tpu_torch.protos.wire import (
    BOOL,
    BYTES,
    ENUM,
    INT32,
    MESSAGE,
    STRING,
    UINT64,
    Field,
    Message,
)

_COMMON = "fabric_tpu_torch.protos.common"

# TxValidationCode
VALID = 0
NIL_ENVELOPE = 1
BAD_PAYLOAD = 2
BAD_COMMON_HEADER = 3
BAD_CREATOR_SIGNATURE = 4
INVALID_ENDORSER_TRANSACTION = 5
INVALID_CONFIG_TRANSACTION = 6
UNSUPPORTED_TX_PAYLOAD = 7
BAD_PROPOSAL_TXID = 8
DUPLICATE_TXID = 9
ENDORSEMENT_POLICY_FAILURE = 10
MVCC_READ_CONFLICT = 11
PHANTOM_READ_CONFLICT = 12
UNKNOWN_TX_TYPE = 13
TARGET_CHAIN_NOT_FOUND = 14
MARSHAL_TX_ERROR = 15
NIL_TXACTION = 16
EXPIRED_CHAINCODE = 17
CHAINCODE_VERSION_CONFLICT = 18
BAD_HEADER_EXTENSION = 19
BAD_CHANNEL_HEADER = 20
BAD_RESPONSE_PAYLOAD = 21
BAD_RWSET = 22
ILLEGAL_WRITESET = 23
INVALID_WRITESET = 24
INVALID_CHAINCODE = 25
NOT_VALIDATED = 254
INVALID_OTHER_REASON = 255


# -- chaincode.proto ---------------------------------------------------------


class ChaincodeID(Message):
    FIELDS = (Field(1, "path", STRING), Field(2, "name", STRING),
              Field(3, "version", STRING))


class ChaincodeInput(Message):
    FIELDS = (
        Field(1, "args", BYTES, repeated=True),
        Field(2, "decorations", BYTES, key=STRING, value=BYTES),
        Field(3, "is_init", BOOL),
    )


class ChaincodeSpec(Message):
    UNDEFINED = 0
    GOLANG = 1
    NODE = 2
    CAR = 3
    JAVA = 4
    FIELDS = (
        Field(1, "type", ENUM),
        Field(2, "chaincode_id", MESSAGE, "ChaincodeID"),
        Field(3, "input", MESSAGE, "ChaincodeInput"),
        Field(4, "timeout", INT32),
    )


class ChaincodeInvocationSpec(Message):
    FIELDS = (Field(1, "chaincode_spec", MESSAGE, "ChaincodeSpec"),)


class ChaincodeDeploymentSpec(Message):
    FIELDS = (Field(1, "chaincode_spec", MESSAGE, "ChaincodeSpec"),
              Field(3, "code_package", BYTES))


class ChaincodeEvent(Message):
    FIELDS = (
        Field(1, "chaincode_id", STRING),
        Field(2, "tx_id", STRING),
        Field(3, "event_name", STRING),
        Field(4, "payload", BYTES),
    )


# -- proposal.proto ----------------------------------------------------------


class SignedProposal(Message):
    FIELDS = (Field(1, "proposal_bytes", BYTES), Field(2, "signature", BYTES))


class Proposal(Message):
    FIELDS = (Field(1, "header", BYTES), Field(2, "payload", BYTES),
              Field(3, "extension", BYTES))


class ChaincodeHeaderExtension(Message):
    FIELDS = (Field(2, "chaincode_id", MESSAGE, "ChaincodeID"),)


class ChaincodeProposalPayload(Message):
    FIELDS = (
        Field(1, "input", BYTES),
        Field(2, "TransientMap", BYTES, key=STRING, value=BYTES),
    )


class Response(Message):
    FIELDS = (Field(1, "status", INT32), Field(2, "message", STRING),
              Field(3, "payload", BYTES))


class ChaincodeAction(Message):
    FIELDS = (
        Field(1, "results", BYTES),
        Field(2, "events", BYTES),
        Field(3, "response", MESSAGE, "Response"),
        Field(4, "chaincode_id", MESSAGE, "ChaincodeID"),
    )


# -- proposal_response.proto -------------------------------------------------


class Endorsement(Message):
    FIELDS = (Field(1, "endorser", BYTES), Field(2, "signature", BYTES))


class ProposalResponsePayload(Message):
    FIELDS = (Field(1, "proposal_hash", BYTES), Field(2, "extension", BYTES))


class ProposalResponse(Message):
    FIELDS = (
        Field(1, "version", INT32),
        Field(2, "timestamp", MESSAGE, f"{_COMMON}.Timestamp"),
        Field(4, "response", MESSAGE, "Response"),
        Field(5, "payload", BYTES),
        Field(6, "endorsement", MESSAGE, "Endorsement"),
    )


# -- transaction.proto -------------------------------------------------------


class TransactionAction(Message):
    FIELDS = (Field(1, "header", BYTES), Field(2, "payload", BYTES))


class Transaction(Message):
    FIELDS = (Field(1, "actions", MESSAGE, "TransactionAction",
                    repeated=True),)


class ChaincodeEndorsedAction(Message):
    FIELDS = (
        Field(1, "proposal_response_payload", BYTES),
        Field(2, "endorsements", MESSAGE, "Endorsement", repeated=True),
    )


class ChaincodeActionPayload(Message):
    FIELDS = (
        Field(1, "chaincode_proposal_payload", BYTES),
        Field(2, "action", MESSAGE, "ChaincodeEndorsedAction"),
    )


# -- collection.proto --------------------------------------------------------


class ApplicationPolicy(Message):
    """The chaincode-level validation parameter (package `protos`; not
    `common.ApplicationPolicy`, whose signature policy is a bare rule)."""

    FIELDS = (
        Field(1, "signature_policy", MESSAGE,
              f"{_COMMON}.SignaturePolicyEnvelope", oneof="type"),
        Field(2, "channel_config_policy_reference", STRING, oneof="type"),
    )


class CollectionPolicyConfig(Message):
    FIELDS = (Field(1, "signature_policy", MESSAGE,
                    f"{_COMMON}.SignaturePolicyEnvelope", oneof="payload"),)


class CollectionConfigPackage(Message):
    FIELDS = (Field(1, "config", MESSAGE, "CollectionConfig", repeated=True),)


class CollectionConfig(Message):
    FIELDS = (Field(1, "static_collection_config", MESSAGE,
                    "StaticCollectionConfig", oneof="payload"),)


class StaticCollectionConfig(Message):
    FIELDS = (
        Field(1, "name", STRING),
        Field(2, "member_orgs_policy", MESSAGE, "CollectionPolicyConfig"),
        Field(3, "required_peer_count", INT32),
        Field(4, "maximum_peer_count", INT32),
        Field(5, "block_to_live", UINT64),
        Field(6, "member_only_read", BOOL),
        Field(7, "member_only_write", BOOL),
        Field(8, "endorsement_policy", MESSAGE, "ApplicationPolicy"),
    )


# -- chaincode_shim.proto -----------------------------------------------------


class ChaincodeMessage(Message):
    UNDEFINED = 0  # Type
    REGISTER = 1
    REGISTERED = 2
    INIT = 3
    READY = 4
    TRANSACTION = 5
    COMPLETED = 6
    ERROR = 7
    GET_STATE = 8
    PUT_STATE = 9
    DEL_STATE = 10
    INVOKE_CHAINCODE = 11
    RESPONSE = 13
    GET_STATE_BY_RANGE = 14
    GET_QUERY_RESULT = 15
    QUERY_STATE_NEXT = 16
    QUERY_STATE_CLOSE = 17
    KEEPALIVE = 18
    GET_HISTORY_FOR_KEY = 19
    GET_STATE_METADATA = 20
    PUT_STATE_METADATA = 21
    GET_PRIVATE_DATA_HASH = 22
    FIELDS = (
        Field(1, "type", ENUM),
        Field(2, "payload", BYTES),
        Field(3, "txid", STRING),
        Field(4, "channel_id", STRING),
        Field(5, "proposal", BYTES),
        Field(6, "chaincode_event", BYTES),
    )


class GetState(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "collection", STRING))


class PutState(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "value", BYTES),
              Field(3, "collection", STRING))


class DelState(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "collection", STRING))


class GetStateByRange(Message):
    FIELDS = (
        Field(1, "start_key", STRING),
        Field(2, "end_key", STRING),
        Field(3, "collection", STRING),
        Field(4, "metadata", BYTES),
    )


class QueryResultBytes(Message):
    FIELDS = (Field(1, "result_bytes", BYTES),)


class KV(Message):
    FIELDS = (Field(1, "namespace", STRING), Field(2, "key", STRING),
              Field(3, "value", BYTES))


class QueryResponse(Message):
    FIELDS = (
        Field(1, "results", MESSAGE, "QueryResultBytes", repeated=True),
        Field(2, "has_more", BOOL),
        Field(3, "id", STRING),
    )


class GetQueryResult(Message):
    FIELDS = (Field(1, "query", STRING), Field(2, "collection", STRING),
              Field(3, "metadata", BYTES))


class QueryStateNext(Message):
    FIELDS = (Field(1, "id", STRING),)


class QueryStateClose(Message):
    FIELDS = (Field(1, "id", STRING),)


class GetStateMetadata(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "collection", STRING))


class PutStateMetadata(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "collection", STRING),
              Field(3, "metadata", MESSAGE, "StateMetadata"))


class StateMetadata(Message):
    FIELDS = (Field(1, "metakey", STRING), Field(2, "value", BYTES))


class StateMetadataResult(Message):
    FIELDS = (Field(1, "entries", MESSAGE, "StateMetadata", repeated=True),)


# -- events.proto ---------------------------------------------------------------


class FilteredChaincodeAction(Message):
    FIELDS = (Field(1, "chaincode_event", MESSAGE, "ChaincodeEvent"),)


class FilteredTransactionActions(Message):
    FIELDS = (Field(1, "chaincode_actions", MESSAGE, "FilteredChaincodeAction",
                    repeated=True),)


class FilteredTransaction(Message):
    FIELDS = (
        Field(1, "txid", STRING),
        Field(2, "type", INT32),
        Field(3, "tx_validation_code", ENUM),
        Field(4, "transaction_actions", MESSAGE, "FilteredTransactionActions",
              oneof="Data"),
    )


class FilteredBlock(Message):
    FIELDS = (
        Field(1, "channel_id", STRING),
        Field(2, "number", UINT64),
        Field(4, "filtered_transactions", MESSAGE, "FilteredTransaction",
              repeated=True),
    )


class DeliverResponse(Message):
    FIELDS = (
        Field(1, "status", ENUM, oneof="Type"),
        Field(2, "block", MESSAGE, f"{_COMMON}.Block", oneof="Type"),
        Field(3, "filtered_block", MESSAGE, "FilteredBlock", oneof="Type"),
    )


# -- configuration.proto ----------------------------------------------------------


class AnchorPeer(Message):
    FIELDS = (Field(1, "host", STRING), Field(2, "port", INT32))


class AnchorPeers(Message):
    FIELDS = (Field(1, "anchor_peers", MESSAGE, "AnchorPeer", repeated=True),)


class APIResource(Message):
    FIELDS = (Field(1, "policy_ref", STRING),)


class ACLs(Message):
    FIELDS = (Field(1, "acls", MESSAGE, "APIResource", key=STRING,
                    value=MESSAGE),)


class ChannelQueryResponse(Message):
    FIELDS = (Field(1, "channels", MESSAGE, "ChannelInfo", repeated=True),)


class ChannelInfo(Message):
    FIELDS = (Field(1, "channel_id", STRING),)


# -- query.proto ------------------------------------------------------------------


class ChaincodeInfo(Message):
    FIELDS = (
        Field(1, "name", STRING),
        Field(2, "version", STRING),
        Field(3, "path", STRING),
        Field(4, "input", STRING),
        Field(5, "escc", STRING),
        Field(6, "vscc", STRING),
        Field(7, "id", BYTES),
    )


class ChaincodeQueryResponse(Message):
    FIELDS = (Field(1, "chaincodes", MESSAGE, "ChaincodeInfo",
                    repeated=True),)


class ChaincodeData(Message):
    FIELDS = (
        Field(1, "name", STRING),
        Field(2, "version", STRING),
        Field(3, "escc", STRING),
        Field(4, "vscc", STRING),
        Field(5, "policy", BYTES),
        Field(6, "data", BYTES),
        Field(7, "id", BYTES),
        Field(8, "instantiation_policy", BYTES),
    )
