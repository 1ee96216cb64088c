"""Schemas of package `common`: `common.proto` (with its `Status` codes),
`configtx.proto`,
`configuration.proto`, `policies.proto`, `ledger.proto` and
`msp_principal.proto` (field numbers from the JAX package's
`fabric_tpu/protos/common/*.proto` and `msp/msp_principal.proto`), and
`google.protobuf.Timestamp`."""

from fabric_tpu_torch.protos.wire import (
    BYTES,
    ENUM,
    INT32,
    INT64,
    MESSAGE,
    STRING,
    UINT32,
    UINT64,
    Field,
    Message,
)

# Status
UNKNOWN = 0
SUCCESS = 200
BAD_REQUEST = 400
FORBIDDEN = 403
NOT_FOUND = 404
REQUEST_ENTITY_TOO_LARGE = 413
INTERNAL_SERVER_ERROR = 500
NOT_IMPLEMENTED = 501
SERVICE_UNAVAILABLE = 503

# HeaderType
MESSAGE_TYPE = 0
CONFIG = 1
CONFIG_UPDATE = 2
ENDORSER_TRANSACTION = 3
ORDERER_TRANSACTION = 4
DELIVER_SEEK_INFO = 5
CHAINCODE_PACKAGE = 6
PEER_ADMIN_OPERATION = 8

# BlockMetadataIndex
SIGNATURES = 0
LAST_CONFIG = 1
TRANSACTIONS_FILTER = 2
ORDERER = 3
COMMIT_HASH = 4


class Timestamp(Message):
    FIELDS = (Field(1, "seconds", INT64), Field(2, "nanos", INT32))


# -- common.proto -----------------------------------------------------------


class LastConfig(Message):
    FIELDS = (Field(1, "index", UINT64),)


class MetadataSignature(Message):
    FIELDS = (Field(1, "signature_header", BYTES), Field(2, "signature", BYTES))


class Metadata(Message):
    FIELDS = (
        Field(1, "value", BYTES),
        Field(2, "signatures", MESSAGE, "MetadataSignature", repeated=True),
    )


class Header(Message):
    FIELDS = (Field(1, "channel_header", BYTES),
              Field(2, "signature_header", BYTES))


class ChannelHeader(Message):
    FIELDS = (
        Field(1, "type", INT32),
        Field(2, "version", INT32),
        Field(3, "timestamp", MESSAGE, "Timestamp"),
        Field(4, "channel_id", STRING),
        Field(5, "tx_id", STRING),
        Field(6, "epoch", UINT64),
        Field(7, "extension", BYTES),
        Field(8, "tls_cert_hash", BYTES),
    )


class SignatureHeader(Message):
    FIELDS = (Field(1, "creator", BYTES), Field(2, "nonce", BYTES))


class Payload(Message):
    FIELDS = (Field(1, "header", MESSAGE, "Header"), Field(2, "data", BYTES))


class Envelope(Message):
    FIELDS = (Field(1, "payload", BYTES), Field(2, "signature", BYTES))


class BlockHeader(Message):
    FIELDS = (
        Field(1, "number", UINT64),
        Field(2, "previous_hash", BYTES),
        Field(3, "data_hash", BYTES),
    )


class BlockData(Message):
    FIELDS = (Field(1, "data", BYTES, repeated=True),)


class BlockMetadata(Message):
    FIELDS = (Field(1, "metadata", BYTES, repeated=True),)


class Block(Message):
    FIELDS = (
        Field(1, "header", MESSAGE, "BlockHeader"),
        Field(2, "data", MESSAGE, "BlockData"),
        Field(3, "metadata", MESSAGE, "BlockMetadata"),
    )


class BlockchainInfo(Message):
    """`ledger.proto`: a ledger's height and its last two block hashes."""

    FIELDS = (
        Field(1, "height", UINT64),
        Field(2, "current_block_hash", BYTES),
        Field(3, "previous_block_hash", BYTES),
    )


class OrdererBlockMetadata(Message):
    FIELDS = (
        Field(1, "last_config", MESSAGE, "LastConfig"),
        Field(2, "consenter_metadata", BYTES),
    )


# -- configtx.proto -----------------------------------------------------------


class ConfigValue(Message):
    FIELDS = (
        Field(1, "version", UINT64),
        Field(2, "value", BYTES),
        Field(3, "mod_policy", STRING),
    )


class ConfigPolicy(Message):
    FIELDS = (
        Field(1, "version", UINT64),
        Field(2, "policy", MESSAGE, "Policy"),
        Field(3, "mod_policy", STRING),
    )


class ConfigGroup(Message):
    FIELDS = (
        Field(1, "version", UINT64),
        Field(2, "groups", MESSAGE, "ConfigGroup", key=STRING, value=MESSAGE),
        Field(3, "values", MESSAGE, "ConfigValue", key=STRING, value=MESSAGE),
        Field(4, "policies", MESSAGE, "ConfigPolicy", key=STRING,
              value=MESSAGE),
        Field(5, "mod_policy", STRING),
    )


class Config(Message):
    FIELDS = (
        Field(1, "sequence", UINT64),
        Field(2, "channel_group", MESSAGE, "ConfigGroup"),
    )


class ConfigEnvelope(Message):
    FIELDS = (
        Field(1, "config", MESSAGE, "Config"),
        Field(2, "last_update", MESSAGE, "Envelope"),
    )


class ConfigSignature(Message):
    FIELDS = (Field(1, "signature_header", BYTES), Field(2, "signature", BYTES))


class ConfigUpdateEnvelope(Message):
    FIELDS = (
        Field(1, "config_update", BYTES),
        Field(2, "signatures", MESSAGE, "ConfigSignature", repeated=True),
    )


class ConfigUpdate(Message):
    FIELDS = (
        Field(1, "channel_id", STRING),
        Field(2, "read_set", MESSAGE, "ConfigGroup"),
        Field(3, "write_set", MESSAGE, "ConfigGroup"),
        Field(5, "isolated_data", BYTES, key=STRING, value=BYTES),
    )


# -- configuration.proto ------------------------------------------------------


class HashingAlgorithm(Message):
    FIELDS = (Field(1, "name", STRING),)


class BlockDataHashingStructure(Message):
    FIELDS = (Field(1, "width", UINT32),)


class OrdererAddresses(Message):
    FIELDS = (Field(1, "addresses", STRING, repeated=True),)


class Consortium(Message):
    FIELDS = (Field(1, "name", STRING),)


class Capability(Message):
    FIELDS = ()


class Capabilities(Message):
    FIELDS = (Field(1, "capabilities", MESSAGE, "Capability", key=STRING,
                    value=MESSAGE),)


# -- policies.proto -----------------------------------------------------------


class Policy(Message):
    UNKNOWN = 0
    SIGNATURE = 1
    MSP = 2
    IMPLICIT_META = 3
    FIELDS = (Field(1, "type", INT32), Field(2, "value", BYTES))


class NOutOf(Message):
    FIELDS = (
        Field(1, "n", INT32),
        Field(2, "rules", MESSAGE, "SignaturePolicy", repeated=True),
    )


class SignaturePolicy(Message):
    NOutOf = NOutOf
    FIELDS = (
        Field(1, "signed_by", INT32, oneof="Type"),
        Field(2, "n_out_of", MESSAGE, "NOutOf", oneof="Type"),
    )


class SignaturePolicyEnvelope(Message):
    FIELDS = (
        Field(1, "version", INT32),
        Field(2, "rule", MESSAGE, "SignaturePolicy"),
        Field(3, "identities", MESSAGE, "MSPPrincipal", repeated=True),
    )


class ImplicitMetaPolicy(Message):
    ANY = 0
    ALL = 1
    MAJORITY = 2
    FIELDS = (Field(1, "sub_policy", STRING), Field(2, "rule", ENUM))


class ApplicationPolicy(Message):
    FIELDS = (
        Field(1, "signature_policy", MESSAGE, "SignaturePolicy", oneof="Type"),
        Field(2, "channel_config_policy_reference", STRING, oneof="Type"),
    )


# -- msp_principal.proto (package common) --------------------------------------


class MSPPrincipal(Message):
    ROLE = 0
    ORGANIZATION_UNIT = 1
    IDENTITY = 2
    ANONYMITY = 3
    COMBINED = 4
    FIELDS = (
        Field(1, "principal_classification", ENUM, enum={
            0: "ROLE", 1: "ORGANIZATION_UNIT", 2: "IDENTITY", 3: "ANONYMITY",
            4: "COMBINED"}),
        Field(2, "principal", BYTES),
    )


class OrganizationUnit(Message):
    FIELDS = (
        Field(1, "msp_identifier", STRING),
        Field(2, "organizational_unit_identifier", STRING),
        Field(3, "certifiers_identifier", BYTES),
    )


class MSPRole(Message):
    MEMBER = 0
    ADMIN = 1
    CLIENT = 2
    PEER = 3
    ORDERER = 4
    FIELDS = (Field(1, "msp_identifier", STRING), Field(2, "role", ENUM))


class MSPIdentityAnonymity(Message):
    NOMINAL = 0
    ANONYMOUS = 1
    FIELDS = (Field(1, "anonymity_type", ENUM),)


class CombinedPrincipal(Message):
    FIELDS = (Field(1, "principals", MESSAGE, "MSPPrincipal", repeated=True),)
