"""Schemas of package `msp`: `identities.proto` and `msp_config.proto`
(field numbers from the JAX package's `fabric_tpu/protos/msp/`)."""

from fabric_tpu_torch.protos.wire import (
    BOOL,
    BYTES,
    INT32,
    MESSAGE,
    STRING,
    UINT64,
    Field,
    Message,
)


class SerializedIdentity(Message):
    FIELDS = (Field(1, "mspid", STRING), Field(2, "id_bytes", BYTES))


class SerializedIdemixIdentity(Message):
    FIELDS = (
        Field(1, "nym_x", BYTES),
        Field(2, "nym_y", BYTES),
        Field(3, "ou", BYTES),
        Field(4, "role", BYTES),
        Field(5, "proof", BYTES),
    )


class MSPConfig(Message):
    FIELDS = (Field(1, "type", INT32), Field(2, "config", BYTES))


class FabricCryptoConfig(Message):
    FIELDS = (
        Field(1, "signature_hash_family", STRING),
        Field(2, "identity_identifier_hash_function", STRING),
    )


class KeyInfo(Message):
    FIELDS = (Field(1, "key_identifier", STRING),
              Field(2, "key_material", BYTES))


class SigningIdentityInfo(Message):
    FIELDS = (
        Field(1, "public_signer", BYTES),
        Field(2, "private_signer", MESSAGE, "KeyInfo"),
    )


class FabricOUIdentifier(Message):
    FIELDS = (
        Field(1, "certificate", BYTES),
        Field(2, "organizational_unit_identifier", STRING),
    )


class FabricNodeOUs(Message):
    FIELDS = (
        Field(1, "enable", BOOL),
        Field(2, "client_ou_identifier", MESSAGE, "FabricOUIdentifier"),
        Field(3, "peer_ou_identifier", MESSAGE, "FabricOUIdentifier"),
        Field(4, "admin_ou_identifier", MESSAGE, "FabricOUIdentifier"),
        Field(5, "orderer_ou_identifier", MESSAGE, "FabricOUIdentifier"),
    )


class FabricMSPConfig(Message):
    FIELDS = (
        Field(1, "name", STRING),
        Field(2, "root_certs", BYTES, repeated=True),
        Field(3, "intermediate_certs", BYTES, repeated=True),
        Field(4, "admins", BYTES, repeated=True),
        Field(5, "revocation_list", BYTES, repeated=True),
        Field(6, "signing_identity", MESSAGE, "SigningIdentityInfo"),
        Field(7, "organizational_unit_identifiers", MESSAGE,
              "FabricOUIdentifier", repeated=True),
        Field(8, "crypto_config", MESSAGE, "FabricCryptoConfig"),
        Field(9, "tls_root_certs", BYTES, repeated=True),
        Field(10, "tls_intermediate_certs", BYTES, repeated=True),
        Field(11, "fabric_node_ous", MESSAGE, "FabricNodeOUs"),
    )


class IdemixMSPConfig(Message):
    FIELDS = (
        Field(1, "name", STRING),
        Field(2, "ipk", BYTES),
        Field(3, "signer", BYTES),
        Field(4, "revocation_pk", BYTES),
        Field(5, "epoch", UINT64),
    )


class IdemixMSPSignerConfig(Message):
    FIELDS = (
        Field(1, "cred", BYTES),
        Field(2, "sk", BYTES),
        Field(3, "organizational_unit_identifier", STRING),
        Field(4, "role", INT32),
        Field(5, "enrollment_id", BYTES),
        Field(6, "credential_revocation_information", BYTES),
    )
