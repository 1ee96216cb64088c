"""Schemas of package `lifecycle`: `lifecycle.proto`, the `_lifecycle`
system chaincode's arguments, results and the committed chaincode
definition (field numbers from the JAX package's
`fabric_tpu/protos/peer/lifecycle.proto`).  Its `ApplicationPolicy`
carries the signature policy as bytes, unlike package `protos`'s."""

from fabric_tpu_torch.protos.wire import (
    BOOL,
    BYTES,
    INT64,
    MESSAGE,
    STRING,
    Field,
    Message,
)


class InstallChaincodeArgs(Message):
    FIELDS = (Field(1, "chaincode_install_package", BYTES),)


class InstallChaincodeResult(Message):
    FIELDS = (Field(1, "package_id", STRING), Field(2, "label", STRING))


class QueryInstalledChaincodesArgs(Message):
    FIELDS = ()


class InstalledChaincode(Message):
    """`QueryInstalledChaincodesResult.InstalledChaincode`."""

    FIELDS = (Field(1, "package_id", STRING), Field(2, "label", STRING))


class QueryInstalledChaincodesResult(Message):
    FIELDS = (Field(1, "installed_chaincodes", MESSAGE, "InstalledChaincode",
                    repeated=True),)


class Unavailable(Message):
    """`ChaincodeSource.Unavailable`."""

    FIELDS = ()


class Local(Message):
    """`ChaincodeSource.Local`."""

    FIELDS = (Field(1, "package_id", STRING),)


class ChaincodeSource(Message):
    FIELDS = (
        Field(1, "unavailable", MESSAGE, "Unavailable", oneof="Type"),
        Field(2, "local_package", MESSAGE, "Local", oneof="Type"),
    )


class ChaincodeDefinition(Message):
    FIELDS = (
        Field(1, "sequence", INT64),
        Field(2, "name", STRING),
        Field(3, "version", STRING),
        Field(4, "endorsement_plugin", STRING),
        Field(5, "validation_plugin", STRING),
        Field(6, "validation_parameter", BYTES),
        Field(7, "collections", BYTES),
        Field(8, "init_required", BOOL),
    )


class ApproveChaincodeDefinitionForMyOrgArgs(Message):
    FIELDS = (Field(1, "definition", MESSAGE, "ChaincodeDefinition"),
              Field(2, "source", MESSAGE, "ChaincodeSource"))


class ApproveChaincodeDefinitionForMyOrgResult(Message):
    FIELDS = ()


class CheckCommitReadinessArgs(Message):
    FIELDS = (Field(1, "definition", MESSAGE, "ChaincodeDefinition"),)


class CheckCommitReadinessResult(Message):
    FIELDS = (Field(1, "approvals", BOOL, key=STRING, value=BOOL),)


class CommitChaincodeDefinitionArgs(Message):
    FIELDS = (Field(1, "definition", MESSAGE, "ChaincodeDefinition"),)


class CommitChaincodeDefinitionResult(Message):
    FIELDS = ()


class QueryChaincodeDefinitionArgs(Message):
    FIELDS = (Field(1, "name", STRING),)


class QueryChaincodeDefinitionResult(Message):
    FIELDS = (
        Field(1, "definition", MESSAGE, "ChaincodeDefinition"),
        Field(2, "approvals", BOOL, key=STRING, value=BOOL),
    )


class QueryChaincodeDefinitionsArgs(Message):
    FIELDS = ()


class ChaincodeInfo(Message):
    """`QueryChaincodeDefinitionsResult.ChaincodeInfo`."""

    FIELDS = (Field(1, "name", STRING),
              Field(2, "definition", MESSAGE, "ChaincodeDefinition"))


class QueryChaincodeDefinitionsResult(Message):
    FIELDS = (Field(1, "chaincode_definitions", MESSAGE, "ChaincodeInfo",
                    repeated=True),)


class ApplicationPolicy(Message):
    FIELDS = (
        Field(1, "signature_policy", BYTES, oneof="Type"),
        Field(2, "channel_config_policy_reference", STRING, oneof="Type"),
    )
