"""ACL management: resource names to policies, checked at API entry (the
port's copy of `fabric_tpu/peer/aclmgmt.py`; reference core/aclmgmt:
resources.go's catalog, defaultaclprovider.go's defaults on
/Channel/Application/{Readers,Writers,Admins}, resourceprovider.go's
overrides from the channel's ACLs value).

`ACLProvider.check_acl(resource, policy_manager, signed_data)` raises
ACLError unless the resource's policy passes, through the port's
`evaluate_signed_data` (one signature at a time on the host under the
CSP's `min_device_batch`).
"""

from __future__ import annotations

from fabric_tpu_torch.protos import peer as pb


class ACLError(Exception):
    pass


# Resource names (reference resources.go).
LSCC_GET_CC_DATA = "lscc/GetChaincodeData"
LSCC_GET_CHAINCODES = "lscc/GetInstantiatedChaincodes"
LSCC_CC_EXISTS = "lscc/ChaincodeExists"
LSCC_GET_DEP_SPEC = "lscc/GetDeploymentSpec"
QSCC_GET_CHAIN_INFO = "qscc/GetChainInfo"
QSCC_GET_BLOCK_BY_NUMBER = "qscc/GetBlockByNumber"
QSCC_GET_BLOCK_BY_HASH = "qscc/GetBlockByHash"
QSCC_GET_TX_BY_ID = "qscc/GetTransactionByID"
QSCC_GET_BLOCK_BY_TX_ID = "qscc/GetBlockByTxID"
CSCC_GET_CONFIG_BLOCK = "cscc/GetConfigBlock"
CSCC_GET_CHANNEL_CONFIG = "cscc/GetChannelConfig"
CSCC_JOIN_CHAIN = "cscc/JoinChain"
CSCC_GET_CHANNELS = "cscc/GetChannels"
LSCC_INSTALL = "lscc/Install"
LSCC_GET_INSTALLED_CC = "lscc/GetInstalledChaincodes"
LIFECYCLE_INSTALL = "_lifecycle/InstallChaincode"
LIFECYCLE_QUERY_INSTALLED = "_lifecycle/QueryInstalledChaincodes"
LIFECYCLE_GET_PACKAGE = "_lifecycle/GetInstalledChaincodePackage"
LIFECYCLE_APPROVE = "_lifecycle/ApproveChaincodeDefinitionForMyOrg"
LIFECYCLE_COMMIT = "_lifecycle/CommitChaincodeDefinition"
LIFECYCLE_CHECK_READINESS = "_lifecycle/CheckCommitReadiness"
LIFECYCLE_QUERY_COMMITTED = "_lifecycle/QueryChaincodeDefinition"
LIFECYCLE_QUERY_COMMITTED_ALL = "_lifecycle/QueryChaincodeDefinitions"
PEER_PROPOSE = "peer/Propose"
PEER_CC2CC = "peer/ChaincodeToChaincode"
EVENT_BLOCK = "event/Block"
EVENT_FILTERED_BLOCK = "event/FilteredBlock"
GOSSIP_PRIVATE_DATA = "gossip/PrivateData"

_READERS = "/Channel/Application/Readers"
_WRITERS = "/Channel/Application/Writers"
_ADMINS = "/Channel/Application/Admins"

DEFAULT_POLICIES: dict[str, str] = {
    LSCC_GET_CC_DATA: _READERS,
    LSCC_GET_CHAINCODES: _READERS,
    LSCC_CC_EXISTS: _READERS,
    LSCC_GET_DEP_SPEC: _READERS,
    QSCC_GET_CHAIN_INFO: _READERS,
    QSCC_GET_BLOCK_BY_NUMBER: _READERS,
    QSCC_GET_BLOCK_BY_HASH: _READERS,
    QSCC_GET_TX_BY_ID: _READERS,
    QSCC_GET_BLOCK_BY_TX_ID: _READERS,
    CSCC_GET_CONFIG_BLOCK: _READERS,
    CSCC_GET_CHANNEL_CONFIG: _READERS,
    CSCC_GET_CHANNELS: _READERS,  # channel-less in practice
    CSCC_JOIN_CHAIN: _ADMINS,  # local admin in the reference
    LSCC_INSTALL: _ADMINS,  # local admin in the reference
    LSCC_GET_INSTALLED_CC: _ADMINS,
    LIFECYCLE_INSTALL: _ADMINS,
    LIFECYCLE_QUERY_INSTALLED: _ADMINS,
    LIFECYCLE_GET_PACKAGE: _ADMINS,
    LIFECYCLE_QUERY_COMMITTED_ALL: _READERS,
    LIFECYCLE_APPROVE: _WRITERS,
    LIFECYCLE_COMMIT: _WRITERS,
    LIFECYCLE_CHECK_READINESS: _WRITERS,
    LIFECYCLE_QUERY_COMMITTED: _READERS,
    PEER_PROPOSE: _WRITERS,
    PEER_CC2CC: _WRITERS,
    EVENT_BLOCK: _READERS,
    EVENT_FILTERED_BLOCK: _READERS,
    GOSSIP_PRIVATE_DATA: _READERS,
}


# System-chaincode function -> resource mapping.  The reference checks
# these inside each SCC, where the stub exposes the SignedProposal
# (qscc/query.go:112 fn->resource switch, cscc/configure.go:163-186,
# lifecycle/scc.go:209 "_lifecycle/<FuncName>"); here the enforcement
# point is the endorser entry, the one place this build has the signed
# proposal, the channel policy manager, and the chaincode name+function
# together.
SCC_FUNCTION_RESOURCES: dict[tuple[str, str], str] = {
    ("qscc", "GetChainInfo"): QSCC_GET_CHAIN_INFO,
    ("qscc", "GetBlockByNumber"): QSCC_GET_BLOCK_BY_NUMBER,
    ("qscc", "GetBlockByHash"): QSCC_GET_BLOCK_BY_HASH,
    ("qscc", "GetTransactionByID"): QSCC_GET_TX_BY_ID,
    ("qscc", "GetBlockByTxID"): QSCC_GET_BLOCK_BY_TX_ID,
    ("cscc", "GetConfigBlock"): CSCC_GET_CONFIG_BLOCK,
    ("cscc", "GetChannelConfig"): CSCC_GET_CHANNEL_CONFIG,
    ("cscc", "GetChannels"): CSCC_GET_CHANNELS,
    ("cscc", "JoinChain"): CSCC_JOIN_CHAIN,
    # fn names as the JAX package's lscc dispatch spells them
    ("lscc", "getccdata"): LSCC_GET_CC_DATA,
    ("lscc", "getchaincodes"): LSCC_GET_CHAINCODES,
    # the dispatch's alias of getchaincodes needs the same resource
    ("lscc", "GetChaincodesResult"): LSCC_GET_CHAINCODES,
    ("lscc", "getid"): LSCC_CC_EXISTS,
    ("lscc", "getdepspec"): LSCC_GET_DEP_SPEC,
    ("lscc", "install"): LSCC_INSTALL,
    ("lscc", "getinstalledchaincodes"): LSCC_GET_INSTALLED_CC,
    # deploy/upgrade: "ACL check covered by PROPOSAL" in the reference
    # (defaultaclprovider.go:69-70) — the channel Writers gate applies
    ("lscc", "deploy"): PEER_PROPOSE,
    ("lscc", "upgrade"): PEER_PROPOSE,
    ("_lifecycle", "InstallChaincode"): LIFECYCLE_INSTALL,
    ("_lifecycle", "QueryInstalledChaincodes"): LIFECYCLE_QUERY_INSTALLED,
    ("_lifecycle", "GetInstalledChaincodePackage"): LIFECYCLE_GET_PACKAGE,
    ("_lifecycle", "ApproveChaincodeDefinitionForMyOrg"): LIFECYCLE_APPROVE,
    ("_lifecycle", "CommitChaincodeDefinition"): LIFECYCLE_COMMIT,
    ("_lifecycle", "CheckCommitReadiness"): LIFECYCLE_CHECK_READINESS,
    ("_lifecycle", "QueryChaincodeDefinition"): LIFECYCLE_QUERY_COMMITTED,
    ("_lifecycle", "QueryChaincodeDefinitions"): LIFECYCLE_QUERY_COMMITTED_ALL,
}

SYSTEM_CHAINCODES = frozenset({"qscc", "cscc", "lscc", "_lifecycle"})


def resource_for_chaincode(cc_name: str, fn: str) -> str:
    """Resource an on-channel proposal must satisfy: the per-function
    SCC resource, or peer/Propose for application chaincodes.

    Fail-closed: a system-chaincode function with no catalog entry is
    denied (ACLError), so a function added to an SCC without an entry is
    never open to all."""
    if cc_name in SYSTEM_CHAINCODES:
        res = SCC_FUNCTION_RESOURCES.get((cc_name, fn))
        if res is None:
            raise ACLError(
                f"access denied: no ACL catalog entry for system "
                f"chaincode function {cc_name}/{fn!r}"
            )
        return res
    return PEER_PROPOSE


class ACLProvider:
    """Resource ACLs against a channel's policy manager, with the
    channel's overrides."""

    def __init__(self, overrides: dict[str, str] | None = None, csp=None):
        self._overrides = dict(overrides or {})
        self._csp = csp

    @classmethod
    def from_acls_config(cls, raw: bytes, csp=None) -> "ACLProvider":
        """From a marshaled peer.ACLs config value."""
        acls = pb.ACLs.decode(raw)
        return cls({name: a.policy_ref for name, a in acls.acls.items()},
                   csp=csp)

    def policy_ref(self, resource: str) -> str:
        ref = self._overrides.get(resource) or DEFAULT_POLICIES.get(resource)
        if ref is None:
            raise ACLError(f"no ACL policy for resource {resource!r}")
        if not ref.startswith("/"):
            # a relative reference names a policy of the Application group
            ref = "/Channel/Application/" + ref
        return ref

    def check_acl(self, resource: str, policy_manager, signed_data) -> None:
        """Raise ACLError unless the resource's policy passes (reference
        aclmgmt CheckACL)."""
        ref = self.policy_ref(resource)
        pol = policy_manager.get_policy(ref)
        if not pol.evaluate_signed_data(
                signed_data if isinstance(signed_data, list)
                else [signed_data], self._csp):
            raise ACLError(
                f"access denied: resource {resource!r} requires {ref!r}")


__all__ = [
    "ACLProvider",
    "ACLError",
    "DEFAULT_POLICIES",
    "SCC_FUNCTION_RESOURCES",
    "SYSTEM_CHAINCODES",
    "resource_for_chaincode",
]
