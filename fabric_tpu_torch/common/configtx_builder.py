"""Channel config-tree construction (the port's copy of
`fabric_tpu/common/configtx_builder.py`; reference configtxgen's
encoder): org, application, orderer and channel groups, and the genesis
block that wraps them in a CONFIG envelope."""

from __future__ import annotations

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.policies.policydsl import from_string
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb

# config value keys (reference common/channelconfig key constants)
MSP_KEY = "MSP"
HASHING_ALGORITHM_KEY = "HashingAlgorithm"
BLOCK_DATA_HASHING_STRUCTURE_KEY = "BlockDataHashingStructure"
ORDERER_ADDRESSES_KEY = "OrdererAddresses"
CONSENSUS_TYPE_KEY = "ConsensusType"
BATCH_SIZE_KEY = "BatchSize"
BATCH_TIMEOUT_KEY = "BatchTimeout"
CONSORTIUM_KEY = "Consortium"
ENDORSEMENT_POLICY_KEY = "Endorsement"
ACLS_KEY = "ACLs"


def _group() -> cb.ConfigGroup:
    return cb.ConfigGroup(groups={}, values={}, policies={},
                          mod_policy="Admins")


def _implicit_meta(group: cb.ConfigGroup, name: str, rule: int,
                   sub_policy: str | None = None) -> None:
    group.policies[name] = cb.ConfigPolicy(
        policy=cb.Policy(type=cb.Policy.IMPLICIT_META,
                         value=cb.ImplicitMetaPolicy(
                             sub_policy=sub_policy or name,
                             rule=rule).encode()),
        mod_policy="Admins")


def _signature_policy(group: cb.ConfigGroup, name: str, dsl: str) -> None:
    group.policies[name] = cb.ConfigPolicy(
        policy=cb.Policy(type=cb.Policy.SIGNATURE,
                         value=from_string(dsl).encode()),
        mod_policy="Admins")


def _set_value(group: cb.ConfigGroup, key: str, msg,
               mod_policy: str = "Admins") -> None:
    group.values[key] = cb.ConfigValue(value=msg.encode(),
                                       mod_policy=mod_policy)


def org_group(mspid: str, msp_conf: mb.MSPConfig,
              anchor=None) -> cb.ConfigGroup:
    """An org group: its MSP and org-scoped policies.  `anchor` (anchor
    peers) is accepted and, as in the JAX builder, written nowhere."""
    g = _group()
    _set_value(g, MSP_KEY, msp_conf)
    _signature_policy(g, "Readers", f"'{mspid}.member'")
    _signature_policy(g, "Writers", f"'{mspid}.member'")
    _signature_policy(g, "Admins", f"'{mspid}.admin'")
    _signature_policy(g, ENDORSEMENT_POLICY_KEY, f"'{mspid}.peer'")
    return g


def application_group(orgs: dict[str, cb.ConfigGroup],
                      acls: dict[str, str] | None = None) -> cb.ConfigGroup:
    """`acls` maps resource names to policy refs, written as the
    Application group's ACLs value."""
    g = _group()
    R = cb.ImplicitMetaPolicy
    _implicit_meta(g, "Readers", R.ANY)
    _implicit_meta(g, "Writers", R.ANY)
    _implicit_meta(g, "Admins", R.MAJORITY)
    _implicit_meta(g, "Endorsement", R.MAJORITY,
                   sub_policy=ENDORSEMENT_POLICY_KEY)
    _implicit_meta(g, "LifecycleEndorsement", R.MAJORITY,
                   sub_policy=ENDORSEMENT_POLICY_KEY)
    if acls:
        _set_value(g, ACLS_KEY, pb.ACLs(acls={
            name: pb.APIResource(policy_ref=ref)
            for name, ref in acls.items()}))
    g.groups.update(orgs)
    return g


def orderer_group(orgs: dict[str, cb.ConfigGroup],
                  consensus_type: str = "solo",
                  consensus_metadata: bytes = b"",
                  max_message_count: int = 500,
                  absolute_max_bytes: int = 10 * 1024 * 1024,
                  preferred_max_bytes: int = 2 * 1024 * 1024,
                  batch_timeout: str = "2s") -> cb.ConfigGroup:
    """An orderer group; the defaults are the JAX builder's (solo, 500
    messages, 10 MiB absolute, 2 MiB preferred, 2s)."""
    g = _group()
    R = cb.ImplicitMetaPolicy
    _implicit_meta(g, "Readers", R.ANY)
    _implicit_meta(g, "Writers", R.ANY)
    _implicit_meta(g, "Admins", R.MAJORITY)
    _implicit_meta(g, "BlockValidation", R.ANY, sub_policy="Writers")
    _set_value(g, CONSENSUS_TYPE_KEY, ob.ConsensusType(
        type=consensus_type, metadata=consensus_metadata))
    _set_value(g, BATCH_SIZE_KEY, ob.BatchSize(
        max_message_count=max_message_count,
        absolute_max_bytes=absolute_max_bytes,
        preferred_max_bytes=preferred_max_bytes))
    _set_value(g, BATCH_TIMEOUT_KEY, ob.BatchTimeout(timeout=batch_timeout))
    g.groups.update(orgs)
    return g


def channel_group(application: cb.ConfigGroup | None,
                  orderer: cb.ConfigGroup | None,
                  orderer_addresses: list[str] | None = None
                  ) -> cb.ConfigGroup:
    g = _group()
    R = cb.ImplicitMetaPolicy
    _implicit_meta(g, "Readers", R.ANY)
    _implicit_meta(g, "Writers", R.ANY)
    _implicit_meta(g, "Admins", R.MAJORITY)
    _set_value(g, HASHING_ALGORITHM_KEY, cb.HashingAlgorithm(name="SHA256"))
    _set_value(g, BLOCK_DATA_HASHING_STRUCTURE_KEY,
               cb.BlockDataHashingStructure(width=0xFFFFFFFF))
    if orderer_addresses:
        _set_value(g, ORDERER_ADDRESSES_KEY,
                   cb.OrdererAddresses(addresses=orderer_addresses),
                   mod_policy="/Channel/Orderer/Admins")
    if application is not None:
        g.groups["Application"] = application
    if orderer is not None:
        g.groups["Orderer"] = orderer
    return g


def genesis_block(channel_id: str, group: cb.ConfigGroup,
                  nonce: bytes | None = None,
                  timestamp: float | None = None) -> cb.Block:
    """Block 0 wrapping the CONFIG envelope."""
    config_env = cb.ConfigEnvelope(config=cb.Config(sequence=0,
                                                    channel_group=group))
    chdr = protoutil.make_channel_header(cb.CONFIG, channel_id,
                                         timestamp=timestamp)
    shdr = protoutil.make_signature_header(
        b"", nonce if nonce is not None else protoutil.random_nonce())
    payload = protoutil.make_payload_bytes(chdr, shdr, config_env.encode())
    blk = protoutil.new_block(0, b"")
    blk.data.data.append(cb.Envelope(payload=payload).encode())
    blk.header.data_hash = protoutil.block_data_hash(blk.data)
    protoutil.set_tx_filter(blk, b"\x00")
    return blk


__all__ = ["org_group", "application_group", "orderer_group",
           "channel_group", "genesis_block", "MSP_KEY", "CONSENSUS_TYPE_KEY",
           "BATCH_SIZE_KEY", "BATCH_TIMEOUT_KEY", "ENDORSEMENT_POLICY_KEY",
           "ORDERER_ADDRESSES_KEY", "CONSORTIUM_KEY", "ACLS_KEY"]
