"""An immutable view of a channel's configuration (the port's copy of
`fabric_tpu/common/channelconfig.py`; reference channelconfig.Bundle):
the channel's MSPs, behind the memoizing cache, its policy manager, its
typed orderer and application config and its ACLs, built from one Config
(a genesis or config block's CONFIG envelope)."""

from __future__ import annotations

import dataclasses

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.common import configtx_builder as keys
from fabric_tpu_torch.msp.cache import CachedMSP
from fabric_tpu_torch.msp.msp import MSP, MSPManager
from fabric_tpu_torch.policies.manager import Manager, manager_from_config_group
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb


@dataclasses.dataclass
class OrdererConfig:
    consensus_type: str
    consensus_metadata: bytes
    max_message_count: int
    absolute_max_bytes: int
    preferred_max_bytes: int
    batch_timeout_s: float
    org_mspids: list[str]
    # ConsensusType.State: STATE_NORMAL or STATE_MAINTENANCE (the gate of
    # a consensus-type migration)
    consensus_state: int = 0


@dataclasses.dataclass
class ApplicationOrg:
    name: str
    mspid: str


@dataclasses.dataclass
class ApplicationConfig:
    orgs: dict[str, ApplicationOrg]


def _parse_timeout(s: str) -> float:
    s = s.strip()
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    for suffix, mult in sorted(units.items(), key=lambda kv: -len(kv[0])):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    return float(s)


def _mspid(group: cb.ConfigGroup) -> str | None:
    if keys.MSP_KEY not in group.values:
        return None
    conf = mb.MSPConfig.decode(group.values[keys.MSP_KEY].value)
    return mb.FabricMSPConfig.decode(conf.config).name


class Bundle:
    """MSP manager, policy manager, orderer and application config and
    ACLs of one channel Config.  `csp` is the reference's argument (its
    MSPs check certificates through it); the port's MSPs check them with
    `msp/x509.py`, and policies take their CSP at evaluation."""

    def __init__(self, channel_id: str, config: cb.Config, csp=None):
        self.channel_id = channel_id
        self.config = config
        group = config.channel_group
        msps: list[MSP] = []
        for top in ("Application", "Orderer", "Consortiums"):
            if top in group.groups:
                self._collect_msps(group.groups[top], msps)
        self.msp_manager = CachedMSP(MSPManager(msps))
        self.policy_manager: Manager = manager_from_config_group(
            "Channel", group, self.msp_manager)
        self.orderer_config = self._orderer_config(group)
        self.application_config = self._application_config(group)
        self.acls = self._acls(group)

    @staticmethod
    def _collect_msps(group: cb.ConfigGroup, out: list[MSP]) -> None:
        if keys.MSP_KEY in group.values:
            conf = mb.MSPConfig.decode(group.values[keys.MSP_KEY].value)
            out.append(MSP.from_config(conf))
        for sub in group.groups.values():
            Bundle._collect_msps(sub, out)

    @staticmethod
    def _acls(group: cb.ConfigGroup) -> dict[str, str]:
        """The Application ACLs value: resource name -> policy ref."""
        if "Application" not in group.groups:
            return {}
        values = group.groups["Application"].values
        if keys.ACLS_KEY not in values:
            return {}
        acls = pb.ACLs.decode(values[keys.ACLS_KEY].value)
        return {name: a.policy_ref for name, a in acls.acls.items()}

    @staticmethod
    def _orderer_config(group: cb.ConfigGroup) -> OrdererConfig | None:
        if "Orderer" not in group.groups:
            return None
        og = group.groups["Orderer"]
        ct = ob.ConsensusType.decode(og.values[keys.CONSENSUS_TYPE_KEY].value)
        bs = ob.BatchSize.decode(og.values[keys.BATCH_SIZE_KEY].value)
        bt = ob.BatchTimeout.decode(og.values[keys.BATCH_TIMEOUT_KEY].value)
        mspids = [m for m in map(_mspid, og.groups.values()) if m is not None]
        return OrdererConfig(
            consensus_type=ct.type,
            consensus_metadata=ct.metadata,
            consensus_state=ct.state,
            max_message_count=bs.max_message_count,
            absolute_max_bytes=bs.absolute_max_bytes,
            preferred_max_bytes=bs.preferred_max_bytes,
            batch_timeout_s=_parse_timeout(bt.timeout),
            org_mspids=mspids,
        )

    @staticmethod
    def _application_config(group: cb.ConfigGroup) -> ApplicationConfig | None:
        if "Application" not in group.groups:
            return None
        orgs = {}
        for name, sub in group.groups["Application"].groups.items():
            mspid = _mspid(sub)
            orgs[name] = ApplicationOrg(name=name,
                                        mspid=name if mspid is None else mspid)
        return ApplicationConfig(orgs=orgs)


def bundle_from_genesis(block, csp=None) -> Bundle:
    """The bundle of a block whose transaction 0 is a CONFIG envelope (a
    `Block` or its bytes)."""
    if not isinstance(block, cb.Block):
        block = cb.Block.decode(block)
    env = protoutil.extract_envelope(block, 0)
    payload = cb.Payload.decode(env.payload)
    chdr = cb.ChannelHeader.decode(payload.header.channel_header)
    if chdr.type != cb.CONFIG:
        raise ValueError("block 0 does not carry a CONFIG transaction")
    config_env = cb.ConfigEnvelope.decode(payload.data)
    return Bundle(chdr.channel_id, config_env.config, csp)


__all__ = ["Bundle", "OrdererConfig", "ApplicationConfig", "ApplicationOrg",
           "bundle_from_genesis"]
