"""An immutable view of a channel's configuration (the port's copy of
`fabric_tpu/common/channelconfig.py`; reference channelconfig.Bundle):
the channel's MSPs, behind the memoizing cache, and its policy manager,
built from the genesis block's CONFIG envelope."""

from __future__ import annotations

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.common import configtx_builder as keys
from fabric_tpu_torch.msp.cache import CachedMSP
from fabric_tpu_torch.msp.msp import MSP, MSPManager
from fabric_tpu_torch.policies.manager import Manager, manager_from_config_group
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb


class Bundle:
    """MSP manager and policy manager of one channel Config."""

    def __init__(self, channel_id: str, config: cb.Config):
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

    @staticmethod
    def _collect_msps(group: cb.ConfigGroup, out: list[MSP]) -> None:
        if keys.MSP_KEY in group.values:
            conf = mb.MSPConfig.decode(group.values[keys.MSP_KEY].value)
            out.append(MSP.from_config(conf))
        for sub in group.groups.values():
            Bundle._collect_msps(sub, out)


def bundle_from_genesis(block) -> Bundle:
    """The bundle of a genesis block (a `Block` or its bytes)."""
    if not isinstance(block, cb.Block):
        block = cb.Block.decode(block)
    env = protoutil.extract_envelope(block, 0)
    payload = cb.Payload.decode(env.payload)
    chdr = cb.ChannelHeader.decode(payload.header.channel_header)
    if chdr.type != cb.CONFIG:
        raise ValueError("block 0 does not carry a CONFIG transaction")
    config_env = cb.ConfigEnvelope.decode(payload.data)
    return Bundle(chdr.channel_id, config_env.config)


__all__ = ["Bundle", "bundle_from_genesis"]
