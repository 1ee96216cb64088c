"""Capability gating (the port's copy of `fabric_tpu/common/capabilities.py`;
reference common/capabilities).

A channel's config names the capabilities it requires at the channel,
orderer and application levels; a node that lacks one must refuse the
channel (`supported()`).  The port implements the V2_0 semantics and
accepts the V1_x names for compatibility, as the JAX package does.
"""

from __future__ import annotations

from fabric_tpu_torch.protos import common as cb

CHANNEL_V2_0 = "V2_0"
CHANNEL_V1_4_3 = "V1_4_3"
CHANNEL_V1_4_2 = "V1_4_2"
CHANNEL_V1_3 = "V1_3"
CHANNEL_V1_1 = "V1_1"

APPLICATION_V2_0 = "V2_0"
APPLICATION_V1_4_2 = "V1_4_2"
APPLICATION_V1_3 = "V1_3"
APPLICATION_V1_2 = "V1_2"
APPLICATION_V1_1 = "V1_1"

ORDERER_V2_0 = "V2_0"
ORDERER_V1_4_2 = "V1_4_2"
ORDERER_V1_1 = "V1_1"


class UnsupportedCapabilityError(Exception):
    pass


class _Registry:
    def __init__(self, kind: str, known: set[str], caps: dict[str, bool]):
        self._kind = kind
        self._known = known
        self._required = {c for c, req in caps.items() if req}

    def supported(self) -> None:
        """Raise if the channel requires a capability this node lacks."""
        unknown = self._required - self._known
        if unknown:
            raise UnsupportedCapabilityError(
                f"{self._kind} capabilities not supported: {sorted(unknown)}")

    def required(self) -> set[str]:
        return set(self._required)

    def _has(self, cap: str) -> bool:
        return cap in self._required


class ChannelCapabilities(_Registry):
    def __init__(self, caps: dict[str, bool]):
        super().__init__("channel", {CHANNEL_V1_1, CHANNEL_V1_3,
                                     CHANNEL_V1_4_2, CHANNEL_V1_4_3,
                                     CHANNEL_V2_0}, caps)

    @property
    def consensus_type_migration(self) -> bool:
        return self._has(CHANNEL_V1_4_2) or self._has(CHANNEL_V2_0)


class ApplicationCapabilities(_Registry):
    def __init__(self, caps: dict[str, bool]):
        super().__init__("application", {APPLICATION_V1_1, APPLICATION_V1_2,
                                         APPLICATION_V1_3, APPLICATION_V1_4_2,
                                         APPLICATION_V2_0}, caps)

    @property
    def lifecycle_v20(self) -> bool:
        return self._has(APPLICATION_V2_0)

    @property
    def key_level_endorsement(self) -> bool:
        return self._has(APPLICATION_V1_3) or self._has(APPLICATION_V2_0)

    @property
    def private_channel_data(self) -> bool:
        return True  # always on, as in the JAX package

    @property
    def storage_pvt_data_experimental(self) -> bool:
        return self._has(APPLICATION_V2_0)


class OrdererCapabilities(_Registry):
    def __init__(self, caps: dict[str, bool]):
        super().__init__("orderer", {ORDERER_V1_1, ORDERER_V1_4_2,
                                     ORDERER_V2_0}, caps)

    @property
    def use_channel_creation_policy_as_admins(self) -> bool:
        return self._has(ORDERER_V2_0)


def capabilities_value(names: list[str]) -> cb.Capabilities:
    return cb.Capabilities(capabilities={n: cb.Capability() for n in names})


def parse_capabilities(raw: bytes) -> dict[str, bool]:
    return {name: True for name in cb.Capabilities.decode(raw).capabilities}


__all__ = [
    "ChannelCapabilities",
    "ApplicationCapabilities",
    "OrdererCapabilities",
    "UnsupportedCapabilityError",
    "capabilities_value",
    "parse_capabilities",
    "CHANNEL_V2_0",
    "APPLICATION_V2_0",
    "ORDERER_V2_0",
]
