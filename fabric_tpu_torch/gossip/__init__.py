"""The port's gossip (a copy of `fabric_tpu/gossip/`): authenticated
comm (in-process and TCP over mutual TLS), membership, identity
dissemination, block push and pull, leader election, state transfer,
private-data dissemination and the commit coordinator, and the service
that wires them a channel at a time."""

from fabric_tpu_torch.gossip.comm import (
    GossipComm,
    InProcGossipComm,
    InProcGossipNet,
    MessageCryptoService,
    SignerMCS,
    TCPGossipComm,
)
from fabric_tpu_torch.gossip.core import ChannelGossip, MessageStore
from fabric_tpu_torch.gossip.discovery import Discovery, DiscoveryCore
from fabric_tpu_torch.gossip.election import LeaderElection
from fabric_tpu_torch.gossip.service import GossipRunner, GossipService
from fabric_tpu_torch.gossip.state import StateProvider

__all__ = [
    "GossipComm",
    "InProcGossipComm",
    "InProcGossipNet",
    "TCPGossipComm",
    "MessageCryptoService",
    "SignerMCS",
    "ChannelGossip",
    "MessageStore",
    "Discovery",
    "DiscoveryCore",
    "LeaderElection",
    "GossipService",
    "GossipRunner",
    "StateProvider",
]
