"""Raft ordering on the port (copies of the JAX package's
`fabric_tpu/orderer/raft/` modules of the same names): the state machine,
its write-ahead log, the cluster transports and the consenter chain."""

from fabric_tpu_torch.orderer.raft.chain import RaftChain
from fabric_tpu_torch.orderer.raft.raftcore import MemoryLog, RaftNode, Ready
from fabric_tpu_torch.orderer.raft.transport import (
    InProcTransport,
    TCPTransport,
)
from fabric_tpu_torch.orderer.raft.wal import WAL

__all__ = [
    "RaftNode",
    "Ready",
    "MemoryLog",
    "WAL",
    "RaftChain",
    "InProcTransport",
    "TCPTransport",
]
