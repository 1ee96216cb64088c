"""Follower and inactive chains (the port's copy of
`fabric_tpu/orderer/follower.py`; reference orderer/consensus/follower
and orderer/consensus/inactive).

A node in a channel's config but outside its consenter set runs a
`FollowerChain`: it pulls blocks from the cluster and appends them to its
ledger until a config block puts the node in the consenter set, and then
stops, so that the registrar can start a consenter.  `InactiveChain`
stands for a channel that this node tracks and does not serve: every
submission raises `NotServicedError`.
"""

from __future__ import annotations

import threading

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.protos import common as cb


class NotServicedError(Exception):
    """A submission to a channel this node does not serve."""


class InactiveChain:
    def __init__(self, channel_id: str):
        self.channel_id = channel_id

    def start(self) -> None:
        pass

    def halt(self) -> None:
        pass

    def wait_ready(self) -> None:
        raise NotServicedError(f"channel {self.channel_id!r} is not serviced")

    def order(self, env: cb.Envelope, config_seq: int = 0) -> None:
        raise NotServicedError(f"channel {self.channel_id!r} is not serviced")

    def configure(self, env: cb.Envelope, config_seq: int = 0) -> None:
        raise NotServicedError(f"channel {self.channel_id!r} is not serviced")


class FollowerChain:
    """Pulls blocks while outside the consenter set.

    puller: callable(height) -> Block | None, the block at `height` from
        some cluster member;
    writer: callable(Block), appends to the local ledger;
    in_consenter_set: callable(Block) -> bool, read on config blocks; once
        True the follower stops and sets `joined`.
    """

    def __init__(self, channel_id: str, height, puller, writer,
                 in_consenter_set, poll_interval_s: float = 0.2):
        self.channel_id = channel_id
        self._height = height
        self._puller = puller
        self._writer = writer
        self._in_set = in_consenter_set
        self._poll = poll_interval_s
        self._stop = threading.Event()
        self.joined = threading.Event()
        self._thread: threading.Thread | None = None

    def wait_ready(self) -> None:
        raise NotServicedError(
            f"channel {self.channel_id!r}: this node is a follower")

    order = InactiveChain.order
    configure = InactiveChain.configure

    def start(self) -> None:
        self._thread = spawn_thread(target=self._run,
                                    name=f"follower-{self.channel_id}",
                                    kind="service")
        self._thread.start()

    def halt(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    @property
    def height(self) -> int:
        return self._height

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                blk = self._puller(self._height)
            except Exception:
                blk = None  # a failed pull is retried after the poll
            if blk is None:
                self._stop.wait(self._poll)
                continue
            self._writer(blk)
            self._height += 1
            if self._is_config(blk) and self._in_set(blk):
                self.joined.set()
                return

    @staticmethod
    def _is_config(blk: cb.Block) -> bool:
        try:
            env = protoutil.extract_envelope(blk, 0)
            return protoutil.channel_header(env).type == cb.CONFIG
        except Exception:
            return False


__all__ = ["FollowerChain", "InactiveChain", "NotServicedError"]
