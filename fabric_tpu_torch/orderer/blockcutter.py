"""Batching envelopes into blocks (the port's copy of
`fabric_tpu/orderer/blockcutter.py`; reference
orderer/common/blockcutter).

A batch is cut by message count, by preferred byte size, and around an
oversized message, which gets a block of its own.  Cutting on a timer is
the consenter's part: it calls `cut()` when its batch timer fires.
"""

from __future__ import annotations


class BlockCutter:
    def __init__(self, max_message_count: int = 500,
                 preferred_max_bytes: int = 2 * 1024 * 1024,
                 absolute_max_bytes: int = 10 * 1024 * 1024):
        self.max_message_count = max_message_count
        self.preferred_max_bytes = preferred_max_bytes
        self.absolute_max_bytes = absolute_max_bytes
        self._pending: list[bytes] = []
        self._pending_bytes = 0

    @classmethod
    def from_orderer_config(cls, oc) -> "BlockCutter":
        return cls(oc.max_message_count, oc.preferred_max_bytes,
                   oc.absolute_max_bytes)

    def update_from_orderer_config(self, oc) -> None:
        """Adopt a committed BatchSize in place: the running chain holds
        this cutter, and its pending messages go on under the new
        limits."""
        self.max_message_count = oc.max_message_count
        self.preferred_max_bytes = oc.preferred_max_bytes
        self.absolute_max_bytes = oc.absolute_max_bytes

    def ordered(self, env_bytes: bytes) -> tuple[list[list[bytes]], bool]:
        """Enqueue one message; returns (the batches cut, whether messages
        remain pending)."""
        batches: list[list[bytes]] = []
        size = len(env_bytes)
        if size > self.preferred_max_bytes:
            # an oversized message is a block of its own
            if self._pending:
                batches.append(self.cut())
            batches.append([env_bytes])
            return batches, False
        if self._pending_bytes + size > self.preferred_max_bytes \
                and self._pending:
            batches.append(self.cut())
        self._pending.append(env_bytes)
        self._pending_bytes += size
        if len(self._pending) >= self.max_message_count:
            batches.append(self.cut())
        return batches, bool(self._pending)

    def cut(self) -> list[bytes]:
        batch = self._pending
        self._pending = []
        self._pending_bytes = 0
        return batch

    @property
    def pending(self) -> bool:
        return bool(self._pending)


__all__ = ["BlockCutter"]
