"""Chaincode lifecycle event management (reference
core/ledger/cceventmgmt; the port's copy of
`fabric_tpu/ledger/cceventmgmt.py`): listeners (state-DB index builders,
the lifecycle cache) are told when a chaincode definition is committed
to a channel, or a package matching a committed definition is
installed.
"""

from __future__ import annotations

import dataclasses
import threading

from fabric_tpu_torch.common.flogging import must_get_logger


@dataclasses.dataclass(frozen=True)
class ChaincodeDefinitionEvent:
    channel_id: str
    name: str
    version: str
    sequence: int


class ChaincodeEventMgr:
    """The registry of listeners (reference cceventmgmt.GetMgr): the
    committer calls `handle_definition_committed` after a block carrying a
    _lifecycle commit lands; install flows call `handle_installed`."""

    def __init__(self):
        self._listeners: dict[str, list] = {}
        self._global: list = []
        self._lock = threading.Lock()

    def register(self, channel_id: str | None, listener) -> None:
        """listener(event) -> None; channel_id None listens to every
        channel."""
        with self._lock:
            if channel_id is None:
                self._global.append(listener)
            else:
                self._listeners.setdefault(channel_id, []).append(listener)

    def _fire(self, event: ChaincodeDefinitionEvent) -> None:
        with self._lock:
            targets = list(self._global) + list(
                self._listeners.get(event.channel_id, []))
        for fn in targets:
            try:
                fn(event)
            except Exception as exc:
                # a listener's error never poisons the commit path, but it
                # is logged, not swallowed
                must_get_logger("ledger.cceventmgmt").warning(
                    "chaincode-event listener %r failed: %s", fn, exc)

    def handle_definition_committed(
        self, channel_id: str, name: str, version: str, sequence: int
    ) -> None:
        self._fire(
            ChaincodeDefinitionEvent(channel_id, name, version, sequence))

    def handle_installed(self, channel_id: str, name: str,
                         version: str) -> None:
        self._fire(ChaincodeDefinitionEvent(channel_id, name, version, 0))


__all__ = ["ChaincodeEventMgr", "ChaincodeDefinitionEvent"]
