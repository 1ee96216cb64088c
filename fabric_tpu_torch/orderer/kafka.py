"""The kafka consenter (the port's copy of `fabric_tpu/orderer/kafka.py`;
reference orderer/consensus/kafka).

A channel is ordered by appending wrapped messages to one partition and
replaying it in offset order: REGULAR messages feed the block cutter, a
TIME-TO-CUT message (appended when the batch timer fires) cuts the
pending batch, so every orderer on the partition cuts at the same offset,
and CONNECT marks a start.  `Partition` is the broker seam; `InProcBroker`
holds the partitions of one in-process cluster.  The next offset to read
is kept in each block's ORDERER metadata, so a restart resumes there.
"""

from __future__ import annotations

import json
import threading

from fabric_tpu_torch.devtools.lockwatch import (
    named_condition,
    spawn_thread,
    spawn_timer,
)
from fabric_tpu_torch.orderer.blockcutter import BlockCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter
from fabric_tpu_torch.protos import common as cb


class Partition:
    """An append-only log addressed by offset (one topic partition)."""

    def __init__(self):
        self._log: list[bytes] = []
        self._cond = named_condition("kafka.partition")

    def append(self, msg: bytes) -> int:
        with self._cond:
            self._log.append(msg)
            self._cond.notify_all()
            return len(self._log) - 1

    def get(self, offset: int, timeout: float = 0.25) -> bytes | None:
        with self._cond:
            if offset >= len(self._log):
                self._cond.wait(timeout)
            if offset < len(self._log):
                return self._log[offset]
            return None


class InProcBroker:
    """The partitions of one cluster, by channel.  Every replica of a
    network gets the same broker; there is no process-wide default, so
    unrelated registrars never read each other's channels."""

    def __init__(self):
        self._parts: dict[str, Partition] = {}
        self._lock = threading.Lock()

    def partition(self, channel_id: str) -> Partition:
        with self._lock:
            return self._parts.setdefault(channel_id, Partition())


def _wrap(kind: str, payload: bytes = b"", block_number: int = 0) -> bytes:
    return json.dumps({"type": kind, "payload": payload.hex(),
                       "block_number": block_number}).encode()


def _persisted_offset(last_block) -> int:
    """The offset after the last message consumed, from the block's
    ORDERER metadata."""
    if last_block is None:
        return 0
    md = last_block.metadata.metadata
    if len(md) > cb.ORDERER and md[cb.ORDERER]:
        try:
            return json.loads(md[cb.ORDERER])["next_offset"]
        except Exception:
            return 0
    return 0


class KafkaChain:
    """A consenter replaying a partition in offset order; orderers on one
    partition write the same chain."""

    def __init__(self, channel_id: str, cutter: BlockCutter,
                 writer: BlockWriter, broker: InProcBroker,
                 batch_timeout_s: float = 2.0, on_block=None,
                 start_offset: int | None = None):
        if broker is None:
            raise ValueError("kafka consenter requires a broker")
        self._partition = broker.partition(channel_id)
        self._cutter = cutter
        self._writer = writer
        self._timeout = batch_timeout_s
        self._on_block = on_block or (lambda blk: None)
        if start_offset is None:
            start_offset = _persisted_offset(writer.last_block())
        self._offset = start_offset
        self._halted = threading.Event()
        self._timer: threading.Timer | None = None
        # the block number that the next TIME-TO-CUT refers to
        self._pending_block = writer.height
        self._lock = threading.Lock()
        self._thread = spawn_thread(target=self._run, name="kafka-consenter",
                                    kind="service")

    def start(self) -> None:
        self._partition.append(_wrap("connect"))
        self._thread.start()

    def halt(self) -> None:
        self._halted.set()
        self._thread.join(timeout=5)
        self._cancel_timer()

    def wait_ready(self) -> None:
        return

    def set_batch_timeout(self, seconds: float) -> None:
        """Adopt a committed BatchTimeout."""
        self._timeout = seconds

    def order(self, env, config_seq: int = 0) -> None:
        if self._halted.is_set():
            raise RuntimeError("chain is halted")
        self._partition.append(_wrap("normal", env.encode()))

    def configure(self, env, config_seq: int = 0) -> None:
        if self._halted.is_set():
            raise RuntimeError("chain is halted")
        self._partition.append(_wrap("config", env.encode()))

    def _arm_timer(self) -> None:
        with self._lock:
            if self._timer is None:
                block_number = self._pending_block
                self._timer = spawn_timer(
                    self._timeout,
                    lambda: self._partition.append(
                        _wrap("timetocut", block_number=block_number)),
                    name="kafka-batch-timer")
                self._timer.start()

    def _cancel_timer(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def _emit(self, batch: list[bytes], is_config: bool = False) -> None:
        if not batch:
            return
        blk = self._writer.create_next_block(batch)
        blk.metadata.metadata[cb.ORDERER] = json.dumps(
            {"next_offset": self._offset}).encode()
        self._writer.write_block(blk, is_config=is_config)
        self._pending_block += 1
        self._on_block(blk)

    def _run(self) -> None:
        while not self._halted.is_set():
            raw = self._partition.get(self._offset)
            if raw is None:
                continue
            self._offset += 1
            msg = json.loads(raw)
            kind = msg["type"]
            if kind == "connect":
                continue
            if kind == "timetocut":
                # a stale TIME-TO-CUT (for a block already cut) is ignored
                if msg["block_number"] == self._pending_block:
                    self._cancel_timer()
                    self._emit(self._cutter.cut())
                continue
            payload = bytes.fromhex(msg["payload"])
            if kind == "config":
                self._cancel_timer()
                self._emit(self._cutter.cut())
                self._emit([payload], is_config=True)
                continue
            batches, pending = self._cutter.ordered(payload)
            for batch in batches:
                self._cancel_timer()
                self._emit(batch)
            if pending:
                self._arm_timer()


__all__ = ["KafkaChain", "InProcBroker", "Partition"]
