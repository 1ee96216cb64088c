"""The solo consenter: one node orders (the port's copy of
`fabric_tpu/orderer/solo.py`; reference orderer/consensus/solo).

A service thread drains a queue through the block cutter; the batch timer
cuts a partial batch `batch_timeout_s` after the last message when
nothing else arrives; a config message is a block of its own.
"""

from __future__ import annotations

import queue
import threading

from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.orderer.blockcutter import BlockCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter
from fabric_tpu_torch.protos import common as cb


class SoloChain:
    def __init__(self, cutter: BlockCutter, writer: BlockWriter,
                 batch_timeout_s: float = 2.0, on_block=None):
        self._cutter = cutter
        self._writer = writer
        self._timeout = batch_timeout_s
        self._on_block = on_block or (lambda blk: None)
        self._q: queue.Queue = queue.Queue()
        self._halted = threading.Event()
        self._thread = spawn_thread(target=self._run, name="solo-consenter",
                                    kind="service")

    def start(self) -> None:
        self._thread.start()

    def halt(self) -> None:
        self._halted.set()
        self._q.put(None)
        self._thread.join(timeout=5)

    def wait_ready(self) -> None:
        return

    def set_batch_timeout(self, seconds: float) -> None:
        """Adopt a committed BatchTimeout."""
        self._timeout = seconds

    def order(self, env: cb.Envelope, config_seq: int = 0) -> None:
        if self._halted.is_set():
            raise RuntimeError("chain is halted")
        self._q.put(("normal", env.encode()))

    def configure(self, env: cb.Envelope, config_seq: int = 0) -> None:
        if self._halted.is_set():
            raise RuntimeError("chain is halted")
        self._q.put(("config", env.encode()))

    def _emit(self, batch: list[bytes], is_config: bool = False) -> None:
        if not batch:
            return
        blk = self._writer.create_next_block(batch)
        self._writer.write_block(blk, is_config=is_config)
        self._on_block(blk)

    def _run(self) -> None:
        timer_armed = False
        while not self._halted.is_set():
            try:
                item = self._q.get(
                    timeout=self._timeout if timer_armed else None)
            except queue.Empty:  # the batch timer fired
                self._emit(self._cutter.cut())
                timer_armed = False
                continue
            if item is None:
                break
            kind, raw = item
            if kind == "config":
                self._emit(self._cutter.cut())
                self._emit([raw], is_config=True)
                timer_armed = self._cutter.pending
                continue
            batches, pending = self._cutter.ordered(raw)
            for batch in batches:
                self._emit(batch)
            timer_armed = pending
        self._emit(self._cutter.cut())  # drain on halt


__all__ = ["SoloChain"]
