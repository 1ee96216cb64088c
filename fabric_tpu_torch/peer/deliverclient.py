"""The deliver client: pulls blocks from the ordering service into the
peer (the port's copy of `fabric_tpu/peer/deliverclient.py`; reference
core/deliverservice and internal/pkg/peer/blocksprovider).

A service thread connects to an orderer endpoint (the rotation order
shuffled, with exponential backoff on failure), asks from the peer's
height, checks each block's orderer signature against the channel's
/Channel/Orderer/BlockValidation policy, and hands it to the sink.  A
block that fails the check ends the stream: the client moves to the next
endpoint.  `endpoints` are callables start -> iterator of Block, so one
client drives in-process orderers and socket transports alike.  Seams:
faultline points `deliver.connect`, `deliver.read`, `deliver.reconnect`,
netsplit on `endpoint_addrs`, clockskew on the backoff wait, and a
`deliver.block` span per block.
"""

from __future__ import annotations

import collections
import random
import threading

from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.devtools import clockskew, faultline, netsplit
from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.orderer.blockwriter import verify_block_signature
from fabric_tpu_torch.protos import common as cb


class DeliverClient:
    def __init__(self, channel_id: str, endpoints, height_fn, sink,
                 bundle=None, csp=None, max_backoff_s: float = 10.0,
                 metrics=None, endpoint_addrs=None):
        """endpoints: callables start_num -> iterator of Block; height_fn:
        () -> the committed height; sink: callable(seq, block_bytes);
        bundle: the channel config the signatures are checked against
        (None: unchecked); metrics: a `common.metrics.DeliverMetrics`;
        endpoint_addrs: "host:port" labels beside `endpoints`, each
        attempt judged by the netsplit seam first."""
        self.channel_id = channel_id
        self._metrics = metrics
        self._endpoints = list(endpoints)
        self._endpoint_addrs = (list(endpoint_addrs)
                                if endpoint_addrs is not None else None)
        self._height = height_fn
        self._sink = sink
        self._bundle = bundle
        self._csp = csp
        self._max_backoff = max_backoff_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # the backoffs waited, in order (bounded)
        self.backoff_log: collections.deque = collections.deque(maxlen=64)
        # the endpoint indices attempted, in order (bounded)
        self.endpoint_log: collections.deque = collections.deque(maxlen=64)
        self.delivered = 0  # blocks handed to the sink since start()

    def set_metrics(self, metrics) -> None:
        self._metrics = metrics

    def start(self) -> None:
        """Idempotent while running.  Each start gets its own stop event,
        so a runner still draining from an earlier stop() exits on its
        own event and never wedges a new one."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive() \
                    and not self._stop.is_set():
                return
            self._stop = stop = threading.Event()
            self._thread = spawn_thread(target=self._run, args=(stop,),
                                        name="deliver-client",
                                        kind="service")
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            t = self._thread
        if t is not None:
            t.join(timeout=3)

    def _verify(self, blk: cb.Block) -> bool:
        if self._bundle is None:
            return True
        policy = self._bundle.policy_manager.get_policy(
            "/Channel/Orderer/BlockValidation")
        if policy is None:
            return True
        return verify_block_signature(blk, policy, self._csp)

    def _run(self, stop: threading.Event) -> None:
        backoff = 0.1
        # shuffle the rotation order, so endpoint_log's indices stay the
        # caller's
        order = list(range(len(self._endpoints)))
        random.shuffle(order)
        idx = 0
        while not stop.is_set():
            pos = order[idx % len(order)]
            connect = self._endpoints[pos]
            idx += 1
            self.endpoint_log.append(pos)
            try:
                faultline.point("deliver.connect", endpoint=pos)
                if self._endpoint_addrs is not None:
                    netsplit.connect(addr=self._endpoint_addrs[pos])
                for blk in connect(self._height()):
                    if stop.is_set():
                        return
                    faultline.point("deliver.read", block=blk.header.number)
                    with tracing.span("deliver.block",
                                      block=blk.header.number,
                                      channel=self.channel_id):
                        if not self._verify(blk):
                            break  # a bad orderer: the next endpoint
                        self._sink(blk.header.number, blk.encode())
                        self.delivered += 1
                        if self._metrics is not None:
                            self._metrics.blocks.With(
                                "channel", self.channel_id).add()
                    backoff = 0.1
            except Exception:
                # fabriclint: allow[exception-discipline] reconnect loop: ANY
                # endpoint failure routes to backoff + the next endpoint
                # (the faultline seam is transparent to the rule; use
                # action=delay rules here to count reconnects)
                faultline.point("deliver.reconnect")
            if self._metrics is not None:
                self._metrics.reconnects.With("channel",
                                              self.channel_id).add()
                self._metrics.backoff_seconds.With(
                    "channel", self.channel_id).add(backoff)
            self.backoff_log.append(backoff)
            if clockskew.wait(stop, backoff):
                return
            backoff = min(backoff * 2, self._max_backoff)


__all__ = ["DeliverClient"]
