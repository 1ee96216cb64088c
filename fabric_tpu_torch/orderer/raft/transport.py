"""The orderer-to-orderer Step fabric (the port's copy of
`fabric_tpu/orderer/raft/transport.py`; reference
orderer/common/cluster/comm.go, its Step RPC over mutual TLS).

`InProcTransport` joins the nodes of one process, with per-link
`partition` / `heal` for fault tests.  `TCPTransport` sends StepRequest
frames (a 4-byte big-endian length and the marshaled request, the JAX
package's frames byte for byte, so nodes of both packages join one
cluster) through a sender thread a peer (`OutboundConn`): a bounded
queue that drops on overflow (raft retransmits; every drop is counted in
`raft_send_dropped_total` and logged once an episode) and reconnects
under the deterministic backoff of `comm.backoff.BackoffGate`.

With `comm.tls.TLSCredentials` whose `pinned_certs` hold the consenters'
TLS leaves, every link is mutual TLS and both sides require the other's
leaf to be one of them (reference cluster/comm.go:116); `set_pinned`
replaces the list when a config block changes the consenter set.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading

from fabric_tpu_torch.comm.backoff import BackoffGate
from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.devtools import faultline, netsplit
from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.protos import orderer as ob

_LEN = struct.Struct(">I")

_logger = must_get_logger("orderer.consensus.transport")


class InProcTransport:
    """Shared by the nodes of one process: `register(id, handler)`, then
    `send`."""

    def __init__(self):
        self._nodes: dict = {}
        self._cut: set[tuple[int, int]] = set()
        self._lock = threading.Lock()

    def register(self, node_id: int, handler) -> None:
        with self._lock:
            self._nodes[node_id] = handler

    def unregister(self, node_id: int) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def partition(self, a: int, b: int) -> None:
        with self._lock:
            self._cut.add((a, b))
            self._cut.add((b, a))

    def heal(self, a: int | None = None, b: int | None = None) -> None:
        with self._lock:
            if a is None:
                self._cut.clear()
            else:
                self._cut.discard((a, b))
                self._cut.discard((b, a))

    def send(self, frm: int, to: int, req: ob.StepRequest) -> None:
        with self._lock:
            if (frm, to) in self._cut:
                return
            handler = self._nodes.get(to)
        if handler is not None:
            handler(req)


class OutboundConn:
    """The sender thread of one peer: a bounded queue, reconnects under a
    backoff seeded from the local and peer identity (never the clock),
    and counted drops."""

    def __init__(self, addr: tuple[str, int], tls=None, ssl_ctx=None,
                 peer_id: int | None = None, metrics=None,
                 queue_size: int = 4096, local_key: str = ""):
        self.addr = addr
        self._tls = tls
        self._ssl_ctx = ssl_ctx
        self.peer_id = peer_id
        self._metrics = metrics
        self._queue_gauge = (metrics.queue_depth.With("dest", self._dest())
                             if metrics is not None else None)
        self.q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._sock: socket.socket | None = None
        self._ns_tok: int | None = None  # netsplit's handle of the socket
        self._stop = threading.Event()
        self.dropped = 0
        self._drop_episode = False  # contiguous queue-full drops
        self._down_episode = False  # contiguous link-down drops
        self._gate = BackoffGate.for_key(f"{local_key}->{addr!r}")
        self._thread = spawn_thread(target=self._run, name="raft-dial",
                                    kind="service")
        self._thread.start()

    def _dest(self) -> str:
        return (str(self.peer_id) if self.peer_id is not None
                else repr(self.addr))

    def _count_drop(self) -> None:
        self.dropped += 1
        if self._metrics is not None:
            self._metrics.send_dropped.With("dest", self._dest()).add()

    def send(self, data: bytes) -> None:
        try:
            # the caller's span context rides along, so the sender's
            # raft.send span joins its trace
            self.q.put_nowait((data, tracing.current()))
            self._drop_episode = False
            if self._queue_gauge is not None:
                self._queue_gauge.set(self.q.qsize())  # a trend, racy
        except queue.Full:
            self._count_drop()
            if not self._drop_episode:
                self._drop_episode = True
                _logger.warning(
                    "raft outbound queue to node %s full; dropping "
                    "messages (one log per episode; see "
                    "raft_send_dropped_total)", self._dest())

    def _connect(self) -> socket.socket | None:
        if self._metrics is not None:
            self._metrics.dials.With("dest", self._dest()).add()
        try:
            faultline.point("raft.connect", peer=self.peer_id)
            # a link that netsplit denies fails here, before the connect
            # timeout, and takes the down-peer path
            netsplit.connect(addr=self.addr)
            s = socket.create_connection(self.addr, timeout=2.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ssl_ctx is not None:
                s = self._ssl_ctx.wrap_socket(s,
                                              server_hostname=self.addr[0])
                if not self._tls.check_pinned(s.getpeercert(binary_form=True)):
                    s.close()
                    return None  # not a consenter
            s = faultline.io(s, "raft.conn")
            self._ns_tok = netsplit.track(s, addr=self.addr)
            return s
        except OSError:
            return None

    def _drop_down(self) -> None:
        """A message discarded because the link is down."""
        self._count_drop()
        if not self._down_episode:
            self._down_episode = True
            _logger.warning(
                "raft outbound link to node %s down; dropping queued "
                "messages during reconnect backoff (one log per episode; "
                "see raft_send_dropped_total)", self._dest())

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                data, trace_ctx = self.q.get(timeout=0.5)
            except queue.Empty:
                continue
            if self._sock is None:
                if not self._gate.ready():
                    self._drop_down()  # inside the backoff window
                    continue
                self._sock = self._connect()
                if self._sock is None:
                    self._gate.arm()
                    self._drop_down()
                    continue
                self._gate.clear()
            try:
                with tracing.attached(trace_ctx), tracing.span(
                        "raft.send", peer=self.peer_id, n=len(data)):
                    self._sock.sendall(_LEN.pack(len(data)) + data)
                # only a completed send proves the link
                self._gate.reset()
                self._down_episode = False
            except OSError:
                if self._ns_tok is not None:
                    netsplit.untrack(self._ns_tok)
                    self._ns_tok = None
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                self._drop_down()
                self._gate.arm()

    def close(self) -> None:
        self._stop.set()
        if self._ns_tok is not None:
            netsplit.untrack(self._ns_tok)
            self._ns_tok = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class TCPTransport:
    """One listener a node; senders keyed by node id."""

    def __init__(self, node_id: int, listen_addr: tuple[str, int], tls=None,
                 metrics=None):
        self.node_id = node_id
        self._handler = None
        self._tls = tls
        self._metrics = metrics  # common.metrics.RaftMetrics | None
        self._server_ctx = tls.server_context() if tls is not None else None
        self._client_ctx = tls.client_context() if tls is not None else None
        if tls is not None and tls.pinned_certs is not None:
            # pinned leaves authenticate the cluster; consenters are often
            # dialed at addresses their certificates do not name
            self._client_ctx.check_hostname = False
        self._peers: dict[int, OutboundConn] = {}
        self._lock = threading.Lock()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(listen_addr)
        self._server.listen(32)
        self.addr = self._server.getsockname()
        self._stop = threading.Event()
        self._accept_thread = spawn_thread(target=self._accept,
                                           name="raft-accept", kind="service")
        self._accept_thread.start()

    def set_handler(self, handler) -> None:
        self._handler = handler

    def set_metrics(self, metrics) -> None:
        """Bind a RaftMetrics; the existing senders count into it from
        their next call."""
        self._metrics = metrics
        with self._lock:
            for conn in self._peers.values():
                conn._metrics = metrics
                conn._queue_gauge = (
                    metrics.queue_depth.With("dest", conn._dest())
                    if metrics is not None else None)

    def set_peer(self, node_id: int, addr: tuple[str, int]) -> None:
        with self._lock:
            old = self._peers.get(node_id)
            if old is not None and old.addr == tuple(addr):
                return
            if old is not None:
                old.close()
            self._peers[node_id] = OutboundConn(
                tuple(addr), self._tls, self._client_ctx, peer_id=node_id,
                metrics=self._metrics, local_key=str(self.node_id))

    def remove_peer(self, node_id: int) -> None:
        with self._lock:
            s = self._peers.pop(node_id, None)
        if s is not None:
            s.close()

    def send(self, frm: int, to: int, req: ob.StepRequest) -> None:
        with self._lock:
            sender = self._peers.get(to)
        if sender is not None:
            sender.send(req.encode())

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            spawn_thread(target=self._serve_conn, args=(conn,),
                         name="raft-serve", kind="service").start()

    def set_pinned(self, certs: list) -> None:
        """Replace the pinned DER leaves (a config block changed the
        consenter set); the client context stops matching names, as
        with pinning at construction."""
        if self._tls is not None:
            self._tls.pinned_certs = list(certs)
            if self._client_ctx is not None:
                self._client_ctx.check_hostname = False

    @staticmethod
    def _close(conn) -> None:
        try:
            conn.close()
        except OSError:
            pass

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(30.0)
        try:
            # netsplit's accept half: a plain accept knows only the
            # remote's ephemeral address, the dial side enforces
            netsplit.accept(addr=conn.getpeername())
        except OSError:
            self._close(conn)
            return
        if self._server_ctx is not None:
            try:
                conn = self._server_ctx.wrap_socket(conn, server_side=True)
            except OSError:
                return
            if not self._tls.check_pinned(conn.getpeercert(binary_form=True)):
                self._close(conn)
                return
        buf = bytearray()
        try:
            while not self._stop.is_set():
                while len(buf) < _LEN.size:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                (ln,) = _LEN.unpack_from(buf)
                while len(buf) < _LEN.size + ln:
                    chunk = conn.recv(1 << 20)
                    if not chunk:
                        return
                    buf += chunk
                frame = bytes(buf[_LEN.size: _LEN.size + ln])
                del buf[: _LEN.size + ln]
                if self._handler is not None:
                    self._handler(ob.StepRequest.decode(frame))
        except OSError:
            return
        finally:
            self._close(conn)

    def close(self) -> None:
        self._stop.set()
        try:
            # shutdown wakes the accept thread, which close alone does not
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._close(self._server)
        with self._lock:
            for s in self._peers.values():
                s.close()
            self._peers.clear()


__all__ = ["InProcTransport", "OutboundConn", "TCPTransport"]
