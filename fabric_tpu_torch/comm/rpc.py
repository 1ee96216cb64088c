"""Minimal framed RPC over TCP, with optional (mutual) TLS.

The port's copy of the JAX package's `fabric_tpu/comm/rpc.py`, byte for
byte the same wire format, so a client of either package talks to a
server of the other.  The reference's universal substrate is gRPC over mutual TLS
(internal/pkg/comm/server.go:56, client.go).  This is the same
architectural role with a deliberately small wire format:

    frame   := uint32_be length | payload
    request := uint8 method_len | method_utf8 | body
    reply   := uint8 kind | body      kind: 0 DATA, 1 END, 2 ERR

A handler returns bytes (unary: one DATA + END), an iterator of bytes
(server streaming: DATA per item + END), or raises (ERR with message).
Authentication above the transport rides in the payloads themselves
(signed envelopes / SignedProposals, exactly as the reference checks
creator signatures at the application layer on top of TLS).

TLS: pass a `comm.tls.TLSCredentials` to RPCServer/RPCClient.  The
server performs its handshake in the per-connection handler thread (a
slow or malicious client cannot stall the accept loop), demands a
client cert when `require_client_auth` (mutual TLS), and rejects peers
failing the optional pinned-cert allowlist (the orderer cluster scheme,
orderer/common/cluster/comm.go:116).  Handlers see the authenticated
peer certificate via `Stream.peer_cert` (DER), which the gossip layer
binds into its signed handshake."""

from __future__ import annotations

import dataclasses
import queue
import select
import socket
import socketserver
import ssl
import struct
import threading
import time

from fabric_tpu_torch.devtools import clockskew, faultline, netsplit
from fabric_tpu_torch.devtools.lockwatch import spawn_thread

from fabric_tpu_torch.common import tracing

KIND_DATA = 0
KIND_END = 1
KIND_ERR = 2
KIND_PING = 3  # server liveness marker on quiet streams; clients skip it

_MAX_FRAME = 100 * 1024 * 1024  # reference default max message size

# Trace-context piggyback: a traced client prefixes the method field
# with "\x01<token>\x01" (tracing.wire_token, ~35 bytes — method_len
# stays well under its uint8 bound).  Servers ALWAYS strip the prefix
# (one startswith on the decoded method) and adopt the context only
# when tracing is armed; untraced clients emit byte-identical frames.
_TRACE_MARK = "\x01"


def _split_trace(method: str) -> tuple[str, "tracing.SpanContext | None"]:
    if not method.startswith(_TRACE_MARK):
        return method, None
    end = method.find(_TRACE_MARK, 1)
    if end < 0:
        return method, None
    return method[end + 1:], tracing.from_wire(method[1:end])


@dataclasses.dataclass(frozen=True)
class KeepaliveOptions:
    """Connection-lifecycle knobs (reference
    internal/pkg/comm/config.go:26 DefaultKeepaliveOptions, surfaced in
    core.yaml peer.keepalive).

    idle_timeout: server closes a connection that sends no request
      within this window (a connected-but-silent peer stops holding a
      thread forever).
    ping_interval: on a streaming response with no data for this long,
      the server emits a PING frame so live-idle streams are
      distinguishable from dead servers.
    ping_timeout: clients reading a stream treat silence longer than
      ping_interval + ping_timeout as a dead peer.
    tcp_*: kernel keepalive probing for both directions (SO_KEEPALIVE
      + TCP_USER_TIMEOUT), reaping peers that vanish without FIN.
    """

    idle_timeout: float = 30.0
    ping_interval: float = 15.0
    ping_timeout: float = 20.0
    tcp_idle_s: int = 30
    tcp_interval_s: int = 10
    tcp_count: int = 3

    @classmethod
    def from_config(cls, cfg, prefix: str = "peer.keepalive") -> "KeepaliveOptions":
        d = {}
        for name, key in (
            ("idle_timeout", "idleTimeout"),
            ("ping_interval", "interval"),
            ("ping_timeout", "timeout"),
        ):
            v = cfg.get(f"{prefix}.{key}")
            if v is not None:
                d[name] = float(v)
        return cls(**d)


def set_tcp_keepalive(sock, ka: "KeepaliveOptions") -> None:
    """Kernel-level dead-peer detection: keepalive probes on idle
    connections plus a bound on how long unacked writes linger."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        # TCP_KEEPIDLE/-INTVL/-CNT/USER_TIMEOUT are Linux names; other
        # platforms (e.g. macOS) lack some — probe each
        for opt, val in (
            ("TCP_KEEPIDLE", ka.tcp_idle_s),
            ("TCP_KEEPINTVL", ka.tcp_interval_s),
            ("TCP_KEEPCNT", ka.tcp_count),
            (
                "TCP_USER_TIMEOUT",
                1000 * (ka.tcp_idle_s + ka.tcp_interval_s * ka.tcp_count),
            ),
        ):
            if hasattr(socket, opt):
                sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)
    except OSError:
        pass  # platform without the options: lifecycle still app-level


def set_nodelay(sock) -> None:
    """Frames go out as written: a call's small frames (a request; a
    reply's DATA then END) would otherwise wait out Nagle's algorithm
    against the peer's delayed ACK, ~40 ms a unary call on Linux.  The
    JAX package's transport leaves Nagle on; the bytes are the same."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # not a TCP socket


class RPCError(Exception):
    pass


def _read_exact(sock, n: int) -> bytes | None:
    # recv(k) allocates a k-byte buffer up front, so the chunk size must
    # be capped: a client declaring a ~100MB frame and sending nothing
    # would otherwise pin ~100MB of allocation PER CONNECTION while the
    # idle timeout runs down.
    buf = bytearray()
    while len(buf) < n:
        got = sock.recv(min(n - len(buf), 1 << 18))
        if not got:
            return None
        buf += got
    return bytes(buf)


def read_frame(sock) -> bytes | None:
    hdr = _read_exact(sock, 4)
    if hdr is None:
        return None
    (ln,) = struct.unpack(">I", hdr)
    if ln > _MAX_FRAME:
        raise RPCError(f"frame too large: {ln}")
    return _read_exact(sock, ln)


def write_frame(sock, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


class Stream:
    """Server-side handle for bidirectional-ish methods: the handler may
    read further client frames (e.g. a deliver SeekInfo stream) and send
    DATA frames incrementally.  `peer_cert` is the TLS-authenticated
    client certificate (DER) or None on plaintext connections."""

    def __init__(self, sock, peer_cert: bytes | None = None):
        self._sock = sock
        self.peer_cert = peer_cert

    def send(self, body: bytes) -> None:
        write_frame(self._sock, bytes([KIND_DATA]) + body)

    def recv(self) -> bytes | None:
        return read_frame(self._sock)


class DuplexStream:
    """Client-side handle for a bidirectional-streaming method (e.g. the
    gateway's pipelined ``ab.BroadcastStream``): `send` writes raw
    request frames the server handler reads via ``Stream.recv``, and
    `recv` returns the DATA bodies the handler writes via
    ``Stream.send``.  A writer thread and a reader thread may share the
    handle (each direction single-threaded).  A TLS connection must not
    be read and written by two threads at once, so every write and every
    read attempt holds one lock, and a reader waits for data outside it
    (the JAX package's handle reads and writes the socket unguarded).

    By convention an EMPTY ``send`` frame marks graceful end-of-stream
    (``finish()``); the handler answers by returning, which surfaces
    here as ``recv() -> None`` (END)."""

    def __init__(self, sock, keepalive: "KeepaliveOptions", ns_token=None):
        self._sock = sock
        self._ka = keepalive
        self._ns_token = ns_token  # netsplit cut-registry handle
        # recv() owns the read deadline; sends rely on TCP buffering +
        # kernel keepalive (set_tcp_keepalive) to detect a dead peer
        self._deadline_s = clockskew.io_timeout(
            keepalive.ping_interval + keepalive.ping_timeout)
        sock.settimeout(self._deadline_s)
        self._io = threading.Lock()
        self._rbuf = bytearray()

    def send(self, body: bytes) -> None:
        with self._io:
            write_frame(self._sock, body)

    def finish(self) -> None:
        """Signal graceful end-of-stream to the handler."""
        with self._io:
            write_frame(self._sock, b"")

    def _fill(self) -> bool:
        """Appends what the connection holds to the read buffer, waiting
        up to the read deadline; False at the connection's end."""
        sock = self._sock
        deadline = (None if self._deadline_s is None
                    else time.monotonic() + self._deadline_s)
        while True:
            pending = getattr(sock, "pending", None)
            if not (pending is not None and pending()):
                wait = 0.5 if deadline is None else min(
                    0.5, deadline - time.monotonic())
                if wait <= 0:
                    raise socket.timeout("read deadline passed")
                if not select.select([sock], [], [], wait)[0]:
                    continue
            with self._io:
                sock.settimeout(0.0)
                try:
                    data = sock.recv(1 << 18)
                except (BlockingIOError, ssl.SSLWantReadError,
                        ssl.SSLWantWriteError):
                    continue  # a partial TLS record: wait for the rest
                finally:
                    sock.settimeout(self._deadline_s)
            if not data:
                return False
            self._rbuf += data
            return True

    def _read_frame(self) -> bytes | None:
        buf = self._rbuf
        while True:
            if len(buf) >= 4:
                (ln,) = struct.unpack(">I", buf[:4])
                if ln > _MAX_FRAME:
                    raise RPCError(f"frame too large: {ln}")
                if len(buf) >= 4 + ln:
                    frame = bytes(buf[4:4 + ln])
                    del buf[:4 + ln]
                    return frame
            if not self._fill():
                return None

    def recv(self) -> bytes | None:
        """Next DATA body from the server; None on END.  PING frames
        are skipped; ERR raises RPCError, as does silence past the
        keepalive deadline or a torn connection."""
        while True:
            try:
                frame = self._read_frame()
            except socket.timeout:
                raise RPCError(
                    "stream silent past the keepalive deadline"
                ) from None
            if frame is None:
                raise RPCError("connection closed mid-stream")
            kind, rest = frame[0], frame[1:]
            if kind == KIND_PING:
                continue  # live-idle stream
            if kind == KIND_ERR:
                raise RPCError(rest.decode("utf-8", "replace"))
            if kind == KIND_END:
                return None
            return rest

    def close(self) -> None:
        """Close the connection; a `recv` waiting on another thread
        returns at once (the socket is shut down first)."""
        if self._ns_token is not None:
            netsplit.untrack(self._ns_token)
            self._ns_token = None
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        server: RPCServer = self.server.rpc  # type: ignore[attr-defined]
        sock = self.request
        ka = server.keepalive
        set_tcp_keepalive(sock, ka)
        set_nodelay(sock)
        # Idle reaping: a connected-but-silent peer must not hold this
        # thread (and later a limiter permit) forever — the handshake
        # and the request read each get the idle window, then the
        # timeout clears for the handler's own streaming reads.  The
        # deadline routes through the clockskew seam so chaos tests
        # compress a 30s idle window into milliseconds of real time.
        sock.settimeout(clockskew.io_timeout(ka.idle_timeout))
        # the holder is re-pointed at the TLS socket after the wrap
        # (wrap_socket detaches the raw fd — closing the pre-wrap object
        # in stop() would be a no-op for TLS connections)
        holder = [sock]
        server._track(holder)
        try:
            try:
                faultline.point("rpc.accept")
                # accept half of the netsplit seam: plain-TCP accepts
                # only know the remote's ephemeral address, so denial
                # here needs a plan that maps it; the outbound check in
                # RPCClient._connect is the primary enforcement point
                netsplit.accept(addr=sock.getpeername())
            except OSError:
                return  # injected accept fault: drop cleanly — real
                # handler errors must keep surfacing via handle_error
            self._serve(server, sock, holder)
        finally:
            server._untrack(holder)

    def _serve(self, server: "RPCServer", sock, holder) -> None:
        peer_cert: bytes | None = None
        if server.tls is not None:
            # Handshake here, in the per-connection thread — the accept
            # loop stays responsive regardless of handshake latency.
            try:
                sock = server.ssl_context.wrap_socket(sock, server_side=True)
                holder[0] = sock
            except (ssl.SSLError, OSError):
                return
            peer_cert = sock.getpeercert(binary_form=True)
            if not server.tls.check_pinned(peer_cert):
                try:
                    write_frame(
                        sock, bytes([KIND_ERR]) + b"certificate not pinned"
                    )
                finally:
                    sock.close()
                return
        # wrapped AFTER the TLS handshake so injected read/write faults
        # land on the application byte stream, not inside the handshake
        sock = faultline.io(sock, "rpc.server")
        try:
            try:
                frame = read_frame(sock)
            except socket.timeout:
                return  # reaped: no request within the idle window
            except RPCError as exc:  # oversized frame declaration
                write_frame(sock, bytes([KIND_ERR]) + str(exc).encode())
                return
            if frame is None or not frame:
                return
            sock.settimeout(None)  # handler-controlled from here on
            mlen = frame[0]
            try:
                # a method length pointing past the frame or bytes that
                # are not UTF-8 is a malformed request, not a server
                # error: answer ERR and drop the connection cleanly
                if 1 + mlen > len(frame):
                    raise ValueError("method length exceeds frame")
                method = frame[1:1 + mlen].decode("utf-8")
            except (ValueError, UnicodeDecodeError):
                write_frame(sock, bytes([KIND_ERR]) + b"malformed request")
                return
            body = frame[1 + mlen:]
            method, trace_ctx = _split_trace(method)
            fn = server.methods.get(method)
            if fn is None:
                write_frame(
                    sock, bytes([KIND_ERR]) + f"no method {method}".encode()
                )
                return
            try:
                # the serve span parents into the CLIENT's rpc.call span
                # via the frame-carried context (the cross-process hop)
                with tracing.span(
                    "rpc.serve", parent=trace_ctx, method=method,
                ):
                    out = fn(body, Stream(sock, peer_cert))
            except Exception as exc:  # noqa: BLE001 — error surface to client
                try:
                    write_frame(
                        sock, bytes([KIND_ERR]) + str(exc).encode("utf-8")
                    )
                except OSError:
                    pass
                return
            if out is None:
                write_frame(sock, bytes([KIND_END]))
            elif isinstance(out, (bytes, bytearray)):
                write_frame(sock, bytes([KIND_DATA]) + bytes(out))
                write_frame(sock, bytes([KIND_END]))
            else:  # iterator of bytes — generators raise lazily, so the
                # iteration needs the same ERR surface as the call itself
                if not _pump_stream(sock, out, server.keepalive):
                    return
                write_frame(sock, bytes([KIND_END]))
        except (ConnectionError, OSError):
            pass


def _pump_stream(sock, out, ka: KeepaliveOptions) -> bool:
    """Write the iterator's items as DATA frames, emitting a PING frame
    whenever the stream is quiet for ka.ping_interval so clients can
    tell a live-idle stream from a dead server.  The iterator runs in a
    side thread (it may block indefinitely between items, e.g. a
    deliver stream waiting for new blocks).  Returns False when the
    handler raised (ERR already written)."""
    q: queue.Queue = queue.Queue(maxsize=8)
    _END, _ERR = object(), object()
    dead = threading.Event()

    def put(item) -> bool:
        while not dead.is_set():
            try:
                q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def pull():
        try:
            for item in out:
                if not put(item):
                    break  # client gone: run the generator's finally
        except Exception as exc:  # noqa: BLE001 — surfaced as ERR frame
            put((_ERR, str(exc)))
            return
        put(_END)

    t = spawn_thread(target=pull, name="rpc-stream-pull", kind="worker")
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=clockskew.io_timeout(ka.ping_interval))
            except queue.Empty:
                faultline.point("rpc.ping")
                write_frame(sock, bytes([KIND_PING]))  # live but idle
                continue
            if item is _END:
                return True
            if isinstance(item, tuple) and item[0] is _ERR:
                write_frame(sock, bytes([KIND_ERR]) + item[1].encode("utf-8"))
                return False
            write_frame(sock, bytes([KIND_DATA]) + item)
    finally:
        dead.set()


class _ThreadingServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class RPCServer:
    """method name -> handler(body: bytes, stream: Stream)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, tls=None,
                 keepalive: KeepaliveOptions | None = None):
        self.methods: dict = {}
        self.tls = tls  # comm.tls.TLSCredentials | None
        self.keepalive = keepalive or KeepaliveOptions()
        self.ssl_context = tls.server_context() if tls is not None else None
        self._srv = _ThreadingServer((host, port), _Handler)
        self._srv.rpc = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._conns: set = set()
        self._holders: dict = {}  # id -> [current socket] per connection
        self._conn_lock = threading.Lock()

    def _track(self, holder: list) -> None:
        with self._conn_lock:
            self._conns.add(id(holder))
            self._holders[id(holder)] = holder

    def _untrack(self, holder: list) -> None:
        with self._conn_lock:
            self._conns.discard(id(holder))
            self._holders.pop(id(holder), None)

    @property
    def connection_count(self) -> int:
        with self._conn_lock:
            return len(self._conns)

    @property
    def addr(self) -> tuple[str, int]:
        return self._srv.server_address[:2]

    def register(self, method: str, fn, limiter=None) -> None:
        """Register a handler; `limiter` (a common.semaphore.Semaphore)
        caps concurrent invocations of this method — the reference's
        per-service gRPC concurrency limiters
        (internal/peer/node/grpc_limiters.go): excess calls fail fast
        with a resource-exhausted error rather than queueing."""
        if limiter is None:
            self.methods[method] = fn
            return

        def limited(body, stream):
            if not limiter.try_acquire():
                raise RuntimeError(
                    f"{method}: too many requests, try again later"
                )
            released = [False]

            def release_once():
                if not released[0]:
                    released[0] = True
                    limiter.release()

            try:
                out = fn(body, stream)
            except BaseException:
                release_once()
                raise
            if out is None or isinstance(out, (bytes, bytearray)):
                release_once()
                return out

            # Streaming handler: it returned a lazy iterator, so the
            # permit must span the whole stream (the reference's deliver
            # limiter caps concurrent STREAMS, not handler dispatches).
            def held():
                try:
                    yield from out
                finally:
                    release_once()

            return held()

        self.methods[method] = limited

    def start(self) -> None:
        self._started = True
        self._thread = spawn_thread(
            target=self._srv.serve_forever, name="rpc-server",
            kind="service",
        )
        self._thread.start()

    def stop(self) -> None:
        # shutdown() blocks on serve_forever()'s shut-down handshake, so
        # it must be skipped when start() never ran (a constructed-but-
        # never-started server would hang its owner's stop() forever)
        if getattr(self, "_started", False):
            self._srv.shutdown()
        self._srv.server_close()
        with self._conn_lock:
            holders = list(self._holders.values())
        for holder in holders:  # unblock handler threads mid-read
            try:
                holder[0].close()
            except OSError:
                pass


class RPCClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 tls=None, server_hostname: str | None = None,
                 keepalive: KeepaliveOptions | None = None):
        self._addr = (host, port)
        self._timeout = timeout
        self._tls = tls  # comm.tls.TLSCredentials | None
        self._server_hostname = server_hostname
        self._keepalive = keepalive or KeepaliveOptions()
        self._ssl_context = (
            tls.client_context() if tls is not None else None
        )

    def _connect(self, method: str, body: bytes):
        # the netsplit seam rules on the destination BEFORE any socket
        # exists: a denied link raises NetsplitDenied (an OSError)
        # immediately instead of stalling out the connect timeout
        netsplit.connect(addr=self._addr)
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        set_tcp_keepalive(sock, self._keepalive)
        set_nodelay(sock)
        if self._ssl_context is not None:
            try:
                sock = self._ssl_context.wrap_socket(
                    sock, server_hostname=self._server_hostname or self._addr[0]
                )
                peer = sock.getpeercert(binary_form=True)
                if not self._tls.check_pinned(peer):
                    raise RPCError("server certificate not pinned")
            except (ssl.SSLError, OSError) as exc:
                sock.close()
                raise RPCError(f"tls handshake failed: {exc}") from exc
            except RPCError:
                sock.close()
                raise
        sock = faultline.io(sock, "rpc.client")
        token = tracing.wire_token()
        if token is not None:
            method = f"{_TRACE_MARK}{token}{_TRACE_MARK}{method}"
        m = method.encode("utf-8")
        write_frame(sock, bytes([len(m)]) + m + body)
        return sock

    def call(self, method: str, body: bytes = b"") -> bytes:
        """Unary call: returns the single DATA body (b"" when END-only)."""
        # the span opens BEFORE _connect so the wire token carries ITS
        # id — the server's rpc.serve span nests under this one
        with tracing.span("rpc.call", method=method):
            return self._call(method, body)

    def _call(self, method: str, body: bytes) -> bytes:
        sock = self._connect(method, body)
        ns_tok = netsplit.track(sock, addr=self._addr)
        try:
            data = b""
            while True:
                frame = read_frame(sock)
                if frame is None:
                    raise RPCError("connection closed mid-reply")
                kind, rest = frame[0], frame[1:]
                if kind == KIND_PING:
                    continue  # server alive, reply still pending
                if kind == KIND_ERR:
                    raise RPCError(rest.decode("utf-8", "replace"))
                if kind == KIND_END:
                    return data
                data = rest
        finally:
            netsplit.untrack(ns_tok)
            sock.close()

    def duplex(self, method: str, body: bytes = b"") -> DuplexStream:
        """Open a bidirectional stream: the returned handle's `send`
        frames arrive at the server handler's ``Stream.recv`` and the
        handler's ``Stream.send`` bodies come back through `recv`.
        The caller owns the handle's lifecycle (``finish``/``close``)."""
        with tracing.span("rpc.duplex", method=method):
            sock = self._connect(method, body)
        return DuplexStream(
            sock, self._keepalive,
            ns_token=netsplit.track(sock, addr=self._addr),
        )

    def stream(self, method: str, body: bytes = b""):
        """Server-streaming call: yields DATA bodies until END.

        Long-lived streams are keepalive-aware: the server emits PING
        frames on quiet intervals, so the read deadline is
        ping_interval + ping_timeout — silence past that means a dead
        peer (RPCError), while a merely idle stream stays up
        indefinitely."""
        # span covers the connect+request only: the stream body is
        # consumed lazily by the caller, and a generator must not pin
        # an open span on this thread across arbitrary yields
        with tracing.span("rpc.stream", method=method):
            sock = self._connect(method, body)
        ka = self._keepalive
        # long-lived streams (deliver especially) register for the
        # mid-stream cut: arming a severing plan closes this socket
        ns_tok = netsplit.track(sock, addr=self._addr)
        try:
            sock.settimeout(
                clockskew.io_timeout(ka.ping_interval + ka.ping_timeout)
            )
            while True:
                try:
                    frame = read_frame(sock)
                except socket.timeout:
                    raise RPCError(
                        "stream silent past the keepalive deadline"
                    ) from None
                if frame is None:
                    raise RPCError("connection closed mid-stream")
                kind, rest = frame[0], frame[1:]
                if kind == KIND_PING:
                    continue  # live-idle stream
                if kind == KIND_ERR:
                    raise RPCError(rest.decode("utf-8", "replace"))
                if kind == KIND_END:
                    return
                yield rest
        finally:
            netsplit.untrack(ns_tok)
            sock.close()


__all__ = ["RPCServer", "RPCClient", "RPCError", "Stream",
           "DuplexStream", "KeepaliveOptions", "set_tcp_keepalive",
           "set_nodelay",
           "read_frame", "write_frame"]
