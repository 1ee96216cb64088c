"""Gossip comm: authenticated peer-to-peer message streams (the port's
copy of `fabric_tpu/gossip/comm.py`; reference gossip/comm).

Two transports behind one interface:

  InProcGossipNet — a process-local registry with partition controls,
                    the unit-test fabric.
  TCPGossipComm   — length-prefixed SignedGossipMessage frames over TCP
                    (mutual TLS when given credentials) with a
                    ConnEstablish handshake on each new stream.

Signatures cover the serialized GossipMessage; the receiver verifies
them through the supplied MessageCryptoService.  The wire is the JAX
package's, frame for frame, so the two packages' transports talk to each
other.  Seams: faultline `gossip.dial` and the `gossip.conn` socket,
netsplit on dial and accept, knob `FABRIC_TPU_DIAL_TIMEOUT_S`, and the
`gossip.send` / `gossip.deliver` spans.
"""

from __future__ import annotations

import ipaddress
import queue
import socket
import struct
import threading

from fabric_tpu_torch.comm.backoff import BackoffGate
from fabric_tpu_torch.comm.tls import cert_hash_from_der
from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.hashing import sha256
from fabric_tpu_torch.devtools import faultline, knob_registry, netsplit
from fabric_tpu_torch.devtools.lockwatch import named_lock, spawn_thread
from fabric_tpu_torch.protos import gossip as gpb
from fabric_tpu_torch.protos.wire import DecodeError

_LEN = struct.Struct(">I")

_DIAL_TIMEOUT_ENV = "FABRIC_TPU_DIAL_TIMEOUT_S"


def _dial_timeout() -> float:
    """The sender's dial timeout in seconds, from the knob (default 2)."""
    raw = knob_registry.raw(_DIAL_TIMEOUT_ENV)
    if not raw:
        return 2.0
    try:
        t = float(raw)
    except ValueError:
        raise ValueError(
            f"{_DIAL_TIMEOUT_ENV} must be a number of seconds, got {raw!r}"
        ) from None
    if t <= 0:
        raise ValueError(f"{_DIAL_TIMEOUT_ENV} must be > 0, got {raw!r}")
    return t


class ReceivedMessage:
    """A decoded, signature-checked inbound message and its reply path."""

    def __init__(self, msg: gpb.GossipMessage, sender_pki: bytes, respond):
        self.msg = msg
        self.sender_pki = sender_pki
        self._respond = respond

    def respond(self, msg: gpb.GossipMessage) -> None:
        self._respond(msg)


class MessageCryptoService:
    """Pluggable crypto callbacks (reference gossip/api).  The default:
    the pki-id is a hash of the identity bytes, signatures are empty and
    every one verifies."""

    def get_pki_id(self, identity: bytes) -> bytes:
        return sha256(identity)[:16]

    def sign(self, payload: bytes) -> bytes:
        return b""

    def verify(self, identity: bytes, signature: bytes, payload: bytes) -> bool:
        return True


class SignerMCS(MessageCryptoService):
    """MSP-backed crypto: sign with the node's signing identity; verify
    against the sender's serialized identity through the deserializer,
    as a one-lane `verify_batch` on the peer's CSP (under its
    `min_device_batch` the lane takes the host route)."""

    def __init__(self, signer, deserializer, csp):
        self._signer = signer
        self._deserializer = deserializer
        self._csp = csp

    def sign(self, payload: bytes) -> bytes:
        return self._signer.sign(payload)

    def verify(self, identity: bytes, signature: bytes, payload: bytes) -> bool:
        try:
            ident = self._deserializer.deserialize_identity(identity)
            item = ident.verification_item(payload, signature)
            return bool(self._csp.verify_batch([item])[0])
        except Exception:
            return False


class GossipComm:
    """Common plumbing: wrap and sign outbound, verify and demux inbound."""

    def __init__(self, self_identity: bytes,
                 mcs: MessageCryptoService | None = None):
        self.mcs = mcs or MessageCryptoService()
        self.identity = self_identity
        self.pki_id = self.mcs.get_pki_id(self_identity)
        self._subscribers: list = []
        self._known_identities: dict[bytes, bytes] = {
            self.pki_id: self_identity
        }
        self._lock = named_lock("gossip.comm.identities")
        self._metrics = None  # common.metrics.GossipMetrics

    def set_metrics(self, metrics) -> None:
        self._metrics = metrics

    def subscribe(self, handler) -> None:
        """handler(ReceivedMessage)"""
        self._subscribers.append(handler)

    def learn_identity(self, identity: bytes) -> bytes:
        pki = self.mcs.get_pki_id(identity)
        with self._lock:
            self._known_identities[pki] = identity
        return pki

    def identity_of(self, pki_id: bytes) -> bytes | None:
        with self._lock:
            return self._known_identities.get(pki_id)

    def forget_identity(self, pki_id: bytes) -> None:
        """Drop a learned identity (the identity mapper's purge)."""
        with self._lock:
            self._known_identities.pop(pki_id, None)

    def wrap(self, msg: gpb.GossipMessage) -> gpb.SignedGossipMessage:
        payload = msg.encode()
        m = self._metrics
        if m is not None:
            m.messages_sent.add()
        return gpb.SignedGossipMessage(payload=payload,
                                       signature=self.mcs.sign(payload))

    def _dispatch(self, signed: gpb.SignedGossipMessage, sender_pki: bytes,
                  respond, trace_parent=None):
        try:
            msg = gpb.GossipMessage.decode(signed.payload)
        except DecodeError:
            return  # a malformed payload is dropped
        # every message verifies under the sender's handshake-bound
        # identity, signed or not
        ident = self.identity_of(sender_pki)
        if ident is None:
            return
        if not self.mcs.verify(ident, signed.signature, signed.payload):
            return
        content = msg.which("content") or ""
        m = self._metrics
        if m is not None:
            m.messages_received.With("content", content or "unknown").add()
        rm = ReceivedMessage(msg, sender_pki, respond)
        with tracing.span("gossip.deliver", parent=trace_parent,
                          content=content,
                          subscribers=len(self._subscribers)):
            for h in list(self._subscribers):
                try:
                    h(rm)
                except Exception:
                    # one subscriber's fault starves neither the others
                    # nor the connection's serving loop
                    must_get_logger("gossip.comm").warning(
                        "gossip subscriber raised", exc_info=True)


class InProcGossipNet:
    """The shared fabric of InProcGossipComm endpoints, by endpoint name."""

    def __init__(self):
        self._peers: dict[str, "InProcGossipComm"] = {}
        self._cut: set[frozenset] = set()
        self._lock = named_lock("gossip.net")

    def register(self, comm: "InProcGossipComm") -> None:
        with self._lock:
            self._peers[comm.endpoint] = comm

    def unregister(self, endpoint: str) -> None:
        with self._lock:
            self._peers.pop(endpoint, None)

    def partition(self, a: str, b: str) -> None:
        with self._lock:
            self._cut.add(frozenset((a, b)))

    def heal(self) -> None:
        with self._lock:
            self._cut.clear()

    def route(self, frm: "InProcGossipComm", to_endpoint: str, signed) -> None:
        with self._lock:
            if frozenset((frm.endpoint, to_endpoint)) in self._cut:
                return
            peer = self._peers.get(to_endpoint)
        if peer is not None:
            peer.receive_from(frm, signed)


class InProcGossipComm(GossipComm):
    def __init__(self, endpoint: str, net: InProcGossipNet,
                 self_identity: bytes, mcs=None):
        super().__init__(self_identity, mcs)
        self.endpoint = endpoint
        self._net = net
        net.register(self)

    def send(self, to_endpoint: str, msg: gpb.GossipMessage) -> None:
        self._net.route(self, to_endpoint, self.wrap(msg))

    def receive_from(self, frm: "InProcGossipComm", signed) -> None:
        # first contact teaches the peer's identity (the handshake's role)
        self.learn_identity(frm.identity)
        self._dispatch(signed, frm.pki_id,
                       lambda m: frm.receive_from(self, self.wrap(m)))

    def close(self) -> None:
        self._net.unregister(self.endpoint)


class TCPGossipComm(GossipComm):
    """The deployment transport: one listener, an outbound connection
    and sender thread per endpoint, a ConnEstablish handshake that
    carries the identity.

    With `tls` (comm.tls.TLSCredentials, client authentication required)
    every stream runs over mutual TLS, and the handshake binds the
    session to the signed identity: each side puts the SHA-256 of its own
    TLS leaf in ConnEstablish.tls_cert_hash and signs pki_id ||
    tls_cert_hash || endpoint; the receiver recomputes the hash from the
    certificate its TLS layer authenticated, so a handshake replayed over
    another session is refused (reference gossip/comm/crypto.go)."""

    # every message is delivered on its connection's reader thread, in
    # order: a subscriber that commits moves it off (gossip.state)
    delivers_on_reader = True
    # a peer declaring a larger frame is cut off (the RPC transport's cap)
    _MAX_FRAME = 100 * 1024 * 1024

    def __init__(self, listen_addr: tuple[str, int], self_identity: bytes,
                 mcs=None, tls=None):
        super().__init__(self_identity, mcs)
        if tls is not None and not tls.require_client_auth:
            raise ValueError("gossip TLS requires require_client_auth=True")
        self._tls = tls
        self._server_ctx = tls.server_context() if tls is not None else None
        self._client_ctx = tls.client_context() if tls is not None else None
        self._cert_hash = tls.cert_hash if tls is not None else b""
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(listen_addr)
        self._server.listen(64)
        self.addr = self._server.getsockname()
        self.endpoint = f"{self.addr[0]}:{self.addr[1]}"
        self._out: dict[str, queue.Queue] = {}
        self._lock = named_lock("gossip.comm.out")
        self._served: set = set()  # the accepted connections, open
        self._stop = threading.Event()
        spawn_thread(target=self._accept, name="gossip-accept",
                     kind="service").start()

    # -- outbound ----------------------------------------------------------

    def send(self, to_endpoint: str, msg: gpb.GossipMessage) -> None:
        with self._lock:
            q = self._out.get(to_endpoint)
            if q is None:
                q = queue.Queue(maxsize=1024)
                self._out[to_endpoint] = q
                spawn_thread(target=self._sender, args=(to_endpoint, q),
                             name=f"gossip-send-{to_endpoint}",
                             kind="service").start()
        try:
            # the caller's span context rides the item to the sender
            q.put_nowait((self.wrap(msg).encode(), tracing.current()))
        except queue.Full:
            pass  # gossip tolerates loss

    def _handshake_frame(self) -> bytes:
        ce = gpb.ConnEstablish(
            pki_id=self.pki_id, identity=self.identity,
            tls_cert_hash=self._cert_hash, endpoint=self.endpoint,
            signature=self.mcs.sign(self.pki_id + self._cert_hash
                                    + self.endpoint.encode()))
        raw = ce.encode()
        return _LEN.pack(len(raw)) + raw

    def _dial(self, endpoint: str):
        faultline.point("gossip.dial", endpoint=endpoint)
        netsplit.connect(addr=endpoint)
        host, port = endpoint.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=_dial_timeout())
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._client_ctx is not None:
            sock = self._client_ctx.wrap_socket(sock, server_hostname=host)
        sock = faultline.io(sock, "gossip.conn")
        sock.sendall(self._handshake_frame())
        return sock

    def _sender(self, endpoint: str, q: queue.Queue) -> None:
        sock = None
        ns_tok = None
        # a down member is re-dialed behind a gate, seeded from this link
        # (a dict lookup a message inside the window, never a stall)
        gate = BackoffGate.for_key(f"{self.endpoint}->{endpoint}")
        while not self._stop.is_set():
            try:
                data, trace_ctx = q.get(timeout=0.5)
            except queue.Empty:
                continue
            if self._stop.is_set():
                break
            for _ in range(2):  # one reconnect a message
                if sock is None:
                    if not gate.ready():
                        break  # inside the backoff window: drop it
                    try:
                        sock = self._dial(endpoint)
                        ns_tok = netsplit.track(sock, addr=endpoint)
                    except OSError:
                        sock = None
                        gate.arm()
                        break
                try:
                    # the enqueuer's context rides the frame as a token
                    wire = tracing.frame_with_token(data, trace_ctx)
                    with tracing.attached(trace_ctx), tracing.span(
                            "gossip.send", endpoint=endpoint, n=len(data)):
                        sock.sendall(_LEN.pack(len(wire)) + wire)
                    gate.reset()  # only a data send proves the link
                    break
                except OSError:
                    if ns_tok is not None:
                        netsplit.untrack(ns_tok)
                        ns_tok = None
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                    gate.arm()
        if sock is not None:
            if ns_tok is not None:
                netsplit.untrack(ns_tok)
            try:
                sock.close()
            except OSError:
                pass

    # -- inbound -----------------------------------------------------------

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            spawn_thread(target=self._serve, args=(conn,),
                         name="gossip-serve", kind="service").start()

    @classmethod
    def _read_frame(cls, conn, buf: bytearray) -> bytes | None:
        while len(buf) < _LEN.size:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            buf.extend(chunk)
        (ln,) = _LEN.unpack_from(bytes(buf[:_LEN.size]))
        if ln > cls._MAX_FRAME:
            return None
        while len(buf) < _LEN.size + ln:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            buf.extend(chunk)
        frame = bytes(buf[_LEN.size:_LEN.size + ln])
        del buf[:_LEN.size + ln]
        return frame

    def _handshake_ok(self, ce: gpb.ConnEstablish,
                      peer_der: bytes | None) -> bool:
        if self.mcs.get_pki_id(ce.identity) != ce.pki_id:
            return False
        sig_payload = ce.pki_id + ce.tls_cert_hash + ce.endpoint.encode()
        if self._tls is not None:
            # the claimed hash is the certificate this session
            # authenticated, and a signature binds it
            if not peer_der or ce.tls_cert_hash != cert_hash_from_der(
                    peer_der):
                return False
            if not ce.signature:
                return False
        # plaintext: the handshake still verifies under the MCS
        return self.mcs.verify(ce.identity, ce.signature, sig_payload)

    def _serve(self, conn: socket.socket) -> None:
        buf = bytearray()
        conn.settimeout(60)
        ns_tok = None
        peer_der = None
        with self._lock:
            if self._stop.is_set():
                conn.close()
                return
            self._served.add(conn)
        raw = conn
        try:
            if self._server_ctx is not None:
                try:
                    conn = self._server_ctx.wrap_socket(conn,
                                                         server_side=True)
                    peer_der = conn.getpeercert(binary_form=True)
                except OSError:  # ssl.SSLError included
                    return
            frame = self._read_frame(conn, buf)
            if frame is None:
                return
            try:
                ce = gpb.ConnEstablish.decode(frame)
            except DecodeError:
                return
            if not self._handshake_ok(ce, peer_der):
                return
            netsplit.accept(addr=ce.endpoint)
            ns_tok = netsplit.track(conn, addr=ce.endpoint)
            self.learn_identity(ce.identity)
            sender_pki = ce.pki_id
            # replies dial back to the sender's signed listen endpoint,
            # bounded to the connection's source host
            if ce.endpoint and self._dialback_allowed(ce.endpoint, conn):
                respond = lambda m, _ep=ce.endpoint: self.send(_ep, m)
            else:
                respond = lambda m: None
            while not self._stop.is_set():
                frame = self._read_frame(conn, buf)
                if frame is None:
                    return
                payload, trace_parent = tracing.split_frame_token(frame)
                try:
                    sm = gpb.SignedGossipMessage.decode(payload)
                except DecodeError:
                    continue  # a malformed frame: drop it, keep serving
                self._dispatch(sm, sender_pki, respond,
                               trace_parent=trace_parent)
        except OSError:
            return
        finally:
            with self._lock:
                self._served.discard(raw)
            if ns_tok is not None:
                netsplit.untrack(ns_tok)
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _dialback_allowed(endpoint: str, conn) -> bool:
        """True when the claimed listen endpoint's host is the
        connection's source address (any port); DNS names are refused;
        loopback literals of either family are interchangeable."""
        host = endpoint.rsplit(":", 1)[0].strip("[]")
        try:
            src = conn.getpeername()[0]
        except OSError:
            return False
        if host == src:
            return True
        try:
            return (ipaddress.ip_address(host).is_loopback
                    and ipaddress.ip_address(src).is_loopback)
        except ValueError:
            return False

    def close(self) -> None:
        """Stop listening, end the streams served (so that the senders
        of the other peers dial again, to whoever listens next) and let
        the sender threads close their connections."""
        with self._lock:
            self._stop.set()
            served = list(self._served)
        try:
            # a shutdown wakes the accept loop; a close alone leaves it
            # blocked, and the port bound, until a dial arrives
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            pass
        for conn in served:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


__all__ = [
    "GossipComm",
    "InProcGossipNet",
    "InProcGossipComm",
    "TCPGossipComm",
    "MessageCryptoService",
    "SignerMCS",
    "ReceivedMessage",
]
