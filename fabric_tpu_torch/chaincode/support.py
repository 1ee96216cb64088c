"""The peer's chaincode runtime (the port's copy of
`fabric_tpu/chaincode/support.py`; reference core/chaincode:
chaincode_support.go, handler.go's message state machine,
transaction_context.go).

- `ChaincodeSupport.register_stream` serves one chaincode connection:
  REGISTER, REGISTERED, READY; then it answers the ledger calls of each
  transaction against its TxSimulator with RESPONSE or ERROR.
- `execute` sends a TRANSACTION (or INIT) to a registered chaincode and
  waits for its COMPLETED or ERROR.
- Range and rich queries page through the transaction's open iterators
  (QUERY_STATE_NEXT / CLOSE), 100 results a page.
- A chaincode calls another (INVOKE_CHAINCODE) on the same simulator:
  one read-write set.
- `InProcStream` binds a shim in the same process (system chaincodes);
  `TCPChaincodeListener` accepts external chaincode processes that open
  with their launch credential.
"""

from __future__ import annotations

import hmac
import queue
import secrets
import socket
import threading
import time

from fabric_tpu_torch.chaincode.shim import (
    ShimHandler,
    frame_reader,
    frame_writer,
)
from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.ledger.txmgmt import encode_metadata
from fabric_tpu_torch.protos import peer as pb

M = pb.ChaincodeMessage
_RANGE_PAGE = 100


class ChaincodeExecuteError(Exception):
    pass


class TxContext:
    def __init__(self, simulator, channel_id: str, txid: str):
        self.simulator = simulator
        self.channel_id = channel_id
        self.txid = txid
        self.iterators: dict[str, object] = {}
        self._iter_seq = 0
        self.event: bytes = b""
        self.response_q: queue.Queue = queue.Queue(maxsize=1)

    def new_iterator_id(self) -> str:
        self._iter_seq += 1
        return f"it{self._iter_seq}"


class _CCHandle:
    """One registered chaincode stream."""

    def __init__(self, name: str, send):
        self.name = name
        self.send = send


class ChaincodeSupport:
    def __init__(self, invoke_timeout_s: float = 30.0):
        self._ccs: dict[str, _CCHandle] = {}
        self._contexts: dict[tuple[str, str], TxContext] = {}
        self._namespaces: dict[tuple[str, str], str] = {}
        self._lock = threading.Lock()
        self._timeout = invoke_timeout_s
        self.cc2cc_allowed = True
        self._launch_tokens: dict[str, str] = {}

    # -- launch credentials: a random token the peer hands a chaincode
    # process at launch, demanded by the TCP listener before any protocol
    # message (the reference issues a TLS client certificate instead);
    # in-process streams are the peer's own

    def issue_launch_token(self, name: str) -> str:
        """Mint the launch credential of one chaincode process; a new one
        replaces the last."""
        token = secrets.token_hex(32)
        with self._lock:
            self._launch_tokens[name] = token
        return token

    def check_launch_token(self, name: str, token: str) -> bool:
        with self._lock:
            want = self._launch_tokens.get(name)
        return want is not None and hmac.compare_digest(want, token)

    # -- registration, one a stream ----------------------------------------

    def register_stream(self, send, recv,
                        authorized_name: str | None = None) -> None:
        """Serve one chaincode connection until its end: `send(bytes)`,
        `recv() -> bytes | None`.  With `authorized_name` (an
        authenticated TCP stream), a REGISTER of another name is
        refused."""
        name: str | None = None
        handle: _CCHandle | None = None
        try:
            while True:
                raw = recv()
                if raw is None:
                    return
                msg = M.decode(raw)
                if msg.type == M.REGISTER:
                    cid = pb.ChaincodeID.decode(msg.payload)
                    if authorized_name is not None \
                            and cid.name != authorized_name:
                        send(M(type=M.ERROR,
                               payload=b"chaincode name does not match "
                               b"launch credential").encode())
                        return
                    with self._lock:
                        dup = cid.name in self._ccs  # refused, as handler.go
                        if not dup:
                            name = cid.name
                            handle = _CCHandle(
                                name, lambda m: send(m.encode()))
                            self._ccs[name] = handle
                    if dup:
                        send(M(type=M.ERROR,
                               payload=b"duplicate registered name "
                               + cid.name.encode()).encode())
                        return
                    send(M(type=M.REGISTERED).encode())
                    send(M(type=M.READY).encode())
                    continue
                if msg.type in (M.COMPLETED, M.ERROR):
                    ctx = self._ctx(msg)
                    if ctx is not None:
                        self._dispatch(msg, ctx)
                    continue
                # ledger calls run off the read loop, so that a cc2cc call
                # that blocks cannot hold up the COMPLETED this stream must
                # also deliver
                spawn_thread(target=self._dispatch_async, args=(msg, send),
                             name="cc-dispatch", kind="worker").start()
        finally:
            if name is not None:
                with self._lock:
                    if self._ccs.get(name) is handle:
                        self._ccs.pop(name, None)

    def _dispatch_async(self, msg: pb.ChaincodeMessage, send) -> None:
        ctx = self._ctx(msg)
        if ctx is None:
            return  # an unknown transaction: dropped
        try:
            out = self._dispatch(msg, ctx)
        except Exception as exc:
            out = self._error(msg, str(exc))
        if out is not None:
            send(out.encode())

    def registered(self, name: str) -> bool:
        with self._lock:
            return name in self._ccs

    # -- execution, the peer's call ----------------------------------------

    def execute(self, name: str, channel_id: str, txid: str, simulator,
                args: list[bytes], is_init: bool = False,
                signed_proposal_bytes: bytes = b"",
                namespace: str | None = None) -> tuple[pb.Response, bytes]:
        """(Response, the chaincode event's bytes).  The transaction's
        state lives in the namespace of the chaincode's name (or
        `namespace`)."""
        with self._lock:
            cc = self._ccs.get(name)
        if cc is None:
            raise ChaincodeExecuteError(f"chaincode {name!r} not registered")
        ctx = TxContext(simulator, channel_id, txid)
        key = (channel_id, txid)
        with self._lock:
            if key in self._contexts:
                raise ChaincodeExecuteError(f"duplicate tx context {key}")
            self._contexts[key] = ctx
            self._namespaces[key] = namespace if namespace is not None \
                else name
        try:
            cc.send(M(type=M.INIT if is_init else M.TRANSACTION,
                      payload=pb.ChaincodeInput(args=args).encode(),
                      txid=txid, channel_id=channel_id,
                      proposal=signed_proposal_bytes))
            try:
                msg = ctx.response_q.get(timeout=self._timeout)
            except queue.Empty:
                raise ChaincodeExecuteError(
                    f"chaincode {name!r} timed out after {self._timeout}s"
                ) from None
            if msg.type == M.ERROR:
                raise ChaincodeExecuteError(
                    msg.payload.decode("utf-8", "replace"))
            return pb.Response.decode(msg.payload), bytes(
                msg.chaincode_event)
        finally:
            with self._lock:
                self._contexts.pop(key, None)
                self._namespaces.pop(key, None)

    # -- ledger calls, the chaincode's -------------------------------------

    def _ctx(self, msg: pb.ChaincodeMessage) -> TxContext | None:
        with self._lock:
            return self._contexts.get((msg.channel_id, msg.txid))

    def _reply(self, msg: pb.ChaincodeMessage,
               payload: bytes = b"") -> pb.ChaincodeMessage:
        return M(type=M.RESPONSE, payload=payload, txid=msg.txid,
                 channel_id=msg.channel_id)

    def _error(self, msg: pb.ChaincodeMessage,
               text: str) -> pb.ChaincodeMessage:
        return M(type=M.ERROR, payload=text.encode(), txid=msg.txid,
                 channel_id=msg.channel_id)

    def _dispatch(self, msg: pb.ChaincodeMessage, ctx: TxContext):
        sim = ctx.simulator
        ns = self._tx_namespace(ctx)
        t = msg.type
        if t == M.GET_STATE:
            g = pb.GetState.decode(msg.payload)
            val = (sim.get_private_data(ns, g.collection, g.key)
                   if g.collection else sim.get_state(ns, g.key))
            return self._reply(msg, val or b"")
        if t == M.PUT_STATE:
            p = pb.PutState.decode(msg.payload)
            if p.collection:
                sim.set_private_data(ns, p.collection, p.key, p.value)
            else:
                sim.set_state(ns, p.key, p.value)
            return self._reply(msg)
        if t == M.DEL_STATE:
            d = pb.DelState.decode(msg.payload)
            if d.collection:
                sim.delete_private_data(ns, d.collection, d.key)
            else:
                sim.delete_state(ns, d.key)
            return self._reply(msg)
        if t == M.GET_STATE_METADATA:
            g = pb.GetStateMetadata.decode(msg.payload)
            entries = (sim.get_private_data_metadata(ns, g.collection, g.key)
                       if g.collection else sim.get_state_metadata(ns, g.key))
            return self._reply(msg, encode_metadata(entries))
        if t == M.PUT_STATE_METADATA:
            p = pb.PutStateMetadata.decode(msg.payload)
            entry = {p.metadata.metakey: bytes(p.metadata.value)}
            if p.collection:
                sim.set_private_data_metadata(ns, p.collection, p.key, entry)
            else:
                sim.set_state_metadata(ns, p.key, entry)
            return self._reply(msg)
        if t == M.GET_PRIVATE_DATA_HASH:
            g = pb.GetState.decode(msg.payload)
            val = sim.get_private_data_hash(ns, g.collection, g.key)
            return self._reply(msg, val or b"")
        if t == M.GET_STATE_BY_RANGE:
            g = pb.GetStateByRange.decode(msg.payload)
            rows = (sim.get_private_data_range(ns, g.collection, g.start_key,
                                               g.end_key)
                    if g.collection
                    else sim.get_state_range(ns, g.start_key, g.end_key))
            return self._open_iterator(msg, ctx, rows)
        if t == M.GET_QUERY_RESULT:
            g = pb.GetQueryResult.decode(msg.payload)
            rows = (sim.get_private_data_query_result(ns, g.collection,
                                                      g.query)
                    if g.collection else sim.get_query_result(ns, g.query))
            return self._open_iterator(msg, ctx, rows)
        if t == M.QUERY_STATE_NEXT:
            qn = pb.QueryStateNext.decode(msg.payload)
            if qn.id not in ctx.iterators:
                return self._error(msg, f"unknown iterator {qn.id}")
            return self._reply(msg, self._page(ctx, qn.id).encode())
        if t == M.QUERY_STATE_CLOSE:
            qc = pb.QueryStateClose.decode(msg.payload)
            ctx.iterators.pop(qc.id, None)
            return self._reply(msg)
        if t == M.INVOKE_CHAINCODE:
            return self._handle_cc2cc(msg, ctx)
        if t in (M.COMPLETED, M.ERROR):
            ctx.event = bytes(msg.chaincode_event)
            ctx.response_q.put(msg)
            return None  # no reply
        return self._error(msg, f"unexpected message type {t}")

    def _open_iterator(self, msg, ctx: TxContext, rows):
        iid = ctx.new_iterator_id()
        ctx.iterators[iid] = iter(rows)
        return self._reply(msg, self._page(ctx, iid).encode())

    def _tx_namespace(self, ctx: TxContext) -> str:
        return self._namespaces.get((ctx.channel_id, ctx.txid), "")

    def set_tx_namespace(self, channel_id: str, txid: str, ns: str) -> None:
        self._namespaces[(channel_id, txid)] = ns

    def _page(self, ctx: TxContext, iid: str) -> pb.QueryResponse:
        it = ctx.iterators[iid]
        results = []
        for _ in range(_RANGE_PAGE):
            try:
                key, value = next(it)
            except StopIteration:
                ctx.iterators.pop(iid, None)
                return pb.QueryResponse(id=iid, results=results,
                                        has_more=False)
            results.append(pb.QueryResultBytes(
                result_bytes=pb.KV(key=key, value=value).encode()))
        return pb.QueryResponse(id=iid, results=results, has_more=True)

    def _handle_cc2cc(self, msg: pb.ChaincodeMessage, ctx: TxContext):
        if not self.cc2cc_allowed:
            return self._error(msg, "chaincode-to-chaincode disabled")
        spec = pb.ChaincodeSpec.decode(msg.payload)
        target = spec.chaincode_id.name.split("/", 1)[0]
        try:
            resp, _ = self.execute(
                target, ctx.channel_id, f"{msg.txid}-cc2cc-{target}",
                ctx.simulator,  # the same simulator: one read-write set
                list(spec.input.args))
        except ChaincodeExecuteError as exc:
            return self._error(msg, str(exc))
        return self._reply(msg, resp.encode())


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


class InProcStream:
    """A queue pair binding a shim to ChaincodeSupport in one process
    (reference core/scc/inprocstream.go)."""

    def __init__(self, support: ChaincodeSupport, cc, name: str):
        self._to_peer: queue.Queue = queue.Queue()
        self._to_cc: queue.Queue = queue.Queue()
        self._support = support
        self._shim = ShimHandler(cc, name, send=self._to_peer.put,
                                 recv=self._to_cc.get)
        self._threads = [
            spawn_thread(target=support.register_stream,
                         args=(self._to_cc.put, self._to_peer.get),
                         name="cc-peer-side", kind="service"),
            spawn_thread(target=self._shim.run, name="cc-shim",
                         kind="service"),
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 5.0) -> None:
        """End both loops (a None on each queue, their one reader's end of
        stream) and join them; a second call changes nothing."""
        self._to_peer.put(None)
        self._to_cc.put(None)
        for t in self._threads:
            if t.ident is not None:
                t.join(timeout)

    def wait_registered(self, support: ChaincodeSupport, name: str,
                        timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if support.registered(name):
                return
            time.sleep(0.01)
        raise TimeoutError(f"chaincode {name} did not register")


class TCPChaincodeListener:
    """The peer's listener for external chaincode processes.  A connection
    opens with the frame `CCAUTH1\\0<name>\\0<token>`, the launch
    credential the peer issued for that chaincode; anything else closes
    it (the reference authenticates with launch-issued TLS client
    certificates, core/chaincode/accesscontrol)."""

    _HELLO = b"CCAUTH1"

    def __init__(self, support: ChaincodeSupport,
                 listen_addr=("127.0.0.1", 0)):
        self._support = support
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(listen_addr)
        self._server.listen(16)
        self.addr = self._server.getsockname()
        self._stop = threading.Event()
        # the live (connection, thread) pairs, for close(); `_closing`
        # flips under the same lock, so no connection accepted during
        # close() is registered after the drain
        self._conn_lock = threading.Lock()
        self._conns: list = []
        self._closing = False
        spawn_thread(target=self._accept, name="cc-accept",
                     kind="service").start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            t = spawn_thread(target=self._serve, args=(conn,),
                             name="cc-serve", kind="service")
            with self._conn_lock:
                if self._closing:
                    _close(conn)
                    return
                self._conns.append((conn, t))
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        recv = frame_reader(conn)
        try:
            hello = recv()
            if hello is None:
                return
            parts = hello.split(b"\x00")
            if len(parts) != 3 or parts[0] != self._HELLO:
                return  # not an authenticated chaincode stream
            name = parts[1].decode("utf-8", "replace")
            token = parts[2].decode("utf-8", "replace")
            if not self._support.check_launch_token(name, token):
                return  # an unknown or forged credential
            self._support.register_stream(frame_writer(conn), recv,
                                          authorized_name=name)
        except OSError:
            return  # the peer's abrupt end: dropped like a clean close
        finally:
            _close(conn)
            with self._conn_lock:
                self._conns[:] = [(c, t) for c, t in self._conns
                                  if c is not conn]

    def close(self) -> None:
        self._stop.set()
        # shutdown before close: close alone does not wake a thread in
        # accept() or recv() on the socket
        _shutdown(self._server)
        _close(self._server)
        with self._conn_lock:
            self._closing = True
            conns = list(self._conns)
            self._conns.clear()
        for conn, t in conns:
            _shutdown(conn)
            _close(conn)
            if t.ident is not None:
                t.join(5.0)


def _shutdown(sock) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _close(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass


__all__ = [
    "ChaincodeSupport",
    "InProcStream",
    "TCPChaincodeListener",
    "ChaincodeExecuteError",
    "TxContext",
]
