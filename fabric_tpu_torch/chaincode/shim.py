"""The chaincode shim: what a chaincode runs against (the port's copy of
`fabric_tpu/chaincode/shim.py`; reference fabric-chaincode-go's shim, the
peer's side in core/chaincode/handler.go).

REGISTER first; then each TRANSACTION or INIT builds a `ChaincodeStub`
on the stream and calls the chaincode; GetState, PutState and the rest
wait for the peer's RESPONSE of their txid.  A stream is a pair of
callables (send, recv) of whole frames, so the same shim runs over an
in-process queue pair (`support.InProcStream`) or a TCP socket of another
process (`shim_main`, 4-byte big-endian length-prefixed frames, the JAX
package's bytes).  Every thread goes through `lockwatch.spawn_thread`.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading

from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb
from fabric_tpu_torch.protos import peer as pb

_LEN = struct.Struct(">I")
M = pb.ChaincodeMessage


class ChaincodeError(Exception):
    pass


class Chaincode:
    """A chaincode: subclass and implement `init` / `invoke`."""

    def init(self, stub: "ChaincodeStub") -> pb.Response:
        return success()

    def invoke(self, stub: "ChaincodeStub") -> pb.Response:
        raise NotImplementedError


def success(payload: bytes = b"", message: str = "") -> pb.Response:
    return pb.Response(status=200, message=message, payload=payload)


def error(message: str, status: int = 500) -> pb.Response:
    return pb.Response(status=status, message=message)


class ChaincodeStub:
    def __init__(self, handler: "ShimHandler", msg: pb.ChaincodeMessage):
        self._handler = handler
        self.txid = msg.txid
        self.channel_id = msg.channel_id
        self.args = list(pb.ChaincodeInput.decode(msg.payload).args)
        self._proposal_bytes = bytes(msg.proposal)
        self._event: bytes = b""

    # -- arguments ---------------------------------------------------------

    def get_args(self) -> list[bytes]:
        return self.args

    def get_function_and_parameters(self) -> tuple[str, list[bytes]]:
        if not self.args:
            return "", []
        return self.args[0].decode(), self.args[1:]

    # -- identity ----------------------------------------------------------

    def get_creator(self) -> bytes:
        """The proposal's creator, a marshaled SerializedIdentity."""
        if not self._proposal_bytes:
            return b""
        sp = pb.SignedProposal.decode(self._proposal_bytes)
        prop = pb.Proposal.decode(sp.proposal_bytes)
        hdr = cb.Header.decode(prop.header)
        return bytes(cb.SignatureHeader.decode(hdr.signature_header).creator)

    def creator_mspid(self) -> str:
        creator = self.get_creator()
        if not creator:
            return ""
        return mb.SerializedIdentity.decode(creator).mspid

    # -- state -------------------------------------------------------------

    def _call(self, mtype, payload: bytes) -> pb.ChaincodeMessage:
        resp = self._handler.call_peer(M(type=mtype, payload=payload,
                                         txid=self.txid,
                                         channel_id=self.channel_id))
        if resp.type == M.ERROR:
            raise ChaincodeError(resp.payload.decode("utf-8", "replace"))
        return resp

    def get_state(self, key: str, collection: str = "") -> bytes:
        g = pb.GetState(key=key, collection=collection)
        return self._call(M.GET_STATE, g.encode()).payload

    def put_state(self, key: str, value: bytes, collection: str = "") -> None:
        p = pb.PutState(key=key, value=value, collection=collection)
        self._call(M.PUT_STATE, p.encode())

    def del_state(self, key: str, collection: str = "") -> None:
        d = pb.DelState(key=key, collection=collection)
        self._call(M.DEL_STATE, d.encode())

    def _paged_results(self, first_resp):
        """The (key, value) pairs of a QueryResponse and its
        QUERY_STATE_NEXT pages (range and rich queries)."""
        qr = pb.QueryResponse.decode(first_resp.payload)
        while True:
            for rb in qr.results:
                kv = pb.KV.decode(rb.result_bytes)
                yield kv.key, kv.value
            if not qr.has_more:
                return
            resp = self._call(M.QUERY_STATE_NEXT,
                              pb.QueryStateNext(id=qr.id).encode())
            qr = pb.QueryResponse.decode(resp.payload)

    def get_state_by_range(self, start: str, end: str, collection: str = ""):
        """Yields (key, value) pairs."""
        g = pb.GetStateByRange(start_key=start, end_key=end,
                               collection=collection)
        resp = self._call(M.GET_STATE_BY_RANGE, g.encode())
        yield from self._paged_results(resp)

    def get_query_result(self, query: str, collection: str = ""):
        """A rich JSON-selector query; yields (key, value) pairs."""
        g = pb.GetQueryResult(query=query, collection=collection)
        resp = self._call(M.GET_QUERY_RESULT, g.encode())
        yield from self._paged_results(resp)

    def get_private_data_hash(self, collection: str, key: str) -> bytes:
        g = pb.GetState(key=key, collection=collection)
        return self._call(M.GET_PRIVATE_DATA_HASH, g.encode()).payload

    # -- state metadata and key-level endorsement ---------------------------

    def get_state_metadata(self, key: str,
                           collection: str = "") -> dict[str, bytes]:
        g = pb.GetStateMetadata(key=key, collection=collection)
        resp = self._call(M.GET_STATE_METADATA, g.encode())
        res = pb.StateMetadataResult.decode(resp.payload)
        return {e.metakey: bytes(e.value) for e in res.entries}

    def put_state_metadata(self, key: str, metakey: str, value: bytes,
                           collection: str = "") -> None:
        p = pb.PutStateMetadata(key=key, collection=collection,
                                metadata=pb.StateMetadata(metakey=metakey,
                                                          value=value))
        self._call(M.PUT_STATE_METADATA, p.encode())

    def set_state_validation_parameter(self, key: str, policy_bytes: bytes,
                                       collection: str = "") -> None:
        """Attach a key-level endorsement policy (build it with
        `chaincode.statebased`)."""
        self.put_state_metadata(key, "VALIDATION_PARAMETER", policy_bytes,
                                collection)

    def get_state_validation_parameter(self, key: str,
                                       collection: str = "") -> bytes:
        return self.get_state_metadata(key, collection).get(
            "VALIDATION_PARAMETER", b"")

    def invoke_chaincode(self, name: str, args: list[bytes],
                         channel: str = "") -> pb.Response:
        spec = pb.ChaincodeSpec(
            chaincode_id=pb.ChaincodeID(
                name=name if not channel else f"{name}/{channel}"),
            input=pb.ChaincodeInput(args=args))
        resp = self._call(M.INVOKE_CHAINCODE, spec.encode())
        return pb.Response.decode(resp.payload)

    def set_event(self, name: str, payload: bytes) -> None:
        self._event = pb.ChaincodeEvent(chaincode_id="", tx_id=self.txid,
                                        event_name=name,
                                        payload=payload).encode()


class ShimHandler:
    """Drives one chaincode over one stream."""

    def __init__(self, cc: Chaincode, name: str, send, recv):
        self._cc = cc
        self.name = name
        self._send_raw = send
        self._recv = recv
        # responses routed by (channel_id, txid): one txid may be live on
        # two channels at once
        self._responses: dict[tuple[str, str], queue.Queue] = {}
        self._lock = threading.Lock()

    def _send(self, msg: pb.ChaincodeMessage) -> None:
        self._send_raw(msg.encode())

    def call_peer(self, msg: pb.ChaincodeMessage) -> pb.ChaincodeMessage:
        q: queue.Queue = queue.Queue(maxsize=1)
        key = (msg.channel_id, msg.txid)
        with self._lock:
            if key in self._responses:
                raise ChaincodeError(
                    f"concurrent peer call for tx {key} on one stub")
            self._responses[key] = q
        try:
            self._send(msg)
            return q.get(timeout=30)
        finally:
            with self._lock:
                self._responses.pop(key, None)

    def run(self) -> None:
        reg = pb.ChaincodeID(name=self.name)
        self._send(M(type=M.REGISTER, payload=reg.encode()))
        while True:
            raw = self._recv()
            if raw is None:
                return
            msg = M.decode(raw)
            if msg.type in (M.REGISTERED, M.READY, M.KEEPALIVE):
                continue
            if msg.type in (M.RESPONSE, M.ERROR):
                with self._lock:
                    q = self._responses.get((msg.channel_id, msg.txid))
                if q is not None:
                    q.put(msg)
                continue
            if msg.type in (M.TRANSACTION, M.INIT):
                spawn_thread(target=self._execute, args=(msg,),
                             name=f"cc-exec-{msg.txid[:8]}",
                             kind="worker").start()

    def _execute(self, msg: pb.ChaincodeMessage) -> None:
        try:
            stub = ChaincodeStub(self, msg)
            resp = (self._cc.init(stub) if msg.type == M.INIT
                    else self._cc.invoke(stub))
            self._send(M(type=M.COMPLETED, payload=resp.encode(),
                         txid=msg.txid, channel_id=msg.channel_id,
                         chaincode_event=stub._event))
        except Exception as exc:  # a chaincode's panic: ERROR
            self._send(M(type=M.ERROR, payload=str(exc).encode(),
                         txid=msg.txid, channel_id=msg.channel_id))


def frame_reader(sock: socket.socket):
    """recv() -> the next length-prefixed frame of the socket, or None at
    its end."""
    buf = bytearray()

    def recv() -> bytes | None:
        while len(buf) < _LEN.size:
            chunk = sock.recv(65536)
            if not chunk:
                return None
            buf.extend(chunk)
        (ln,) = _LEN.unpack_from(buf)
        while len(buf) < _LEN.size + ln:
            chunk = sock.recv(65536)
            if not chunk:
                return None
            buf.extend(chunk)
        frame = bytes(buf[_LEN.size: _LEN.size + ln])
        del buf[: _LEN.size + ln]
        return frame

    return recv


def frame_writer(sock: socket.socket):
    """send(data): one length-prefixed frame, whole, under a lock."""
    lock = threading.Lock()

    def send(data: bytes) -> None:
        with lock:
            sock.sendall(_LEN.pack(len(data)) + data)

    return send


def shim_main(cc: Chaincode, name: str, peer_address: str,
              auth_token: str | None = None) -> None:
    """An external chaincode's entry: connect to the peer's chaincode
    listener and serve until it closes.  `auth_token` is the launch
    credential (`ChaincodeSupport.issue_launch_token`), sent in a
    `CCAUTH1\\0<name>\\0<token>` frame before anything else."""
    host, port = peer_address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send = frame_writer(sock)
    if auth_token is not None:
        send(b"\x00".join([b"CCAUTH1", name.encode(), auth_token.encode()]))
    ShimHandler(cc, name, send, frame_reader(sock)).run()


__all__ = [
    "Chaincode",
    "ChaincodeStub",
    "ChaincodeError",
    "ShimHandler",
    "shim_main",
    "success",
    "error",
]
