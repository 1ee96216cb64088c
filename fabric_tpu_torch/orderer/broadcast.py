"""The client-facing Broadcast handler (the port's copy of
`fabric_tpu/orderer/broadcast.py`; reference orderer/common/broadcast):
find the channel, classify the message, run the channel's filters, and
hand it to the consenter (`order` / `configure`).  Returns a `Status` per
message, as the AtomicBroadcast.Broadcast stream does; every status and
every exception class caught is the reference's.

`broadcast_stream_handler` is the server half of the gateway's
``ab.BroadcastStream`` over comm's RPC: a frame an envelope, each put
through `process_message` and acked with its status.  The JAX package
serves that stream from a test harness node that orders without the
filters; here every envelope passes the channel's filters.
"""

from __future__ import annotations

from fabric_tpu_torch.orderer.msgprocessor import (
    Classification,
    MsgProcessorError,
    _headers,
)
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos.wire import DecodeError


class BroadcastHandler:
    def __init__(self, registrar):
        self._registrar = registrar

    def process_message(self, env: cb.Envelope) -> int:
        """A `common.Status` code (SUCCESS once enqueued).  The headers
        are decoded once, for the lookup, the classification and the
        filters."""
        try:
            headers = _headers(env)
        except DecodeError:
            headers = None  # each step below decodes, and refuses, alike
        chdr = headers[0] if headers else None
        try:
            cs = self._registrar.broadcast_channel_support(env, chdr)
        except KeyError:
            return cb.NOT_FOUND
        except Exception:
            return cb.BAD_REQUEST
        try:
            kind = cs.processor.classify(env, chdr)
            if kind == Classification.NORMAL:
                seq = cs.processor.process_normal_msg(env, headers)
                cs.chain.wait_ready()
                cs.chain.order(env, seq)
            elif kind == Classification.CONFIG_UPDATE:
                new_env, seq = cs.processor.process_config_update_msg(env)
                cs.chain.wait_ready()
                cs.chain.configure(new_env, seq)
            else:
                return cb.BAD_REQUEST  # a raw CONFIG is not accepted here
        except MsgProcessorError:
            return cb.FORBIDDEN
        except NotImplementedError:
            return cb.NOT_IMPLEMENTED
        except RuntimeError:
            return cb.SERVICE_UNAVAILABLE
        return cb.SUCCESS


def broadcast_stream_handler(registrar):
    """The RPC handler `(body, stream)` of ``ab.BroadcastStream``: each
    request frame one marshaled Envelope, each reply frame the
    BroadcastResponse with that envelope's status (BAD_REQUEST for bytes
    that are no Envelope); an empty frame ends the stream."""
    handler = BroadcastHandler(registrar)

    def serve(body: bytes, stream):
        while True:
            frame = stream.recv()
            if not frame:
                return None
            try:
                status = handler.process_message(cb.Envelope.decode(frame))
            except DecodeError:
                status = cb.BAD_REQUEST
            stream.send(ob.BroadcastResponse(status=status).encode())

    return serve


__all__ = ["BroadcastHandler", "broadcast_stream_handler"]
