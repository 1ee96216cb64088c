"""The client-facing Broadcast handler (the port's copy of
`fabric_tpu/orderer/broadcast.py`; reference orderer/common/broadcast):
find the channel, classify the message, run the channel's filters, and
hand it to the consenter (`order` / `configure`).  Returns a `Status` per
message, as the AtomicBroadcast.Broadcast stream does; every status and
every exception class caught is the reference's.
"""

from __future__ import annotations

from fabric_tpu_torch.orderer.msgprocessor import (
    Classification,
    MsgProcessorError,
    _headers,
)
from fabric_tpu_torch.protos import common as cb
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


__all__ = ["BroadcastHandler"]
