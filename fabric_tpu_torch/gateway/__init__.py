"""The port's gateway (a copy of `fabric_tpu/gateway/`): the pipelined
submission front end of the ordering service.  Clients multiplex onto
one broadcast stream; the gateway dedups txids, admits within a window
that follows the commit rate, fails over between orderers in a fixed
order (resubmitting what is in flight), and tails a peer's blocks to
resolve every accepted transaction to VALID, INVALID or TIMEOUT."""

from fabric_tpu_torch.gateway.core import (  # noqa: F401
    STATUS_INVALID,
    STATUS_PENDING,
    STATUS_TIMEOUT,
    STATUS_VALID,
    Gateway,
    SubmitResult,
    orderer_stream_connect,
    txid_of,
)
