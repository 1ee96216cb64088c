"""RPC interceptors: per-method metrics + payload logging.

The reference wraps every gRPC server with duration/count metric
interceptors (common/grpcmetrics/interceptor.go: grpc_server_unary_
requests_completed, _request_duration) and optional zap payload logging
(common/grpclogging).  The port's copy of the JAX package's
`fabric_tpu/comm/instrument.py`.  `instrument` installs the equivalent around an
RPCServer's method table; it applies to methods registered before AND
after the call.
"""

from __future__ import annotations

import logging
import time

from fabric_tpu_torch.common.metrics import CounterOpts, HistogramOpts


def instrument(server, provider, payload_logger: str | None = None):
    """Wrap all (current and future) methods of `server` with metrics
    from `provider` (common.metrics Provider) and, when payload_logger
    names a logger, DEBUG-level payload logging."""
    completed = provider.new_counter(CounterOpts(
        namespace="rpc", subsystem="server",
        name="requests_completed",
        help="Completed RPCs, labeled by method and result code.",
        label_names=["method", "code"],
    ))
    duration = provider.new_histogram(HistogramOpts(
        namespace="rpc", subsystem="server",
        name="request_duration",
        help="RPC handling time in seconds, labeled by method.",
        label_names=["method"],
    ))
    log = logging.getLogger(payload_logger) if payload_logger else None

    def wrap(method: str, fn):
        def handler(body, stream):
            t0 = time.perf_counter()
            if log is not None:
                log.debug("rpc recv %s (%d bytes)", method, len(body))
            try:
                out = fn(body, stream)
            except Exception:
                completed.with_labels("method", method, "code", "error").add()
                duration.with_labels("method", method).observe(
                    time.perf_counter() - t0
                )
                raise
            completed.with_labels("method", method, "code", "ok").add()
            duration.with_labels("method", method).observe(
                time.perf_counter() - t0
            )
            return out

        return handler

    # wrap what exists; hook register for what comes later
    for m, fn in list(server.methods.items()):
        server.methods[m] = wrap(m, fn)
    orig_register = server.register

    def register(method, fn, limiter=None):
        orig_register(method, fn, limiter=limiter)
        server.methods[method] = wrap(method, server.methods[method])

    server.register = register
    return server


__all__ = ["instrument"]
