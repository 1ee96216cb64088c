"""Process-level communication substrate (reference internal/pkg/comm):
framed TCP RPC with unary, server-streaming, and bidirectional
(duplex) calls, with optional mutual TLS (`comm.tls`).  The port's copy
of the JAX package's `fabric_tpu/comm`, wire-compatible with it; the
snapshot fetch (`ledger.snapshot.fetch_snapshot`) and key custody
(`csp.custody`) run over it."""

from fabric_tpu_torch.comm.rpc import (  # noqa: F401
    DuplexStream,
    RPCClient,
    RPCError,
    RPCServer,
    Stream,
)
