"""TLS credentials + ssl-context construction for every transport.

The reference's universal substrate is gRPC over (mutual) TLS:
server/client construction internal/pkg/comm/server.go:56 +
internal/pkg/comm/client.go, config internal/pkg/comm/config.go
(ClientAuthRequired, pinned cluster certs
orderer/common/cluster/comm.go:116).  Here the same trust model wraps
the framed-TCP RPC substrate (comm/rpc.py) and the gossip transport
(gossip/comm.py) with the stdlib `ssl` module; certificates come from
the in-repo CA (common/crypto.py) or from MSP TLS-CA directories.  The
port's copy of the JAX package's `fabric_tpu/comm/tls.py`; it reads a
certificate's DER with the port's own `msp.x509`.

Python's ssl requires the *cert chain* to come from files, so key
material is written to a private (0700) temp directory per credentials
object; CA roots load from memory via `cadata`.
"""

from __future__ import annotations

import dataclasses
import os
import ssl
import tempfile

from fabric_tpu_torch.common.hashing import sha256 as _sha256
from fabric_tpu_torch.msp import x509


@dataclasses.dataclass
class TLSCredentials:
    """One endpoint's TLS identity + trust.

    cert_pem/key_pem: this endpoint's certificate and private key.
    ca_pems: trust roots for the counterparty's chain.
    require_client_auth: servers demand (and verify) a client cert —
      mutual TLS, the reference's ClientAuthRequired.
    pinned_certs: optional DER allowlist; when set, the counterparty's
      leaf must be byte-identical to one of these (the orderer cluster's
      pinned-cert scheme, cluster/comm.go:116).
    verify_server_name: clients verify the dialed host against the
      server cert's SANs (DNS or IP), like gRPC's transport credentials.
    """

    cert_pem: bytes
    key_pem: bytes
    ca_pems: list
    require_client_auth: bool = True
    pinned_certs: list | None = None
    verify_server_name: bool = True

    _tmpdir: tempfile.TemporaryDirectory | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _materialize(self) -> tuple[str, str]:
        """Write cert/key to a private temp dir (ssl.load_cert_chain is
        path-only); reused across contexts for this object's lifetime."""
        if self._tmpdir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="fabric-tls-")
            os.chmod(self._tmpdir.name, 0o700)
            cp = os.path.join(self._tmpdir.name, "cert.pem")
            kp = os.path.join(self._tmpdir.name, "key.pem")
            with open(cp, "wb") as f:
                f.write(self.cert_pem)
            with open(kp, "wb") as f:
                f.write(self.key_pem)
            os.chmod(kp, 0o600)
        return (
            os.path.join(self._tmpdir.name, "cert.pem"),
            os.path.join(self._tmpdir.name, "key.pem"),
        )

    @property
    def cert_der(self) -> bytes:
        return x509.load_pem_certificates(self.cert_pem)[0].der

    @property
    def cert_hash(self) -> bytes:
        """SHA-256 of the DER leaf — the value gossip binds into its
        signed connection handshake (reference gossip/comm/crypto.go:20
        certHashFromRawCert)."""
        return _sha256(self.cert_der)

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        cp, kp = self._materialize()
        ctx.load_cert_chain(cp, kp)
        if self.require_client_auth:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(
                cadata="\n".join(p.decode() for p in self.ca_pems)
            )
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """Client-side context.  Endpoint names ARE verified: the name
        passed to wrap_socket(server_hostname=...) — every in-repo
        transport passes the dialed host — must match a SAN (DNS or IP)
        of the server's cert, as the reference's gRPC credentials do.
        Without this, any client cert from any trusted org TLS CA could
        impersonate any peer/orderer endpoint.  Set verify_server_name
        False only for pin-protected transports."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.check_hostname = self.verify_server_name
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(
            cadata="\n".join(p.decode() for p in self.ca_pems)
        )
        cp, kp = self._materialize()
        ctx.load_cert_chain(cp, kp)
        return ctx

    def check_pinned(self, peer_der: bytes | None) -> bool:
        """True when no pinning is configured or the peer's DER leaf is
        in the allowlist."""
        if self.pinned_certs is None:
            return True
        return peer_der is not None and any(
            peer_der == p for p in self.pinned_certs
        )


def credentials_from_ca(
    ca,
    common_name: str,
    sans: list | None = None,
    require_client_auth: bool = True,
    extra_root_pems: list | None = None,
) -> TLSCredentials:
    """Issue a server+client capable TLS cert from a common.crypto.CA and
    bundle it with that CA's root (plus any extra roots) as trust."""
    pair = ca.issue(
        common_name,
        sans=sans or ["localhost", "127.0.0.1"],
        client=True,
        server=True,
    )
    return TLSCredentials(
        cert_pem=pair.cert_pem,
        key_pem=pair.key_pem,
        ca_pems=[ca.cert_pem] + list(extra_root_pems or []),
        require_client_auth=require_client_auth,
    )


def cert_hash_from_der(der: bytes | None) -> bytes:
    return _sha256(der) if der else b""


def credentials_from_files(
    cert_file: str,
    key_file: str,
    ca_files: list,
    require_client_auth: bool = True,
) -> TLSCredentials:
    """Load from PEM files (core.yaml peer.tls.* / orderer General.TLS)."""
    with open(cert_file, "rb") as f:
        cert = f.read()
    with open(key_file, "rb") as f:
        key = f.read()
    cas = []
    for p in ca_files:
        with open(p, "rb") as f:
            cas.append(f.read())
    return TLSCredentials(
        cert_pem=cert, key_pem=key, ca_pems=cas,
        require_client_auth=require_client_auth,
    )


__all__ = [
    "TLSCredentials",
    "credentials_from_ca",
    "credentials_from_files",
    "cert_hash_from_der",
]
