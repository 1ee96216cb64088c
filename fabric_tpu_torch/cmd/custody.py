"""fabric-custody: run a key-custody daemon (the port's copy of
`fabric_tpu/cmd/custody.py`, over `csp/custody.py`).

The process-isolation analogue of the reference's PKCS#11 HSM seam
(bccsp/pkcs11): peers configured with `bccsp.default: CUSTODY` route
key generation and signing here; private keys live ONLY under this
process's keystore directory.

    fabric-custody --keystore /var/fabric/keys --token-file /etc/ct \
                   --listen 127.0.0.1:7599 [--tls-cert c --tls-key k \
                   --tls-ca ca]

The token file is the PIN analogue: provision the same file to the
daemon and to the peers' core.yaml `bccsp.custody.tokenFile`.
"""

from __future__ import annotations

import argparse
import signal
import threading

from fabric_tpu_torch.cmd.common import parse_endpoint
from fabric_tpu_torch.csp.custody import KeyCustodyServer, load_token


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fabric-custody", description=__doc__)
    ap.add_argument("--keystore", required=True,
                    help="directory holding the PEM keystore (0700)")
    ap.add_argument("--token-file", required=True,
                    help="shared-token file (the PIN analogue)")
    ap.add_argument("--listen", default="127.0.0.1:7599")
    ap.add_argument("--tls-cert")
    ap.add_argument("--tls-key")
    ap.add_argument("--tls-ca")
    args = ap.parse_args(argv)

    tls = None
    if args.tls_cert or args.tls_key or args.tls_ca:
        if not (args.tls_cert and args.tls_key):
            ap.error(
                "--tls-cert and --tls-key must be given together "
                "(a partial TLS config would silently serve plaintext)"
            )
        from fabric_tpu_torch.comm.tls import credentials_from_files

        tls = credentials_from_files(
            args.tls_cert, args.tls_key,
            [args.tls_ca] if args.tls_ca else [],
            require_client_auth=bool(args.tls_ca),
        )
    host, port = parse_endpoint(args.listen)
    srv = KeyCustodyServer(
        args.keystore, load_token(args.token_file),
        host=host, port=port, tls=tls,
    )
    srv.start()
    print(f"custody daemon on {srv.addr[0]}:{srv.addr[1]}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
