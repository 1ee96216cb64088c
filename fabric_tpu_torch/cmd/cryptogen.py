"""cryptogen: generate a network's MSP material from crypto-config.yaml
(the port's copy of `fabric_tpu/cmd/cryptogen.py`; reference
internal/cryptogen + cmd/cryptogen).  Certificates come from the port's
CA (`common.crypto`), the config from the port's YAML reader.

Config schema (subset of the reference's):

    OrdererOrgs:
      - Name: Orderer
        Domain: example.com
        Specs: [{Hostname: orderer}]
    PeerOrgs:
      - Name: Org1
        Domain: org1.example.com
        Template: {Count: 2}
        Users: {Count: 1}

Output layout mirrors the reference:
  <out>/ordererOrganizations/<domain>/{msp, tlsca,
       orderers/<host>.<domain>/{msp, tls}}
  <out>/peerOrganizations/<domain>/{msp, tlsca, peers/.../{msp, tls},
       users/Admin@<domain>/{msp, tls}}

TLS material matches the reference cryptogen (internal/cryptogen/ca +
msp.GenerateLocalMSP tls output): each org gets its own TLS CA; every
node dir gains tls/{ca.crt, server.crt, server.key} and every user dir
tls/{ca.crt, client.crt, client.key}.
"""

from __future__ import annotations

import argparse
import os
import sys

from fabric_tpu_torch.common import yamlsub
from fabric_tpu_torch.common.crypto import CA, key_pem
from fabric_tpu_torch.msp.config import write_msp_dir


def _emit_node(base: str, ca: CA, name: str, ou: str, node_ous: bool = True,
               tlsca: CA | None = None, server: bool = False):
    pair = ca.issue(name, ous=[ou])
    d = os.path.join(base, "msp")
    write_msp_dir(
        d, ca, node_ous=node_ous,
        signer_cert_pem=pair.cert_pem, signer_key_pem=pair.key_pem,
    )
    if tlsca is not None:
        tdir = os.path.join(base, "tls")
        os.makedirs(tdir, exist_ok=True)
        host = name.split(".", 1)[0]
        tpair = tlsca.issue(
            name, sans=[name, host, "localhost", "127.0.0.1"], client=True, server=True
        )
        stem = "server" if server else "client"
        with open(os.path.join(tdir, "ca.crt"), "wb") as f:
            f.write(tlsca.cert_pem)
        with open(os.path.join(tdir, f"{stem}.crt"), "wb") as f:
            f.write(tpair.cert_pem)
        with open(os.path.join(tdir, f"{stem}.key"), "wb") as f:
            f.write(tpair.key_pem)
    return pair


def _gen_org(out_root: str, kind: str, org: dict) -> None:
    domain = org["Domain"]
    base = os.path.join(out_root, f"{kind}Organizations", domain)
    ca = CA(f"ca.{domain}", domain)
    tlsca = CA(f"tlsca.{domain}", domain)
    # org-level MSP (verification material only)
    write_msp_dir(os.path.join(base, "msp"), ca, node_ous=True)
    os.makedirs(os.path.join(base, "ca"), exist_ok=True)
    with open(os.path.join(base, "ca", f"ca.{domain}-cert.pem"), "wb") as f:
        f.write(ca.cert_pem)
    with open(os.path.join(base, "ca", "priv_sk"), "wb") as f:
        f.write(key_pem(ca.key))
    os.makedirs(os.path.join(base, "tlsca"), exist_ok=True)
    with open(
        os.path.join(base, "tlsca", f"tlsca.{domain}-cert.pem"), "wb"
    ) as f:
        f.write(tlsca.cert_pem)

    node_kind = "orderers" if kind == "orderer" else "peers"
    node_ou = "orderer" if kind == "orderer" else "peer"
    hosts = [s["Hostname"] for s in org.get("Specs", [])]
    count = (org.get("Template") or {}).get("Count", 0)
    hosts += [f"peer{i}" for i in range(count)]
    for host in hosts:
        fqdn = f"{host}.{domain}"
        _emit_node(
            os.path.join(base, node_kind, fqdn), ca, fqdn, node_ou,
            tlsca=tlsca, server=True,
        )
    # admin + users
    _emit_node(os.path.join(base, "users", f"Admin@{domain}"), ca,
               f"Admin@{domain}", "admin", tlsca=tlsca)
    for i in range(1, (org.get("Users") or {}).get("Count", 0) + 1):
        _emit_node(os.path.join(base, "users", f"User{i}@{domain}"), ca,
                   f"User{i}@{domain}", "client", tlsca=tlsca)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cryptogen")
    sub = ap.add_subparsers(dest="cmd", required=True)
    gen = sub.add_parser("generate")
    gen.add_argument("--config", required=True)
    gen.add_argument("--output", default="crypto-config")
    args = ap.parse_args(argv)

    conf = yamlsub.load(args.config) or {}
    for org in conf.get("OrdererOrgs") or []:
        _gen_org(args.output, "orderer", org)
    for org in conf.get("PeerOrgs") or []:
        _gen_org(args.output, "peer", org)
    print(f"crypto material written to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
