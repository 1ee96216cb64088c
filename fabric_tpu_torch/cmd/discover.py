"""discover: CLI client for the peer discovery service (the port's copy
of `fabric_tpu/cmd/discover.py`; reference cmd/discover +
discovery/client).

    discover peers   --channel ch --peer :7051 --mspid Org1MSP --msp-dir d
    discover config  --channel ch --peer :7051 ...
    discover endorsers --channel ch --chaincode cc --peer :7051 ...
"""

from __future__ import annotations

import argparse
import json
import sys

from fabric_tpu_torch.cmd.common import (
    load_signer,
    parse_endpoint,
    tls_from_args,
    tls_parent,
)
from fabric_tpu_torch.comm import RPCClient
from fabric_tpu_torch.discovery.client import DiscoveryClient, select_endorsers
from fabric_tpu_torch.protos import discovery as dpb


def _client(args) -> DiscoveryClient:
    signer = load_signer(args.msp_dir, args.mspid)
    rpc = RPCClient(*parse_endpoint(args.peer), tls=tls_from_args(args))

    def send(signed: dpb.SignedRequest) -> dpb.Response:
        raw = rpc.call("discovery.Process", signed.encode())
        return dpb.Response.decode(raw)

    return DiscoveryClient(signer, send)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="discover")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tlsp = tls_parent()
    for name in ("peers", "config", "endorsers"):
        p = sub.add_parser(name, parents=[tlsp])
        p.add_argument("--channel", required=True)
        p.add_argument("--peer", required=True)
        p.add_argument("--mspid", required=True)
        p.add_argument("--msp-dir", required=True)
        if name == "endorsers":
            p.add_argument("--chaincode", required=True)
    args = ap.parse_args(argv)
    client = _client(args)

    if args.cmd == "peers":
        out = [
            {
                "endpoint": p.endpoint,
                "ledger_height": p.ledger_height,
                "chaincodes": list(p.chaincodes),
            }
            for p in client.peers(args.channel)
        ]
        print(json.dumps(out, indent=2))
        return 0
    if args.cmd == "config":
        conf = client.config(args.channel)
        print(json.dumps({"msps": sorted(conf.msps)}, indent=2))
        return 0
    desc = client.endorsers(args.channel, args.chaincode)
    sel = select_endorsers(desc)
    print(json.dumps(sorted(s.endpoint for s in sel), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
