"""configtxlator: proto <-> JSON translation and config update computation
(the port's copy of `fabric_tpu/cmd/configtxlator.py`; reference
internal/configtxlator + cmd/configtxlator), over the proto3 JSON mapping
of the port's codec (`protos/jsonpb.py`).

    configtxlator proto_decode --type common.Block --input b.pb [--output j]
    configtxlator proto_encode --type common.Config --input j.json --output p
    configtxlator compute_update --channel_id ch --original a.pb \
        --updated b.pb --output update.pb
"""

from __future__ import annotations

import argparse
import sys

from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import jsonpb
from fabric_tpu_torch.protos import msp as mspb
from fabric_tpu_torch.protos import orderer as ob

_TYPES = {
    "common.Block": cb.Block,
    "common.Envelope": cb.Envelope,
    "common.Payload": cb.Payload,
    "common.Config": cb.Config,
    "common.ConfigEnvelope": cb.ConfigEnvelope,
    "common.ConfigUpdate": cb.ConfigUpdate,
    "common.ConfigUpdateEnvelope": cb.ConfigUpdateEnvelope,
    "common.Policy": cb.Policy,
    "common.SignaturePolicyEnvelope": cb.SignaturePolicyEnvelope,
    "msp.MSPConfig": mspb.MSPConfig,
    "msp.FabricMSPConfig": mspb.FabricMSPConfig,
    "orderer.SeekInfo": ob.SeekInfo,
}


def _read(path):
    if path in (None, "-"):
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path, data: bytes):
    if path in (None, "-"):
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="configtxlator")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("proto_decode", "proto_encode"):
        p = sub.add_parser(name)
        p.add_argument("--type", required=True, choices=sorted(_TYPES))
        p.add_argument("--input", default="-")
        p.add_argument("--output", default="-")
    cu = sub.add_parser("compute_update")
    cu.add_argument("--channel_id", required=True)
    cu.add_argument("--original", required=True)
    cu.add_argument("--updated", required=True)
    cu.add_argument("--output", default="-")
    args = ap.parse_args(argv)

    if args.cmd == "proto_decode":
        msg = _TYPES[args.type].decode(_read(args.input))
        _write(args.output, jsonpb.message_to_json(msg).encode("utf-8"))
        return 0
    if args.cmd == "proto_encode":
        msg = jsonpb.parse(_read(args.input).decode("utf-8"), _TYPES[args.type])
        _write(args.output, msg.encode())
        return 0

    from fabric_tpu_torch.common.configtx import compute_update

    original = cb.Config.decode(_read(args.original))
    updated = cb.Config.decode(_read(args.updated))
    upd = compute_update(args.channel_id, original, updated)
    _write(args.output, upd.encode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
