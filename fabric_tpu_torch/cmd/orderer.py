"""orderer daemon CLI (the port's copy of `fabric_tpu/cmd/orderer.py`;
reference cmd/orderer + orderer/common/server):

    orderer --listen 127.0.0.1:7050 --root /var/orderer \
        --genesis sys.block [--mspid OrdererMSP --msp-dir .../msp]

The node serves its operations endpoint (/metrics, /healthz, /traces,
...) at orderer.yaml's `operations.listenAddress`
(`ORDERER_OPERATIONS_LISTENADDRESS`; port 0 binds a free port, an empty
value serves none), as the reference orderer does; the JAX package's
orderer CLI serves none.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from fabric_tpu_torch.cmd.common import (
    load_signer,
    parse_endpoint,
    tls_from_args,
    tls_parent,
)
from fabric_tpu_torch.comm.rpc import KeepaliveOptions
from fabric_tpu_torch.csp import csp_from_config
from fabric_tpu_torch.node.orderer_node import OrdererNode
from fabric_tpu_torch.protos import common as cb


def main(argv=None) -> int:
    from fabric_tpu_torch.common.config import Config

    # orderer.yaml (FABRIC_CFG_PATH) + ORDERER_* env supply defaults the
    # flags can override (viper precedence)
    cfg = Config.load("orderer", "ORDERER")
    cfg_listen = "%s:%s" % (
        cfg.get("general.listenAddress", "127.0.0.1"),
        cfg.get_int("general.listenPort", 0),
    )
    ap = argparse.ArgumentParser(prog="orderer", parents=[tls_parent()])
    ap.add_argument("--listen", default=cfg_listen)
    ap.add_argument("--root", default=cfg.get("fileLedger.location"))
    ap.add_argument("--genesis", action="append", default=[])
    ap.add_argument("--mspid", default=cfg.get("general.localMspId"))
    ap.add_argument("--msp-dir")
    args = ap.parse_args(argv)

    blocks = []
    genesis_paths = list(args.genesis)
    if not genesis_paths and cfg.get("general.bootstrapMethod") == "file":
        bf = cfg.get("general.bootstrapFile")
        if bf and os.path.exists(bf):
            genesis_paths.append(bf)
    for path in genesis_paths:
        with open(path, "rb") as f:
            blocks.append(cb.Block.decode(f.read()))
    signer = (
        load_signer(args.msp_dir, args.mspid)
        if args.msp_dir and args.mspid
        else None
    )
    host, port = parse_endpoint(args.listen)
    ops = cfg.get("operations.listenAddress")
    ops_host, ops_port = (parse_endpoint(str(ops)) if ops
                          else ("127.0.0.1", None))
    node = OrdererNode(
        # orderer.yaml General.BCCSP block (reference localconfig)
        args.root, csp_from_config(cfg, prefix="general.bccsp"),
        signer=signer, host=host, port=port,
        keepalive=KeepaliveOptions.from_config(cfg, prefix="general.keepalive"),
        genesis_blocks=blocks, tls=tls_from_args(args),
        operations_port=ops_port, operations_host=ops_host,
    )
    node.start()
    if cfg.get_bool("general.profile.enabled", False):
        # reference orderer/common/server/main.go:410-412
        # initializeProfiling — here the continuous profscope sampler;
        # the speedscope doc is served from the operations endpoint
        # (GET /profile) instead of a standalone pprof listener
        from fabric_tpu_torch.common import profile

        if not profile.enabled():
            profile.arm()
        if node.operations is not None:
            profile.set_lock_metrics(node.operations.lock_metrics())
        print("profiling armed: GET /profile on the operations "
              "endpoint", flush=True)
    if node.operations is not None:
        print("operations endpoint on %s:%d" % node.operations.addr[:2],
              flush=True)
    print(f"orderer listening on {node.addr[0]}:{node.addr[1]}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    node.stop()
    from fabric_tpu_torch.common import profile as _profile

    _profile.disarm()  # joins the sampler thread; no-op when disarmed
    return 0


if __name__ == "__main__":
    sys.exit(main())
