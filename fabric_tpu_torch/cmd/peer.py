"""peer CLI (the port's copy of `fabric_tpu/cmd/peer.py`; reference
cmd/peer + internal/peer/**): node daemon, channel ops, chaincode
invoke/query, lifecycle commands, snapshots.

    peer node start --listen :7051 --root /var/peer --mspid Org1MSP \
        --msp-dir .../peers/peer0.org1/msp --orderer 127.0.0.1:7050 \
        --chaincode mycc=my_pkg.chaincodes:MyCC
    peer channel join --block ch.block --peer :7051
    peer channel list --peer :7051
    peer channel fetch newest out.block -c ch --peer :7051 --mspid ... \
        --msp-dir ...
    peer chaincode invoke -C ch -n mycc -a put -a k -a v --peer :7051 \
        --orderer :7050 --mspid ... --msp-dir ...
    peer chaincode query  -C ch -n mycc -a get -a k --peer :7051 ...
    peer lifecycle queryinstalled/querycommitted/...
    peer snapshot submitrequest -c ch -b 500 --peer :7051
    peer snapshot listpending -c ch --peer :7051
    peer snapshot joinbysnapshot --snapshotpath .../completed/ch/499 \
        --peer :7051
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from fabric_tpu_torch.cmd.common import (
    endorse,
    load_signer,
    parse_endpoint,
    submit,
    tls_from_args,
    tls_parent,
)
from fabric_tpu_torch.comm import RPCClient
from fabric_tpu_torch.comm.rpc import KeepaliveOptions
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import lifecycle as lcpb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb


def _signer(args):
    return load_signer(args.msp_dir, args.mspid)


def cmd_node_start(args) -> int:
    from fabric_tpu_torch.common.config import Config
    from fabric_tpu_torch.common.diag import install_signal_handler
    from fabric_tpu_torch.csp import csp_from_config
    from fabric_tpu_torch.node.peer_node import PeerNode

    install_signal_handler()  # SIGUSR1 -> thread dump (common/diag)
    # core.yaml (FABRIC_CFG_PATH) + CORE_* env supply defaults the flags
    # can override (viper precedence)
    cfg = Config.load("core", "CORE")
    host, port = parse_endpoint(args.listen)
    node = PeerNode(
        args.root,
        # the bccsp block selects SW/TPU (CUDACSP on bccsp.tpu.device)
        # and the SKI-keyed file keystore
        csp_from_config(cfg),
        load_signer(args.msp_dir, args.mspid),
        host=host,
        port=port,
        chaincode_specs=args.chaincode,
        orderer_endpoints=[parse_endpoint(o) for o in args.orderer],
        operations_port=args.operations_port,
        endorser_concurrency=cfg.get_int(
            "peer.limits.concurrency.endorserService", 2500
        ),
        deliver_concurrency=cfg.get_int(
            "peer.limits.concurrency.deliverService", 2500
        ),
        tls=tls_from_args(args),
        keepalive=KeepaliveOptions.from_config(cfg),
    )
    if cfg.get_bool("peer.profile.enabled", False):
        # continuous profscope sampling (reference cmd/peer/main.go:10 +
        # core/peer/config.go:83-85 ProfileEnabled gates pprof the same
        # way).  The speedscope document is served from the operations
        # endpoint (GET /profile, /profile/heap) — the old standalone
        # ProfileServer listener is retired
        from fabric_tpu_torch.common import profile

        if not profile.enabled():
            # FABRIC_TPU_PROFILE may already have armed a tuned cadence
            profile.arm()
        if node.operations is not None:
            profile.set_lock_metrics(node.operations.lock_metrics())
            print(
                f"profiling armed: GET /profile on operations port "
                f"{args.operations_port}",
                flush=True,
            )
        else:
            print("profiling armed (no operations port: export via "
                  "common.profile.dump_to)", flush=True)
    gossip_bootstrap = list(args.gossip_bootstrap) or [
        str(b) for b in (cfg.get("peer.gossip.bootstrap") or [])
    ]
    if args.gossip_listen:
        node.enable_gossip(
            parse_endpoint(args.gossip_listen),
            gossip_bootstrap,
            fanout=cfg.get_int("peer.gossip.fanout", 3),
            store_capacity=cfg.get_int(
                "peer.gossip.maxBlockCountToStore", 200
            ),
            tick_interval_s=cfg.get_duration(
                "peer.gossip.pullInterval", 4.0
            ),
            identity_ttl_s=cfg.get_duration(
                "peer.gossip.identityExpiration", 3600.0
            ),
            reconcile_interval_s=cfg.get_duration(
                "peer.gossip.pvtData.reconcileSleepInterval", 60.0
            ),
        )
    node.start()
    print(f"peer listening on {node.addr[0]}:{node.addr[1]}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    node.stop()
    from fabric_tpu_torch.common import profile as _profile

    _profile.disarm()  # joins the sampler thread; no-op when disarmed
    return 0


def cmd_node_rebuild_dbs(args) -> int:
    from fabric_tpu_torch.ledger import admin

    ids = admin.rebuild_dbs(args.root, args.channel)
    for lid in ids:
        h = admin.verify_rebuild(args.root, lid)
        print(f"rebuilt state/history DBs for {lid} (height {h})")
    return 0


def cmd_node_rollback(args) -> int:
    from fabric_tpu_torch.ledger import admin

    h = admin.rollback(args.root, args.channel, args.block_number)
    print(f"rolled back {args.channel} to height {h}")
    return 0


def cmd_node_reset(args) -> int:
    from fabric_tpu_torch.ledger import admin

    for lid, h in admin.reset(args.root).items():
        print(f"reset {lid} to height {h}")
    return 0


def cmd_channel_join(args) -> int:
    with open(args.block, "rb") as f:
        raw = f.read()
    out = RPCClient(*parse_endpoint(args.peer), tls=tls_from_args(args)).call(
        "admin.JoinChannel", raw
    )
    print(f"joined channel {out.decode()}")
    return 0


def cmd_channel_list(args) -> int:
    """List channels from a peer (admin.Channels) or, with --orderer,
    from the orderer's channel-participation API (reference osnadmin
    channel list / channelparticipation restapi.go)."""
    if bool(args.peer) == bool(args.orderer):
        print("channel list requires exactly one of --peer/--orderer",
              file=sys.stderr)
        return 2
    if args.peer:
        raw = RPCClient(
            *parse_endpoint(args.peer), tls=tls_from_args(args)
        ).call("admin.Channels")
    else:
        raw = RPCClient(
            *parse_endpoint(args.orderer), tls=tls_from_args(args)
        ).call("participation.List")
    resp = pb.ChannelQueryResponse.decode(raw)
    for ch in resp.channels:
        print(ch.channel_id)
    return 0


def cmd_channel_getinfo(args) -> int:
    raw = RPCClient(*parse_endpoint(args.peer), tls=tls_from_args(args)).call(
        "admin.Height", args.channel.encode()
    )
    print(f"height: {raw.decode()}")
    return 0


def cmd_channel_fetch(args) -> int:
    from fabric_tpu_torch.common.deliver import make_seek_info_envelope

    if not args.peer and not args.orderer:
        print("channel fetch requires --peer or --orderer", file=sys.stderr)
        return 2
    if args.filtered and not args.peer:
        print("channel fetch --filtered requires --peer (the filtered "
              "deliver service is peer-side)", file=sys.stderr)
        return 2
    signer = _signer(args) if args.msp_dir else None
    pos = args.position
    if args.filtered:
        start = stop = pos if pos in ("newest", "oldest") else int(pos)
        return _fetch_filtered(args, make_seek_info_envelope(
            args.channel, start, stop, signer=signer))
    target = args.peer or args.orderer
    client = RPCClient(*parse_endpoint(target), tls=tls_from_args(args))

    def fetch(at):
        method = "deliver.Deliver" if args.peer else "ab.Deliver"
        env = make_seek_info_envelope(args.channel, at, at, signer=signer)
        got = None
        for raw in client.stream(method, env.encode()):
            resp = ob.DeliverResponse.decode(raw)
            if resp.which("Type") == "block":
                got = resp.block
        return got

    if pos == "config":
        # the newest block names the last config block in its metadata
        # (reference peer channel fetch config)
        newest = fetch("newest")
        blk = None if newest is None else fetch(_last_config_index(newest))
    else:
        blk = fetch(pos if pos in ("newest", "oldest") else int(pos))
    if blk is None:
        print("no block received", file=sys.stderr)
        return 1
    with open(args.out, "wb") as f:
        f.write(blk.encode())
    print(f"wrote block {blk.header.number} to {args.out}")
    return 0


def _last_config_index(block: cb.Block) -> int:
    """The LastConfig index of a block's orderer metadata."""
    meta = cb.Metadata.decode(block.metadata.metadata[cb.SIGNATURES])
    if not meta.value:
        return 0
    return cb.OrdererBlockMetadata.decode(meta.value).last_config.index


def _fetch_filtered(args, env) -> int:
    """`channel fetch --filtered`: pull through the peer's filtered
    deliver service (reference peer/deliverevents.go DeliverFiltered) —
    txids + validation codes, no payloads."""
    fblk = None
    for raw in RPCClient(
        *parse_endpoint(args.peer), tls=tls_from_args(args)
    ).stream("deliver.DeliverFiltered", env.encode()):
        resp = pb.DeliverResponse.decode(raw)
        if resp.which("Type") == "filtered_block":
            fblk = resp.filtered_block
    if fblk is None:
        print("no filtered block received", file=sys.stderr)
        return 1
    with open(args.out, "wb") as f:
        f.write(fblk.encode())
    for ftx in fblk.filtered_transactions:
        print(f"{ftx.txid or '-'} {ftx.tx_validation_code}")
    print(f"wrote filtered block {fblk.number} to {args.out}")
    return 0


def _cc_args(args) -> list[bytes]:
    return [a.encode("utf-8") for a in args.arg or []]


def cmd_chaincode_invoke(args) -> int:
    signer = _signer(args)
    peers = [parse_endpoint(p) for p in args.peer]
    prop, responses = endorse(
        peers, signer, args.channel, args.name, _cc_args(args),
        tls=tls_from_args(args),
    )
    for r in responses:
        # same success range create_signed_tx enforces (2xx/3xx)
        if not (200 <= r.response.status < 400):
            print(f"endorsement failed: {r.response.message}",
                  file=sys.stderr)
            return 1
    status = submit(
        parse_endpoint(args.orderer), signer, prop, responses,
        tls=tls_from_args(args),
    )
    ok = status == cb.SUCCESS
    print("committed" if ok else f"broadcast status {status}")
    return 0 if ok else 1


def cmd_chaincode_query(args) -> int:
    signer = _signer(args)
    _, responses = endorse(
        [parse_endpoint(args.peer[0])], signer, args.channel, args.name,
        _cc_args(args), tls=tls_from_args(args),
    )
    r = responses[0]
    if not (200 <= r.response.status < 400):
        print(f"query failed: {r.response.message}", file=sys.stderr)
        return 1
    sys.stdout.buffer.write(r.response.payload)
    sys.stdout.write("\n")
    return 0


def _lifecycle_call(args, fn_name: str, payload: bytes, channel: str = ""):
    """Endorse a _lifecycle invocation on the given peers; raises on a
    non-2xx endorsement (same guard as chaincode invoke/query)."""
    peers = [parse_endpoint(p) for p in args.peer]
    prop, resps = endorse(
        peers, _signer(args), channel or getattr(args, "channel", ""),
        "_lifecycle", [fn_name.encode(), payload], tls=tls_from_args(args),
    )
    for r in resps:
        if not (200 <= r.response.status < 400):
            raise SystemExit(
                f"{fn_name} failed ({r.response.status}): {r.response.message}"
            )
    return prop, resps


def cmd_lifecycle_package(args) -> int:
    from fabric_tpu_torch.chaincode.platforms import package_chaincode

    pkg = package_chaincode(args.path, args.label, args.lang)
    with open(args.output, "wb") as f:
        f.write(pkg)
    print(f"wrote {args.output} ({len(pkg)} bytes, label {args.label})")
    return 0


def cmd_lifecycle_install(args) -> int:
    with open(args.package, "rb") as f:
        pkg = f.read()
    req = lcpb.InstallChaincodeArgs(chaincode_install_package=pkg)
    _, resps = _lifecycle_call(args, "InstallChaincode", req.encode())
    res = lcpb.InstallChaincodeResult.decode(resps[0].response.payload)
    print(f"installed {res.package_id} (label {res.label})")
    return 0


def cmd_lifecycle_queryinstalled(args) -> int:
    _, resps = _lifecycle_call(args, "QueryInstalledChaincodes", b"")
    res = lcpb.QueryInstalledChaincodesResult.decode(
        resps[0].response.payload
    )
    for ic in res.installed_chaincodes:
        print(f"{ic.package_id}\t{ic.label}")
    return 0


def _definition_from(args):
    return lcpb.ChaincodeDefinition(
        sequence=args.sequence, name=args.name, version=args.version,
    )


def cmd_lifecycle_approve(args) -> int:
    req = lcpb.ApproveChaincodeDefinitionForMyOrgArgs(
        definition=_definition_from(args)
    )
    if args.package_id:
        req.source = lcpb.ChaincodeSource(
            local_package=lcpb.Local(package_id=args.package_id))
    prop, resps = _lifecycle_call(
        args, "ApproveChaincodeDefinitionForMyOrg", req.encode()
    )
    status = submit(parse_endpoint(args.orderer), _signer(args), prop, resps,
                    tls=tls_from_args(args))
    print(f"approval submitted: {status}")
    return 0 if status == 200 else 1


def cmd_lifecycle_checkreadiness(args) -> int:
    req = lcpb.CheckCommitReadinessArgs(definition=_definition_from(args))
    _, resps = _lifecycle_call(
        args, "CheckCommitReadiness", req.encode()
    )
    res = lcpb.CheckCommitReadinessResult.decode(resps[0].response.payload)
    for org, approved in sorted(res.approvals.items()):
        print(f"{org}: {approved}")
    return 0


def cmd_lifecycle_commit(args) -> int:
    req = lcpb.CommitChaincodeDefinitionArgs(definition=_definition_from(args))
    prop, resps = _lifecycle_call(
        args, "CommitChaincodeDefinition", req.encode()
    )
    status = submit(parse_endpoint(args.orderer), _signer(args), prop, resps,
                    tls=tls_from_args(args))
    print(f"commit submitted: {status}")
    return 0 if status == 200 else 1


def cmd_lifecycle_querycommitted(args) -> int:
    if args.name:
        req = lcpb.QueryChaincodeDefinitionArgs(name=args.name)
        _, resps = _lifecycle_call(
            args, "QueryChaincodeDefinition", req.encode()
        )
        res = lcpb.QueryChaincodeDefinitionResult.decode(
            resps[0].response.payload
        )
        d = res.definition
        print(f"{d.name} v{d.version} seq {d.sequence}")
    else:
        req = lcpb.QueryChaincodeDefinitionsArgs()
        _, resps = _lifecycle_call(
            args, "QueryChaincodeDefinitions", req.encode()
        )
        res = lcpb.QueryChaincodeDefinitionsResult.decode(
            resps[0].response.payload
        )
        for info in res.chaincode_definitions:
            d = info.definition
            print(f"{info.name} v{d.version} seq {d.sequence}")
    return 0


def cmd_node_pause(args) -> int:
    from fabric_tpu_torch.ledger import admin

    admin.pause(args.root, args.channel)
    print(f"channel {args.channel} paused")
    return 0


def cmd_node_resume(args) -> int:
    from fabric_tpu_torch.ledger import admin

    admin.resume(args.root, args.channel)
    print(f"channel {args.channel} resumed")
    return 0


def cmd_node_upgrade_dbs(args) -> int:
    from fabric_tpu_torch.ledger import admin

    rebuilt = admin.upgrade_dbs(args.root)
    print("up to date" if not rebuilt else f"rebuilt: {', '.join(rebuilt)}")
    return 0


def cmd_snapshot_submitrequest(args) -> int:
    """Request a channel snapshot at a block number (0 = the last
    committed block, generated immediately); future blocks auto-trigger
    at commit (reference peer snapshot submitrequest)."""
    import json

    payload = json.dumps(
        {"channel": args.channel, "block_number": args.block_number}
    ).encode()
    raw = RPCClient(*parse_endpoint(args.peer), tls=tls_from_args(args)).call(
        "admin.SnapshotSubmit", payload
    )
    res = json.loads(raw.decode())
    if res.get("snapshot_dir"):
        print(f"snapshot generated at {res['snapshot_dir']}")
    else:
        print(
            f"snapshot request submitted for block {res['block_number']}"
        )
    return 0


def cmd_snapshot_cancelrequest(args) -> int:
    import json

    payload = json.dumps(
        {"channel": args.channel, "block_number": args.block_number}
    ).encode()
    RPCClient(*parse_endpoint(args.peer), tls=tls_from_args(args)).call(
        "admin.SnapshotCancel", payload
    )
    print(f"cancelled snapshot request for block {args.block_number}")
    return 0


def cmd_snapshot_listpending(args) -> int:
    import json

    raw = RPCClient(*parse_endpoint(args.peer), tls=tls_from_args(args)).call(
        "admin.SnapshotList", args.channel.encode()
    )
    pending = json.loads(raw.decode())
    print(
        "pending: " + (", ".join(str(n) for n in pending) if pending else "none")
    )
    return 0


def cmd_snapshot_fetch(args) -> int:
    """Stream a COMPLETED snapshot from a REMOTE peer into a local
    directory (no shared disk required), then optionally join from it.
    The fetched directory is verified the same way a local one is:
    verify-on-import recomputes every file digest, so a torn or
    tampered stream is refused at join time."""
    from fabric_tpu_torch.ledger import snapshot as snap

    client = RPCClient(*parse_endpoint(args.frompeer),
                       tls=tls_from_args(args))
    dest = snap.fetch_snapshot(
        client, args.channel, args.block_number, args.out
    )
    print(f"fetched snapshot for {args.channel}@{args.block_number} "
          f"into {dest}")
    if args.join_via:
        raw = RPCClient(
            *parse_endpoint(args.join_via), tls=tls_from_args(args)
        ).call("admin.JoinBySnapshot", dest.encode())
        print(f"joined channel {raw.decode()} from fetched snapshot")
    return 0


def cmd_snapshot_joinbysnapshot(args) -> int:
    """Join a channel from a snapshot directory: the peer bootstraps a
    blockless ledger at the snapshot height and catches up from the
    orderer from there (reference peer channel joinbysnapshot)."""
    raw = RPCClient(*parse_endpoint(args.peer), tls=tls_from_args(args)).call(
        "admin.JoinBySnapshot", args.snapshotpath.encode()
    )
    print(f"joined channel {raw.decode()} from snapshot")
    return 0


def cmd_channel_create(args) -> int:
    """Create a channel: submit its genesis block to the orderer's
    channel-participation API (the reference's post-system-channel flow:
    osnadmin channel join / channelparticipation restapi.go)."""
    with open(args.file, "rb") as f:
        raw = f.read()
    out = RPCClient(
        *parse_endpoint(args.orderer), tls=tls_from_args(args)
    ).call("participation.Join", raw)
    print(f"channel {out.decode()} created")
    return 0


def cmd_channel_update(args) -> int:
    """Submit a signed CONFIG_UPDATE envelope (reference peer channel
    update)."""
    with open(args.file, "rb") as f:
        raw = f.read()
    resp = ob.BroadcastResponse.decode(
        RPCClient(
            *parse_endpoint(args.orderer), tls=tls_from_args(args)
        ).call("ab.Broadcast", raw)
    )
    print(f"update status: {resp.status}")
    return 0 if resp.status == 200 else 1


def cmd_channel_signconfigtx(args) -> int:
    """Add this identity's signature to a config-update envelope in
    place (reference peer channel signconfigtx)."""
    from fabric_tpu_torch import protoutil

    signer = load_signer(args.msp_dir, args.mspid)
    with open(args.file, "rb") as f:
        env = cb.Envelope.decode(f.read())
    payload = cb.Payload.decode(env.payload)
    cue = cb.ConfigUpdateEnvelope.decode(payload.data)
    shdr = protoutil.make_signature_header(
        signer.serialize(), protoutil.random_nonce()
    ).encode()
    cue.signatures = [*cue.signatures, cb.ConfigSignature(
        signature_header=shdr,
        signature=signer.sign(shdr + cue.config_update))]
    payload.data = cue.encode()
    env = cb.Envelope(
        payload=payload.encode(),
        signature=signer.sign(payload.encode()),
    )
    with open(args.file, "wb") as f:
        f.write(env.encode())
    print(f"signed config update as {args.mspid}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="peer")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tlsp = tls_parent()

    node = sub.add_parser("node").add_subparsers(dest="sub", required=True)
    start = node.add_parser("start", parents=[tlsp])
    start.add_argument("--listen", default="127.0.0.1:0")
    start.add_argument("--root", default=None)
    start.add_argument("--mspid", required=True)
    start.add_argument("--msp-dir", required=True)
    start.add_argument("--orderer", action="append", default=[])
    start.add_argument("--chaincode", action="append", default=[])
    start.add_argument("--operations-port", type=int, default=None)
    start.add_argument("--gossip-listen", default=None,
                       help="host:port for the gossip transport")
    start.add_argument("--gossip-bootstrap", action="append", default=[],
                       help="bootstrap gossip endpoint (repeatable)")
    start.set_defaults(fn=cmd_node_start)
    # offline repair ops (reference internal/peer/node/{reset,rollback,
    # rebuild_dbs}.go) — run against a STOPPED peer's storage root
    rb = node.add_parser("rebuild-dbs")
    rb.add_argument("--root", required=True)
    rb.add_argument("-c", "--channel", default=None)
    rb.set_defaults(fn=cmd_node_rebuild_dbs)
    ro = node.add_parser("rollback")
    ro.add_argument("--root", required=True)
    ro.add_argument("-c", "--channel", required=True)
    ro.add_argument("-b", "--block-number", type=int, required=True)
    ro.set_defaults(fn=cmd_node_rollback)
    for opname, fn in (("pause", cmd_node_pause), ("resume", cmd_node_resume)):
        op = node.add_parser(opname)
        op.add_argument("--root", required=True)
        op.add_argument("-c", "--channel", required=True)
        op.set_defaults(fn=fn)
    ud = node.add_parser("upgrade-dbs")
    ud.add_argument("--root", required=True)
    ud.set_defaults(fn=cmd_node_upgrade_dbs)
    rs = node.add_parser("reset")
    rs.add_argument("--root", required=True)
    rs.set_defaults(fn=cmd_node_reset)

    chan = sub.add_parser("channel").add_subparsers(dest="sub", required=True)
    create = chan.add_parser("create", parents=[tlsp])
    create.add_argument("-f", "--file", required=True,
                        help="genesis block for the new channel")
    create.add_argument("--orderer", required=True)
    create.set_defaults(fn=cmd_channel_create)
    upd = chan.add_parser("update", parents=[tlsp])
    upd.add_argument("-f", "--file", required=True,
                     help="signed CONFIG_UPDATE envelope")
    upd.add_argument("--orderer", required=True)
    upd.set_defaults(fn=cmd_channel_update)
    sct = chan.add_parser("signconfigtx")
    sct.add_argument("-f", "--file", required=True)
    sct.add_argument("--mspid", required=True)
    sct.add_argument("--msp-dir", required=True)
    sct.set_defaults(fn=cmd_channel_signconfigtx)
    join = chan.add_parser("join", parents=[tlsp])
    join.add_argument("--block", required=True)
    join.add_argument("--peer", required=True)
    join.set_defaults(fn=cmd_channel_join)
    lst = chan.add_parser("list", parents=[tlsp])
    lst.add_argument("--peer")
    lst.add_argument("--orderer")
    lst.set_defaults(fn=cmd_channel_list)
    info = chan.add_parser("getinfo", parents=[tlsp])
    info.add_argument("-c", "--channel", required=True)
    info.add_argument("--peer", required=True)
    info.set_defaults(fn=cmd_channel_getinfo)
    fetch = chan.add_parser("fetch", parents=[tlsp])
    fetch.add_argument("position")  # newest | oldest | config | block number
    fetch.add_argument("out")
    fetch.add_argument("-c", "--channel", required=True)
    fetch.add_argument("--peer")
    fetch.add_argument("--orderer")
    fetch.add_argument("--mspid")
    fetch.add_argument("--msp-dir")
    fetch.add_argument("--filtered", action="store_true",
                       help="use the peer's filtered deliver service")
    fetch.set_defaults(fn=cmd_channel_fetch)

    snap = sub.add_parser("snapshot").add_subparsers(dest="sub", required=True)
    for name, fn, needs_block in (
        ("submitrequest", cmd_snapshot_submitrequest, False),
        ("cancelrequest", cmd_snapshot_cancelrequest, True),
        ("listpending", cmd_snapshot_listpending, False),
    ):
        p = snap.add_parser(name, parents=[tlsp])
        p.add_argument("-c", "--channel", required=True)
        p.add_argument("--peer", required=True)
        if name != "listpending":
            p.add_argument(
                "-b", "--block-number", type=int,
                required=needs_block, default=0,
                help="0 = snapshot the last committed block now",
            )
        p.set_defaults(fn=fn)
    jbs = snap.add_parser("joinbysnapshot", parents=[tlsp])
    jbs.add_argument("--snapshotpath", required=True,
                     help="completed snapshot directory on the peer host")
    jbs.add_argument("--peer", required=True)
    jbs.set_defaults(fn=cmd_snapshot_joinbysnapshot)
    sf = snap.add_parser("fetch", parents=[tlsp])
    sf.add_argument("-c", "--channel", required=True)
    sf.add_argument("-b", "--block-number", type=int, required=True)
    sf.add_argument("--frompeer", required=True,
                    help="remote peer serving admin.SnapshotFetch")
    sf.add_argument("--out", required=True,
                    help="local directory to receive the snapshot")
    sf.add_argument("--join-via", default=None,
                    help="optionally join a LOCAL peer from the fetched "
                         "snapshot (its admin endpoint)")
    sf.set_defaults(fn=cmd_snapshot_fetch)

    cc = sub.add_parser("chaincode").add_subparsers(dest="sub", required=True)
    for name, fn, needs_orderer in (
        ("invoke", cmd_chaincode_invoke, True),
        ("query", cmd_chaincode_query, False),
    ):
        p = cc.add_parser(name, parents=[tlsp])
        p.add_argument("-C", "--channel", required=True)
        p.add_argument("-n", "--name", required=True)
        p.add_argument("-a", "--arg", action="append", default=[])
        p.add_argument("--peer", action="append", required=True)
        if needs_orderer:
            p.add_argument("--orderer", required=True)
        p.add_argument("--mspid", required=True)
        p.add_argument("--msp-dir", required=True)
        p.set_defaults(fn=fn)

    lc = sub.add_parser("lifecycle").add_subparsers(dest="sub", required=True)
    lcc = lc.add_parser("chaincode").add_subparsers(dest="op", required=True)
    pkg = lcc.add_parser("package")
    pkg.add_argument("output")
    pkg.add_argument("--path", required=True)
    pkg.add_argument("--label", required=True)
    pkg.add_argument("--lang", default="python")
    pkg.set_defaults(fn=cmd_lifecycle_package)
    for name, fn in (
        ("install", cmd_lifecycle_install),
        ("queryinstalled", cmd_lifecycle_queryinstalled),
        ("approveformyorg", cmd_lifecycle_approve),
        ("checkcommitreadiness", cmd_lifecycle_checkreadiness),
        ("commit", cmd_lifecycle_commit),
        ("querycommitted", cmd_lifecycle_querycommitted),
    ):
        p = lcc.add_parser(name, parents=[tlsp])
        p.add_argument("--peer", action="append", required=True)
        p.add_argument("--mspid", required=True)
        p.add_argument("--msp-dir", required=True)
        if name == "install":
            p.add_argument("package")
        if name in ("approveformyorg", "checkcommitreadiness", "commit",
                    "querycommitted", "queryinstalled", "install"):
            p.add_argument("-C", "--channel", default="")
        if name in ("approveformyorg", "checkcommitreadiness", "commit"):
            p.add_argument("-n", "--name", required=True)
            p.add_argument("-v", "--version", required=True)
            p.add_argument("--sequence", type=int, required=True)
            p.add_argument("--package-id", default="")
        if name == "querycommitted":
            p.add_argument("-n", "--name", default="")
        if name in ("approveformyorg", "commit"):
            p.add_argument("--orderer", required=True)
        p.set_defaults(fn=fn)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
