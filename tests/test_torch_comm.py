"""The port's `comm` (framed RPC, mutual TLS) and snapshot fetch against
the JAX package's.

- `write_frame` and a client's request frame are the same bytes in both.
- A client of either package calls a server of the other (unary,
  server-streaming, a handler's error, an unknown method), in plain TCP
  and in mutual TLS with certificates from either package's CA.
- A client that trusts another CA, a server whose certificate names
  another host, and a pinned certificate that differs are refused by
  both packages' clients.
- The port CA's TLS certificates carry the JAX CA's extensions: basic
  constraints, key usage, the EKUs asked for, the subject alternative
  names (their DER equal), the key identifiers' form.
- `fetch_snapshot` in both directions: the fetched files equal the
  served ones byte for byte; each package's `verify_snapshot` passes and
  each package joins from them and commits the blocks after the
  snapshot with the original flags; a stream cut at the server's
  ``snapshot.fetch.chunk`` point raises the client's RPCError, and the
  partial directory is refused at import.
- `comm.backoff` draws the same waits and gates alike under a virtual
  clock; `comm.instrument` counts an instrumented server's calls alike.
All checks are exact.
"""

import os
import shutil
from pathlib import Path

import pytest
from cryptography import x509 as cx509

import chip_smoke
from fabric_tpu import comm as jax_comm
from fabric_tpu.comm import rpc as jax_rpc
from fabric_tpu.comm import tls as jax_tls
from fabric_tpu.common import crypto as jax_crypto
from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.csp import SWCSP
from fabric_tpu.devtools import faultline as jax_fl
from fabric_tpu.ledger import snapshot as jax_snap
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu_torch import comm as port_comm
from fabric_tpu_torch.comm import rpc as port_rpc
from fabric_tpu_torch.comm import tls as port_tls
from fabric_tpu_torch.common import crypto as port_crypto
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle_from_genesis,
)
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.devtools import faultline as port_fl
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.ledger import snapshot as port_snap
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb

PKG = {
    "jax": (jax_comm, jax_rpc, jax_tls, jax_crypto),
    "port": (port_comm, port_rpc, port_tls, port_crypto),
}
CH = chip_smoke.VALIDATOR_CHANNEL
N_BLOCKS = 8
N_TXS = 10
SNAP = chip_smoke.SNAP_BLOCK


@pytest.fixture(autouse=True, scope="module")
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


class _Capture:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += bytes(b)


@pytest.mark.parametrize("payload", [b"", b"x", bytes(range(256)) * 300])
def test_write_frame_bytes_are_equal(payload):
    got = []
    for name in ("jax", "port"):
        cap = _Capture()
        PKG[name][1].write_frame(cap, payload)
        got.append(cap.data)
    assert got[0] == got[1] == len(payload).to_bytes(4, "big") + payload


@pytest.mark.parametrize("traced", [False, True])
def test_request_frames_are_equal(traced):
    """What a client writes for one call, with and without a trace token
    (each package's tracing armed with fresh ids)."""
    import contextlib
    import socket
    import threading

    from fabric_tpu.common import tracing as jax_tr
    from fabric_tpu_torch.common import tracing as port_tr

    frames = []
    for name, tr in (("jax", jax_tr), ("port", port_tr)):
        lsock = socket.create_server(("127.0.0.1", 0))

        def serve(lsock=lsock, rpc=PKG[name][1]):
            conn, _ = lsock.accept()
            with conn:
                frames.append(rpc.read_frame(conn))
                rpc.write_frame(conn, bytes([rpc.KIND_END]))

        t = threading.Thread(target=serve)
        t.start()
        scope = tr.scope() if traced else contextlib.nullcontext()
        with scope:
            PKG[name][0].RPCClient(*lsock.getsockname()).call("m", b"body")
        t.join()
        lsock.close()
    assert frames[0] == frames[1]
    assert frames[0].startswith(b"\x06\x011.1\x01m" if traced else b"\x01m")


def _handlers(server):
    server.register("echo", lambda body, st: body[::-1])
    server.register("count", lambda body, st: (b"%d" % i for i in range(
        int(body))))
    server.register("none", lambda body, st: None)

    def fail(body, st):
        raise ValueError("handler says no")

    server.register("fail", fail)


def _creds(ca_pkg: str, ca, tls_pkg: str, cn: str):
    return PKG[tls_pkg][2].credentials_from_ca(ca, cn)


MATRIX = [(s, c, ca, t) for s in ("jax", "port") for c in ("jax", "port")
          if s != c for ca in ("jax", "port") for t in (False, True)
          if t or ca == "jax"]


@pytest.mark.parametrize("server_pkg,client_pkg,ca_pkg,tls", MATRIX)
def test_calls_cross_the_packages(server_pkg, client_pkg, ca_pkg, tls):
    ca = PKG[ca_pkg][3].CA("tlsca.example.com", "example.com")
    s_tls = _creds(ca_pkg, ca, server_pkg, "server") if tls else None
    c_tls = _creds(ca_pkg, ca, client_pkg, "client") if tls else None
    server = PKG[server_pkg][0].RPCServer(tls=s_tls)
    _handlers(server)
    seen = []
    server.register("peer", lambda body, st: seen.append(st.peer_cert))
    server.start()
    try:
        client = PKG[client_pkg][0].RPCClient(*server.addr, tls=c_tls)
        assert client.call("echo", b"abc") == b"cba"
        assert client.call("none") == b""
        assert list(client.stream("count", b"4")) == [b"0", b"1", b"2", b"3"]
        with pytest.raises(PKG[client_pkg][1].RPCError, match="handler says"):
            client.call("fail")
        with pytest.raises(PKG[client_pkg][1].RPCError, match="no method"):
            client.call("missing")
        client.call("peer")
        # the handler sees the client's certificate, DER
        assert seen == [c_tls.cert_der if tls else None]
    finally:
        server.stop()


REFUSALS = ["wrong_ca", "wrong_san", "pinned"]


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
@pytest.mark.parametrize("how", REFUSALS)
def test_both_clients_refuse(client_pkg, how):
    server_pkg = "port" if client_pkg == "jax" else "jax"
    ca = PKG[server_pkg][3].CA("tlsca.example.com", "example.com")
    other = PKG[client_pkg][3].CA("other.example.com", "other.com")
    if how == "wrong_san":
        pair = ca.issue("server", sans=["elsewhere.example.com"],
                        client=True, server=True)
        s_tls = PKG[server_pkg][2].TLSCredentials(
            pair.cert_pem, pair.key_pem, [ca.cert_pem])
    else:
        s_tls = PKG[server_pkg][2].credentials_from_ca(ca, "server")
    c_tls = PKG[client_pkg][2].credentials_from_ca(
        other if how == "wrong_ca" else ca, "client")
    if how == "wrong_ca":
        c_tls.ca_pems = [other.cert_pem]
    if how == "pinned":
        c_tls.pinned_certs = [PKG[client_pkg][2].credentials_from_ca(
            ca, "someone-else").cert_der]
    server = PKG[server_pkg][0].RPCServer(tls=s_tls)
    _handlers(server)
    server.start()
    try:
        client = PKG[client_pkg][0].RPCClient(*server.addr, tls=c_tls)
        want = "not pinned" if how == "pinned" else "tls handshake failed"
        with pytest.raises(PKG[client_pkg][1].RPCError, match=want):
            client.call("echo", b"abc")
    finally:
        server.stop()


def _ext_view(pem: bytes) -> list:
    """Each extension's OID and criticality, and its value where it does
    not depend on the key (SAN, EKU, key usage, basic constraints)."""
    cert = cx509.load_pem_x509_certificate(pem)
    out = []
    for e in cert.extensions:
        v = e.value
        if isinstance(v, (cx509.SubjectKeyIdentifier,
                          cx509.AuthorityKeyIdentifier)):
            v = (type(v).__name__, len(v.digest if hasattr(v, "digest")
                                       else v.key_identifier))
        else:
            v = v.public_bytes()
        out.append((e.oid.dotted_string, e.critical, v))
    return out


@pytest.mark.parametrize("sans,client,server", [
    (None, True, False), (["localhost", "127.0.0.1", "::1"], True, True),
    (["peer0.org1.example.com"], False, True), (None, False, False)])
def test_issued_tls_certificates_carry_the_reference_extensions(
        sans, client, server):
    views = []
    for name in ("jax", "port"):
        ca = PKG[name][3].CA("ca.example.com", "example.com")
        pair = ca.issue("peer0", ous=["peer"], sans=sans, client=client,
                        server=server)
        views.append(_ext_view(pair.cert_pem))
    assert views[0] == views[1]


def test_the_port_certifies_a_key_held_elsewhere():
    from fabric_tpu_torch.csp import hostref

    ca = port_crypto.CA("ca.example.com", "example.com")
    key = hostref.key_gen()
    cert = ca.issue_for_public_key("custody", key.public_key(),
                                   sans=["127.0.0.1"], server=True)
    parsed = cx509.load_der_x509_certificate(cert.der)
    assert parsed.public_key().public_numbers().x == key.public_key().x
    assert parsed.extensions.get_extension_for_class(
        cx509.ExtendedKeyUsage).value == cx509.ExtendedKeyUsage(
        [cx509.oid.ExtendedKeyUsageOID.CLIENT_AUTH,
         cx509.oid.ExtendedKeyUsageOID.SERVER_AUTH])


# -- snapshot fetch --------------------------------------------------------


class Chain:
    """One chain committed by both packages, each exporting its snapshot
    at SNAP (byte-identical, as tests/test_torch_snapshot.py holds)."""

    def __init__(self, root: Path):
        self.world = chip_smoke.validator_world(23)
        self.blocks, expect, conflicts = chip_smoke.validator_blocks(
            self.world, N_BLOCKS, N_TXS, self.world.genesis_hash, mvcc=True)
        want = {**expect, **conflicts}
        self.flags = [[want.get((b, i), 0) for i in range(N_TXS)]
                      for b in range(N_BLOCKS)]
        self.jax_bundle = bundle_from_genesis(
            common_pb2.Block.FromString(self.world.genesis), SWCSP())
        self.port_bundle = port_bundle_from_genesis(self.world.genesis)
        jp = JaxProvider(str(root / "jax"), csp=SWCSP())
        jl = jp.create(common_pb2.Block.FromString(self.world.genesis))
        pp = LedgerProvider(str(root / "port"), csp=_port_csp())
        pl = pp.create(cb.Block.decode(self.world.genesis))
        jl.snapshots.submit_request(SNAP)
        pl.snapshots.submit_request(SNAP)
        jc = JaxCommitter(JaxValidator(CH, jl, self.jax_bundle, SWCSP()), jl)
        pc = Committer(TxValidator(CH, pl, self.port_bundle, _port_csp()), pl)
        assert list(jc.store_stream(
            [common_pb2.Block.FromString(b) for b in self.blocks], depth=3)) \
            == list(pc.store_stream(self.blocks, depth=3)) == self.flags
        assert jl.snapshots.wait_idle() and pl.snapshots.wait_idle()
        self.roots = {"jax": jp.snapshots_root, "port": pp.snapshots_root}
        self.dirs = {"jax": jax_snap.completed_snapshot_dir(
            jp.snapshots_root, CH, SNAP),
            "port": port_snap.completed_snapshot_dir(
                pp.snapshots_root, CH, SNAP)}
        jp.close()
        pp.close()


def _port_csp():
    return CUDACSP(device="cpu", min_device_batch=1 << 30)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    return Chain(tmp_path_factory.mktemp("chain"))


def _serve(pkg: str, chain):
    ca = PKG[pkg][3].CA("tlsca.example.com", "example.com")
    server = PKG[pkg][0].RPCServer(
        tls=PKG[pkg][2].credentials_from_ca(ca, "donor"))
    if pkg == "port":
        server.register("admin.SnapshotFetch",
                        port_snap.snapshot_fetch_handler(chain.roots[pkg]))
    else:
        import json

        def handle(body, stream):
            req = json.loads(body.decode())
            return jax_snap.stream_snapshot_dir(jax_snap.completed_snapshot_dir(
                chain.roots["jax"], req["channel"], int(req["block_number"])))

        server.register("admin.SnapshotFetch", handle)
    server.start()
    return server, ca


def _client(pkg: str, server, ca):
    return PKG[pkg][0].RPCClient(
        *server.addr, tls=PKG[pkg][2].credentials_from_ca(ca, "joiner"))


def _dir(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


def _fetch(pkg, client, dest):
    mod = port_snap if pkg == "port" else jax_snap
    return mod.fetch_snapshot(client, CH, SNAP, str(dest))


def _join(pkg: str, chain, snap_dir, root):
    """Join from the snapshot and commit the blocks after it; the flags."""
    if pkg == "port":
        provider = LedgerProvider(str(root), csp=_port_csp())
        ledger = provider.create_from_snapshot(str(snap_dir))
        committer = Committer(TxValidator(CH, ledger, chain.port_bundle,
                                          _port_csp()), ledger)
        flags = list(committer.store_stream(chain.blocks[SNAP:], depth=2))
    else:
        provider = JaxProvider(str(root), csp=SWCSP())
        ledger = provider.create_from_snapshot(str(snap_dir))
        committer = JaxCommitter(JaxValidator(CH, ledger, chain.jax_bundle,
                                              SWCSP()), ledger)
        flags = list(committer.store_stream(
            [common_pb2.Block.FromString(b) for b in chain.blocks[SNAP:]],
            depth=2))
    pairs = list(provider.kv.iterate())
    provider.close()
    return flags, pairs


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_fetch_snapshot_crosses_the_packages(chain, tmp_path, server_pkg):
    client_pkg = "port" if server_pkg == "jax" else "jax"
    server, ca = _serve(server_pkg, chain)
    try:
        got = _fetch(client_pkg, _client(client_pkg, server, ca),
                     tmp_path / "fetched")
    finally:
        server.stop()
    assert _dir(got) == _dir(chain.dirs[server_pkg]) == _dir(
        chain.dirs[client_pkg])
    assert port_snap.verify_snapshot(got) == jax_snap.verify_snapshot(got)
    joined = {pkg: _join(pkg, chain, got, tmp_path / f"join-{pkg}")
              for pkg in ("jax", "port")}
    assert joined["jax"][0] == joined["port"][0] == chain.flags[SNAP:]
    assert joined["jax"][1] == joined["port"][1]


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_a_torn_stream_raises_and_import_refuses(chain, tmp_path,
                                                 server_pkg):
    client_pkg = "port" if server_pkg == "jax" else "jax"
    fl = port_fl if server_pkg == "port" else jax_fl
    server, ca = _serve(server_pkg, chain)
    plan = {"faults": [{"point": "snapshot.fetch.chunk", "action": "raise",
                        "nth": 3}]}
    try:
        with fl.use_plan(plan):
            with pytest.raises(PKG[client_pkg][1].RPCError,
                               match="injected fault at snapshot.fetch"):
                _fetch(client_pkg, _client(client_pkg, server, ca),
                       tmp_path / "partial")
    finally:
        server.stop()
    partial = tmp_path / "partial"
    assert 0 < len(os.listdir(partial)) < len(os.listdir(
        chain.dirs[server_pkg]))
    for pkg in ("jax", "port"):
        snap_mod = port_snap if pkg == "port" else jax_snap
        prov = (LedgerProvider(str(tmp_path / f"j-{pkg}"), csp=_port_csp())
                if pkg == "port"
                else JaxProvider(str(tmp_path / f"j-{pkg}"), csp=SWCSP()))
        with pytest.raises((snap_mod.SnapshotError, OSError)):
            prov.create_from_snapshot(str(partial))
        prov.close()
    shutil.rmtree(partial)


@pytest.mark.parametrize("key", ["org1-peer0|127.0.0.1:7051", "x"])
def test_backoff_draws_the_same_waits(key):
    from fabric_tpu.comm import backoff as jb
    from fabric_tpu_torch.comm import backoff as pb_

    seqs = []
    for mod in (jb, pb_):
        b = mod.DecorrelatedBackoff.for_key(key, base=0.01, cap=0.5)
        waits = [b.next() for _ in range(12)]
        b.reset()
        waits.append(b.next())
        seqs.append(waits)
    assert seqs[0] == seqs[1] and max(seqs[0]) <= 0.5


def test_backoff_gates_alike_under_a_virtual_clock():
    from fabric_tpu.comm import backoff as jb
    from fabric_tpu.devtools import clockskew as jclk
    from fabric_tpu_torch.comm import backoff as pb_
    from fabric_tpu_torch.devtools import clockskew as pclk

    trails = []
    for mod, clk in ((jb, jclk), (pb_, pclk)):
        with clk.use_virtual(clk.VirtualClock()):
            gate = mod.BackoffGate.for_key("k", base=1.0, cap=8.0)
            trail = [gate.ready()]
            for _ in range(4):
                wait = gate.arm()
                trail += [round(wait, 9), gate.ready()]
                clk.advance(wait)
                trail.append(gate.ready())
            gate.clear()
            trail.append(gate.ready())
        trails.append(trail)
    assert trails[0] == trails[1]


def test_instrumented_servers_count_alike():
    from fabric_tpu.comm.instrument import instrument as jinst
    from fabric_tpu.common import metrics as jm
    from fabric_tpu_torch.comm.instrument import instrument as pinst
    from fabric_tpu_torch.common import metrics as pm

    got = []
    for name, inst, m in (("jax", jinst, jm), ("port", pinst, pm)):
        prom = m.PrometheusProvider()
        server = PKG[name][0].RPCServer()
        _handlers(server)
        inst(server, prom)
        server.start()
        try:
            client = PKG[name][0].RPCClient(*server.addr)
            client.call("echo", b"x")
            list(client.stream("count", b"2"))
            with pytest.raises(PKG[name][1].RPCError):
                client.call("fail")
        finally:
            server.stop()
        got.append(sorted(line for line in prom.registry.expose().splitlines()
                          if line.startswith("rpc_server_requests_completed")))
    assert got[0] == got[1] and len(got[0]) == 3
