"""The port's command-line tools (`cmd.cryptogen`, `cmd.configtxgen`,
`cmd.orderer`, `cmd.peer`) against the JAX package's.

- cryptogen on `tests/test_nwo.py`'s crypto-config.yaml: the same file
  trees, the same parsed certificate fields (names, extensions, validity
  span; keys and serials are random), each key its certificate's.
- configtxgen on the same MSP folders (each package's cryptogen output,
  fed to both): genesis blocks with equal configs, decoded.
- The CLIs' subcommands and flags (their help) are the JAX package's; the
  port's orderer adds no flag, and serves its operations endpoint at
  orderer.yaml's `operations.listenAddress` (ROADMAP Queue C).
- The offline node tools answer the same on copies of one peer root.
- One network of processes: `cmd.orderer` and one `cmd.peer node start`
  (`ORDERER_GENERAL_BCCSP_TPU_DEVICE=cpu`, `CORE_BCCSP_TPU_DEVICE=cpu`:
  without them each would take the card), then join, invoke, query, SIGKILL,
  restart and query again, as `tests/test_nwo.py` does; the peer process
  imports nothing of JAX or of the JAX package.
"""

import contextlib
import io
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

import chip_smoke
from fabric_tpu.cmd import configtxgen as jax_configtxgen
from fabric_tpu.cmd import cryptogen as jax_cryptogen
from fabric_tpu.cmd import orderer as jax_orderer_cli
from fabric_tpu.cmd import peer as jax_peer_cli
from fabric_tpu_torch.cmd import configtxgen as port_configtxgen
from fabric_tpu_torch.cmd import cryptogen as port_cryptogen
from fabric_tpu_torch.cmd import orderer as port_orderer_cli
from fabric_tpu_torch.cmd import peer as port_peer_cli
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.msp import x509
from fabric_tpu_torch.protos import common as cb
from test_torch_config import NWO_CONFIGTX, NWO_CRYPTO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = {"jax": (jax_cryptogen, jax_configtxgen, jax_peer_cli,
               jax_orderer_cli),
       "port": (port_cryptogen, port_configtxgen, port_peer_cli,
                port_orderer_cli)}


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


@pytest.fixture(scope="module")
def material(tmp_path_factory):
    """Each package's cryptogen output of test_nwo's crypto-config.yaml,
    under <root>/<pkg>/crypto-config, with test_nwo's configtx.yaml."""
    out = {}
    for pkg, (cryptogen, *_rest) in CLI.items():
        root = str(tmp_path_factory.mktemp(f"cmd-{pkg}"))
        with open(os.path.join(root, "crypto-config.yaml"), "w") as f:
            f.write(NWO_CRYPTO)
        with open(os.path.join(root, "configtx.yaml"), "w") as f:
            f.write(NWO_CONFIGTX)
        with contextlib.redirect_stdout(io.StringIO()):
            assert cryptogen.main([
                "generate", "--config",
                os.path.join(root, "crypto-config.yaml"), "--output",
                os.path.join(root, "crypto-config")]) == 0
        out[pkg] = root
    return out


def _files(root: str) -> dict:
    tree = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            full = os.path.join(dirpath, n)
            with open(full, "rb") as f:
                tree[os.path.relpath(full, root)] = f.read()
    return tree


_KEYED = (x509.OID_SKI, x509.OID_AKI)


def _fields(cert: x509.Certificate) -> tuple:
    """A certificate's fields that do not depend on its key or serial."""
    return (cert.version, cert.signature_algorithm, cert.issuer,
            cert.subject_attributes,
            cert.not_valid_after - cert.not_valid_before,
            sorted((oid, crit, val) for oid, (crit, val)
                   in cert.extensions.items() if oid not in _KEYED),
            sorted(oid for oid in cert.extensions if oid in _KEYED))


def test_cryptogen_writes_the_same_trees_and_fields(material):
    trees = {pkg: _files(os.path.join(root, "crypto-config"))
             for pkg, root in material.items()}
    assert sorted(trees["port"]) == sorted(trees["jax"])
    n_certs = 0
    for rel, raw in trees["port"].items():
        other = trees["jax"][rel]
        if rel.endswith("config.yaml"):
            assert raw == other, rel
        elif b"CERTIFICATE" in raw:
            mine, theirs = (x509.load_pem_certificates(b)[0]
                            for b in (raw, other))
            assert _fields(mine) == _fields(theirs), rel
            n_certs += 1
        else:  # a private key: its certificate's, in each package
            for tree in trees.values():
                key = x509.load_pem_private_key(tree[rel])
                cert_rel = _cert_of(rel)
                if cert_rel is not None:
                    cert = x509.load_pem_certificates(tree[cert_rel])[0]
                    assert key.public_key().x == cert.public_key.x, rel
    assert n_certs >= 20


def _cert_of(key_rel: str):
    d, name = os.path.split(key_rel)
    if name == "key.pem":
        return os.path.join(os.path.dirname(d), "signcerts", "cert.pem")
    if name in ("server.key", "client.key"):
        return os.path.join(d, name[:-3] + "crt")
    if name == "priv_sk":
        org = os.path.basename(os.path.dirname(d))
        return os.path.join(d, f"ca.{org}-cert.pem")
    return None


def test_configtxgen_builds_equal_configs_on_the_same_folders(material,
                                                              tmp_path):
    configs = {}
    for mat, root in material.items():
        for pkg, (_, configtxgen, *_rest) in CLI.items():
            out = str(tmp_path / f"{mat}-{pkg}.block")
            with contextlib.redirect_stdout(io.StringIO()):
                assert configtxgen.main([
                    "-profile", "OneOrg", "-channelID", "nwoch",
                    "-outputBlock", out, "-configPath", root]) == 0
            with open(out, "rb") as f:
                blk = cb.Block.decode(f.read())
            env = cb.Envelope.decode(blk.data.data[0])
            cfg = cb.ConfigEnvelope.decode(cb.Payload.decode(
                env.payload).data).config
            configs[(mat, pkg)] = cfg.encode(deterministic=True)
            insp = io.StringIO()
            with contextlib.redirect_stdout(insp):
                assert configtxgen.main(["-inspectBlock", out]) == 0
            configs[(mat, pkg, "inspect")] = json.loads(insp.getvalue())
    for mat in material:
        assert configs[(mat, "port")] == configs[(mat, "jax")]
        inspect = [configs[(mat, pkg, "inspect")] for pkg in CLI]
        assert [i["tx_count"] for i in inspect] == [1, 1]
    # the two cryptogen outputs carry different keys: different configs
    assert configs[("port", "port")] != configs[("jax", "port")]


HELP = [
    ["node", "start"], ["node", "rebuild-dbs"], ["node", "rollback"],
    ["node", "reset"], ["node", "pause"], ["node", "resume"],
    ["node", "upgrade-dbs"],
    ["channel", "create"], ["channel", "update"], ["channel", "signconfigtx"],
    ["channel", "join"], ["channel", "list"], ["channel", "getinfo"],
    ["channel", "fetch"],
    ["chaincode", "invoke"], ["chaincode", "query"],
    ["lifecycle", "chaincode", "package"],
    ["lifecycle", "chaincode", "install"],
    ["lifecycle", "chaincode", "queryinstalled"],
    ["lifecycle", "chaincode", "approveformyorg"],
    ["lifecycle", "chaincode", "checkcommitreadiness"],
    ["lifecycle", "chaincode", "commit"],
    ["lifecycle", "chaincode", "querycommitted"],
    ["snapshot", "submitrequest"], ["snapshot", "cancelrequest"],
    ["snapshot", "listpending"], ["snapshot", "fetch"],
    ["snapshot", "joinbysnapshot"],
]


def _help(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(argv + ["--help"])
    return out.getvalue()


@pytest.mark.parametrize("argv", HELP, ids=["-".join(a) for a in HELP])
def test_every_peer_subcommand_has_the_references_flags(argv):
    assert _help(port_peer_cli.main, argv) == _help(jax_peer_cli.main, argv)


def test_the_orderer_cli_adds_only_the_operations_port(monkeypatch):
    """The operations port comes from orderer.yaml, not from a flag: the
    port's orderer takes the JAX package's flags and no other."""
    monkeypatch.setenv("FABRIC_CFG_PATH", os.path.join(REPO, "sampleconfig"))
    port = _help(port_orderer_cli.main, [])
    jax = _help(jax_orderer_cli.main, [])
    flags = {pkg: set(re.findall(r"--[\w-]+", text))
             for pkg, text in (("port", port), ("jax", jax))}
    assert flags["port"] == flags["jax"]
    for pkg, cli in (("jax", jax_cryptogen), ("port", port_cryptogen)):
        assert "generate" in _help(cli.main, [])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Net:
    """test_nwo's network on the port: material from the port's tools, the
    orderer and one peer as processes of its CLIs, mutual TLS."""

    def __init__(self, root: str):
        self.root = root
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = REPO + os.pathsep + root
        self.env["FABRIC_CFG_PATH"] = os.path.join(REPO, "sampleconfig")
        self.env["CORE_BCCSP_TPU_DEVICE"] = "cpu"
        self.env["ORDERER_GENERAL_BCCSP_TPU_DEVICE"] = "cpu"
        self.env["ORDERER_OPERATIONS_LISTENADDRESS"] = "127.0.0.1:0"
        self.env.pop("JAX_PLATFORMS", None)
        self.procs: dict = {}
        cc = os.path.join(root, "crypto-config")
        self.ordo = os.path.join(cc, "ordererOrganizations", "example.com")
        self.org1 = os.path.join(cc, "peerOrganizations", "org1.example.com")
        self.admin = os.path.join(self.org1, "users", "Admin@org1.example.com")
        self.ord_ca = os.path.join(self.ordo, "tlsca",
                                   "tlsca.example.com-cert.pem")
        self.org1_ca = os.path.join(self.org1, "tlsca",
                                    "tlsca.org1.example.com-cert.pem")
        with open(os.path.join(root, "kvcc.py"), "w") as f:
            f.write(chip_smoke.NODES_KV)
        with contextlib.redirect_stdout(io.StringIO()):
            assert port_configtxgen.main([
                "-profile", "OneOrg", "-channelID", "nwoch", "-outputBlock",
                os.path.join(root, "nwoch.block"), "-configPath", root]) == 0

    def _spawn(self, name: str, args: list[str], port: int) -> None:
        log = open(os.path.join(self.root, f"{name}.log"), "ab")
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=self.root, env=self.env,
            stdout=log, stderr=subprocess.STDOUT)
        log.close()
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                return
            except OSError:
                assert self.procs[name].poll() is None, self.log(name)
                assert time.monotonic() < deadline, self.log(name)
                time.sleep(0.05)

    def log(self, name: str) -> str:
        with open(os.path.join(self.root, f"{name}.log"), "rb") as f:
            return f.read()[-3000:].decode("utf-8", "replace")

    def start_orderer(self) -> None:
        self.orderer_port = _free_port()
        node = os.path.join(self.ordo, "orderers", "orderer.example.com")
        self._spawn("orderer", [
            "fabric_tpu_torch.cmd.orderer", "--listen",
            f"127.0.0.1:{self.orderer_port}", "--root", "orderer-root",
            "--genesis", "nwoch.block", "--mspid", "OrdererMSP",
            "--msp-dir", os.path.join(node, "msp"),
            "--tls-dir", os.path.join(node, "tls"),
            "--tls-root", self.org1_ca], self.orderer_port)

    def start_peer(self) -> None:
        self.peer_port = _free_port()
        node = os.path.join(self.org1, "peers", "peer0.org1.example.com")
        self._spawn("peer", [
            "fabric_tpu_torch.cmd.peer", "node", "start", "--listen",
            f"127.0.0.1:{self.peer_port}", "--root", "peer-root",
            "--mspid", "Org1MSP", "--msp-dir", os.path.join(node, "msp"),
            "--orderer", f"127.0.0.1:{self.orderer_port}",
            "--chaincode", "kvcc=kvcc:KV",
            "--tls-dir", os.path.join(node, "tls"),
            "--tls-root", self.ord_ca], self.peer_port)

    def peer_cli(self, *args: str) -> subprocess.CompletedProcess:
        return subprocess.run(
            [sys.executable, "-m", "fabric_tpu_torch.cmd.peer", *args,
             "--tls-dir", os.path.join(self.admin, "tls"),
             "--tls-root", self.ord_ca],
            cwd=self.root, env=self.env, capture_output=True, timeout=60)

    def chaincode(self, op: str, *cc_args: str):
        argv = ["chaincode", op, "-C", "nwoch", "-n", "kvcc"]
        for a in cc_args:
            argv += ["-a", a]
        argv += ["--peer", f"127.0.0.1:{self.peer_port}"]
        if op == "invoke":
            argv += ["--orderer", f"127.0.0.1:{self.orderer_port}"]
        argv += ["--mspid", "Org1MSP",
                 "--msp-dir", os.path.join(self.admin, "msp")]
        return self.peer_cli(*argv)

    def query(self, *cc_args: str) -> bytes:
        out = self.chaincode("query", *cc_args)
        assert out.returncode == 0, out.stderr
        return out.stdout.rstrip(b"\n")

    def height(self) -> int:
        out = self.peer_cli("channel", "getinfo", "-c", "nwoch",
                            "--peer", f"127.0.0.1:{self.peer_port}")
        assert out.returncode == 0, out.stderr
        return int(out.stdout.split(b":")[1])

    def wait_height(self, want: int, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while self.height() < want:
            assert time.monotonic() < deadline, self.log("peer")
            time.sleep(0.1)

    def stop_all(self) -> dict:
        codes = {}
        for name, p in self.procs.items():
            if p.poll() is None:
                p.terminate()
        for name, p in self.procs.items():
            try:
                codes[name] = p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                codes[name] = p.wait()
        return codes


def test_a_network_of_the_ports_processes(material, tmp_path):
    root = str(tmp_path / "net")
    shutil.copytree(material["port"], root)
    net = Net(root)
    try:
        net.start_orderer()
        net.start_peer()
        # the orderer's operations endpoint, at orderer.yaml's address
        # as the environment layer overrides it
        deadline = time.monotonic() + 30
        while not (m := re.search(rb"operations endpoint on ([\d.]+:\d+)",
                                  net.log("orderer").encode())):
            assert time.monotonic() < deadline, net.log("orderer")
            time.sleep(0.05)
        with urllib.request.urlopen(
                f"http://{m.group(1).decode()}/healthz", timeout=10) as r:
            assert r.status == 200
        join = net.peer_cli("channel", "join", "--block", "nwoch.block",
                            "--peer", f"127.0.0.1:{net.peer_port}")
        assert join.returncode == 0, join.stderr
        assert join.stdout.strip() == b"joined channel nwoch"
        out = net.chaincode("invoke", "rw", "r1", "k1", "v1")
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == b"committed"
        net.wait_height(2)
        assert net.query("get", "k1") == b"v1"
        assert json.loads(net.query("modules")) == []
        lst = net.peer_cli("channel", "list",
                           "--peer", f"127.0.0.1:{net.peer_port}")
        assert lst.stdout.split() == [b"nwoch"]
        # SIGKILL, then a restart on the same root: the peer reopens its
        # channel (no join) and keeps its state
        net.procs["peer"].send_signal(signal.SIGKILL)
        net.procs["peer"].wait(timeout=10)
        net.start_peer()
        deadline = time.monotonic() + 30
        while net.chaincode("query", "get", "k1").stdout.rstrip() != b"v1":
            assert time.monotonic() < deadline, net.log("peer")
            time.sleep(0.2)
        out = net.chaincode("invoke", "rw", "k1", "k2", "v2")
        assert out.returncode == 0, out.stderr
        net.wait_height(3)
        assert json.loads(net.query("range")) == {"k1": "v1", "k2": "v2"}
    finally:
        codes = net.stop_all()
    assert codes == {"orderer": 0, "peer": 0}
    # the offline tools, on copies of the stopped peer's root, answer as
    # the reference's
    answers = {}
    for pkg, (*_rest, peer_cli, _orderer) in CLI.items():
        copy = str(tmp_path / f"root-{pkg}")
        shutil.copytree(os.path.join(root, "peer-root"), copy)
        lines = []
        for argv in (["node", "pause", "--root", copy, "-c", "nwoch"],
                     ["node", "resume", "--root", copy, "-c", "nwoch"],
                     ["node", "rebuild-dbs", "--root", copy],
                     ["node", "rollback", "--root", copy, "-c", "nwoch",
                      "-b", "1"],
                     ["node", "upgrade-dbs", "--root", copy],
                     ["node", "reset", "--root", copy]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert peer_cli.main(argv) == 0
            lines.append(out.getvalue())
        answers[pkg] = lines
    assert answers["port"] == answers["jax"]
    assert "rolled back nwoch to height 2" in answers["port"][3]


def _kv_chaincode():
    from fabric_tpu_torch.chaincode import shim

    class KV(shim.Chaincode):
        def invoke(self, stub):
            fn, params = stub.get_function_and_parameters()
            if fn == "put":
                stub.put_state(params[0].decode(), params[1])
                return shim.success()
            return shim.success(stub.get_state(params[0].decode()) or b"")

    return KV()


def _run(cli, argv) -> str:
    """A CLI's stdout, or its exit message."""
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    except SystemExit as exc:
        return f"exit: {exc.code}"
    out.flush()
    return f"rc {rc}: " + re.sub(r"[0-9a-f]{64}", "<hash>",
                                 raw.getvalue().decode())


def test_peer_cli_subcommands_answer_as_the_reference(material, tmp_path):
    """The JAX package's peer CLI and the port's, each against its own
    in-process port orderer and peer nodes started alike (plaintext):
    the same outputs, step by step."""
    from fabric_tpu_torch.cmd.common import load_signer
    from fabric_tpu_torch.csp.cuda.provider import CUDACSP
    from fabric_tpu_torch.node.orderer_node import OrdererNode
    from fabric_tpu_torch.node.peer_node import PeerNode

    root = material["port"]
    cc = os.path.join(root, "crypto-config")
    ordo = os.path.join(cc, "ordererOrganizations", "example.com")
    org1 = os.path.join(cc, "peerOrganizations", "org1.example.com")
    admin = ["--mspid", "Org1MSP", "--msp-dir",
             os.path.join(org1, "users", "Admin@org1.example.com", "msp")]
    block = str(tmp_path / "ch.block")
    with contextlib.redirect_stdout(io.StringIO()):
        port_configtxgen.main(["-profile", "OneOrg", "-channelID", "nwoch",
                               "-outputBlock", block, "-configPath", root])
    with open(block, "rb") as f:
        genesis = cb.Block.decode(f.read())
    src = tmp_path / "ccsrc"
    src.mkdir()
    (src / "main.py").write_text("print('kv')\n")
    outputs = {}
    for pkg, (*_rest, peer_cli, _orderer) in CLI.items():
        work = tmp_path / pkg
        orderer = OrdererNode(
            str(work / "o"), CUDACSP(device="cpu"),
            signer=load_signer(os.path.join(
                ordo, "orderers", "orderer.example.com", "msp"),
                "OrdererMSP"),
            genesis_blocks=[genesis])
        orderer.start()
        peer = PeerNode(
            str(work / "p"), CUDACSP(device="cpu"),
            load_signer(os.path.join(org1, "peers", "peer0.org1.example.com",
                                     "msp"), "Org1MSP"),
            orderer_endpoints=[orderer.addr],
            chaincodes={"kvcc": _kv_chaincode()})
        peer.start()
        p = f"127.0.0.1:{peer.addr[1]}"
        o = f"127.0.0.1:{orderer.addr[1]}"
        steps = [
            ["channel", "join", "--block", block, "--peer", p],
            ["channel", "join", "--block", block, "--peer", p],
            ["channel", "list", "--peer", p],
            ["channel", "list", "--orderer", o],
            ["channel", "list", "--peer", p, "--orderer", o],
            ["channel", "getinfo", "-c", "nwoch", "--peer", p],
            ["chaincode", "invoke", "-C", "nwoch", "-n", "kvcc", "-a", "put",
             "-a", "k", "-a", "v", "--peer", p, "--orderer", o, *admin],
            "wait",
            ["chaincode", "query", "-C", "nwoch", "-n", "kvcc", "-a", "get",
             "-a", "k", "--peer", p, *admin],
            ["channel", "getinfo", "-c", "nwoch", "--peer", p],
            ["channel", "fetch", "newest", str(work / "b1"), "-c", "nwoch",
             "--peer", p, *admin],
            ["channel", "fetch", "0", str(work / "b0"), "-c", "nwoch",
             "--orderer", o, *admin],
            ["channel", "fetch", "1", str(work / "f1"), "-c", "nwoch",
             "--peer", p, "--filtered", *admin],
            ["channel", "fetch", "1", str(work / "f1"), "-c", "nwoch",
             "--orderer", o, "--filtered", *admin],
            ["lifecycle", "chaincode", "package", str(work / "cc.tgz"),
             "--path", str(src), "--label", "kv_1"],
            ["lifecycle", "chaincode", "install", str(work / "cc.tgz"),
             "--peer", p, *admin],
            ["lifecycle", "chaincode", "queryinstalled", "--peer", p, *admin],
            ["lifecycle", "chaincode", "checkcommitreadiness", "-C", "nwoch",
             "-n", "kvcc", "-v", "1.0", "--sequence", "1", "--peer", p,
             *admin],
            ["lifecycle", "chaincode", "approveformyorg", "-C", "nwoch",
             "-n", "kvcc", "-v", "1.0", "--sequence", "1", "--peer", p,
             "--orderer", o, "--package-id", "kv_1:00", *admin],
            ["snapshot", "listpending", "-c", "nwoch", "--peer", p],
            ["snapshot", "submitrequest", "-c", "nwoch", "-b", "9",
             "--peer", p],
            ["snapshot", "listpending", "-c", "nwoch", "--peer", p],
            ["snapshot", "cancelrequest", "-c", "nwoch", "-b", "9",
             "--peer", p],
            ["snapshot", "listpending", "-c", "nwoch", "--peer", p],
        ]
        outs = []
        try:
            for argv in steps:
                if argv == "wait":
                    deadline = time.monotonic() + 30
                    while peer.channels["nwoch"].ledger.height < 2:
                        assert time.monotonic() < deadline
                        time.sleep(0.02)
                    continue
                outs.append(_run(peer_cli, argv).replace(str(work), "<w>"))
        finally:
            orderer.stop()
            peer.stop()
        with open(work / "b1", "rb") as f:
            fetched = cb.Block.decode(f.read())
        outs.append((fetched.header.number, len(fetched.data.data)))
        outputs[pkg] = outs
    assert outputs["port"] == outputs["jax"]
    joined, _, peer_list, ord_list, both, info = outputs["port"][:6]
    assert joined == "rc 0: joined channel nwoch\n"
    assert peer_list == ord_list == "rc 0: nwoch\n" and both == "rc 2: "
    assert outputs["port"][6:9] == ["rc 0: committed\n", "rc 0: v\n",
                                    "rc 0: height: 2\n"]
    assert "cannot determine approving org" in outputs["port"][17]
    assert outputs["port"][-1] == (1, 1)
