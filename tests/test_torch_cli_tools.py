"""The port's last four CLIs (`cmd.configtxlator`, `cmd.discover`,
`cmd.custody`, `cmd.idemixgen`) against the JAX package's.

- configtxlator, on a config block from the port's configtxgen and one
  from the reference's (the same MSP folders): `proto_decode` gives the
  reference's JSON for each of the twelve `--type`s the blocks reach
  (textually where no map is involved, equal after `json.loads`
  otherwise: upb's map order is its own); `proto_encode` of either JSON
  gives the reference's message (the same bytes where no map is
  involved); `compute_update` gives the same `ConfigUpdate`, decoded; an
  unknown JSON field is refused by both.  The JSON mapping itself
  (`protos/jsonpb.py`) parses what `json_format.Parse` parses, and
  refuses what it refuses.
- discover, against an in-process port `PeerNode` and a reference one on
  the same crypto material: the same JSON, but for the ports.
- custody: the same error for a partial TLS config; one keystore
  directory serves the port's daemon and the reference's (each a process
  of its CLI), and each one's signatures verify on the other package's
  provider; the port's daemon exits 0 on SIGTERM.
- idemixgen: each package's `SignerConfig.pb` decodes in the other's
  codec to the same bytes, and its signatures verify under the other's
  idemix MSP.  The port refuses the reference's `IssuerKey.pkl` (a pickle
  naming the JAX package's classes) and imports nothing of the JAX
  package doing so: a deliberate divergence (ROADMAP Queue C).
- Each CLI, and a netnode, runs in a process where `jax` and the JAX
  package cannot be imported.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import time
import types

import pytest
from google.protobuf import json_format

import chip_smoke
from fabric_tpu.cmd import configtxgen as jax_configtxgen
from fabric_tpu.cmd import configtxlator as jax_lator
from fabric_tpu.cmd import discover as jax_discover
from fabric_tpu.cmd import idemixgen as jax_idemixgen
from fabric_tpu.cmd import custody as jax_custody_cli
from fabric_tpu.common.configtx import compute_update as jax_compute
from fabric_tpu.protos.common import common_pb2, configtx_pb2, policies_pb2
from fabric_tpu.protos.msp import msp_config_pb2
from fabric_tpu.protos.orderer import ab_pb2
from fabric_tpu_torch.cmd import configtxgen, cryptogen
from fabric_tpu_torch.cmd import configtxlator as port_lator
from fabric_tpu_torch.cmd import custody as port_custody_cli
from fabric_tpu_torch.cmd import discover as port_discover
from fabric_tpu_torch.cmd import idemixgen as port_idemixgen
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.configtx import compute_update as port_compute
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import jsonpb
from fabric_tpu_torch.protos import msp as mb
from fabric_tpu_torch.protos import orderer as ob

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH = "toolch"
LATOR = {"jax": jax_lator, "port": port_lator}
TYPES = {
    "common.Block": (common_pb2.Block, cb.Block),
    "common.Envelope": (common_pb2.Envelope, cb.Envelope),
    "common.Payload": (common_pb2.Payload, cb.Payload),
    "common.Config": (configtx_pb2.Config, cb.Config),
    "common.ConfigEnvelope": (configtx_pb2.ConfigEnvelope,
                              cb.ConfigEnvelope),
    "common.ConfigUpdate": (configtx_pb2.ConfigUpdate, cb.ConfigUpdate),
    "common.ConfigUpdateEnvelope": (configtx_pb2.ConfigUpdateEnvelope,
                                    cb.ConfigUpdateEnvelope),
    "common.Policy": (policies_pb2.Policy, cb.Policy),
    "common.SignaturePolicyEnvelope": (
        policies_pb2.SignaturePolicyEnvelope, cb.SignaturePolicyEnvelope),
    "msp.MSPConfig": (msp_config_pb2.MSPConfig, mb.MSPConfig),
    "msp.FabricMSPConfig": (msp_config_pb2.FabricMSPConfig,
                            mb.FabricMSPConfig),
    "orderer.SeekInfo": (ab_pb2.SeekInfo, ob.SeekInfo),
}
# the types whose JSON here holds a map (ConfigGroup's): equal decoded
MAPPED = {"common.Config", "common.ConfigEnvelope", "common.ConfigUpdate"}


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


def _quiet(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*a)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def material(tmp_path_factory):
    """An orderer org and Org1 from the port's cryptogen; a solo channel
    block from each package's configtxgen on those folders."""
    root = str(tmp_path_factory.mktemp("tools"))
    with open(os.path.join(root, "crypto-config.yaml"), "w") as f:
        f.write(chip_smoke.nodes_crypto_config(1))
    with open(os.path.join(root, "configtx.yaml"), "w") as f:
        f.write(chip_smoke.nodes_configtx(1).replace(
            "Profiles:\n  Nodes:", "Profiles:\n  Tools:"))
    cc = os.path.join(root, "crypto-config")
    assert _quiet(cryptogen.main, [
        "generate", "--config", os.path.join(root, "crypto-config.yaml"),
        "--output", cc])[0] == 0
    blocks = {}
    for pkg, gen in (("port", configtxgen), ("jax", jax_configtxgen)):
        path = os.path.join(root, f"{pkg}.block")
        assert _quiet(gen.main, ["-profile", "Tools", "-channelID", CH,
                                 "-outputBlock", path,
                                 "-configPath", root])[0] == 0
        blocks[pkg] = path
    ordo = os.path.join(cc, "ordererOrganizations", "example.com")
    org1 = os.path.join(cc, "peerOrganizations", "org1.example.com")
    return types.SimpleNamespace(root=root, cc=cc, blocks=blocks,
                                 ordo=ordo, org1=org1)


# ---------------------------------------------------------------------------
# configtxlator
# ---------------------------------------------------------------------------


def _lator(pkg, argv) -> int:
    return LATOR[pkg].main(argv)


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _messages(block_raw: bytes) -> dict:
    """The bytes of one message of each of the twelve types, reached from
    a config block (with the port's codec)."""
    blk = cb.Block.decode(block_raw)
    env = cb.Envelope.decode(blk.data.data[0])
    payload = cb.Payload.decode(env.payload)
    cenv = cb.ConfigEnvelope.decode(payload.data)
    config = cenv.config
    app = config.channel_group.groups["Application"]
    org = app.groups["Org1"]
    sig_policy = org.policies["Readers"].policy
    assert sig_policy.type == cb.Policy.SIGNATURE
    msp_conf = mb.MSPConfig.decode(org.values["MSP"].value)
    updated = cb.Config.decode(config.encode())
    orderer = updated.channel_group.groups["Orderer"]
    batch = ob.BatchSize.decode(orderer.values["BatchSize"].value)
    batch.max_message_count = 500
    orderer.values["BatchSize"].value = batch.encode()
    update = port_compute(CH, config, updated)
    cue = cb.ConfigUpdateEnvelope(config_update=update.encode(), signatures=[
        cb.ConfigSignature(signature_header=b"\x0a\x03abc",
                           signature=b"sig")])
    seek = ob.SeekInfo(
        start=ob.SeekPosition(specified=ob.SeekSpecified(number=0)),
        stop=ob.SeekPosition(newest=ob.SeekNewest()),
        behavior=ob.SeekInfo.FAIL_IF_NOT_READY,
        error_response=ob.SeekInfo.BEST_EFFORT)
    return {
        "common.Block": block_raw,
        "common.Envelope": blk.data.data[0],
        "common.Payload": env.payload,
        "common.Config": config.encode(),
        "common.ConfigEnvelope": payload.data,
        "common.ConfigUpdate": update.encode(),
        "common.ConfigUpdateEnvelope": cue.encode(),
        "common.Policy": sig_policy.encode(),
        "common.SignaturePolicyEnvelope": sig_policy.value,
        "msp.MSPConfig": org.values["MSP"].value,
        "msp.FabricMSPConfig": msp_conf.config,
        "orderer.SeekInfo": seek.encode(),
    }


def _decoded_equal(type_name, port_raw: bytes, jax_raw: bytes) -> bool:
    """Equal messages: each package's bytes parsed by the reference and
    written deterministically (map entries sorted)."""
    jcls = TYPES[type_name][0]
    return jcls.FromString(port_raw).SerializeToString(deterministic=True) \
        == jcls.FromString(jax_raw).SerializeToString(deterministic=True)


@pytest.mark.parametrize("maker", ["port", "jax"])
def test_configtxlator_decodes_and_encodes_as_the_reference(material,
                                                            tmp_path, maker):
    msgs = _messages(_read(material.blocks[maker]))
    assert set(msgs) == set(TYPES) == set(port_lator._TYPES) \
        == set(jax_lator._TYPES)
    for type_name, raw in msgs.items():
        src = _write(str(tmp_path / f"{type_name}.pb"), raw)
        text = {}
        for pkg in LATOR:
            out = str(tmp_path / f"{type_name}.{pkg}.json")
            assert _lator(pkg, ["proto_decode", "--type", type_name,
                                "--input", src, "--output", out]) == 0
            text[pkg] = _read(out).decode()
        assert json.loads(text["port"]) == json.loads(text["jax"]), type_name
        if type_name not in MAPPED:
            assert text["port"] == text["jax"], type_name
        # proto_encode of either JSON, in either package: the message
        for js in LATOR:
            enc = {}
            for pkg in LATOR:
                out = str(tmp_path / f"{type_name}.{js}.{pkg}.pb")
                assert _lator(pkg, [
                    "proto_encode", "--type", type_name, "--input",
                    str(tmp_path / f"{type_name}.{js}.json"),
                    "--output", out]) == 0
                enc[pkg] = _read(out)
            assert _decoded_equal(type_name, enc["port"], enc["jax"])
            assert _decoded_equal(type_name, enc["port"], raw)
            if type_name not in MAPPED:
                assert enc["port"] == enc["jax"] == raw, type_name
    seek = json.loads(_read(str(tmp_path / "orderer.SeekInfo.port.json")))
    assert seek["behavior"] == "FAIL_IF_NOT_READY"
    assert seek["error_response"] == "BEST_EFFORT"
    spe = json.loads(_read(str(
        tmp_path / "common.SignaturePolicyEnvelope.port.json")))
    # ROLE is the enum's zero: left out, as the reference leaves it out
    assert "principal_classification" not in spe["identities"][0]


def test_configtxlator_computes_the_references_update(material, tmp_path):
    original = cb.Block.decode(_read(material.blocks["port"]))
    config = cb.ConfigEnvelope.decode(cb.Payload.decode(cb.Envelope.decode(
        original.data.data[0]).payload).data).config
    updated = cb.Config.decode(config.encode())
    orderer = updated.channel_group.groups["Orderer"]
    batch = ob.BatchSize.decode(orderer.values["BatchSize"].value)
    batch.max_message_count = 500
    orderer.values["BatchSize"].value = batch.encode()
    app = updated.channel_group.groups["Application"]
    app.mod_policy = "Writers"
    a = _write(str(tmp_path / "a.pb"), config.encode())
    b = _write(str(tmp_path / "b.pb"), updated.encode())
    got = {}
    for pkg in LATOR:
        out = str(tmp_path / f"update.{pkg}.pb")
        assert _lator(pkg, ["compute_update", "--channel_id", CH,
                            "--original", a, "--updated", b,
                            "--output", out]) == 0
        got[pkg] = _read(out)
    assert _decoded_equal("common.ConfigUpdate", got["port"], got["jax"])
    upd = cb.ConfigUpdate.decode(got["port"])
    assert upd.channel_id == CH
    assert set(upd.write_set.groups) == {"Orderer", "Application"}
    jax_upd = jax_compute(CH, configtx_pb2.Config.FromString(_read(a)),
                          configtx_pb2.Config.FromString(_read(b)))
    assert _decoded_equal("common.ConfigUpdate", got["port"],
                          jax_upd.SerializeToString())
    # no difference: both refuse
    for pkg in LATOR:
        with pytest.raises(Exception, match="no differences"):
            _lator(pkg, ["compute_update", "--channel_id", CH, "--original",
                         a, "--updated", a, "--output",
                         str(tmp_path / "none.pb")])


@pytest.mark.parametrize("type_name,js", [
    ("common.Block", '{"header": {"number": "1"}, "bogus": 1}'),
    ("common.Config", '{"channel_group": {"groups": {"A": {"nope": 2}}}}'),
    ("orderer.SeekInfo", '{"behavior": "NOT_A_BEHAVIOR"}'),
    ("common.Envelope", '{"payload": "abc", "payload": "abd"}'),
    ("common.SignaturePolicyEnvelope",
     '{"rule": {"signed_by": 0, "n_out_of": {"n": 1}}}'),
])
def test_configtxlator_refuses_what_the_reference_refuses(tmp_path,
                                                          type_name, js):
    src = _write(str(tmp_path / "in.json"), js.encode())
    with pytest.raises(json_format.ParseError):
        _lator("jax", ["proto_encode", "--type", type_name, "--input", src,
                       "--output", str(tmp_path / "j.pb")])
    with pytest.raises(jsonpb.ParseError):
        _lator("port", ["proto_encode", "--type", type_name, "--input", src,
                        "--output", str(tmp_path / "p.pb")])


PARSE_CASES = [
    ("common.Block", {"header": {"number": 7, "previousHash": "AAE-_w",
                                 "data_hash": "AAE+/w=="},
                      "data": {"data": ["YWJj", "YQ"]},
                      "metadata": {"metadata": []}}),
    ("common.Block", {"header": {"number": "18446744073709551615"},
                      "data": None}),
    ("orderer.SeekInfo", {"behavior": 1, "errorResponse": "BEST_EFFORT",
                          "start": {"oldest": {}}}),
    ("orderer.SeekInfo", {"behavior": 7, "stop": {"specified": {
        "number": "12"}}}),
    ("common.Config", {"sequence": "3", "channel_group": {
        "version": 2, "mod_policy": "Admins", "groups": {"B": {}, "A": {
            "values": {"X": {"value": "eA==", "version": "0"}}}},
        "policies": {"P": {"policy": {"type": 3, "value": ""}}}}}),
    ("common.SignaturePolicyEnvelope", {
        "version": 0, "rule": {"n_out_of": {"n": 2, "rules": [
            {"signed_by": 0}, {"signed_by": 1}]}},
        "identities": [{"principal_classification": "ORGANIZATION_UNIT",
                        "principal": "YQ=="},
                       {"principal_classification": 2}]}),
    ("msp.FabricMSPConfig", {"name": "Org1MSP", "root_certs": ["YQ=="],
                             "fabric_node_ous": {"enable": True},
                             "crypto_config": {}}),
    ("common.Policy", {"type": -1}),
]


@pytest.mark.parametrize("case", range(len(PARSE_CASES)))
def test_the_json_mapping_parses_and_prints_as_json_format(case):
    type_name, js = PARSE_CASES[case]
    jcls, pcls = TYPES[type_name]
    text = json.dumps(js)
    ref = json_format.Parse(text, jcls())
    port = jsonpb.parse(text, pcls)
    assert port.encode(deterministic=True) == \
        ref.SerializeToString(deterministic=True)
    assert json.loads(jsonpb.message_to_json(port)) == json.loads(
        json_format.MessageToJson(ref, preserving_proto_field_name=True))


# ---------------------------------------------------------------------------
# discover
# ---------------------------------------------------------------------------


def _kv(shim):
    class KV(shim.Chaincode):
        def invoke(self, stub):
            fn, params = stub.get_function_and_parameters()
            stub.put_state(params[0].decode(), params[1])
            return shim.success(b"")
    return KV


def _discover_json(pkg, cli, material, peer_addr, cmd):
    user = os.path.join(material.org1, "users", "User1@org1.example.com")
    argv = [cmd, "--channel", CH, "--peer", f"{peer_addr[0]}:{peer_addr[1]}",
            "--mspid", "Org1MSP", "--msp-dir", os.path.join(user, "msp")]
    if cmd == "endorsers":
        argv += ["--chaincode", "kv"]
    rc, out = _quiet(cli.main, argv)
    assert rc == 0
    return re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:PORT", out)


def test_discover_prints_the_references_json(material, tmp_path):
    from fabric_tpu.chaincode import shim as jax_shim
    from fabric_tpu.cmd.common import load_signer as jax_load_signer
    from fabric_tpu.csp import SWCSP
    from fabric_tpu.node.orderer_node import OrdererNode as JaxOrderer
    from fabric_tpu.node.peer_node import PeerNode as JaxPeer
    from fabric_tpu_torch.chaincode import shim as port_shim
    from fabric_tpu_torch.cmd.common import load_signer
    from fabric_tpu_torch.comm import RPCClient
    from fabric_tpu_torch.csp.cuda.provider import CUDACSP
    from fabric_tpu_torch.node.orderer_node import OrdererNode
    from fabric_tpu_torch.node.peer_node import PeerNode

    genesis = _read(material.blocks["port"])
    sides = {
        "jax": (JaxOrderer, JaxPeer, SWCSP, jax_load_signer, jax_shim,
                lambda raw: common_pb2.Block.FromString(raw)),
        "port": (OrdererNode, PeerNode, lambda: CUDACSP(device="cpu"),
                 load_signer, port_shim, cb.Block.decode),
    }
    orderer_msp = os.path.join(material.ordo, "orderers",
                               "orderer.example.com", "msp")
    peer_msp = os.path.join(material.org1, "peers",
                            "peer0.org1.example.com", "msp")
    got, nodes = {}, []
    try:
        for pkg, (Orderer, Peer, csp, load, shim, block) in sides.items():
            o = Orderer(str(tmp_path / f"{pkg}-o"), csp(),
                        signer=load(orderer_msp, "OrdererMSP"),
                        genesis_blocks=[block(genesis)])
            o.start()
            nodes.append(o)
            p = Peer(str(tmp_path / f"{pkg}-p"), csp(),
                     load(peer_msp, "Org1MSP"), orderer_endpoints=[o.addr],
                     chaincodes={"kv": _kv(shim)()})
            p.start()
            nodes.append(p)
            assert RPCClient(*p.addr, timeout=30).call(
                "admin.JoinChannel", genesis) == CH.encode()
            for cli_pkg, cli in (("jax", jax_discover),
                                 ("port", port_discover)):
                got[(pkg, cli_pkg)] = {
                    cmd: _discover_json(pkg, cli, material, p.addr, cmd)
                    for cmd in ("peers", "config", "endorsers")}
            if pkg == "port":
                fetched = _fetch_config(material, p.addr, tmp_path)
    finally:
        for n in sorted(nodes, key=lambda n: not hasattr(n, "registrar")):
            n.stop()
    assert got[("port", "port")] == got[("jax", "jax")]
    assert got[("port", "jax")] == got[("jax", "port")] == got[("jax", "jax")]
    peers = json.loads(got[("port", "port")]["peers"])
    assert [p["ledger_height"] for p in peers] == [1]
    # `peer channel fetch config` (the port's CLI): the channel's config
    # block, found through the newest block's LastConfig index
    assert fetched.header.number == 0
    assert fetched.data.data == cb.Block.decode(genesis).data.data
    # a peer node's discovery support names no MSP configs in either
    # package (its `msp_configs` is empty: ROADMAP Queue C)
    assert json.loads(got[("port", "port")]["config"]) == {"msps": []}
    assert json.loads(got[("port", "port")]["endorsers"]) == [
        "127.0.0.1:PORT"]


def _fetch_config(material, peer_addr, tmp_path):
    """`peer channel fetch config` against a peer, as the client user."""
    from fabric_tpu_torch.cmd import peer as port_peer_cli

    user = os.path.join(material.org1, "users", "User1@org1.example.com")
    out = str(tmp_path / "fetched_config.block")
    rc, text = _quiet(port_peer_cli.main, [
        "channel", "fetch", "config", out, "-c", CH, "--peer",
        f"{peer_addr[0]}:{peer_addr[1]}", "--mspid", "Org1MSP",
        "--msp-dir", os.path.join(user, "msp")])
    assert rc == 0 and text.startswith("wrote block 0"), text
    return cb.Block.decode(_read(out))


# ---------------------------------------------------------------------------
# custody
# ---------------------------------------------------------------------------


def test_custody_refuses_a_partial_tls_config_as_the_reference(tmp_path):
    argv = ["--keystore", str(tmp_path / "k"), "--token-file",
            str(tmp_path / "t"), "--tls-cert", "c.pem"]
    errs = {}
    for pkg, cli in (("jax", jax_custody_cli), ("port", port_custody_cli)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        errs[pkg] = err.getvalue()
    assert errs["port"] == errs["jax"]
    assert "--tls-cert and --tls-key must be given together" in errs["port"]
    assert not os.path.exists(str(tmp_path / "k"))


# a module run as `python -m`, where `jax` and the JAX package cannot be
# imported (BLOCK=1), or where they could be and must not be (BLOCK=0);
# the modules of either loaded at the end go to stderr
_RUN = """
import os, runpy, sys
if os.environ.get("BLOCK") == "1":
    for name in ("jax", "jaxlib", "fabric_tpu"):
        sys.modules[name] = None
sys.argv = sys.argv[1:]
code = 0
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                   else 1)
except Exception as e:
    print(f"RAISED {type(e).__name__}: {e}", file=sys.stderr)
    code = 1
loaded = sorted(k for k, v in sys.modules.items() if v is not None and (
    k in ("jax", "fabric_tpu") or k.startswith(("jax.", "fabric_tpu."))))
print(f"LOADED {loaded}", file=sys.stderr, flush=True)
sys.exit(code)
"""


def _spawn(module, args, block=True, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, BLOCK="1" if block else "0")
    return subprocess.Popen([sys.executable, "-c", _RUN, module, *args],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def _run(module, args, block=True, timeout=120):
    proc = _spawn(module, args, block)
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def _daemon(module, keystore, token_file, block):
    proc = _spawn(module, ["--keystore", keystore, "--token-file",
                           token_file, "--listen", "127.0.0.1:0"], block)
    line = proc.stdout.readline()
    m = re.match(r"custody daemon on ([\d.]+):(\d+)", line)
    assert m, (line, proc.poll())
    return proc, (m.group(1), int(m.group(2)))


def test_one_keystore_serves_both_custody_daemons(tmp_path):
    from fabric_tpu.csp import SWCSP
    from fabric_tpu.csp import api as jax_api
    from fabric_tpu.csp import custody as jax_cust
    from fabric_tpu_torch.csp import custody as port_cust
    from fabric_tpu_torch.csp import hostref
    from fabric_tpu_torch.csp.api import P256PublicKey

    keystore = str(tmp_path / "keys")
    token = _write(str(tmp_path / "token"), b"custody-pin\n")
    pin = port_cust.load_token(token)
    port_proc, port_addr = _daemon("fabric_tpu_torch.cmd.custody", keystore,
                                   token, True)
    jax_proc, jax_addr = _daemon("fabric_tpu.cmd.custody", keystore, token,
                                 False)
    try:
        port = port_cust.CustodyCSP(port_addr, pin,
                                    verify_csp=hostref.HostCSP())
        jax = jax_cust.CustodyCSP(jax_addr, pin, verify_csp=SWCSP())
        keys = [port.key_gen(), jax.key_gen()]
        for i, key in enumerate(keys):
            digest = hashlib.sha256(b"custody %d" % i).digest()
            ski = key.ski()
            pkey, jkey = port.get_key(ski), jax.get_key(ski)
            raw = pkey.public_key().raw()
            assert jkey.public_key().raw() == raw
            psig, jsig = port.sign(pkey, digest), jax.sign(jkey, digest)
            # the port daemon's signature on the reference's provider, and
            # the reference daemon's on the port's
            jpub = jax_api.ECDSAP256PublicKey.from_point(
                int.from_bytes(raw[1:33], "big"),
                int.from_bytes(raw[33:], "big"))
            assert SWCSP().verify(jpub, psig, digest)
            ppub = P256PublicKey.from_raw(raw)
            assert hostref.verify(ppub, jsig, digest)
            assert not hostref.verify(ppub, jsig, bytes(32))
        assert len(os.listdir(keystore)) == 2
    finally:
        for proc in (port_proc, jax_proc):
            proc.send_signal(signal.SIGTERM)
        rcs = [proc.wait(timeout=30) for proc in (port_proc, jax_proc)]
        errs = [proc.stderr.read() for proc in (port_proc, jax_proc)]
    assert rcs == [0, 0], errs
    assert "LOADED []" in errs[0]


# ---------------------------------------------------------------------------
# idemixgen
# ---------------------------------------------------------------------------


IDEMIXGEN = {"jax": jax_idemixgen, "port": port_idemixgen}


def test_idemixgen_configs_cross_the_packages(tmp_path):
    from fabric_tpu.msp import idemixmsp as jmsp
    from fabric_tpu_torch.msp import idemixmsp as pmsp

    MSP = {"jax": (jmsp, msp_config_pb2), "port": (pmsp, mb)}
    for pkg, gen in IDEMIXGEN.items():
        out = str(tmp_path / pkg)
        assert _quiet(gen.main, ["ca-keygen", "--output", out])[0] == 0
        assert _quiet(gen.main, ["signerconfig", "--output", out,
                                 "--org-unit", "ou1", "--enrollment-id",
                                 "alice", "--admin"])[0] == 0
        assert sorted(os.listdir(out)) == ["ca", "user"]
        raw = _read(os.path.join(out, "user", "SignerConfig.pb"))
        assert mb.IdemixMSPSignerConfig.decode(raw).encode() == raw
        jsc = msp_config_pb2.IdemixMSPSignerConfig.FromString(raw)
        assert jsc.SerializeToString() == raw
        assert (jsc.organizational_unit_identifier, jsc.role,
                jsc.enrollment_id) == ("ou1", 2, b"alice")
        mod, codec = MSP[pkg]
        if pkg == "port":
            issuer = port_idemixgen.load_issuer(
                os.path.join(out, "ca", "IssuerKey.pkl"))
        else:
            with open(os.path.join(out, "ca", "IssuerKey.pkl"), "rb") as f:
                issuer = pickle.load(f)
        signer = codec.IdemixMSPSignerConfig.FromString(raw) \
            if pkg == "jax" else mb.IdemixMSPSignerConfig.decode(raw)
        conf = mod.idemix_msp_config(issuer, "IdemixMSP", signer)
        conf_raw = _enc(conf)
        own = mod.IdemixMSP.from_config(conf)
        ident = own.get_default_signing_identity()
        assert ident.is_admin and ident.ou == "ou1"
        sig = ident.sign(b"payload")
        for other in ("jax", "port"):
            omod, _ = MSP[other]
            msp = omod.IdemixMSP.from_config(
                msp_config_pb2.MSPConfig.FromString(conf_raw)
                if other == "jax" else mb.MSPConfig.decode(conf_raw))
            back = msp.deserialize_identity(ident.serialize())
            assert msp.verify(back, b"payload", sig), (pkg, other)
            assert not msp.verify(back, b"other", sig)


def _enc(msg) -> bytes:
    return msg.SerializeToString() if hasattr(msg, "SerializeToString") \
        else msg.encode()


def test_the_port_refuses_the_references_issuer_key(tmp_path):
    """A deliberate divergence: the reference's IssuerKey.pkl names the
    JAX package's classes, and the port's loader admits only its own, so
    the port refuses it, and imports nothing of the JAX package on the
    way (the subprocess could import it, and does not)."""
    out = str(tmp_path / "ref")
    assert _quiet(jax_idemixgen.main, ["ca-keygen", "--output", out])[0] == 0
    rc, _, err = _run("fabric_tpu_torch.cmd.idemixgen",
                      ["signerconfig", "--output", out], block=False)
    assert rc == 1
    assert "UnpicklingError" in err and \
        "IssuerKey.pkl names fabric_tpu.idemix.issuer.IssuerKey" in err
    assert "LOADED []" in err
    assert not os.path.exists(os.path.join(out, "user"))
    with pytest.raises(pickle.UnpicklingError, match="only the port's"):
        port_idemixgen.load_issuer(os.path.join(out, "ca", "IssuerKey.pkl"))
    # a pickle of anything else is refused the same way
    evil = _write(str(tmp_path / "evil.pkl"),
                  pickle.dumps(types.SimpleNamespace(a=1)))
    with pytest.raises(pickle.UnpicklingError, match="types.SimpleNamespace"):
        port_idemixgen.load_issuer(evil)


def test_the_clis_and_a_netnode_run_without_jax(material, tmp_path):
    """Each CLI as a process where `jax` and the JAX package cannot be
    imported: idemixgen's two commands, configtxlator's three, discover
    (its refusal to reach a peer that is not there), and a netnode
    (orderer role) that starts, reports ready and exits 0 on SIGTERM.
    The custody daemon's run is test_one_keystore_serves_both_custody_
    daemons."""
    out = str(tmp_path / "idemix")
    for args in (["ca-keygen", "--output", out],
                 ["signerconfig", "--output", out]):
        rc, stdout, err = _run("fabric_tpu_torch.cmd.idemixgen", args)
        assert rc == 0 and "LOADED []" in err, err
    block = material.blocks["port"]
    js = str(tmp_path / "b.json")
    rc, _, err = _run("fabric_tpu_torch.cmd.configtxlator", [
        "proto_decode", "--type", "common.Block", "--input", block,
        "--output", js])
    assert rc == 0 and "LOADED []" in err, err
    rc, _, err = _run("fabric_tpu_torch.cmd.configtxlator", [
        "proto_encode", "--type", "common.Block", "--input", js,
        "--output", str(tmp_path / "b.pb")])
    assert rc == 0 and "LOADED []" in err, err
    assert _read(str(tmp_path / "b.pb")) == _read(block)
    cfg = cb.ConfigEnvelope.decode(cb.Payload.decode(cb.Envelope.decode(
        cb.Block.decode(_read(block)).data.data[0]).payload).data).config
    a = _write(str(tmp_path / "a.pb"), cfg.encode())
    cfg.channel_group.mod_policy = "Writers"
    b = _write(str(tmp_path / "c.pb"), cfg.encode())
    rc, _, err = _run("fabric_tpu_torch.cmd.configtxlator", [
        "compute_update", "--channel_id", CH, "--original", a, "--updated",
        b, "--output", str(tmp_path / "u.pb")])
    assert rc == 0 and "LOADED []" in err, err
    user = os.path.join(material.org1, "users", "User1@org1.example.com")
    rc, _, err = _run("fabric_tpu_torch.cmd.discover", [
        "peers", "--channel", CH, "--peer", "127.0.0.1:1", "--mspid",
        "Org1MSP", "--msp-dir", os.path.join(user, "msp")])
    assert rc == 1 and "RAISED" in err and "LOADED []" in err, err

    from fabric_tpu_torch.devtools import netharness as pnh

    node_dir = tmp_path / "node"
    node_dir.mkdir()
    cfg = {"role": "orderer", "name": "orderer1", "channel": "netchan",
           "root": str(node_dir / "root"), "rpc_port": pnh.free_port(),
           "ready_file": str(node_dir / "ready"), "node_id": 1,
           "raft_port": pnh.free_port(), "consenters": {"1": [
               "127.0.0.1", 0]}, "secret": "00", "env": {}}
    path = _write(str(node_dir / "config.json"), json.dumps(cfg).encode())
    proc = _spawn("fabric_tpu_torch.devtools.netnode", [path])
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(cfg["ready_file"]):
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    err = proc.stderr.read()
    assert rc == 0 and "LOADED []" in err, err
