"""The port stands alone: no JAX, nothing of the JAX package, no
`cryptography` or `protobuf`; the card by default, and no silent CPU or
build fallback.  Also the BN254 kernel's own source, compiled for the host
by g++ (csrc/bn254_host_check.cpp), against Python ints and the plain
PyTorch version, and its device field's PTX carry chains, run by a small
interpreter of the instructions they use, against Python ints.

The import check runs in a subprocess: tests/conftest.py imports jax for
the whole session.
"""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import ctypes  # noqa: E402
import random  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from fabric_tpu_torch import native  # noqa: E402
from fabric_tpu_torch.csp.cuda import bn254_batch as bb  # noqa: E402
from fabric_tpu_torch.csp.cuda import bn254_ec, build, fp254  # noqa: E402
from fabric_tpu_torch.csp.cuda import bn254_kernel as bk  # noqa: E402
from fabric_tpu_torch.csp.cuda import p256_kernel as pk  # noqa: E402
from fabric_tpu_torch.csp.cuda.provider import CUDACSP  # noqa: E402
from fabric_tpu_torch.csp.idemix_provider import IdemixCSP  # noqa: E402
from fabric_tpu_torch.idemix import bn254 as bn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "fabric_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "fabric_tpu", "cryptography", "google.protobuf",
             "yaml")

_BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "fabric_tpu", "cryptography", "google.protobuf",
             "yaml"):
    sys.modules[name] = None
import importlib, pkgutil
import fabric_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    fabric_tpu_torch.__path__, "fabric_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import numpy as np
from fabric_tpu_torch import native
from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import VerifyBatchItem
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
rng = np.random.default_rng(1)
key = hostref.key_gen(rng)
items = []
for i in range(3):
    d = bytes([i]) * 32
    items.append(VerifyBatchItem(key.public_key(), d, hostref.sign(key, d, rng)))
items[1] = VerifyBatchItem(items[1].key, bytes(32), items[1].signature)
mask = CUDACSP(device="cpu", min_device_batch=1).verify_batch(items)
assert mask == [True, False, True], mask
# the degraded mode: one breaker trip on an injected collect fault (the
# host answers), then the probe closes it, on /metrics
from fabric_tpu_torch.common import metrics
from fabric_tpu_torch.devtools import faultline
prom = metrics.PrometheusProvider()
csp = CUDACSP(device="cpu", min_device_batch=1, breaker_threshold=1,
              breaker_probe_every=1, metrics=metrics.CSPMetrics(prom))
with faultline.use_plan({"faults": [{"point": "tpu.collect",
                                     "action": "raise",
                                     "error": "DeviceUnavailable",
                                     "nth": 1}]}):
    assert csp.verify_batch(items) == mask and csp.breaker_open
    assert csp.verify_batch(items) == mask and not csp.breaker_open
assert native.ecdsa_impl() in ("libcrypto", "none")
assert csp.degraded_stats()["host_lanes"] == 3
exposed = prom.registry.expose()
assert "csp_tpu_breaker_trips_total 1" in exposed, exposed
assert 'csp_tpu_breaker_probes_total{result="ok"} 1' in exposed, exposed
csp.close()
from fabric_tpu_torch.csp.idemix_provider import IdemixCSP
from fabric_tpu_torch.idemix import bn254 as bn
csp = IdemixCSP(device="cpu")
assert bn.pairing_check([(bn.G1_GEN, bn.G2_GEN),
                         (bn.g1_neg(bn.G1_GEN), bn.G2_GEN)])
import hashlib
assert native.bn254_msm([bn.G1_GEN], [5]) == bn._g1_mul_py(bn.G1_GEN, 5)
msgs = [bytes([i % 256]) * (i % 50) for i in range(1300)]  # wide: B4's route
assert CUDACSP(device="cpu").hash_batch(msgs) == [
    hashlib.sha256(m).digest() for m in msgs]
# a port-minted world and block through the port's validator
world = chip_smoke.validator_world(5)
blocks, expect, _ = chip_smoke.validator_blocks(world, 1, 8,
                                                world.genesis_hash)
from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
from fabric_tpu_torch.peer.txvalidator import TxValidator
bundle = bundle_from_genesis(world.genesis)
v = TxValidator(chip_smoke.VALIDATOR_CHANNEL, chip_smoke.EmptyLedger(),
                bundle, CUDACSP(device="cpu"))
flags = v.validate(blocks[0])
assert flags == [expect.get((0, i), 0) for i in range(8)], flags
# ... and committed into an on-disk port ledger, then read back
import sqlite3, tempfile
from fabric_tpu_torch.ledger import LedgerProvider
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.protos import common as cb
with tempfile.TemporaryDirectory() as root:
    provider = LedgerProvider(root)
    ledger = provider.create(cb.Block.decode(world.genesis))
    committer = Committer(TxValidator(chip_smoke.VALIDATOR_CHANNEL, ledger,
                                      bundle, CUDACSP(device="cpu")), ledger)
    assert list(committer.store_stream(blocks, depth=2)) == [flags]
    provider.close()
    again = LedgerProvider(root).open(chip_smoke.VALIDATOR_CHANNEL)
    assert again.height == 2 and again.durable_height == 2
    got = again.get_block_by_number(1)
    assert list(got.data.data) == list(cb.Block.decode(blocks[0]).data.data)
    assert got.metadata.metadata[cb.TRANSACTIONS_FILTER] == bytes(flags)
    for i, f in enumerate(flags):
        value = again.get_state(chip_smoke.VALIDATOR_CC, f"k0-{i}")
        assert value == (b"v%d" % i if f == 0 else None), (i, f, value)
    assert again.get_history_for_key(chip_smoke.VALIDATOR_CC, "k0-0") == \
        [(1, 0)]
# the read side, parallel MVCC, an index and a snapshot round trip
import os
from fabric_tpu_torch.common import workpool
with tempfile.TemporaryDirectory() as root:
    seed, sb, pays, sb_flags = chip_smoke.smallbank_blocks(
        world, world.genesis_hash, n_accounts=40, n_txs=36, n_blocks=2)
    provider = LedgerProvider(root, csp=CUDACSP(device="cpu"))
    ledger = provider.create(cb.Block.decode(world.genesis))
    ledger.define_index("checking", "color")
    committer = Committer(TxValidator(
        chip_smoke.VALIDATOR_CHANNEL, ledger, bundle,
        CUDACSP(device="cpu", min_device_batch=1 << 30)), ledger)
    assert committer.store_block(seed) == [0]
    assert list(committer.store_stream(sb, depth=2)) == sb_flags
    snap_dir = ledger.snapshots.submit_request(0)["snapshot_dir"]
    other = LedgerProvider(os.path.join(root, "joined"),
                           csp=CUDACSP(device="cpu"))
    joined = other.create_from_snapshot(snap_dir)
    assert joined.height == ledger.height == 4
    assert joined.get_state_multiple("checking", ["acct0000", "acct0039"]) \
        == ledger.get_state_multiple("checking", ["acct0000", "acct0039"])
    assert joined.new_query_executor().get_state("savings", "acct0001") \
        == b"1000"
    sim = joined.new_tx_simulator()
    assert sim.get_query_result("checking", '{"selector": {}}') == []
    assert [k for k, _ in sim.get_state_range("checking", "", "acct0002")] \
        == ["acct0000", "acct0001"]
    assert sim.get_tx_simulation_results()
    other.close()
    provider.close()
# the idemix MSP, a nym signature and a CRI on the port's P-384
import random
from fabric_tpu_torch.idemix import revocation
from fabric_tpu_torch.msp import idemixmsp
from fabric_tpu_torch.protos import msp as mb
rng = random.Random(3)
issuer = idemixmsp.generate_issuer(rng)
signer = idemixmsp.issue_signer_config(issuer, "Idx", "ou1",
                                       idemixmsp.ROLE_ADMIN, "eve", rng=rng)
imsp = idemixmsp.IdemixMSP.from_config(mb.MSPConfig.decode(
    idemixmsp.idemix_msp_config(issuer, "Idx", signer).encode()), rng=rng)
me = imsp.get_default_signing_identity()
ident = imsp.deserialize_identity(me.serialize())
assert ident.is_admin and imsp.verify(ident, b"m", me.sign(b"m"))
ra = revocation.generate_long_term_revocation_key(rng)
cri = revocation.create_cri(ra, 2, rng=rng)
assert revocation.verify_epoch_pk(ra.public_key(), cri)
# the admin tools and a sharded root, reopened by a fresh provider
from fabric_tpu_torch.ledger import admin, kvstore
with tempfile.TemporaryDirectory() as root:
    os.environ["FABRIC_TPU_STORE_SHARDS"] = "2"
    provider = LedgerProvider(root)
    ledger = provider.create(cb.Block.decode(world.genesis))
    committer = Committer(TxValidator(chip_smoke.VALIDATOR_CHANNEL, ledger,
                                      bundle, CUDACSP(device="cpu")), ledger)
    assert list(committer.store_stream(blocks, depth=2)) == [flags]
    provider.close()
    del os.environ["FABRIC_TPU_STORE_SHARDS"]
    again = LedgerProvider(root)
    assert isinstance(again.kv, kvstore.ShardedKVStore)
    assert again.open(chip_smoke.VALIDATOR_CHANNEL).height == 2
    again.close()
    admin.pause(root, chip_smoke.VALIDATOR_CHANNEL)
    assert admin.paused_channels(root) == {chip_smoke.VALIDATOR_CHANNEL}
# one block ordered by the port's solo orderer, delivered to a peer whose
# deliver client checks its signature, and committed
from fabric_tpu_torch.common import deliver
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.orderer.broadcast import BroadcastHandler
from fabric_tpu_torch.orderer.multichannel import Registrar
from fabric_tpu_torch.peer.deliverclient import DeliverClient
genesis = chip_smoke.order_genesis(world, 8, 1 << 20, 1 << 20, "60s")
reg = Registrar(None, HostCSP(), signer=chip_smoke.orderer_identity(world))
reg.startup([cb.Block.decode(genesis)])
h = BroadcastHandler(reg)
envs = list(cb.Block.decode(blocks[0]).data.data)
assert [h.process_message(cb.Envelope.decode(e)) for e in envs] == [
    cb.BAD_REQUEST if expect.get((0, i)) == 2 else
    cb.FORBIDDEN if expect.get((0, i)) == 4 else cb.SUCCESS
    for i in range(8)]
import time
deadline = time.monotonic() + 30
while time.monotonic() < deadline and reg.get_chain(
        chip_smoke.VALIDATOR_CHANNEL).store.height < 1:
    time.sleep(0.01)
svc = deliver.DeliverService(reg.get_chain, HostCSP())
got = []
def connect(start):
    env = deliver.make_seek_info_envelope(
        chip_smoke.VALIDATOR_CHANNEL, start, "newest", signer=world.client)
    return (b for kind, b in svc.deliver(env) if kind == "block")
dc = DeliverClient(chip_smoke.VALIDATOR_CHANNEL, [connect], lambda: 1,
                   lambda seq, raw: got.append(raw),
                   bundle=bundle_from_genesis(genesis), csp=HostCSP())
reg.halt_all()  # the solo chain cuts its pending batch as it halts
dc.start()
deadline = time.monotonic() + 30
while not got and time.monotonic() < deadline:
    time.sleep(0.01)
dc.stop()
assert len(got) >= 1 and cb.Block.decode(got[0]).header.number == 1
with tempfile.TemporaryDirectory() as root:
    provider = LedgerProvider(root)
    ledger = provider.create(cb.Block.decode(genesis))
    committer = Committer(TxValidator(
        chip_smoke.VALIDATOR_CHANNEL, ledger, bundle_from_genesis(genesis),
        CUDACSP(device="cpu")), ledger)
    assert len(list(committer.store_stream(got[:1], depth=2))[0]) == 6
    provider.close()
# one proposal endorsed through a shim chaincode, ordered by a single-node
# raft chain of the port's registrar (its WAL on disk) and committed
from fabric_tpu_torch.chaincode.shim import Chaincode, success
from fabric_tpu_torch.chaincode.support import ChaincodeSupport, InProcStream
from fabric_tpu_torch.orderer.multichannel import ChannelStepRouter
from fabric_tpu_torch.orderer.raft import InProcTransport
from fabric_tpu_torch.peer.endorser import Endorser
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.protos import peer as pb
class Put(Chaincode):
    def invoke(self, stub):
        stub.put_state("k", stub.get_args()[0])
        return success()
def put(sim, args):
    resp, _ = support.execute("benchcc", "", "t%d" % len(resps), sim, args)
    return resp.status, resp.message, resp.payload
raft_genesis = chip_smoke.order_genesis(world, 1, 1 << 20, 1 << 20, "60s",
                                        consensus_type="etcdraft")
with tempfile.TemporaryDirectory() as root:
    support = ChaincodeSupport()
    stream = InProcStream(support, Put(), "benchcc")
    stream.start()
    stream.wait_registered(support, "benchcc")
    provider = LedgerProvider(f"{root}/peer")
    ledger = provider.create(cb.Block.decode(raft_genesis))
    rbundle = bundle_from_genesis(raft_genesis)
    prop, _ = pu.create_chaincode_proposal(
        world.client.serialize(), chip_smoke.VALIDATOR_CHANNEL, "benchcc",
        [b"v"])
    sp = pb.SignedProposal(proposal_bytes=prop.encode(),
                           signature=world.client.sign(prop.encode()))
    resps = []
    for peer in world.peers[:3]:
        resps.append(Endorser(chip_smoke.VALIDATOR_CHANNEL, ledger, rbundle,
                              peer, {"benchcc": put}, HostCSP())
                     .process_proposal(sp))
    env = pu.create_signed_tx(prop, world.client, resps)
    router = ChannelStepRouter(InProcTransport())
    reg = Registrar(f"{root}/orderer", HostCSP(),
                    signer=chip_smoke.orderer_identity(world),
                    transport=router)
    router.register(1, None)
    reg.startup([cb.Block.decode(raft_genesis)])
    cs = reg.get_chain(chip_smoke.VALIDATOR_CHANNEL)
    deadline = time.monotonic() + 30
    while not cs.chain.is_leader and time.monotonic() < deadline:
        time.sleep(0.01)
    assert BroadcastHandler(reg).process_message(env) == cb.SUCCESS
    while cs.store.height < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    reg.halt_all()
    stream.stop()
    assert os.path.getsize(f"{root}/orderer/raft/"
                           f"{chip_smoke.VALIDATOR_CHANNEL}/raft.wal") > 0
    committer = Committer(TxValidator(
        chip_smoke.VALIDATOR_CHANNEL, ledger, rbundle, CUDACSP(device="cpu")),
        ledger)
    assert list(committer.store_stream([cs.store.get_block_by_number(1)],
                                       depth=2)) == [[0]]
    assert ledger.new_query_executor().get_state("benchcc", "k") == b"v"
    provider.close()
workpool.shutdown()
assert not any(k in ("jax", "yaml", "cryptography")
               or k.startswith(("jax.", "fabric_tpu.", "google.protobuf"))
               for k, v in sys.modules.items() if v is not None)
print("modules", len(mods))
"""


_BLOCKED_COMM = """
import sys
for name in ("jax", "jaxlib", "fabric_tpu", "cryptography", "google.protobuf",
             "yaml"):
    sys.modules[name] = None
import hashlib, tempfile
from fabric_tpu_torch.comm import RPCClient, RPCServer
from fabric_tpu_torch.comm.tls import credentials_from_ca
from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.common.crypto import CA
from fabric_tpu_torch.csp import custody
from fabric_tpu_torch.csp.hostref import HostCSP
ca = CA("tlsca.example.com", "example.com")
server = RPCServer(tls=credentials_from_ca(ca, "server"))
server.register("echo", lambda body, stream: stream.peer_cert[:1] + body)
server.start()
client_tls = credentials_from_ca(ca, "client")
with tracing.scope() as rec:
    got = RPCClient(*server.addr, tls=client_tls).call("echo", b"x")
assert got == b"0x", got
assert {ev["name"] for ev in rec.snapshot()} == {"rpc.call", "rpc.serve"}
server.stop()
with tempfile.TemporaryDirectory() as keys:
    daemon = custody.KeyCustodyServer(keys, b"pin", tls=credentials_from_ca(
        ca, "custody"))
    daemon.start()
    csp = custody.CustodyCSP(daemon.addr, b"pin", verify_csp=HostCSP(),
                             tls=client_tls)
    key = csp.key_gen()
    digest = hashlib.sha256(b"m").digest()
    assert csp.verify(key, csp.sign(key, digest), digest)
    daemon.stop()
assert not any(k in ("jax", "yaml", "cryptography")
               or k.startswith(("jax.", "fabric_tpu.", "google.protobuf"))
               for k, v in sys.modules.items() if v is not None)
print("comm ok")
"""


def test_tls_rpc_and_custody_run_without_jax_or_cryptography():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_COMM], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("comm ok")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def test_port_imports_and_verifies_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout
    assert int(proc.stdout.split()[-1]) >= 20


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_of_the_port_imports_forbidden_modules():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    # the commit path's modules are among the files scanned
    assert {f"ledger/{m}.py" for m in (
        "kvstore", "statedb", "txmgmt", "history", "pvtdatastorage",
        "confighistory", "blkstorage", "kvledger", "richquery",
        "bookkeeping", "snapshot")} | {
        "peer/committer.py", "protoutil.py", "common/workpool.py",
        "common/metrics.py", "common/flogging.py", "devtools/faultline.py",
        "devtools/clockskew.py", "devtools/knob_registry.py",
        "ledger/transientstore.py", "ledger/cceventmgmt.py",
        "ledger/admin.py", "idemix/nymsignature.py", "idemix/weakbb.py",
        "idemix/revocation.py", "csp/hostref384.py",
        "msp/idemixmsp.py", "common/tracing.py", "common/profile.py",
        "devtools/lockwatch.py", "devtools/netsplit.py",
        "comm/__init__.py", "comm/rpc.py", "comm/tls.py",
        "comm/backoff.py", "comm/instrument.py", "csp/keystore.py",
        "csp/custody.py", "common/capabilities.py", "common/configtx.py",
        "common/configtx_builder.py", "common/channelconfig.py",
        "common/deliver.py", "orderer/__init__.py", "orderer/blockcutter.py",
        "orderer/blockwriter.py", "orderer/msgprocessor.py",
        "orderer/broadcast.py", "orderer/solo.py", "orderer/kafka.py",
        "orderer/follower.py", "orderer/multichannel.py",
        "peer/deliverclient.py", "orderer/raft/__init__.py",
        "orderer/raft/raftcore.py", "orderer/raft/wal.py",
        "orderer/raft/transport.py", "orderer/raft/chain.py",
        "protos/lifecycle.py", "common/privdata.py", "peer/aclmgmt.py",
        "peer/endorser.py", "chaincode/__init__.py", "chaincode/shim.py",
        "chaincode/support.py", "chaincode/scc.py", "chaincode/lifecycle.py",
        "chaincode/statebased.py", "protos/gossip.py",
        "protos/discovery.py", "gossip/__init__.py", "gossip/comm.py",
        "gossip/identity.py", "gossip/certstore.py", "gossip/discovery.py",
        "gossip/core.py", "gossip/election.py", "gossip/state.py",
        "gossip/privdata.py", "gossip/service.py", "discovery/__init__.py",
        "discovery/inquire.py", "discovery/endorsement.py",
        "discovery/service.py", "discovery/client.py",
        "gateway/__init__.py", "gateway/core.py"} <= scanned
    bad = []
    for path in _port_files():
        for name in _imported(path):
            if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_ANGLE_INCLUDE = re.compile(r"^\s*#\s*include\s+<([^>]+)>", re.M)


def test_no_cxx_source_of_the_port_includes_a_file_outside_it():
    """Every quoted include of the port's C++ and CUDA sources (the
    kernels' csrc/ and the host library's native/) names a file beside
    it in the port; angle includes name no path, and neither build adds
    an include directory."""
    sources = [p for ext in ("*.cu", "*.cuh", "*.cpp", "*.cc", "*.h")
               for p in PORT.rglob(ext) if "build" not in p.parts]
    assert {p.parent.name for p in sources} == {"csrc", "native"}
    bad = []
    for path in sources:
        text = path.read_text()
        for inc in _QUOTED_INCLUDE.findall(text):
            target = (path.parent / inc).resolve()
            if not target.is_file() or PORT not in target.parents:
                bad.append(f"{path.relative_to(ROOT)}: \"{inc}\"")
        for inc in _ANGLE_INCLUDE.findall(text):
            if "/" in inc or "fabric" in inc:
                bad.append(f"{path.relative_to(ROOT)}: <{inc}>")
    assert not bad, bad
    assert not any(f.startswith("-I") for f in (*build.NVCC_FLAGS,
                                                *native.CXX_FLAGS))


def test_collect_cc_includes_the_standard_library_and_dlfcn_only():
    """The block walk's C++ includes no header of the JAX package (or any
    other file): the C++ standard library and, for its dlopen of
    libcrypto, <dlfcn.h>."""
    text = (PORT / "native" / "collect.cc").read_text()
    assert not _QUOTED_INCLUDE.findall(text)
    assert set(_ANGLE_INCLUDE.findall(text)) <= {
        "cstdint", "cstring", "string", "new", "dlfcn.h"}
    assert "collect.cc" in native.SOURCES


def test_ecverify_cc_includes_the_standard_library_and_dlfcn_only():
    """The host ECDSA verifier dlopens libcrypto: it includes no OpenSSL
    header, no header of the JAX package, and no other file."""
    text = (PORT / "native" / "ecverify.cc").read_text()
    assert not _QUOTED_INCLUDE.findall(text)
    assert set(_ANGLE_INCLUDE.findall(text)) <= {
        "cstdint", "cstring", "map", "mutex", "string", "vector", "dlfcn.h"}
    assert "ecverify.cc" in native.SOURCES


def test_cudacsp_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDACSP()
    with pytest.raises(ValueError):
        CUDACSP(device="meta")


def test_idemixcsp_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IdemixCSP()
    assert IdemixCSP(device="cpu").device == torch.device("cpu")


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "_libs", {})
    assert build.find_nvcc() is None
    for name in ("p256_verify", "bn254_commit", "sha256"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load(name)
    assert build._libs == {}


def test_build_key_is_per_source():
    """Each library's cache key covers its own source and the headers it
    includes: no two kernel sources share one."""
    keys = {src: build._build_key(src, "nvcc") for src in build.SOURCES}
    assert set(build.SOURCES) == {"p256_verify.cu", "bn254_commit.cu",
                                  "sha256.cu"}
    assert len(set(keys.values())) == len(keys)
    assert build._build_key("bn254_commit.cu", "other") != keys[
        "bn254_commit.cu"]


def test_warm_build_skips_and_a_changed_source_rebuilds_alone(
        tmp_path, monkeypatch):
    """With a stand-in nvcc that records its calls: the first build
    compiles every source, a warm one none, and a change to one source's
    header rebuilds that source alone; the log is kept per library."""
    calls = tmp_path / "calls"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        "echo 'ptxas info    : Used 1 registers'\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
        "  shift\n"
        "done\n")
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_logs", {})
    monkeypatch.setattr(build, "_seconds", {})

    def compiled():
        lines = calls.read_text().splitlines() if calls.exists() else []
        return sorted(Path(line.split()[-1]).name for line in lines)

    paths = build.build_all()
    assert sorted(paths) == ["bn254_commit", "p256_verify", "sha256"]
    assert compiled() == sorted(build.SOURCES)
    assert all(build.build_seconds(n) is not None for n in paths)
    assert all("registers" in build.build_log(n) for n in paths)
    assert build.build_all() == paths
    assert compiled() == sorted(build.SOURCES)
    header = csrc / "bn254_commit.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    again = build.build_all()
    assert compiled() == sorted([*build.SOURCES, "bn254_commit.cu"])
    assert again["p256_verify"] == paths["p256_verify"]
    assert again["sha256"] == paths["sha256"]
    assert again["bn254_commit"] != paths["bn254_commit"]


def test_build_reports_compiler_failure(tmp_path, monkeypatch):
    """A failing nvcc raises with its output; nothing is cached."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path.parent / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="no card here"):
        build.load()
    assert build._libs == {}
    assert not list((tmp_path / "build").rglob("*.so"))


def test_wrapper_refuses_other_devices():
    t = {k: torch.zeros((8, 4), dtype=torch.int32, device="meta")
         for k in ("qx", "qy", "d1", "d2", "cand0")}
    t["flags"] = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.verify_packed(t)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No result without CUDA, from the repo and from a directory that
    holds chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(SMOKE, alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd,
            capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# -- the BN254 kernel's source, built for the host ------------------------------

CSRC = Path(bk.__file__).resolve().parent / "csrc"
P = fp254.P


@pytest.fixture(scope="module")
def bn254_host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    out = tmp_path_factory.mktemp("bn254host") / "libbn254host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
         str(CSRC / "bn254_host_check.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bn254_host_commitments.argtypes = (
        [vp] * 4 + [i32] + [vp] * 2 + [i32, vp, i32])
    lib.bn254_host_terms.argtypes = (
        [vp] * 4 + [i32] + [vp] * 2 + [i32, vp, i32])
    lib.bn254_host_reduce.argtypes = [vp, vp, i32, vp, i32]
    lib.bn254_host_field.argtypes = [i32, vp, vp, vp, i32]
    lib.bn254_host_point.argtypes = [i32, vp, vp, vp, i32]
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _words(vals):
    return np.ascontiguousarray(fp254.words_from_ints(vals).T)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bn254_kernel_field_on_host_matches_python_ints(op, bn254_host_lib):
    """The kernel's CIOS Montgomery arithmetic at R = 2^256 on operands in
    its lazy range [0, 2p), the result made canonical."""
    rng = random.Random(21)
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    xs = edges + [rng.randrange(2 * P) for _ in range(300)]
    ys = list(reversed(edges)) + [rng.randrange(2 * P) for _ in range(300)]
    r = np.zeros((len(xs), 8), np.uint32)
    a, b = _words(xs), _words(ys)
    bn254_host_lib.bn254_host_field(["add", "sub", "mul"].index(op), _ptr(a),
                                    _ptr(b), _ptr(r), len(xs))
    r_inv = pow(fp254.R, -1, P)
    want = {
        "add": lambda x, y: x + y,
        "sub": lambda x, y: x - y,
        "mul": lambda x, y: x * y * r_inv,
    }[op]
    assert fp254.words_to_ints(r.T) == [want(x, y) % P for x, y in
                                        zip(xs, ys)]


def _jacobian(pt, z):
    """Affine int point -> Montgomery Jacobian ints with the given z."""
    x, y = pt
    return (fp254.to_mont(x * z * z), fp254.to_mont(y * z ** 3),
            fp254.to_mont(z))


def _point_rows(points):
    """[(x, y, z, inf)] Montgomery ints -> (n, 25) words."""
    out = np.zeros((len(points), 25), np.uint32)
    for i, (x, y, z, inf) in enumerate(points):
        out[i, :24] = np.concatenate([_words([x]), _words([y]),
                                      _words([z])], axis=1)[0]
        out[i, 24] = inf
    return out


def _plain_point(fp, points):
    """The same (x, y, z, inf) list as plain tensors."""
    t = fp.from_ints
    return (t([p[0] for p in points]), t([p[1] for p in points]),
            t([p[2] for p in points]),
            torch.tensor([bool(p[3]) for p in points]))


def _plain_rows(fp, pt):
    x, y, z, inf = pt
    rows = []
    for c in (x, y, z):
        c = torch.where(inf[:, None], 0, fp.canon(c))
        rows.append(fp.to_words(c).numpy().view(np.uint32).T)
    return np.concatenate(rows + [inf.numpy().astype(np.uint32)[:, None]],
                          axis=1)


def test_bn254_kernel_points_on_host_match_plain(bn254_host_lib):
    """Doubling, full add and mixed add of the kernel against the plain
    PyTorch formulas, canonical words, on generic pairs and every
    degenerate case: equal points in other Jacobian forms (the
    doubling), opposite points (infinity) and an identity operand on
    either side."""
    rng = random.Random(22)
    g = bn.G1_GEN
    pts = [bn.g1_mul(g, k) for k in (3, 5, 11)]
    zs = [rng.randrange(1, P) for _ in range(8)]
    jac = [_jacobian(p, z) + (0,) for p, z in zip(pts, zs)]
    inf = (0, 0, 0, 1)
    p1 = [jac[0], jac[0], jac[0], jac[1], inf, jac[2], inf]
    p2 = [jac[1],
          _jacobian(pts[0], zs[5]) + (0,),          # P + P: the doubling
          _jacobian(bn.g1_neg(pts[0]), zs[6]) + (0,),  # P + (-P)
          jac[2], jac[1], inf, inf]
    # the mixed add reads the second operand as affine (z = 1)
    p2_aff = [(fp254.to_mont(q[0]), fp254.to_mont(q[1]), fp254.to_mont(1),
               0) for q in (pts[1], pts[0], bn.g1_neg(pts[0]), pts[2],
                            pts[1])] + [inf, inf]
    fp = fp254.FpBN254("cpu")
    a1 = _plain_point(fp, p1)
    ax, ay, _, ainf = _plain_point(fp, p2_aff)
    plain = {
        0: bn254_ec.dbl(fp, a1),
        1: bn254_ec.add_full(fp, a1, _plain_point(fp, p2)),
        2: bn254_ec.add_mixed(fp, a1, (ax, ay, ainf)),
    }
    rows1 = _point_rows(p1)
    for op, second in ((0, p2), (1, p2), (2, p2_aff)):
        rows2 = _point_rows(second)
        got = np.zeros((len(p1), 25), np.uint32)
        bn254_host_lib.bn254_host_point(op, _ptr(rows1), _ptr(rows2),
                                        _ptr(got), len(p1))
        np.testing.assert_array_equal(got, _plain_rows(fp, plain[op]),
                                      err_msg=str(op))
    # the degenerate lanes took their branches
    assert plain[1][3].tolist() == [False, False, True, False, False, False,
                                    True]


def _host_run(lib, t: dict, n_terms: int, n_shared: int):
    """The kernel's two phases built for the host, on the plain version's
    inputs: (partials, output) as uint32 arrays."""
    a = {k: np.ascontiguousarray(v.numpy()) for k, v in t.items()}
    n = a["lanes"].shape[1]
    part = np.zeros((bk.PART_ROWS * n_terms, n), np.uint32)
    lib.bn254_host_terms(
        _ptr(a["lanes"]), _ptr(a["laneinf"]), _ptr(a["digits"]),
        _ptr(a["termmeta"]), n_terms, _ptr(a["comb_xy"]),
        _ptr(a["comb_inf"]), n_shared, _ptr(part), n)
    out = np.zeros((bk.OUT_ROWS, n), np.uint32)
    lib.bn254_host_reduce(_ptr(part), _ptr(a["termmeta"]), n_terms,
                          _ptr(out), n)
    whole = np.zeros_like(out)
    lib.bn254_host_commitments(
        _ptr(a["lanes"]), _ptr(a["laneinf"]), _ptr(a["digits"]),
        _ptr(a["termmeta"]), n_terms, _ptr(a["comb_xy"]),
        _ptr(a["comb_inf"]), n_shared, _ptr(whole), n)
    np.testing.assert_array_equal(whole, out)
    return part, out


def _plain_run(t: dict):
    part = bk.term_partials_plain(t)
    out = bk.reduce_plain(part, t["termmeta"])
    np.testing.assert_array_equal(out.numpy(),
                                  bk.commitments_plain(t).numpy())
    return part.numpy().view(np.uint32), out.numpy().view(np.uint32)


def test_bn254_kernel_ladder_on_host_matches_plain(bn254_host_lib):
    """The kernel's term and reduction bodies (bn254_commit.cuh) on a
    small layout of one term per accumulator (a shared base, a lane base,
    both), with a bad lane and a padding lane, word for word against the
    plain version: every term's partial, then the output."""
    rng = random.Random(23)
    g = bn.G1_GEN
    shared_pts = (g, bn.g1_mul(g, 2), bn.g1_mul(g, 3))
    layout = ((1, 3 + 2, 0), (0, 1, 2))
    lanes = [tuple(bn.g1_mul(g, 7 * j + b + 1) for b in range(4))
             for j in range(3)]
    scs = [[rng.randrange(bn.R) for _ in layout[0]] for _ in range(3)]
    packed = bk.pack(lanes, scs, [True, False, True], *layout, lanes=4)
    t = bk.upload(packed, bb.shared_comb(shared_pts), "cpu")
    want_part, want = _plain_run(t)
    got_part, got = _host_run(bn254_host_lib, t, len(layout[0]),
                              len(shared_pts))
    np.testing.assert_array_equal(got_part, want_part)
    np.testing.assert_array_equal(got, want)
    aff = bb.to_affine(bk.unpack(want), [True] * 4)
    assert aff[0] == (bn.g1_mul(shared_pts[1], scs[0][0]),
                      bn.g1_mul(lanes[0][2], scs[0][1]),
                      bn.g1_mul(g, scs[0][2]))
    assert aff[1] == aff[3] == (None, None, None)


def test_bn254_kernel_reduction_on_host_takes_degenerate_branches(
        bn254_host_lib):
    """Two terms over the same shared base, side by side in T1, and in T3
    a shared base beside a lane base that equals it or its negation:
    equal partials meet in the reduction and double, opposite ones cancel
    to infinity, and the infinity passes the next partial through.  The
    host-built bodies equal the plain version word for word, and every
    lane the host MSM."""
    rng = random.Random(24)
    g = bn.G1_GEN
    shared_pts = (g, bn.g1_mul(g, 2), bn.g1_mul(g, 3))
    layout = ((1, 1, 3 + 2, 0, 3 + 1), (0, 0, 0, 2, 2))
    lanes, scs = [], []
    for j in range(6):
        pts = [bn.g1_mul(g, 7 * j + b + 1) for b in range(4)]
        sc = [rng.randrange(1, bn.R) for _ in layout[0]]
        if j == 1:
            sc[1] = sc[0]  # T1: s 2G + s 2G doubles
        elif j == 2:
            sc[1] = bn.R - sc[0]  # T1: s 2G - s 2G cancels, then + s' B
        elif j in (3, 4):
            pts[1] = g if j == 3 else bn.g1_neg(g)  # T3: s G +- s G
            sc[4] = sc[3]
        lanes.append(tuple(pts))
        scs.append(sc)
    ok = [True] * 5 + [False]
    packed = bk.pack(lanes, scs, ok, *layout, lanes=7)
    t = bk.upload(packed, bb.shared_comb(shared_pts), "cpu")
    want_part, want = _plain_run(t)
    got_part, got = _host_run(bn254_host_lib, t, len(layout[0]),
                              len(shared_pts))
    np.testing.assert_array_equal(got_part, want_part)
    np.testing.assert_array_equal(got, want)
    aff = bb.to_affine(bk.unpack(want), [True] * 7)
    for j in range(5):
        tables = (*shared_pts, *lanes[j])
        assert aff[j] == tuple(
            bn.g1_msm([(tables[tab], s) for tab, acc, s in
                       zip(*layout, scs[j]) if acc == a]) for a in range(3)
        ), j
    assert aff[1][0] == bn.g1_add(bn.g1_mul(g, 4 * scs[1][0]),
                                  bn.g1_mul(lanes[1][2], scs[1][2]))
    assert aff[2][0] == bn.g1_mul(lanes[2][2], scs[2][2])
    assert aff[3][2] == bn.g1_mul(g, 2 * scs[3][3])
    assert aff[4][2] is None
    assert aff[5] == aff[6] == (None, None, None)
    # the partials that meet are finite: the branches came from the sums
    rows = want_part.reshape(len(layout[0]), bk.PART_ROWS, 7)
    assert not rows[:, 24, :5].any()


# -- the device field's PTX, interpreted --------------------------------------

_M32 = (1 << 32) - 1


def _device_asm(func: str, header: str = "bn254_commit.cuh") -> list[str]:
    """The PTX templates of the asm statements of `func` in `header`'s
    __CUDA_ARCH__ branch, in order."""
    src = (CSRC / header).read_text()
    start = src.index("#if defined(__CUDA_ARCH__)")
    dev = src[start:src.index("\n#else  // the host field", start)]
    body = dev[dev.index(f"void {func}("):]
    body = body[:body.index("\n}\n")]
    stmts = re.findall(r"asm\((.*?)\);", body, re.S)
    return ["".join(re.findall(r'"((?:[^"\\]|\\.)*)"', st.split(":")[0]))
            .replace("\\n", "\n").replace("\\t", "") for st in stmts]


def _run_ptx(template: str, ops: list[int]) -> list[int]:
    """Run one asm template on its operands (%0, %1, ...): add, sub and
    mad with .cc carry-out and the c forms' carry-in (a borrow for sub),
    .lo/.hi halves of mad, 32-bit registers."""
    v = list(ops)
    cf = 0

    def get(x):
        return v[int(x[1:])] if x.startswith("%") else int(x, 0)

    for line in template.split("\n"):
        line = line.strip().rstrip(";")
        if not line:
            continue
        op, args = line.split(None, 1)
        a = [x.strip() for x in args.split(",")]
        kind, *mods = op.split(".")
        cin = cf if kind.endswith("c") else 0
        if kind in ("add", "addc"):
            r = get(a[1]) + get(a[2]) + cin
            carry = r >> 32
        elif kind in ("sub", "subc"):
            r = get(a[1]) - get(a[2]) - cin
            carry = int(r < 0)
        elif kind in ("mad", "madc"):
            prod = get(a[1]) * get(a[2])
            prod = prod >> 32 if "hi" in mods else prod & _M32
            r = prod + get(a[3]) + cin
            carry = r >> 32
        else:
            raise ValueError(f"unexpected PTX {op}")
        assert mods[-1] == "u32", op
        v[int(a[0][1:])] = r & _M32
        if "cc" in mods:
            cf = carry
    return v


def _w(x: int) -> list[int]:
    return [(x >> (32 * i)) & _M32 for i in range(8)]


def _device_field(op: str, x: int, y: int) -> int:
    """The header's device fe_add / fe_sub / fe_mul on x, y: its asm
    statements interpreted, with the C between them."""
    a, b, p2 = _w(x), _w(y), _w(2 * P)
    if op == "add":
        t_sum, t_sub = _device_asm("fe_add")
        s = _run_ptx(t_sum, [0] * 8 + a + b)[:8]
        r = _run_ptx(t_sub, [0] * 9 + s + p2)
        keep = r[8]
        out = [(s[i] & keep) | (r[i] & ~keep & _M32) for i in range(8)]
    elif op == "sub":
        t_sub, t_add = _device_asm("fe_sub")
        r = _run_ptx(t_sub, [0] * 9 + a + b)
        out = _run_ptx(t_add, r[:8] + [m & r[8] for m in p2])[:8]
    else:
        t_prod, t_redc = _device_asm("fe_mul")
        t = [0] * 9
        for i in range(8):
            t = _run_ptx(t_prod, t[:8] + [0] + a + [b[i]])[:9]
            m = t[0] * 0xE4866389 & _M32
            t = _run_ptx(t_redc, t + [m] + _w(P))[:9]
            assert t[0] == 0
            t = t[1:]
        out = t[:8]
    return sum(w << (32 * i) for i, w in enumerate(out))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bn254_device_field_chains_match_python_ints(op):
    """The device branch's carry chains give exactly the portable field's
    words: a sum or difference corrected into [0, 2p), and the Montgomery
    product (a b + m p) / R with m = -a b p^-1 mod R."""
    rng = random.Random(25)
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    pairs = [(x, y) for x in edges for y in edges]
    pairs += [(rng.randrange(2 * P), rng.randrange(2 * P))
              for _ in range(300)]
    r = fp254.R
    for x, y in pairs:
        if op == "add":
            want = x + y - 2 * P if x + y >= 2 * P else x + y
        elif op == "sub":
            want = x - y + 2 * P if x < y else x - y
        else:
            want = (x * y + (-x * y * pow(P, -1, r) % r) * P) // r
        assert _device_field(op, x, y) == want, (x, y)


# -- the P-256 device field (p256_verify.cuh), interpreted ---------------------

P256 = 2**256 - 2**224 + 2**192 + 2**96 - 1


def _p256_asm(func: str) -> list[str]:
    return _device_asm(func, "p256_verify.cuh")


def _p256_chain(t: list[int], v: list[int]) -> list[int]:
    """fe_chain<N>: t[0..N-1] += v[0..N-1] as one carry chain."""
    return _run_ptx(_p256_asm("fe_chain")[len(t) - 1], t + v)[:len(t)]


def _p256_select(w: list[int], hi: int) -> list[int]:
    d = _run_ptx(_p256_asm("fe_sub_p_select")[0], [0] * 9 + w + [hi])
    keep = d[8]
    return [(w[i] & keep) | (d[i] & ~keep & _M32) for i in range(8)]


def _p256_chain_calls(func: str) -> list[tuple[str, str, str]]:
    """The fe_chain<N>(dst + offset, src + offset) calls of `func` in the
    header's __CUDA_ARCH__ branch, in order, as C expressions (N, offset
    into dst, offset into src), an empty offset for none."""
    src = (CSRC / "p256_verify.cuh").read_text()
    start = src.index("#if defined(__CUDA_ARCH__)")
    dev = src[start:src.index("\n#else  // the host field", start)]
    body = dev[dev.index(f"void {func}("):]
    body = body[:body.index("\n}\n")]
    return re.findall(r"fe_chain<([^>]+)>\(\w+(?: \+ ([^,]+))?, "
                      r"\w+(?: \+ ([^)]+))?\)", body)


def _c_int(expr: str, **names: int) -> int:
    """An integer C expression of + and * over `names` (empty: 0)."""
    return eval(expr or "0", {"__builtins__": {}}, names)


# The row loops of fe_mul_wide, fe_sqr_row and fe_sqr_wide are C++, not
# asm: the two helpers below mirror them, but take every chain's length
# and word offsets from the header's fe_chain calls, so that a wrong
# offset or length there fails here too.  What they still mirror by hand
# is the split of each wide product into its low and high words, the
# first row's copy in place of a chain, the cross products' doubling by a
# shift and the squares' layout; those show only on the card
# (chip_smoke's phase_field checks each operation against Python ints).


def _p256_mul_wide(a: list[int], b: list[int]) -> list[int]:
    """fe_mul_wide: per row, the 8 wide products' low halves chained in
    at word i, their high halves at word i + 1."""
    (n_lo, o_lo, _), (n_hi, o_hi, _) = _p256_chain_calls("fe_mul_wide")
    t = [0] * 16
    for i in range(8):
        prods = [a[j] * b[i] for j in range(8)]
        lo = [x & _M32 for x in prods] + [0]
        hi = [x >> 32 for x in prods]
        if i == 0:
            t[:9] = lo
        else:
            o, n = _c_int(o_lo, i=i), _c_int(n_lo, i=i)
            t[o:o + n] = _p256_chain(t[o:o + n], lo[:n])
        o, n = _c_int(o_hi, i=i), _c_int(n_hi, i=i)
        t[o:o + n] = _p256_chain(t[o:o + n], hi[:n])
    return t


def _p256_sqr_wide(a: list[int]) -> list[int]:
    """fe_sqr_wide: the cross-product rows, doubled by a shift, plus the
    squares in two chains."""
    (n_lo, o_lo, _), (n_hi, o_hi, _) = _p256_chain_calls("fe_sqr_row")
    c = [0] * 16
    for i in range(7):
        n = 7 - i
        prods = [a[i] * a[i + 1 + k] for k in range(n)]
        lo = [x & _M32 for x in prods] + [0]
        hi = [x >> 32 for x in prods]
        if i == 0:
            c[1:n + 2] = lo
        else:
            o, m = _c_int(o_lo, I=i, kN=n), _c_int(n_lo, I=i, kN=n)
            c[o:o + m] = _p256_chain(c[o:o + m], lo[:m])
        o, m = _c_int(o_hi, I=i, kN=n), _c_int(n_hi, I=i, kN=n)
        c[o:o + m] = _p256_chain(c[o:o + m], hi[:m])
    d = [0] + [((c[i] << 1) | (c[i - 1] >> 31)) & _M32 for i in range(1, 16)]
    t = []
    for i in range(8):
        t += [(a[i] * a[i]) & _M32, (a[i] * a[i]) >> 32]
    (n_sq, o_sq, _), (n_d, o_t, o_d) = _p256_chain_calls("fe_sqr_wide")
    o, n = _c_int(o_sq), _c_int(n_sq)
    t[o:o + n] = _p256_chain(t[o:o + n], (d[:8] + [0])[:n])
    o, n, od = _c_int(o_t), _c_int(n_d), _c_int(o_d)
    t[o:o + n] = _p256_chain(t[o:o + n], d[od:od + n])
    return t


def _p256_reduce(c: list[int]) -> list[int]:
    """fe_reduce_wide's six statements on the 16 words c."""
    s5p, s_u, s_2u, s_pos, s_neg, s_fold = _p256_asm("fe_reduce_wide")
    r = _run_ptx(s5p, [0] * 8 + [4] + c[:8])
    w, top = r[:8], r[8]
    u = _run_ptx(s_u, [0] * 5 + [0] + c[11:16])[:6]
    r = _run_ptx(s_2u, w[3:8] + [top] + u)
    w, top = w[:3] + r[:5], r[5]
    r = _run_ptx(s_pos, w + [top] + c[8:16])
    r = _run_ptx(s_neg, r[:9] + c[8:16])
    w, top = r[:8], r[8]
    r = _run_ptx(s_fold, w + [0, top])
    return _p256_select(r[:8], r[8])


def _p256_device_field(op: str, x: int, y: int) -> int:
    """The header's device fe_add / fe_sub / fe_mul / fe_sqr, or
    fe_reduce_wide on the 512-bit x, interpreted."""
    a, b = _w(x), _w(y)
    if op == "add":
        r = _run_ptx(_p256_asm("fe_add")[0], [0] * 9 + a + b)
        out = _p256_select(r[:8], r[8])
    elif op == "sub":
        t_sub, t_add = _p256_asm("fe_sub")
        r = _run_ptx(t_sub, [0] * 9 + a + b)
        out = _run_ptx(t_add, r[:8] + [r[8], r[8] & 1])[:8]
    elif op == "mul":
        out = _p256_reduce(_p256_mul_wide(a, b))
    elif op == "sqr":
        out = _p256_reduce(_p256_sqr_wide(a))
    else:
        out = _p256_reduce([(x >> (32 * i)) & _M32 for i in range(16)])
    return sum(w << (32 * i) for i, w in enumerate(out))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr", "reduce"])
def test_p256_device_field_chains_match_python_ints(op):
    """The P-256 device branch's carry chains give Python ints' values mod
    p, canonical: add and sub on canonical operands, the product and the
    square of any 256-bit words, and the reduction of any 512-bit
    value."""
    rng = random.Random(26)
    if op == "reduce":
        edges = [0, 1, P256 - 1, P256, P256 * P256 - 1, (P256 - 1) ** 2,
                 2**256 - 1, 2**256, 2**512 - 1, 2**511, 2**480 - 1]
        pairs = [(x, 0) for x in edges]
        pairs += [(rng.randrange(2**512), 0) for _ in range(300)]
    else:
        top = P256 if op in ("add", "sub") else 2**256
        edges = [0, 1, P256 - 1] + ([P256, P256 + 1, 2**256 - 1]
                                    if top > P256 else [])
        pairs = [(x, y) for x in edges for y in edges]
        pairs += [(rng.randrange(top), rng.randrange(top))
                  for _ in range(300)]
    for x, y in pairs:
        want = {"add": x + y, "sub": x - y, "mul": x * y, "sqr": x * x,
                "reduce": x}[op] % P256
        assert _p256_device_field(op, x, y) == want, (x, y)


@pytest.fixture(autouse=True, scope="module")
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file (the session's own gate watches the JAX
    package's module only)."""
    yield
    from fabric_tpu_torch.common import workpool as _pool
    from fabric_tpu_torch.devtools import lockwatch as _watch

    _pool.shutdown()
    assert not _watch.drain_threads(timeout=15.0)
    assert not _watch.violations and not _watch.thread_violations
