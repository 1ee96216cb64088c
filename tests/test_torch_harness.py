"""The port's chaos harness (`devtools.netident`, `invariants`,
`netharness`, `netnode`, `netscope`, `faultfuzz`) against the JAX
package's.

- netident: the genesis block, the transactions, `FakeCSP`'s masks and
  `NetMCS`'s signatures are byte-equal.
- Both schedule generators give equal schedules for seeds 7 and 11.
- invariants: equal violations and an equal `state_digest` over the same
  ledger contents (each package's ledger, the same blocks), equal
  snapshot, import and partition judgments, and `check_breaker` judges
  `CUDACSP`'s breaker as the reference judges `TPUCSP`'s after the same
  faultline plan.
- netscope: byte-identical virtual-clock artifacts from the same scrape
  text (the merged trace apart from its `source`).
- faultfuzz: the discovered fault-point registry (names and kinds) and a
  seeded three-plan campaign's verdicts and canonical trip ledgers are
  equal.
- One multi-process run in each package: `Topology(orgs=1,
  peers_per_org=2, orderers=1, seed=7)` (its batch timer at 1 s, so that
  only the count cuts blocks), 80 transactions, one peer SIGKILLed.  The verdicts are equal but for `rpcmap_sha256` (each
  package's hash of its own tree's static RPC map), and the final state
  digests are equal; the port's repro, which pins the port's hash,
  replays to the same verdict, and every node exits 0 on SIGTERM.
- fabriclint's two harness functions: the port's verdict pins the sha256
  of the port's fabriclint rpcmap, `replay_repro` replays a repro that
  pins it and refuses (`NetError`) one that pins another (a pinned
  divergence: the JAX package's replays any), and `export_registry`
  gives the checked-in `faultmap_registry.json`.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import shutil
import threading

import pytest

from fabric_tpu.devtools import clockskew as jclock
from fabric_tpu.devtools import faultfuzz as jff
from fabric_tpu.devtools import faultline as jfault
from fabric_tpu.devtools import invariants as jinv
from fabric_tpu.devtools import netharness as jnh
from fabric_tpu.devtools import netident as jni
from fabric_tpu.devtools import netscope as jscope
from fabric_tpu.ledger import LedgerProvider as JaxProvider
from fabric_tpu.ledger import snapshot as jsnap
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.csp.api import VerifyBatchItem
from fabric_tpu_torch.devtools import clockskew as pclock
from fabric_tpu_torch.devtools import faultfuzz as pff
from fabric_tpu_torch.devtools import faultline as pfault
from fabric_tpu_torch.devtools import invariants as pinv
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.devtools import netharness as pnh
from fabric_tpu_torch.devtools import netident as pni
from fabric_tpu_torch.devtools import netscope as pscope
from fabric_tpu_torch.ledger import LedgerProvider as PortProvider
from fabric_tpu_torch.ledger import snapshot as psnap

PKG = {
    "jax": dict(nh=jnh, ni=jni, inv=jinv, ff=jff, scope=jscope,
                clock=jclock, fault=jfault, provider=JaxProvider,
                snap=jsnap),
    "port": dict(nh=pnh, ni=pni, inv=pinv, ff=pff, scope=pscope,
                 clock=pclock, fault=pfault, provider=PortProvider,
                 snap=psnap),
}


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


def _enc(msg) -> bytes:
    return msg.SerializeToString() if hasattr(msg, "SerializeToString") \
        else msg.encode()


# ---------------------------------------------------------------------------
# netident
# ---------------------------------------------------------------------------


def test_netident_derives_the_references_bytes():
    for ch in ("netchan", "other"):
        assert _enc(pni.make_genesis(ch)) == _enc(jni.make_genesis(ch))
    for orgs in (1, 2, 3, 5):
        for k in range(4):
            args = (f"ch{orgs}", f"k{k:06d}", b"v%d:" % k + b"f" * 64)
            assert pni.make_tx(*args, orgs=orgs) == \
                jni.make_tx(*args, orgs=orgs)
    assert pni.make_tx("c", "k", b"v", cc="other", creator=b"cre:x") == \
        jni.make_tx("c", "k", b"v", cc="other", creator=b"cre:x")
    assert pni.org_endorsers(3) == jni.org_endorsers(3)
    ident = b"end:org2"
    digest = bytes(range(32))
    assert pni.sign_as(ident, digest) == jni.sign_as(ident, digest)
    pk, jk = pni.key_of(ident), jni.key_of(ident)
    assert (pk.x, pk.y) == (jk.x, jk.y)
    # FakeCSP: the same mask over good, tampered and foreign lanes
    lanes = []
    for i in range(8):
        who = b"end:org%d" % (i % 3)
        d = bytes([i]) * 32
        sig = pni.sign_as(who, d)
        if i % 3 == 1:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        if i == 5:
            d = bytes(32)
        lanes.append((who, d, sig))
    pmask = pni.FakeCSP().verify_batch(
        [VerifyBatchItem(pni.key_of(w), d, s) for w, d, s in lanes])
    jmask = jni.FakeCSP().verify_batch(
        [jni.VerifyBatchItem(jni.key_of(w), d, s) for w, d, s in lanes])
    assert pmask == jmask and 0 < sum(pmask) < len(pmask)
    assert pni.FakeCSP().hash_batch([b"a", b""]) == \
        jni.FakeCSP().hash_batch([b"a", b""])
    pm, jm = pni.NetMCS(b"s3cret"), jni.NetMCS(b"s3cret")
    assert pm.sign(b"payload") == jm.sign(b"payload")
    for sig in (pm.sign(b"payload"), b"forged"):
        assert pm.verify(b"id", sig, b"payload") == \
            jm.verify(b"id", sig, b"payload")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 11])
def test_schedule_generators_agree(seed):
    out = {}
    for pkg, m in PKG.items():
        nh = m["nh"]
        topo = nh.Topology(orgs=3, peers_per_org=2, orderers=3, seed=seed)
        small = nh.Topology(orgs=1, peers_per_org=2, orderers=1, seed=seed)
        out[pkg] = (
            [r.as_dict() for r in nh.generate_kill_schedule(seed, topo, 31)],
            [r.as_dict() for r in nh.generate_kill_schedule(
                seed, small, 17, kills=1)],
            [r.as_dict() for r in nh.generate_partition_schedule(
                seed, topo, 40)],
            [r.as_dict() for r in nh.generate_partition_schedule(
                seed, small, 17)],
            topo.as_dict(), topo.peer_names(), topo.orderer_names(),
        )
    assert out["port"] == out["jax"]
    assert any(r["node"].startswith("orderer") for r in out["port"][0])


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


def _ledger_judgments(pkg, root):
    """Six blocks of faultfuzz's canned workload in `pkg`'s ledger, then
    every invariant check over it, with planted disagreements."""
    m = PKG[pkg]
    ff, inv, snap = m["ff"], m["inv"], m["snap"]
    provider = m["provider"](os.path.join(root, "src"))
    ledger = provider.open(ff.CHANNEL)
    writes = ff.workload_writes(6)
    for n in range(6):
        ledger.commit(ff._endorsed_block(ledger, n, writes[n]))
    out = {}
    model = writes[:6]
    out["clean"] = inv.check_ledger(ledger, model, [1, 2, 3])
    bad = [list(w) for w in model]
    bad[2] = [(ff.NS, "k02", b"wrong")]      # a write that disagrees
    bad.append([(ff.NS, "k06", b"v0006")])   # a block above the height
    bad.append([(ff.NS, "k01", b"v0001")])   # present above the height
    out["planted"] = inv.check_ledger(ledger, bad, [3, 5, 4])
    out["digest"] = inv.state_digest(ledger)
    out["chain"] = inv.check_chain(ledger)
    out["heights"] = inv.check_heights(ledger)
    sdir = ledger.snapshots.generate()
    out["completed"] = inv.check_completed_snapshots(
        os.path.join(root, "src", "snapshots"))
    torn = os.path.join(root, "torn")
    shutil.copytree(sdir, torn)
    with open(os.path.join(torn, snap.PUBLIC_STATE_FILE), "ab") as f:
        f.write(b"\x00torn")
    out["rejected"] = inv.check_snapshot_rejected(torn)
    out["accepted_torn"] = inv.check_snapshot_verifies(torn)
    dst = m["provider"](os.path.join(root, "dst"))
    led2 = dst.create_from_snapshot(sdir)
    out["import"] = inv.check_import_state(led2, sdir)
    out["import_digest"] = inv.state_digest(led2)
    dst.close()
    provider.close()
    return {k: ([v.as_dict() for v in val] if isinstance(val, list)
                else val) for k, val in out.items()}


def test_invariants_judge_as_the_reference(tmp_path):
    jax = _ledger_judgments("jax", str(tmp_path / "jax"))
    port = _ledger_judgments("port", str(tmp_path / "port"))
    assert port == jax
    assert port["clean"] == [] and port["completed"] == []
    assert {v["check"] for v in port["planted"]} == {"state", "heights"}
    assert port["rejected"] == [] and port["accepted_torn"]
    assert port["import"] == [] and port["import_digest"] == port["digest"]


PARTITION_CASES = [
    dict(mode="full", split_tip=5, stall_tip=6,
         pre_heal_heights={"o1": 9, "o2": 9, "o3": 6, "p1": 9, "p2": 8},
         minority_digests={"p2": [8, "aa"]}, majority=["o1", "o2", "p1"],
         minority=["o3", "p2"]),
    dict(mode="full", split_tip=5,
         pre_heal_heights={"o1": 5, "o2": 5, "o3": 5, "p1": 5, "p2": 5},
         minority_digests={"p2": [5, "aa"], "p3": [5, "bb"],
                           "p4": [None, "error:x"]},
         majority=["o1", "o2", "p1"], minority=["o3", "p2", "p3", "p4"]),
    dict(mode="oneway", split_tip=3, pre_heal_heights=None,
         minority_digests=None, majority=["o1"], minority=["p2"]),
    dict(mode="flaky", split_tip=3, pre_heal_heights={"o1": 3},
         minority_digests={}, majority=["o1"], minority=["p2"],
         expect_progress=False),
]


@pytest.mark.parametrize("case", range(len(PARTITION_CASES)))
def test_partition_violations_agree(case):
    kw = dict(PARTITION_CASES[case], orderer_names=["o1", "o2", "o3"],
              peer_names=["p1", "p2", "p3", "p4"])
    got = {pkg: [v.as_dict() for v in m["inv"].partition_violations(**kw)]
           for pkg, m in PKG.items()}
    assert got["port"] == got["jax"]


def _breaker_verdicts(pkg):
    """check_breaker on each package's provider after one plan that
    fails the device's dispatch once (the breaker opens at threshold 1),
    and with a counter made negative."""
    m = PKG[pkg]
    from test_csp_degraded import HostOracle, _items

    if pkg == "jax":
        from fabric_tpu.csp.tpu.provider import TPUCSP as make
    else:
        from fabric_tpu_torch.csp.cuda.provider import CUDACSP

        def make(**kw):
            return CUDACSP(device="cpu", **kw)
    csp = make(sw=HostOracle(), min_device_batch=1, breaker_threshold=1,
               breaker_probe_every=100)
    out = [m["inv"].check_breaker(csp)]
    try:
        plan = {"faults": [{"point": "tpu.dispatch", "action": "raise",
                            "error": "DeviceUnavailable", "nth": 1}]}
        with m["fault"].use_plan(plan):
            mask = csp.verify_batch(list(_items(4)))
        out.append((mask, csp._breaker.open, csp._breaker.trips))
        out.append(m["inv"].check_breaker(csp))
        csp._breaker.trips = -1
        out.append(m["inv"].check_breaker(csp))
        csp._breaker.state = "half-open"
        out.append(m["inv"].check_breaker(csp))
    finally:
        csp.close()
    out.append(m["inv"].check_breaker(object()))
    return [[v.as_dict() for v in x] if isinstance(x, list) else x
            for x in out]


def test_check_breaker_judges_cudacsp_as_the_reference_judges_tpucsp():
    jax, port = _breaker_verdicts("jax"), _breaker_verdicts("port")
    assert port == jax
    assert port[1][1:] == (True, 1) and port[2] == []
    assert port[3] == [{"check": "breaker",
                        "detail": "negative counter trips=-1"}]


# ---------------------------------------------------------------------------
# netscope
# ---------------------------------------------------------------------------


class _Scrapes:
    """Three fake nodes' operations endpoints: each answers /metrics,
    /healthz?detail=1 and /traces from the round's text."""

    def __init__(self):
        self.round = 0
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                node = self.server.node
                status, body = outer.answer(node, self.path)
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.servers = {}
        for node in ("org1-peer0", "org1-peer1", "orderer1"):
            srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
            srv.node = node
            threading.Thread(target=srv.serve_forever).start()
            self.servers[node] = srv

    HEIGHTS = {"org1-peer0": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
               "org1-peer1": [1, 2, 3, 3, 3, 3, 3, 3, 9, 10],
               "orderer1": [2, 3, 4, 5, 6, 7, 8, 9, 10, 10]}

    def answer(self, node, path):
        r = min(self.round, 9)
        if path == "/metrics":
            if node == "org1-peer1" and r == 6:
                return 500, b"down"
            h = self.HEIGHTS[node][r]
            text = (
                "# HELP ledger_height Height of the chain in blocks.\n"
                "# TYPE ledger_height gauge\n"
                f'ledger_height{{channel="netchan"}} {h}\n'
                "# TYPE ledger_transactions_total counter\n"
                f'ledger_transactions_total{{channel="netchan"}} {h * 5}\n'
                f'rpc_duration_bucket{{le="0.5",method="a\\"b"}} {r}\n'
                f"process_cpu_seconds_total {r * 0.25}\n")
            return 200, text.encode()
        if path.startswith("/healthz"):
            if node == "orderer1" and r in (3, 4):
                return 503, json.dumps({"status": "Service Unavailable",
                                        "failed_checks": ["raft"]}).encode()
            return 200, json.dumps({"status": "OK"}).encode()
        if path.startswith("/traces"):
            events = [{"name": "commit", "ph": "X", "ts": r * 1000,
                       "dur": 10, "tid": 1, "args": {"block": r}}]
            return 200, json.dumps({"traceEvents": events, "otherData": {
                "last_event_id": r + 1}}).encode()
        return 404, b""

    def targets(self):
        return {n: s.server_address for n, s in self.servers.items()}

    def close(self):
        for s in self.servers.values():
            s.shutdown()
            s.server_close()


def _scope_session(pkg, scrapes, out_dir):
    m = PKG[pkg]
    scrapes.round = 0
    with m["clock"].use_virtual():
        scope = m["scope"].Netscope(scrapes.targets(), interval_s=0.25,
                                    seed=11, window=64, stall_window=3)
        for r in range(10):
            scrapes.round = r
            scope.scrape_once()
            if r == 2:
                scope.mark("kill", "org1-peer1", sig="kill9")
            if r == 4:
                scope.mark("restart", "org1-peer1", rejoin="restart")
            m["clock"].sleep(scope._next_interval())
        thresholds = {"p99_cross_peer_lag_blocks": 3, "catch_up_s": 5.0,
                      "min_tx_per_s": 1.0}
        paths = m["scope"].write_artifacts(scope, out_dir, thresholds,
                                           prefix="scope")
        slo = scope.slo(thresholds)
    files = {}
    for kind, path in sorted(paths.items()):
        with open(path, "rb") as f:
            files[kind] = f.read()
    trace = json.loads(files.pop("trace"))
    trace["otherData"].pop("source")
    return files, trace, slo, scope.stall_episodes()


def test_netscope_artifacts_are_byte_identical(tmp_path):
    scrapes = _Scrapes()
    try:
        jax = _scope_session("jax", scrapes, str(tmp_path / "jax"))
        port = _scope_session("port", scrapes, str(tmp_path / "port"))
    finally:
        scrapes.close()
    assert port == jax
    files, trace, slo, episodes = port
    assert set(files) == {"jsonl", "html"}
    assert [e["node"] for e in episodes] == ["org1-peer1"]
    assert "org1-peer1" in slo["catch_up_s"]
    sample = pscope.parse_prometheus(
        'a_b{x="1",y="q\\"z"} 2.5\n# c\nbare 3\nbad line here\n')
    assert sample == jscope.parse_prometheus(
        'a_b{x="1",y="q\\"z"} 2.5\n# c\nbare 3\nbad line here\n')


# ---------------------------------------------------------------------------
# faultfuzz
# ---------------------------------------------------------------------------


def test_faultfuzz_registry_and_campaign_as_the_reference(tmp_path):
    out = {}
    for pkg, m in PKG.items():
        ff = m["ff"]
        reg = ff.Campaign(seed=7, plans=0).discover(str(tmp_path / pkg))
        summary = ff.Campaign(seed=7, plans=3,
                              workdir=str(tmp_path / f"{pkg}-run"),
                              out_dir=str(tmp_path / f"{pkg}-out")).run()
        out[pkg] = (
            {name: sorted(ent["kinds"]) for name, ent in reg.items()},
            {name: ent.get("ctx") for name, ent in reg.items()},
            summary["verdicts"], summary["trip_ledger"],
            [e["plan"] for e in summary["results"]],
            summary["registry_points"], summary["trips_total"],
        )
    assert out["port"] == out["jax"]
    assert out["port"][2] == ["pass"] * 3 and out["port"][6] > 0


def test_export_registry_raises_until_the_ports_fabriclint():
    """(The port's fabriclint is in: the export runs, and it is the
    checked-in registry, which the JAX package's registry equals.)"""
    from fabric_tpu_torch.devtools import lint as plint

    exported = pff.export_registry()
    with open(plint.FAULTMAP_REGISTRY_PATH, encoding="utf-8") as f:
        pinned = json.load(f)
    assert exported == pinned
    assert len(pinned["points"]) == 40


# ---------------------------------------------------------------------------
# one multi-process network in each package
# ---------------------------------------------------------------------------


def _network_run(pkg, workdir):
    """The smoke topology in `pkg`.  The state digest covers each key's
    version (block, transaction), so it is equal across runs only where
    the blocks are cut alike: the batch timer is long enough (1 s) that
    only the count (5) cuts, and the C++ library that the peers' validator
    loads is built before they start."""
    nh = PKG[pkg]["nh"]
    topo = nh.Topology(orgs=1, peers_per_org=2, orderers=1, seed=7,
                       batch_timeout_s=1.0)
    schedule = [nh.KillRule(node="org1-peer1", at_height=4, sig="kill9",
                            rejoin="restart", restart_after_s=0.4)]
    with nh.Network(workdir, topo) as net:
        net.start()
        result = nh.run_stream(net, txs=80, kill_schedule=schedule,
                               settle_timeout_s=120)
        digests = {n: net.check(n)["state_digest"]
                   for n in topo.peer_names()}
        rcs = {}
        if pkg == "port":
            for name in sorted(net.nodes):
                net.kill(name, signal.SIGTERM)
                rcs[name] = net.nodes[name].proc.returncode
    return result, digests, rcs


def test_a_kill9_run_gives_the_references_verdict_and_state(tmp_path):
    from fabric_tpu import native as jax_native
    from fabric_tpu_torch import native as port_native

    jax_native.available()
    port_native.build()
    jres, jdig, _ = _network_run("jax", str(tmp_path / "jax"))
    pres, pdig, rcs = _network_run("port", str(tmp_path / "port"))
    assert pres["errors"] == [] and pres["ok"], pres
    jv, pv = jnh.verdict_doc(jres), pnh.verdict_doc(pres)
    assert pv.pop("rpcmap_sha256") == pnh.rpcmap_hash()
    jv.pop("rpcmap_sha256")
    assert json.dumps(pv, sort_keys=True) == json.dumps(jv, sort_keys=True)
    assert pv["caught_up"] == ["org1-peer1"]
    assert len(set(pdig.values())) == 1
    assert pdig == jdig
    assert rcs == {"orderer1": 0, "org1-peer0": 0, "org1-peer1": 0}
    # the port's repro (it pins the port's hash) replays to the same
    # verdict
    path = pnh.write_repro(pres, str(tmp_path / "repro.json"))
    replayed = pnh.replay_repro(path, str(tmp_path / "replay"))
    assert pnh.verdict_doc(replayed) == pnh.verdict_doc(pres)


_RESULT = {"seed": 7, "topology": pnh.Topology().as_dict(),
           "kill_schedule": [], "txs": 10, "ok": True,
           "state_digests_agree": True, "stalled_nodes": [],
           "violations": {}, "missing": [], "catch_up_s": {},
           "partition_schedule": [], "partition_checks": [],
           "heal_catch_up_s": {}}


def test_the_verdict_pins_the_ports_rpcmap_and_a_repro_pinning_it_replays(
        tmp_path, monkeypatch):
    """The verdict keeps every key of the reference's and pins the sha256
    of the port's canonical-JSON static rpcmap; a repro that pins it gets
    past the drift check to the network (stood in for here: the kill9
    test replays a real one)."""
    import hashlib

    from fabric_tpu_torch.devtools.lint import lint_tree

    digest = pnh.rpcmap_hash()
    want = hashlib.sha256(json.dumps(
        lint_tree().rpcmap(), sort_keys=True,
        separators=(",", ":")).encode()).hexdigest()
    assert digest == want and len(digest) == 64
    verdict = pnh.verdict_doc(_RESULT)
    assert set(verdict) == set(jnh.verdict_doc(_RESULT))
    assert verdict["rpcmap_sha256"] == digest
    path = pnh.write_repro(_RESULT, str(tmp_path / "r.json"))
    monkeypatch.setattr(pnh, "Network", _no_network)
    with pytest.raises(_Started):
        pnh.replay_repro(path, str(tmp_path / "replay"))


class _Started(Exception):
    """A replay got past its checks to the network."""


def _no_network(*a, **k):
    raise _Started


def test_the_ports_verdict_pins_no_rpcmap_and_replay_refuses_a_pin(
        tmp_path, monkeypatch):
    """A repro that pins another tree's rpcmap hash is refused
    (`NetError`) before any node starts: the RPC surface it certified
    has drifted.  A pinned divergence: the JAX package's `replay_repro`
    goes on to the network whatever the pin."""
    path = pnh.write_repro(dict(_RESULT), str(tmp_path / "r.json"))
    with open(path) as f:
        doc = json.load(f)
    doc["verdict"]["rpcmap_sha256"] = "ab" * 32
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(pnh.NetError, match="drifted"):
        pnh.replay_repro(path, str(tmp_path / "replay"))
    assert not os.path.exists(str(tmp_path / "replay"))
    monkeypatch.setattr(jnh, "Network", _no_network)
    with pytest.raises(_Started):
        jnh.replay_repro(path, str(tmp_path / "jax-replay"))
