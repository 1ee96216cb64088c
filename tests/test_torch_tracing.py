"""The port's span tracing against the JAX package's.

- A traced `Committer.store_stream` of the same blocks (chip_smoke's
  5-org channel, 8 blocks of 10 transactions with the planted faults)
  records the same span tree per block in both packages: for every span
  its name, category, ``block`` attribute and its parent's name, with
  multiplicity.  At depth 1 every block flushes alone, so the whole tree
  is compared; at depth 3 the group flush's ``fsync`` and ``kv_txn``
  spans land on whichever block ends a group (the committer flushes when
  its queue runs dry, a matter of timing in both packages), so they are
  compared as a count and the rest of the tree exactly.
- A serial run (`store_block`) under a virtual clock gives the same
  `span_sequence` and the same timestamps in both.
- A traced commit writes the same KV pairs and block files as an
  untraced one.
- `critical_path_ms` gives the same numbers in both on the same events.
- The trace token crosses an RPC between the packages in both
  directions: the server's ``rpc.serve`` span is the child of the
  client's ``rpc.call``.
- A log line inside a span carries the same trace ids in both.
- With every metrics bundle bound, a serial commit's stage histograms,
  blocks per sync and height gauges count alike in both, and the
  committer's ``observe`` calls carry the same names and labels.
- With a `WorkpoolMetrics` bundle set, a fan-out leaves the same
  in-flight and saturation gauges in both.
All checks are exact.
"""

import collections
import logging
from pathlib import Path

import pytest

import chip_smoke
from fabric_tpu import comm as jax_comm
from fabric_tpu.common import flogging as jax_flog
from fabric_tpu.common import tracing as jax_tr
from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.csp import SWCSP
from fabric_tpu.devtools import clockskew as jax_clk
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu_torch import comm as port_comm
from fabric_tpu_torch.common import flogging as port_flog
from fabric_tpu_torch.common import tracing as port_tr
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle_from_genesis,
)
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.devtools import clockskew as port_clk
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb

CH = chip_smoke.VALIDATOR_CHANNEL
N_BLOCKS = 8
N_TXS = 10
FLUSH_SPANS = ("fsync", "kv_txn")


@pytest.fixture(autouse=True, scope="module")
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


class Chain:
    def __init__(self):
        self.world = chip_smoke.validator_world(31)
        self.blocks, self.expect, self.conflicts = chip_smoke.validator_blocks(
            self.world, N_BLOCKS, N_TXS, self.world.genesis_hash, mvcc=True)
        self.jax_bundle = bundle_from_genesis(
            common_pb2.Block.FromString(self.world.genesis), SWCSP())
        self.port_bundle = port_bundle_from_genesis(self.world.genesis)


@pytest.fixture(scope="module")
def chain():
    return Chain()


def _jax(chain, root):
    provider = JaxProvider(str(root), csp=SWCSP())
    ledger = provider.create(common_pb2.Block.FromString(chain.world.genesis))
    return provider, JaxCommitter(
        JaxValidator(CH, ledger, chain.jax_bundle, SWCSP()), ledger)


def _port(chain, root):
    provider = LedgerProvider(str(root))
    ledger = provider.create(cb.Block.decode(chain.world.genesis))
    csp = CUDACSP(device="cpu", min_device_batch=1 << 30)
    return provider, Committer(
        TxValidator(CH, ledger, chain.port_bundle, csp), ledger)


def _commit(pkg, chain, root, depth):
    provider, committer = (_jax if pkg == "jax" else _port)(chain, root)
    if depth is None:
        blocks = (chain.blocks if pkg == "port" else
                  [common_pb2.Block.FromString(b) for b in chain.blocks])
        flags = [committer.store_block(b) for b in blocks]
    elif pkg == "port":
        flags = list(committer.store_stream(chain.blocks, depth=depth))
    else:
        flags = list(committer.store_stream(
            [common_pb2.Block.FromString(b) for b in chain.blocks],
            depth=depth))
    pairs = list(provider.kv.iterate())
    provider.close()
    return flags, pairs


def _tree(doc) -> tuple[collections.Counter, collections.Counter]:
    """(name, cat, block, parent's name) of every span with multiplicity,
    the group flush's spans apart as a count per name."""
    evs = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    names = {ev["args"]["span"]: ev["name"] for ev in evs}
    tree, flushes = collections.Counter(), collections.Counter()
    for ev in evs:
        a = ev["args"]
        tree[(ev["name"], ev["cat"], a.get("block"),
              names.get(a.get("parent")))] += 1
        if ev["name"] in FLUSH_SPANS:
            flushes[ev["name"]] += 1
    return tree, flushes


@pytest.mark.parametrize("depth", [1, 3])
def test_the_span_tree_per_block_equals_the_reference(chain, tmp_path, depth):
    got = {}
    for pkg, tr in (("jax", jax_tr), ("port", port_tr)):
        with tr.scope():
            flags, _ = _commit(pkg, chain, tmp_path / pkg, depth)
            got[pkg] = (flags, *_tree(tr.export()))
    assert got["port"][0] == got["jax"][0]
    tree, flushes = got["port"][1], got["port"][2]
    if depth == 1:
        assert tree == got["jax"][1]
    else:
        def solo(t):
            return {k: v for k, v in t.items() if k[0] not in FLUSH_SPANS}

        assert solo(tree) == solo(got["jax"][1])
        assert flushes["fsync"] == flushes["kv_txn"] >= 2
    for b in range(1, N_BLOCKS + 1):
        for stage in ("collect", "verify_wait", "policy", "mvcc",
                      "block_append", "pvt", "state", "history"):
            assert tree[(stage, "stage", b, "block")] == 1
        assert tree[("block", "pipeline", b, None)] == 1


def test_a_serial_run_replays_under_a_virtual_clock(chain, tmp_path):
    docs = []
    for pkg, tr, clk in (("jax", jax_tr, jax_clk), ("port", port_tr,
                                                    port_clk)):
        with clk.use_virtual(clk.VirtualClock()), tr.scope():
            _commit(pkg, chain, tmp_path / pkg, None)
            docs.append(tr.export())
    seq = [jax_tr.span_sequence(docs[0]), port_tr.span_sequence(docs[1])]
    assert seq[0] == seq[1] and len(seq[0]) > 8 * N_BLOCKS
    times = [[(ev["name"], ev["ts"], ev.get("dur")) for ev in d["traceEvents"]]
             for d in docs]
    assert times[0] == times[1]


def test_a_traced_commit_equals_an_untraced_one(chain, tmp_path):
    untraced = _commit("port", chain, tmp_path / "plain", 3)
    with port_tr.scope() as rec:
        traced = _commit("port", chain, tmp_path / "traced", 3)
        assert len(rec) > 0
    assert traced == untraced

    def files(root):
        chains = Path(root) / CH / "chains"
        return {p.name: p.read_bytes() for p in sorted(chains.iterdir())}

    assert files(tmp_path / "traced") == files(tmp_path / "plain")


def _events():
    """Overlapping stage spans of three blocks and noise the function
    must skip (instants, other categories, spans with no block)."""
    evs = []
    for b in range(3):
        base = b * 5000
        for name, ts, dur in (("collect", 0, 3000), ("verify_wait", 2500, 800),
                              ("policy", 3300, 400), ("mvcc", 3700, 900),
                              ("fsync", 4600, 300)):
            evs.append({"ph": "X", "name": name, "cat": "stage",
                        "ts": base + ts + b * 7, "dur": dur + b,
                        "args": {"block": b + 1}})
    evs.append({"ph": "i", "name": "fault", "cat": "stage", "ts": 10,
                "args": {"block": 1}})
    evs.append({"ph": "X", "name": "block", "cat": "pipeline", "ts": 0,
                "dur": 99999, "args": {"block": 1}})
    evs.append({"ph": "X", "name": "collect", "cat": "stage", "ts": 0,
                "dur": 5, "args": {}})
    return evs


def test_critical_path_ms_is_the_same(chain, tmp_path):
    evs = _events()
    assert port_tr.critical_path_ms(evs) == jax_tr.critical_path_ms(evs)
    with port_tr.scope():
        _commit("port", chain, tmp_path, 3)
        recorded = port_tr.export()["traceEvents"]
    got = port_tr.critical_path_ms(recorded)
    assert got == jax_tr.critical_path_ms(recorded)
    assert {"collect", "mvcc"} <= set(got)
    assert port_tr.critical_path_ms(recorded, group_attr="none") == {}


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_the_trace_token_crosses_an_rpc(client_pkg):
    server_pkg = "port" if client_pkg == "jax" else "jax"
    mods = {"jax": (jax_comm, jax_tr), "port": (port_comm, port_tr)}
    server = mods[server_pkg][0].RPCServer()
    server.register("echo", lambda body, st: body)
    server.start()
    try:
        with mods[server_pkg][1].scope(), mods[client_pkg][1].scope():
            client_tr, server_tr = mods[client_pkg][1], mods[server_pkg][1]
            with client_tr.span("caller"):
                assert mods[client_pkg][0].RPCClient(
                    *server.addr).call("echo", b"x") == b"x"
            calls = [ev for ev in client_tr.export()["traceEvents"]
                     if ev["name"] == "rpc.call"]
            serves = [ev for ev in server_tr.export()["traceEvents"]
                      if ev["name"] == "rpc.serve"]
    finally:
        server.stop()
    assert len(calls) == len(serves) == 1
    assert serves[0]["args"]["parent"] == calls[0]["args"]["span"]
    assert serves[0]["args"]["trace"] == calls[0]["args"]["trace"]
    assert serves[0]["args"]["method"] == "echo"


def test_wire_tokens_and_frame_tokens_are_the_same():
    ctx = (port_tr.SpanContext(0x1F, 0x2A), jax_tr.SpanContext(0x1F, 0x2A))
    assert port_tr.frame_with_token(b"\x0apayload", ctx[0]) == \
        jax_tr.frame_with_token(b"\x0apayload", ctx[1])
    framed = jax_tr.frame_with_token(b"\x0apayload", ctx[1])
    data, got = port_tr.split_frame_token(framed)
    assert data == b"\x0apayload" and got == ctx[0]
    for bad in ("", "zz", "1", "1.x"):
        assert (port_tr.from_wire(bad) is None) == (
            jax_tr.from_wire(bad) is None)


def test_a_log_line_in_a_span_carries_the_same_ids():
    record = logging.LogRecord("fabric_tpu_torch.x", logging.INFO, __file__,
                               1, "hello", None, None)
    lines = []
    for tr, flog in ((jax_tr, jax_flog), (port_tr, port_flog)):
        fmt = flog._TraceFormatter("%(levelname)s %(message)s")
        with tr.scope(), tr.span("outer"), tr.span("inner"):
            lines.append(fmt.format(record))
        lines.append(fmt.format(record))
    assert lines[0] == lines[2] == "INFO hello trace=1 span=2"
    assert lines[1] == lines[3] == "INFO hello"


def test_disarmed_tracing_allocates_nothing():
    before = port_tr.lookup_count()
    assert port_tr.begin("x", block=1) is port_tr.span("y") is port_tr._NOOP
    assert port_tr.attached(port_tr.SpanContext(1, 1)) is port_tr._NOOP
    port_tr.instant("z")
    port_tr.annotate(a=1)
    assert port_tr.current() is None and port_tr.wire_token() is None
    assert port_tr.lookup_count() == before and not port_tr.enabled()


def _counts(expo: str) -> dict:
    """The exposition's observation counts and counter values (the
    durations themselves are the host's)."""
    out = {}
    for line in expo.splitlines():
        name, _, value = line.rpartition(" ")
        if line.startswith("#") or not name:
            continue
        if "_count" in name or name.startswith(("ledger_height",
                                                "ledger_durable",
                                                "ledger_blocks",
                                                "ledger_transactions")):
            out[name] = value
    return out


def test_the_stage_metrics_count_as_the_reference(chain, tmp_path):
    """A serial commit with every metrics bundle bound: the validator's
    and the ledger's stage histograms, blocks per sync and the height
    gauges and counters carry the same names, labels and counts; the
    committer's own ``metrics`` sees the same observations."""
    from fabric_tpu.common import metrics as jm
    from fabric_tpu_torch.common import metrics as pm

    class Observed:
        """The committer's ``metrics``: what it observes, less the
        durations (the host's)."""

        def __init__(self):
            self.calls = []

        def observe(self, name, seconds, **labels):
            assert seconds >= 0
            self.calls.append((name, labels))

    got, observed = [], []
    for pkg, m in (("jax", jm), ("port", pm)):
        prom = m.PrometheusProvider()
        kw = dict(commit_metrics=m.CommitMetrics(prom),
                  ledger_metrics=m.LedgerMetrics(prom))
        if pkg == "jax":
            provider = JaxProvider(str(tmp_path / pkg), csp=SWCSP(), **kw)
            ledger = provider.create(
                common_pb2.Block.FromString(chain.world.genesis))
            committer = JaxCommitter(JaxValidator(
                CH, ledger, chain.jax_bundle, SWCSP(),
                metrics=m.ValidateMetrics(prom)), ledger, metrics=Observed())
            blocks = [common_pb2.Block.FromString(b) for b in chain.blocks]
        else:
            provider = LedgerProvider(str(tmp_path / pkg), **kw)
            ledger = provider.create(cb.Block.decode(chain.world.genesis))
            committer = Committer(TxValidator(
                CH, ledger, chain.port_bundle,
                CUDACSP(device="cpu", min_device_batch=1 << 30),
                metrics=m.ValidateMetrics(prom)), ledger, metrics=Observed())
            blocks = chain.blocks
        for b in blocks:
            committer.store_block(b)
        provider.close()
        got.append(_counts(prom.registry.expose()))
        observed.append(committer.metrics.calls)
    assert got[0] == got[1]
    assert observed[0] == observed[1]
    assert observed[1] == [(name, {"channel": CH}) for _ in range(N_BLOCKS)
                           for name in ("validate_duration",
                                        "commit_duration")]
    assert got[1]['validator_block_stage_duration_count{channel="benchch",'
                  'stage="collect"}'] == str(N_BLOCKS)


def _gauges(expo: str) -> dict:
    return {name: value for name, _, value in
            (line.rpartition(" ") for line in expo.splitlines())
            if name.startswith("workpool_")}


def test_the_workpool_gauges_read_as_the_reference():
    """`workpool.set_metrics` in both packages: a fan-out of 3 chunks on
    a 4-worker pool leaves no chunk in flight and a saturation of 0.75;
    the queue depth at the fan-out is the pool's timing, so only its
    presence and range are compared.  Exact."""
    from fabric_tpu.common import metrics as jm
    from fabric_tpu.common import workpool as jax_wp
    from fabric_tpu_torch.common import metrics as pm

    got = []
    for wp, m in ((jax_wp, jm), (workpool, pm)):
        prom = m.PrometheusProvider()
        wp.set_metrics(m.WorkpoolMetrics(prom))
        try:
            with wp.scoped_pool(4, name="gauge-pool") as pool:
                out = wp.run_chunked(
                    pool, lambda off, chunk: [off + i for i in
                                              range(len(chunk))],
                    list(range(9)), 3)
        finally:
            wp.set_metrics(None)
        assert out == list(range(9))
        got.append(_gauges(prom.registry.expose()))
    assert got[0].keys() == got[1].keys() == {
        "workpool_queue_depth", "workpool_in_flight_chunks",
        "workpool_worker_saturation"}
    for g in got:
        assert 0 <= float(g.pop("workpool_queue_depth")) <= 3
    assert got[0] == got[1]
    assert float(got[1]["workpool_in_flight_chunks"]) == 0
    assert float(got[1]["workpool_worker_saturation"]) == 0.75
