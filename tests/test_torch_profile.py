"""The port's profiling plane and the unarmed seams.

- Unarmed, a commit of chip_smoke's chain and an RPC round trip consult
  none of tracing, profiling and netsplit: each `lookup_count()` is
  where it was (0 in a process that never armed them).
- Armed (`profile.scope()` with tracing armed), the same commit's
  profile attributes samples to the commit's stage spans in
  ``self_cpu_ms``, and its lock-role and workpool aggregates are filled
  by the ledger's named locks and a chunked fan-out.
- Fed the same lock waits, holds and chunks, the port's profiler and
  the JAX package's export the same aggregates; their disarmed documents
  are equal.
"""

import pytest

import chip_smoke
from fabric_tpu.common import profile as jax_prof
from fabric_tpu_torch import comm as port_comm
from fabric_tpu_torch.common import profile, tracing, workpool
from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.devtools import netsplit
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb

CH = chip_smoke.VALIDATOR_CHANNEL
STAGES = {"block", "collect", "verify_wait", "policy", "mvcc",
          "block_append", "pvt", "state", "history", "fsync", "kv_txn",
          "workpool.chunk"}


@pytest.fixture(autouse=True, scope="module")
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


@pytest.fixture(scope="module")
def chain():
    world = chip_smoke.validator_world(41)
    blocks, _, _ = chip_smoke.validator_blocks(world, 8, 10,
                                               world.genesis_hash, mvcc=True)
    return world, blocks


def _commit(chain, root) -> list:
    world, blocks = chain
    provider = LedgerProvider(str(root))
    ledger = provider.create(cb.Block.decode(world.genesis))
    committer = Committer(TxValidator(
        CH, ledger, bundle_from_genesis(world.genesis),
        CUDACSP(device="cpu", min_device_batch=1 << 30)), ledger)
    flags = list(committer.store_stream(blocks, depth=3))
    provider.close()
    return flags


def _counts() -> tuple:
    return (tracing.lookup_count(), profile.lookup_count(),
            netsplit.lookup_count())


def test_unarmed_seams_consult_nothing(chain, tmp_path):
    assert not (tracing.enabled() or profile.enabled() or netsplit.active())
    before = _counts()
    _commit(chain, tmp_path)
    server = port_comm.RPCServer()
    server.register("echo", lambda body, st: body)
    server.start()
    try:
        assert port_comm.RPCClient(*server.addr).call("echo", b"x") == b"x"
    finally:
        server.stop()
    assert _counts() == before


def test_an_armed_profile_attributes_the_commit(chain, tmp_path):
    with tracing.scope(), profile.scope(interval_s=0.001) as prof:
        flags = _commit(chain, tmp_path)
        with workpool.scoped_pool(2) as pool:
            assert workpool.run_chunked(
                pool, lambda off, chunk: [x * 2 for x in chunk],
                list(range(8)), 4) == [x * 2 for x in range(8)]
        doc = profile.export()
    assert flags == _commit(chain, tmp_path / "again")
    other = doc["otherData"]
    assert other["armed"] and other["samples"] > 0 and other["collapsed"]
    assert other["self_cpu_ms"] and set(other["self_cpu_ms"]) <= STAGES
    assert "kvledger.commit_lock" in other["locks"]
    assert other["locks"]["kvledger.commit_lock"]["hold_count"] > 0
    assert other["workpool"]["chunks"] == 4
    assert not prof.running and not profile.enabled()


def test_the_aggregates_export_as_the_reference_does():
    docs = []
    for mod in (jax_prof, profile):
        with mod.scope(sampler=False):
            mod.note_lock_wait("ledger.lock", 0.25)
            mod.note_lock_wait("ledger.lock", 0.5)
            mod.note_lock_hold("ledger.lock", 0.125)
            mod.note_lock_wait("profile.self", 1.0)  # never recorded
            mod.note_chunk(0.01, 0.02)
            mod.note_chunk(0.03, 0.04)
            doc = mod.export("parity")
        other = doc["otherData"]
        docs.append((doc["name"], other["locks"], other["workpool"],
                     mod.export()))
    assert docs[0] == docs[1]
    assert docs[1][1]["ledger.lock"]["wait_count"] == 2


def test_an_on_demand_session_and_the_heap_document():
    doc = profile.sample_for(0.0, interval_s=0.001)
    assert doc["otherData"]["samples"] == 1
    assert doc["profiles"][0]["type"] == "sampled"
    import tracemalloc

    was = tracemalloc.is_tracing()
    try:
        heap = profile.heap_doc(limit=3)
    finally:
        if not was:
            tracemalloc.stop()  # it slows every later allocation
    assert len(heap["top"]) <= 3 and heap["current_bytes"] >= 0
    assert heap["tracemalloc_started_now"] == (not was)
