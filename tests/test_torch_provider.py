"""CUDACSP (the port's provider) against TPUCSP and SWCSP, on the CPU.

`CUDACSP(device="cpu")` runs the kernel's plain PyTorch version; the
batching around it (host cutoff, coalescing, per-segment collectors, the
persistent key table and its fallbacks) is the same code that drives the
CUDA kernel on the card.  Verdicts must match exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import threading  # noqa: E402

import numpy as np  # noqa: E402
from test_torch_p256 import corpus  # noqa: E402,F401

from fabric_tpu.csp import SWCSP  # noqa: E402
from fabric_tpu.csp.api import VerifyBatchItem as JaxItem  # noqa: E402
from fabric_tpu.csp.tpu.provider import TPUCSP  # noqa: E402
from fabric_tpu_torch.csp import api, hostref  # noqa: E402
from fabric_tpu_torch.csp.api import VerifyBatchItem  # noqa: E402
from fabric_tpu_torch.csp.cuda import limbs  # noqa: E402
from fabric_tpu_torch.csp.cuda import p256_kernel as pk  # noqa: E402
from fabric_tpu_torch.csp.cuda import provider as prov  # noqa: E402
from fabric_tpu_torch.csp.cuda.provider import CUDACSP, _FlushResult  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs many small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sw():
    return SWCSP()


def _block(sw, n_txs, endorsers=3, tag=b"blk"):
    """Block-shaped lanes: per transaction the client's signature, then
    one per endorsing peer (4 keys in all)."""
    client = sw.key_gen()
    peers = [sw.key_gen() for _ in range(endorsers)]
    items = []
    for i in range(n_txs):
        for j, key in enumerate([client] + peers):
            d = sw.hash(tag + b"-%d-%d" % (i, j))
            items.append(VerifyBatchItem(key.public_key(), d, sw.sign(key, d)))
    return items


def _plant_bad(sw, items):
    out = list(items)
    k, d, s = out[1]
    out[1] = VerifyBatchItem(k, sw.hash(b"forged"), s)  # tampered digest
    k, d, s = out[6]
    r, sv = api.unmarshal_ecdsa_signature(s)
    out[6] = VerifyBatchItem(k, d, api.marshal_ecdsa_signature(r, api.P256_N - sv))
    k, d, s = out[9]
    out[9] = VerifyBatchItem(k, d, b"\x30\x02\x01\x01")  # malformed DER
    k, d, s = out[13]
    out[13] = VerifyBatchItem(k, d[:31], s)  # short digest
    return out, [1, 6, 9, 13]


def test_block_batch_matches_tpucsp_and_sw(sw):
    items, bad = _plant_bad(sw, _block(sw, 10))
    want = sw.verify_batch(items)
    assert [i for i, ok in enumerate(want) if not ok] == bad
    got = CUDACSP(device="cpu", min_device_batch=1).verify_batch(items)
    tpu = TPUCSP(sw=sw, min_device_batch=1)
    try:
        ref = tpu.verify_batch([JaxItem(*it) for it in items])
    finally:
        tpu.close()
    assert got == ref == want


def test_cudacsp_verdicts_on_the_corpus_match_tpucsp(sw, corpus):
    """The port's verdicts are the expected ones on every lane, and
    TPUCSP's on every lane but the zero key's: TPUCSP accepts the
    signature under the point (0, 0), which is not a P-256 key."""
    names, lanes, expect = corpus
    items = [VerifyBatchItem(api.P256PublicKey(x, y), d, der)
             for x, y, d, der in lanes]
    got = CUDACSP(device="cpu", min_device_batch=1).verify_batch(items)
    tpu = TPUCSP(sw=sw, min_device_batch=1)
    try:
        ref = tpu.verify_batch([JaxItem(*it) for it in items])
    finally:
        tpu.close()
    assert got == expect
    zero = names.index("zero_key")
    assert ref[zero] and not got[zero]
    assert got[:zero] + got[zero + 1:] == ref[:zero] + ref[zero + 1:]


def test_verify_batch_small_falls_back_to_host(sw, monkeypatch):
    """Below min_device_batch the host answers and no kernel runs."""
    def no_kernel(t):
        raise AssertionError("kernel path taken below min_device_batch")

    monkeypatch.setattr(pk, "verify_packed", no_kernel)
    csp = CUDACSP(device="cpu", min_device_batch=64)
    key = sw.key_gen()
    d = sw.hash(b"x")
    items = [VerifyBatchItem(key.public_key(), d, sw.sign(key, d))]
    assert csp.verify_batch(items) == [True]
    assert csp.verify_batch_async(items[:0])() == []


def test_flush_collect_concurrent_segments_consistent(sw):
    """Many threads collecting the same flush all see the one mask, which
    is materialized exactly once."""
    items = _block(sw, 4)
    calls = []

    def device_collect():
        calls.append(1)
        return sw.verify_batch(items)

    res = _FlushResult([(device_collect, None)], len(items))
    got: list = [None] * 6
    ths = [
        threading.Thread(target=lambda i=i: got.__setitem__(i, res.collect()))
        for i in range(6)
    ]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=30)
        assert not t.is_alive()
    want = sw.verify_batch(items)
    assert all(g == want for g in got)
    assert len(calls) == 1


def test_coalesced_segments_share_one_flush(sw, monkeypatch):
    """Async batches coalesce into one launch; each collector returns its
    own segment, repeat calls the same list, in any collection order."""
    launches = []
    real = pk.verify_packed

    def counting(t):
        launches.append(t["d1"].shape[1])
        return real(t)

    monkeypatch.setattr(pk, "verify_packed", counting)
    items, bad = _plant_bad(sw, _block(sw, 5))
    want = sw.verify_batch(items)
    csp = CUDACSP(device="cpu", min_device_batch=1, coalesce_lanes=10**6)
    cols = [csp.verify_batch_async(items[:7]),
            csp.verify_batch_async(items[7:12]),
            csp.verify_batch_async(items[12:])]
    assert launches == []  # nothing flushed before the first collect
    second = cols[1]()
    assert second is cols[1]()
    assert cols[2]() == want[12:]
    assert cols[0]() + second + cols[2]() == want
    assert launches == [len(items)]
    assert csp._flushed == {}  # every segment read: the flush is dropped
    csp.close()


def test_coalesce_threshold_flushes_and_chunks(sw, monkeypatch):
    """Reaching coalesce_lanes flushes at enqueue; a flush splits into
    chunks of at most max_chunk lanes, with no padding."""
    launches = []
    real = pk.verify_packed

    def counting(t):
        launches.append(t["d1"].shape[1])
        return real(t)

    monkeypatch.setattr(pk, "verify_packed", counting)
    items = _block(sw, 3)  # 12 lanes
    csp = CUDACSP(device="cpu", min_device_batch=1, coalesce_lanes=12,
                  max_chunk=5)
    col = csp.verify_batch_async(items)
    assert launches == [5, 5, 2]
    assert col() == [True] * 12
    assert prov._chunk_plan(12, 5) == [5, 5, 2]
    assert prov._chunk_plan(0, 5) == []
    csp.drain()


def test_key_table_persists_across_flushes(sw):
    csp = CUDACSP(device="cpu", min_device_batch=1)
    items = _block(sw, 2)
    assert all(csp.verify_batch(items))
    tabs = csp._key_table.device_tables(csp.device)
    assert all(csp.verify_batch(items[::-1]))
    again = csp._key_table.device_tables(csp.device)
    for k in pk.TABLE_KEYS:
        assert again[k] is tabs[k]  # not uploaded again
    assert len(csp._key_table._idx) == 4


def test_key_table_builds_quarter_tables_once_per_change(monkeypatch):
    """A key's quarter tables are built when it enters the table, in one
    call for all the keys an assign adds, uploaded once per change,
    kept across flushes, and rebuilt for the new working set after an
    overflow reset."""
    builds = []
    real = pk.key_quarter_tables

    def counting(ktabx, ktaby):
        builds.append(ktabx.shape[1])
        return real(ktabx, ktaby)

    monkeypatch.setattr(pk, "key_quarter_tables", counting)
    rng = np.random.default_rng(9)
    keys = [hostref.key_gen(rng).public_key() for _ in range(pk.KEYTAB + 1)]
    table = prov._KeyTable()
    dev = torch.device("cpu")
    assert table.assign(keys[:4] * 3).tolist() == [0, 1, 2, 3] * 3
    assert builds == [4]
    first = table.device_tables(dev)
    assert table.assign(keys[3::-1]).tolist() == [3, 2, 1, 0]
    assert builds == [4]  # no new key: nothing built or uploaded
    assert all(table.device_tables(dev)[k] is v for k, v in first.items())
    assert table.assign(keys[:5]).tolist() == [0, 1, 2, 3, 4]
    assert builds == [4, 1]
    second = table.device_tables(dev)
    assert second["qtab"] is not first["qtab"]
    assert second["keybad"][:6].tolist() == [0] * 5 + [1]
    # 5 keys held + 252 new ones overflow: a reset to this batch's keys
    batch = keys[5:]
    assert table.assign(batch).tolist() == list(range(len(batch)))
    assert builds == [4, 1, len(batch)]
    third = table.device_tables(dev)
    assert third["qtab"] is not second["qtab"]
    qtab = third["qtab"].numpy().view(np.uint32)
    for i in (0, len(batch) - 1):  # entry 1 of quarter 0 is the key
        assert qtab[i, 0, 1, 0].tolist() == limbs.int_to_words(
            batch[i].x).tolist()
    assert int(third["keybad"].sum()) == pk.KEYTAB - len(batch)
    # more keys than a fresh table holds: None, and the table left empty
    # (no key kept without its quarter tables), then refilled on demand;
    # keys built before come back with their kept tables, not rebuilt
    assert table.assign(keys) is None
    assert builds == [4, 1, len(batch)] and not table._idx
    assert int(table.device_tables(dev)["keybad"].sum()) == pk.KEYTAB
    assert table.assign([keys[0], keys[-1], keys[1]]).tolist() == [0, 1, 2]
    assert builds == [4, 1, len(batch)]
    fourth = table.device_tables(dev)
    np.testing.assert_array_equal(fourth["qtab"][0], first["qtab"][0])
    np.testing.assert_array_equal(fourth["qtab"][1], third["qtab"][-5])
    assert fourth["keybad"][:4].tolist() == [0, 0, 0, 1]


def test_key_table_keeps_the_last_built_cap_keys_tables(monkeypatch):
    """Built quarter tables are kept for the BUILT_CAP most recently
    entered keys: a key used again stays, the least recently used goes
    and is built again when it returns."""
    builds = []
    real = pk.key_quarter_tables

    def counting(ktabx, ktaby):
        builds.append(ktabx.shape[1])
        return real(ktabx, ktaby)

    monkeypatch.setattr(pk, "key_quarter_tables", counting)
    monkeypatch.setattr(prov._KeyTable, "BUILT_CAP", 3)
    rng = np.random.default_rng(11)
    keys = [hostref.key_gen(rng).public_key() for _ in range(4)]
    table = prov._KeyTable()
    table.cap = 2  # every second assign of a new pair resets
    for pair, built in (((0, 1), [2]), ((2, 0), [2, 1]),
                        ((3, 2), [2, 1, 1]),  # 1, used least lately, goes
                        ((0, 3), [2, 1, 1]),  # 0 was used again: kept
                        ((1, 0), [2, 1, 1, 1])):
        assert table.assign([keys[i] for i in pair]).tolist() == [0, 1]
        assert builds == built, pair
    assert len(table._built) == 3


def test_more_than_256_keys_fall_back_to_lane_keys(sw, monkeypatch):
    """A flush with more distinct keys than the table holds runs the
    per-lane-key layout, with the same verdicts."""
    layouts = []
    real = pk.verify_packed

    def recording(t):
        layouts.append("kidx" in t)
        return real(t)

    monkeypatch.setattr(pk, "verify_packed", recording)
    rng = np.random.default_rng(3)
    keys = [hostref.key_gen(rng) for _ in range(pk.KEYTAB + 1)]
    items = []
    for i, key in enumerate(keys):
        d = sw.hash(b"wide-%d" % i)
        items.append(VerifyBatchItem(key.public_key(), d,
                                     hostref.sign(key, d, rng)))
    k, d, s = items[100]
    items[100] = VerifyBatchItem(k, sw.hash(b"forged"), s)
    got = CUDACSP(device="cpu", min_device_batch=1).verify_batch(items)
    assert layouts == [False]
    assert got == [i != 100 for i in range(len(items))]


def test_dispatch_error_reaches_every_collector(sw, monkeypatch):
    """A launch that fails at run time degrades the whole flush to the
    host, as TPUCSP does: every collector gets the host's verdicts for its
    own segment, the breaker counts one device failure (and stays closed
    under its threshold of 3), and the host's lanes are counted.  A build
    failure still raises (tests/test_torch_degraded.py)."""
    def broken(t):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(pk, "verify_packed", broken)
    csp = CUDACSP(device="cpu", min_device_batch=1, coalesce_lanes=10**6,
                  breaker_threshold=3)
    items = _block(sw, 2)
    cols = [csp.verify_batch_async(items[:4]), csp.verify_batch_async(items[4:])]
    assert [col() for col in cols] == [sw.verify_batch(items[:4]),
                                       sw.verify_batch(items[4:])]
    assert (csp.breaker.open, csp.breaker._consecutive) == (False, 1)
    stats = csp.degraded_stats()
    assert (stats["device_failures"], stats["host_lanes"]) == (1, len(items))
    csp.close()


def test_hostref_matches_sw(sw):
    """hostref signs what SWCSP accepts and verifies what SWCSP signs,
    with the same verdicts on tampered and high-S signatures."""
    rng = np.random.default_rng(11)
    key = hostref.key_gen(rng)
    assert hostref.key_gen(np.random.default_rng(11)).d == key.d
    pub = key.public_key()
    jpub = sw.key_import(pub.raw())
    for i in range(4):
        d = sw.hash(b"ref-%d" % i)
        sig = hostref.sign(key, d, rng)
        r, s = api.unmarshal_ecdsa_signature(sig)
        assert api.is_low_s(s)
        assert sw.verify(jpub, sig, d)
        assert hostref.verify(pub, sig, d)
        high = api.marshal_ecdsa_signature(r, api.P256_N - s)
        assert sw.verify(jpub, high, d) is hostref.verify(pub, high, d) is False
        other = sw.hash(b"other-%d" % i)
        assert sw.verify(jpub, sig, other) is hostref.verify(pub, sig, other)
    skey = sw.key_gen()
    d = sw.hash(b"sw-signed")
    sig = sw.sign(skey, d)
    # a JAX-package key object works as it is
    assert hostref.verify(skey.public_key(), sig, d)
    assert hostref.verify(skey, sig, d)
    assert not hostref.verify(skey.public_key(), sig[:-1], d)
    assert not hostref.verify(skey.public_key(), sig, d[:31])


def test_key_import_sign_verify_roundtrip(sw):
    csp = CUDACSP(device="cpu")
    key = csp.key_gen()
    pub = csp.key_import(key.public_key().raw())
    assert csp.get_key(pub.ski()) is pub
    priv = csp.key_import(key.raw(), private=True)
    assert priv.public_key().raw() == key.public_key().raw()
    d = csp.hash(b"roundtrip")
    sig = csp.sign(priv, d)
    assert csp.verify(pub, sig, d)
    assert sw.verify(sw.key_import(pub.raw()), sig, d)
    assert csp.hash_batch([b"a", b"b"]) == [sw.hash(b"a"), sw.hash(b"b")]
    with pytest.raises(ValueError):
        csp.key_import(b"\x04" + bytes(64))  # (0, 0) is not on the curve


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
