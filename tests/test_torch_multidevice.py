"""Multi-device placement in the port's provider, on the CPU: the
contracts of tests/test_multidevice_csp.py on `CUDACSP(device="cpu")`
over a fake two-device list.

Given a list of devices, the provider places chunks round-robin over
them, as `TPUCSP.place` does, but the turn carries over from one flush
to the next: each chunk takes the next device, so that consecutive
flushes of up to `max_chunk` lanes (the commit path's) alternate cards.
Each device holds its own copy of the key table, `last_dispatch_devices`
names the devices a flush used, and the masks are the single device's.
The two fake devices are `cpu:0` and `cpu:1` (torch keeps CPU tensors on
the one host device whatever the index), so the placement, the
per-device tables and the masks are exercised where no second card
exists.
"""

import pytest

torch = pytest.importorskip("torch")

import hashlib  # noqa: E402
import random  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from fabric_tpu_torch.csp import api, hostref  # noqa: E402
from fabric_tpu_torch.csp.api import VerifyBatchItem  # noqa: E402
from fabric_tpu_torch.csp.cuda import p256_kernel as pk  # noqa: E402
from fabric_tpu_torch.csp.cuda.provider import CUDACSP  # noqa: E402

TWO = [torch.device("cpu", 0), torch.device("cpu", 1)]
BAD = 13  # the tampered lane


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _items(n: int, bad_high_s: bool = False):
    """n lanes over 4 keys, lane BAD tampered: a wrong digest, or (for the
    stand-in kernel) a high-S signature, which the packer's prechecks
    reject."""
    rng = np.random.default_rng(7)
    keys = [hostref.key_gen(rng) for _ in range(4)]
    out = []
    for i in range(n):
        d = hashlib.sha256(b"md-%d" % i).digest()
        k = keys[i % 4]
        sig = hostref.sign(k, d, rng)
        if i == BAD:
            if bad_high_s:
                r, s = api.unmarshal_ecdsa_signature(sig)
                sig = api.marshal_ecdsa_signature(r, api.P256_N - s)
            else:
                d = hashlib.sha256(b"other").digest()
        out.append(VerifyBatchItem(k.public_key(), d, sig))
    return out


def _two_devices(**kw) -> CUDACSP:
    return CUDACSP(device=TWO, min_device_batch=1, **kw)


@pytest.fixture(scope="module")
def spread():
    """32 lanes in chunks of 8 over the two devices, and on one device."""
    items = _items(32)
    multi = _two_devices(max_chunk=8, coalesce_lanes=1)
    single = CUDACSP(device="cpu", min_device_batch=1)
    out = {"items": items, "multi": multi.verify_batch(items),
           "used": multi.last_dispatch_devices,
           "tables": sorted(multi._key_table._dev),
           "single": single.verify_batch(items),
           "single_used": single.last_dispatch_devices}
    multi.close()
    single.close()
    return out


def test_one_device_places_nothing(spread):
    assert CUDACSP(device="cpu")._devices == [torch.device("cpu")]
    assert spread["single_used"] == ()


def test_chunks_spread_across_devices(spread):
    mask = spread["multi"]
    assert mask[BAD] is False
    assert all(v for i, v in enumerate(mask) if i != BAD)
    assert spread["used"] == tuple(TWO)
    # each device holds its own copy of the key table
    assert spread["tables"] == ["cpu:0", "cpu:1"]


def test_multidevice_matches_single_device(spread):
    assert spread["multi"] == spread["single"]
    assert spread["single"] == hostref.verify_batch(spread["items"])


def test_async_coalesced_multidevice():
    items = _items(32)
    csp = _two_devices(max_chunk=16)
    c1 = csp.verify_batch_async(items[:20])
    c2 = csp.verify_batch_async(items[20:])
    m = c1() + c2()
    assert m[BAD] is False and sum(m) == len(items) - 1
    assert csp.last_dispatch_devices == tuple(TWO)
    csp.close()


def test_cuda_places_over_every_visible_card(monkeypatch):
    """device="cuda" is the current card alone, "cuda:N" card N, and a
    list of cards places over them (the first is `device`); a list that
    mixes the CPU and cards is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    csp = CUDACSP()
    assert csp._devices == [torch.device("cuda", 1)]
    assert csp.device == torch.device("cuda", 1)
    assert CUDACSP(device="cuda:2")._devices == [torch.device("cuda", 2)]
    many = CUDACSP(device=["cuda:2", "cuda:0"])
    assert many._devices == [torch.device("cuda", i) for i in (2, 0)]
    assert many.device == torch.device("cuda", 2)
    with pytest.raises(ValueError, match="unsupported devices"):
        CUDACSP(device=["cpu", "cuda:0"])


def test_consecutive_flushes_alternate_devices():
    """Flushes of one chunk each take the next device in turn, and the
    masks are the single device's."""
    items = _items(16)
    csp = _two_devices(coalesce_lanes=8)
    used, masks = [], []
    for k in range(4):
        masks.append(csp.verify_batch(items[8 * (k % 2):8 * (k % 2) + 8]))
        used.append(csp.last_dispatch_devices)
    assert used == [(TWO[0],), (TWO[1],), (TWO[0],), (TWO[1],)]
    assert masks[0] + masks[1] == hostref.verify_batch(items)
    assert masks[2:] == masks[:2]
    csp.close()


def test_concurrent_submitters_stress(monkeypatch):
    """Many threads submit overlapping async batches of random sizes to
    one provider over two devices and collect in random order; each
    caller gets exactly its own mask.  The kernel is stood in for by the
    packer's precheck flags (the tampered lane is a high-S signature,
    which they reject), so the coalescer, not the plain version's speed,
    is under test.  Seeded."""
    monkeypatch.setattr(pk, "verify_packed",
                        lambda t: t["flags"][1].to(torch.bool))
    items = _items(32, bad_high_s=True)
    rng = random.Random(4242)
    csp = _two_devices(max_chunk=8, coalesce_lanes=8)
    jobs = []
    for _ in range(24):
        size = rng.choice((5, 9, 17))
        jobs.append((rng.randrange(0, len(items) - size), size))
    results: list = [None] * len(jobs)
    errors: list = []
    barrier = threading.Barrier(8)

    def worker(w):
        try:
            barrier.wait()
            for j in range(w, len(jobs), 8):
                start, size = jobs[j]
                collect = csp.verify_batch_async(items[start:start + size])
                results[j] = collect() if j % 3 == 0 else ("defer", collect)
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for j, r in enumerate(results):
        if isinstance(r, tuple) and r and r[0] == "defer":
            results[j] = r[1]()
    for j, (start, size) in enumerate(jobs):
        assert results[j] == [i != BAD for i in range(start, start + size)]
    assert csp.last_dispatch_devices
    assert csp.drain(timeout=30)
    csp.close()


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
