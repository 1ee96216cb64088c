"""The port's lockwatch against the JAX package's, script for script.

Each script below drives one module through the same lock orders,
condition waits, guard assertions and thread lifecycles, and returns a
transcript: the order graph's edges among its own roles, each
LockOrderError's message, the violation records (thread names included)
and the thread verdicts.  The two modules' transcripts must be equal,
exactly.  Both run in the mode the test session arms
(FABRIC_TPU_LOCKWATCH=1, FABRIC_TPU_THREADWATCH=1); each script's roles
and threads carry a prefix of their own, and the fixture takes them out
of both modules' graphs and ledgers afterwards.

The last test is the counterpart of the JAX package's
`tests/test_lockwatch.py` runtime-in-static check: a CPU commit and
snapshot session of the port, whose every lock-order edge lockwatch
observed must be an edge of the port's fabriclint static lock graph.
"""

import threading

import pytest

from fabric_tpu.devtools import lockwatch as jax_lw
from fabric_tpu_torch.devtools import lockwatch as port_lw

PFX = "parity."


def _mine(v) -> bool:
    return any(str(x).startswith(PFX) for x in v.values())


@pytest.fixture(autouse=True)
def _scrub():
    yield
    for lw in (jax_lw, port_lw):
        with lw._state_lock:
            for k in [k for k in lw._edges if k.startswith(PFX)]:
                del lw._edges[k]
            for succ in lw._edges.values():
                succ.difference_update(
                    [s for s in succ if s.startswith(PFX)])
            lw.violations[:] = [v for v in lw.violations if not _mine(v)]
        with lw._threads_lock:
            lw.thread_violations[:] = [
                v for v in lw.thread_violations if not _mine(v)]


def _edges(lw) -> dict:
    return {k: sorted(v) for k, v in sorted(lw.edges().items())
            if k.startswith(PFX)}


def _violations(lw) -> list:
    return [v for v in lw.violations if _mine(v)]


def _attempt(fn) -> str | None:
    try:
        fn()
    except Exception as exc:  # the error's class and message
        return f"{type(exc).__name__}: {exc}"
    return None


def inversion(lw, tag):
    a, b = lw.WatchedLock(f"{PFX}{tag}.a"), lw.WatchedLock(f"{PFX}{tag}.b")
    with a, b:
        pass

    def reverse():
        with b, a:
            pass

    return [_edges(lw), _attempt(reverse), _violations(lw)]


def three_cycle(lw, tag):
    a, b, c = (lw.WatchedLock(f"{PFX}{tag}.{n}", threading.RLock)
               for n in "abc")
    with a, b:
        pass
    with b, c:
        pass

    def close():
        with c, a:
            pass

    return [_edges(lw), _attempt(close), _violations(lw)]


def reentrant_and_self(lw, tag):
    r = lw.WatchedLock(f"{PFX}{tag}.r", threading.RLock)
    p = lw.WatchedLock(f"{PFX}{tag}.p")
    with r, r, p:
        pass

    def twice():
        with p:
            # fabriclint: allow[lock-discipline] the re-acquire must raise
            p.acquire()

    return [_edges(lw), _attempt(twice), _violations(lw)]


def try_lock_records_nothing(lw, tag):
    a, b = lw.WatchedLock(f"{PFX}{tag}.a"), lw.WatchedLock(f"{PFX}{tag}.b")
    held = threading.Event()
    done = threading.Event()

    def holder():
        with b:
            held.set()
            done.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    with a:
        got = b.acquire(blocking=False)
    done.set()
    t.join()
    with a:
        got2 = b.acquire(timeout=1.0)
        b.release()
    return [got, got2, _edges(lw)]


def condition_wait(lw, tag):
    outer = lw.WatchedLock(f"{PFX}{tag}.outer")
    cond = lw.WatchedCondition(f"{PFX}{tag}.cond")
    with outer, cond:
        pass

    def wait():
        with outer, cond:
            cond.wait(0.01)

    with cond:
        plain = cond.wait(0.01)
    return [plain, _edges(lw), _attempt(wait), _violations(lw)]


class _Box:
    field = 0


def guard(lw, tag):
    role = f"{PFX}{tag}.g"
    lock = lw.WatchedLock(role)
    box = _Box()
    with lock:
        lw.guarded(box, "field", by=role)
    return [_attempt(lambda: lw.guarded(box, "field", by=role)),
            _violations(lw)]


def cross_thread_release(lw, tag):
    lock = lw.WatchedLock(f"{PFX}{tag}.x")
    out = []
    with lock:
        t = threading.Thread(
            target=lambda: out.append(_attempt(lock.release)),
            name=f"{PFX}{tag}.releaser")
        t.start()
        t.join()
    return [out, _violations(lw)]


def thread_verdicts(lw, tag):
    def boom():
        raise ValueError("worker fault")

    t = lw.spawn_thread(boom, name=f"{PFX}{tag}.boom")
    t.start()
    t.join()
    gate = threading.Event()
    slow = lw.spawn_thread(gate.wait, args=(5,), name=f"{PFX}{tag}.slow")
    slow.start()
    alive = sorted(i["name"] for i in lw.threads_alive()
                   if i["name"].startswith(PFX))
    before = len(lw.thread_violations)
    stragglers = [s for s in lw.drain_threads(timeout=0.05)
                  if s.startswith(PFX)]
    # the 0.05 s deadline is this script's own: a worker of an earlier
    # test of the process still running then is no straggler of it (the
    # session's gate drains every worker with its own deadline)
    with lw._threads_lock:
        lw.thread_violations[before:] = [
            v for v in lw.thread_violations[before:]
            if _mine(v) or v["event"] != "drain-timeout"]
    gate.set()
    slow.join()
    verdicts = [v for v in lw.thread_violations if _mine(v)]
    with pytest.raises(ValueError):
        lw.spawn_thread(boom, kind="daemon")
    return [alive, stragglers, verdicts]


def executor_registry(lw, tag):
    ex = lw.tracked_executor(2, name=f"{PFX}{tag}.pool")
    seen = ex.submit(lambda: sorted(
        i["kind"] for i in lw.threads_alive()
        if i["name"].startswith(f"{PFX}{tag}.pool"))).result()
    ex.shutdown(wait=True)
    left = [i for i in lw.threads_alive()
            if i["name"].startswith(f"{PFX}{tag}.pool")]
    return [seen, left]


SCRIPTS = [inversion, three_cycle, reentrant_and_self,
           try_lock_records_nothing, condition_wait, guard,
           cross_thread_release, thread_verdicts, executor_registry]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("script", SCRIPTS, ids=[s.__name__ for s in SCRIPTS])
def test_the_same_script_gives_the_same_transcript(script):
    tag = script.__name__
    assert port_lw.enabled() and port_lw.threads_enabled()
    assert script(port_lw, tag) == script(jax_lw, tag)


def test_the_watch_is_armed_by_the_same_knobs(monkeypatch):
    """Unarmed, both hand out plain threading objects."""
    for name in ("FABRIC_TPU_LOCKWATCH", "FABRIC_TPU_THREADWATCH",
                 "FABRIC_TPU_PROFILE"):
        monkeypatch.setenv(name, "")
    for lw in (jax_lw, port_lw):
        assert type(lw.named_lock("x")) is type(threading.Lock())
        assert type(lw.named_rlock("x")) is type(threading.RLock())
        assert type(lw.named_condition("x")) is threading.Condition
        assert type(lw.spawn_thread(lambda: None)) is threading.Thread
    monkeypatch.setenv("FABRIC_TPU_LOCKWATCH", "record")
    assert not port_lw._raise_mode() and not jax_lw._raise_mode()


def test_runtime_lock_graph_is_subgraph_of_static(tmp_path):
    """Every acquisition-order edge the port's lockwatch observes during
    a live commit and snapshot session (8 blocks of 10 through the
    committer, a snapshot request the commit crosses, then `generate()`)
    is an edge of the port's static lock-order graph.  The edges that
    earlier tests of the same process observed (a gossip commit's, say)
    are set aside for the session and put back after it, so the check
    holds the session's own edges whatever ran before it."""
    import chip_smoke
    from fabric_tpu_torch.common import workpool
    from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
    from fabric_tpu_torch.csp.cuda.provider import CUDACSP
    from fabric_tpu_torch.devtools.lint import lint_tree
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.peer.committer import Committer
    from fabric_tpu_torch.peer.txvalidator import TxValidator
    from fabric_tpu_torch.protos import common as cb

    assert port_lw.enabled() and port_lw._raise_mode()
    world = chip_smoke.validator_world(17)
    blocks, _, _ = chip_smoke.validator_blocks(
        world, 8, 10, world.genesis_hash, mvcc=True)
    csp = CUDACSP(device="cpu", min_device_batch=1 << 30)
    with port_lw._state_lock:
        before = {k: set(v) for k, v in port_lw._edges.items()}
        port_lw._edges.clear()
    provider = LedgerProvider(str(tmp_path / "ledger"), csp=csp)
    try:
        ledger = provider.create(cb.Block.decode(world.genesis))
        mgr = ledger.snapshots
        mgr.submit_request(chip_smoke.SNAP_BLOCK)
        committer = Committer(TxValidator(
            chip_smoke.VALIDATOR_CHANNEL, ledger,
            bundle_from_genesis(world.genesis), csp), ledger)
        list(committer.store_stream(blocks, depth=3))
        assert mgr.wait_idle(timeout=30)
        mgr.generate()
    finally:
        provider.close()
        workpool.shutdown()
        observed = [(s, d) for s, ds in sorted(port_lw.edges().items())
                    for d in sorted(ds) if not s.startswith(PFX)]
        with port_lw._state_lock:
            for k, v in before.items():
                port_lw._edges.setdefault(k, set()).update(v)
    assert ("kvledger.commit_lock", "snapshot.manager") in observed
    assert not _violations(port_lw) and not [
        v for v in port_lw.violations if not _mine(v)]
    static = lint_tree().lock_graph()["edges"]
    missing = [(s, d) for s, d in observed if d not in static.get(s, {})]
    assert not missing, (
        f"runtime lockwatch edges missing from the static graph: {missing}")
