"""The CSP's degraded mode on the port (CUDACSP on the CPU) held against
the JAX package's TPUCSP.

On the CPU the port's provider answers for a faulty device from the host,
as the reference does.  The same faultline plan, armed in each package's
own `faultline`, and the same calls into `TPUCSP` and
`CUDACSP(device="cpu")` must give equal
masks, an equal breaker trace (open, trips, consecutive failures, probe
results) and an equal `/metrics` exposition: the contracts of
tests/test_csp_degraded.py.  The deadline arithmetic and the flush's
race, reseal and sealing are tests/test_csp_tpu.py's (the JAX package's
CPU path arms no deadline, so the port's race is held against the host
oracle through a stalled CUDA event, a seam, and a `delay` plan).  The
host verifier `native.ecdsa_verify_host` gives SWCSP's verdicts on the
corpus and the Wycheproof vectors.  A kernel or C++-library build failure
reaches every collector of each seam with the breaker untouched, and so
does a built library that will not load.  On a card the host answers
nothing: the same faults raise out of every collector and an open
breaker refuses the call, held here on the CPU provider with the card's
policy switched on.

The JAX side verifies at one XLA shape (bucket 32, ≤ 32 lanes), compiled
once by a module fixture; the port's lanes run B1's plain version.
"""

import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import ctypes.util  # noqa: E402
import hashlib  # noqa: E402
import os  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

from test_csp_degraded import HostOracle, _items  # noqa: E402
from test_torch_p256 import corpus  # noqa: E402,F401

from fabric_tpu import native as jnative  # noqa: E402
from fabric_tpu.common import metrics as jmetrics  # noqa: E402
from fabric_tpu.csp.tpu import provider as jprov  # noqa: E402
from fabric_tpu.devtools import clockskew as jclock  # noqa: E402
from fabric_tpu.devtools import faultline as jfault  # noqa: E402
from fabric_tpu_torch import native  # noqa: E402
from fabric_tpu_torch.common import metrics as pmetrics  # noqa: E402
from fabric_tpu_torch.csp import api, hostref  # noqa: E402
from fabric_tpu_torch.csp.api import VerifyBatchItem  # noqa: E402
from fabric_tpu_torch.csp.cuda import build  # noqa: E402
from fabric_tpu_torch.csp.cuda import p256_kernel as pk  # noqa: E402
from fabric_tpu_torch.csp.cuda import provider as prov  # noqa: E402
from fabric_tpu_torch.csp.cuda import sha256 as sha  # noqa: E402
from fabric_tpu_torch.csp.cuda.provider import CUDACSP, _FlushResult  # noqa: E402
from fabric_tpu_torch.devtools import clockskew as pclock  # noqa: E402
from fabric_tpu_torch.devtools import faultline as pfault  # noqa: E402

COLLECT_RAISE = {"point": "tpu.collect", "action": "raise",
                 "error": "DeviceUnavailable"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def items():
    """24 lanes of test_csp_degraded's (every fourth tampered), with the
    JAX package's verify compiled once at their bucket (32)."""
    lanes = _items(24)
    csp = jprov.TPUCSP(sw=HostOracle(), min_device_batch=1)
    try:
        assert csp.verify_batch(list(lanes)) == HostOracle().verify_batch(
            lanes)
    finally:
        csp.close()
    return lanes


@pytest.fixture(autouse=True)
def _host_rate(monkeypatch):
    """Each package's process-wide measured host rate starts unset, so
    that the deadlines of both follow only this test's calls."""
    monkeypatch.setattr(jprov, "_host_rate_ewma", [None])
    monkeypatch.setattr(prov, "_host_rate_ewma", [None])


PACKAGES = {
    "jax": (jprov.TPUCSP, jfault, jmetrics),
    "port": (lambda **kw: CUDACSP(device="cpu", **kw), pfault, pmetrics),
}


def _csp(pkg, metrics=None, threshold=2, probe_every=2):
    make, _, _ = PACKAGES[pkg]
    return make(sw=HostOracle(), min_device_batch=1,
                breaker_threshold=threshold, breaker_probe_every=probe_every,
                metrics=metrics, host_rate_hint=9000.0)


def _breaker(csp) -> tuple:
    b = csp.breaker
    return (b.open, b.trips, b._consecutive, b.threshold, b.probe_every)


def _run(pkg, scenario, items, **kw):
    """One scenario in one package: its trace and the /metrics text."""
    _, fault, metrics = PACKAGES[pkg]
    prom = metrics.PrometheusProvider()
    csp = _csp(pkg, metrics=metrics.CSPMetrics(prom), **kw)
    try:
        trace = scenario(csp, fault, list(items))
    finally:
        csp.close()
    return trace, prom.registry.expose(), csp


def _parity(scenario, items, **kw):
    """The scenario's trace and exposition in both packages, equal; the
    port's provider for its own counters."""
    jtrace, jtext, _ = _run("jax", scenario, items, **kw)
    ptrace, ptext, port = _run("port", scenario, items, **kw)
    assert ptrace == jtrace
    assert ptext == jtext
    return ptrace, ptext, port


# -- test_csp_degraded's contracts, in both packages ---------------------------


def _reseal(csp, fault, items):
    trace = []
    with fault.use_plan({"faults": [dict(COLLECT_RAISE, nth=1)]}):
        trace.append(csp.verify_batch(list(items)))
        trace.append(len(fault.trips()))
    trace.append(_breaker(csp))
    trace.append(csp.verify_batch(list(items)))  # healthy: resets the count
    trace.append(_breaker(csp))
    return trace


def test_device_failure_mid_flush_reseals_on_host(items):
    want = HostOracle().verify_batch(items)
    trace, _, port = _parity(_reseal, items)
    assert trace == [want, 1, (False, 0, 1, 2, 2), want, (False, 0, 0, 2, 2)]
    assert any(want) and not all(want)
    stats = port.degraded_stats()
    assert (stats["host_lanes"], stats["device_failures"], stats["races"]) \
        == (24, 1, 0)


def _lifecycle(csp, fault, items):
    trace = []
    with fault.use_plan({"faults": [dict(COLLECT_RAISE, count=2)]}):
        trace.append(csp.verify_batch(list(items)))
        trace.append(csp.verify_batch(list(items)))
        trace.append(_breaker(csp))
        gen = csp._gen
        trace.append(csp.verify_batch(list(items)))  # held: host, no flush
        trace.append((csp._gen - gen, _breaker(csp)))
        trace.append(csp.verify_batch(list(items)))  # probe closes it
        trace.append((csp._gen - gen, _breaker(csp)))
        trace.append(len(fault.trips()))
    return trace


def test_breaker_opens_routes_host_probes_and_recovers(items):
    want = HostOracle().verify_batch(items)
    trace, text, port = _parity(_lifecycle, items)
    assert trace[:5] == [want, want, (True, 1, 2, 2, 2), want,
                         (0, (True, 1, 2, 2, 2))]
    assert trace[5] == want and trace[7] == 2
    assert trace[6][0] >= 1 and trace[6][1] == (False, 1, 0, 2, 2)
    assert "csp_tpu_breaker_state 0" in text
    assert "csp_tpu_breaker_trips_total 1" in text
    assert 'csp_tpu_breaker_probes_total{result="ok"} 1' in text
    assert "csp_tpu_device_failures_total 2" in text
    stats = port.degraded_stats()
    assert (stats["host_lanes"], stats["trips"], stats["probes_ok"]) \
        == (72, 1, 1)


def _probe_fails(csp, fault, items):
    trace = []
    with fault.use_plan({"faults": [dict(COLLECT_RAISE, count=100)]}):
        trace.append(csp.verify_batch(list(items[:8])))
        trace.append(_breaker(csp))
        trace.append(csp.verify_batch(list(items[:8])))
        trace.append(_breaker(csp))
    return trace


def test_probe_fails_while_device_still_down(items):
    want = HostOracle().verify_batch(items[:8])
    trace, text, _ = _parity(_probe_fails, items, threshold=1, probe_every=1)
    assert trace[0] == trace[2] == want
    assert trace[1][0] and trace[3][0]
    assert 'csp_tpu_breaker_probes_total{result="fail"} 1' in text


def _dispatch_fails(csp, fault, items):
    with fault.use_plan({"faults": [
        {"point": "tpu.dispatch", "action": "raise",
         "error": "DeviceUnavailable", "nth": 1},
    ]}):
        return [csp.verify_batch(list(items[:8])), _breaker(csp)]


def test_dispatch_failure_counts_toward_breaker(items):
    trace, _, port = _parity(_dispatch_fails, items, threshold=1)
    assert trace == [HostOracle().verify_batch(items[:8]),
                     (True, 1, 1, 1, 2)]
    assert port.degraded_stats()["host_lanes"] == 8


@pytest.fixture
def card_route(monkeypatch):
    """32 one-block messages take the port's card route (its routing
    rule would send them to hashlib), as every batch of 16 or more takes
    the JAX package's device."""
    monkeypatch.setattr(prov, "HASH_WIDTH", 1)
    monkeypatch.setattr(prov, "HASH_FIXED", 0)
    return [b"h%d" % i for i in range(32)]


def _hash_open(csp, fault, msgs):
    with fault.use_plan({"faults": [
        {"point": "tpu.hash", "action": "raise",
         "error": "DeviceUnavailable", "nth": 1},
        # would fire if hash_batch touched the device again while open
        {"point": "tpu.hash", "action": "raise", "error": "RuntimeError",
         "nth": 2},
    ]}):
        return [csp.hash_batch(msgs), _breaker(csp), csp.hash_batch(msgs),
                len(fault.trips())]


def test_hash_batch_routes_host_while_open_and_on_failure(card_route):
    want = [hashlib.sha256(m).digest() for m in card_route]
    trace, _, port = _parity(_hash_open, card_route, threshold=1)
    assert trace == [want, (True, 1, 1, 1, 2), want, 1]
    assert port.degraded_stats()["host_hashes"] == 64


def _hash_closes(csp, fault, msgs):
    with fault.use_plan({"faults": [
        {"point": "tpu.hash", "action": "raise",
         "error": "DeviceUnavailable", "count": 1},
    ]}):
        return [csp.hash_batch(msgs), _breaker(csp), csp.hash_batch(msgs),
                _breaker(csp), csp.hash_batch(msgs), _breaker(csp)]


def test_hash_only_traffic_can_close_breaker(card_route, items):
    want = [hashlib.sha256(m).digest() for m in card_route]
    trace, text, _ = _parity(_hash_closes, card_route, threshold=1)
    assert trace[::2] == [want] * 3
    assert [t[0] for t in trace[1::2]] == [True, True, False]
    assert 'csp_tpu_breaker_probes_total{result="ok"} 1' in text


def test_probe_vector_is_device_valid(items):
    for pkg in PACKAGES:
        csp = _csp(pkg)
        try:
            assert csp._probe_device() is True
        finally:
            csp.close()
    assert prov._ProbeKey(CUDACSP._PROBE_QX, CUDACSP._PROBE_QY).ski() \
        == jprov._ProbeKey(jprov.TPUCSP._PROBE_QX,
                           jprov.TPUCSP._PROBE_QY).ski()


def test_breaker_knobs_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("FABRIC_TPU_BREAKER_THRESHOLD", "5")
    monkeypatch.setenv("FABRIC_TPU_BREAKER_PROBE_EVERY", "junk")
    for b in (prov._Breaker(), jprov._Breaker()):
        assert (b.threshold, b.probe_every) == (5, 8)


def test_health_checker_reports_an_open_breaker(items):
    csp = _csp("port", threshold=1)
    check = csp.health_checker()
    assert check() is True
    with pfault.use_plan({"faults": [dict(COLLECT_RAISE, nth=1)]}):
        csp.verify_batch(list(items[:8]))
    assert csp.breaker_open
    with pytest.raises(RuntimeError, match="circuit breaker open"):
        check()
    csp.close()


def test_faultline_plans_fire_alike_in_both_packages():
    """One plan (every trigger, a wildcard, delay and skew under a
    virtual clock) over the same hits gives both packages' faultline the
    same raised errors, trip ledger and clock; unarmed, a point consults
    nothing."""
    plan = {"seed": 7, "faults": [
        {"point": "tpu.dispatch", "action": "raise",
         "error": "DeviceUnavailable", "every": 3},
        {"point": "tpu.collect", "action": "raise", "prob": 0.3, "count": 4},
        {"point": "tpu.hash", "action": "skew", "skew_s": 2.5, "nth": 2},
        {"point": "tpu.*", "action": "delay", "delay_s": 0.5, "prob": 0.1},
        {"point": "tpu.collect", "ctx": {"lanes": 7}, "action": "crash"},
    ]}
    traces = []
    for fault, clock in ((jfault, jclock), (pfault, pclock)):
        before = fault.lookup_count()
        fault.point("tpu.dispatch", lanes=1)
        assert fault.lookup_count() == before
        with clock.use_virtual() as clk, fault.use_plan(plan):
            raised = []
            for i in range(40):
                name = ("tpu.dispatch", "tpu.collect", "tpu.hash")[i % 3]
                try:
                    fault.point(name, lanes=i)
                    raised.append(None)
                except BaseException as e:  # FaultCrash is one
                    raised.append(type(e).__name__)
            traces.append((raised, fault.trips(), clk.monotonic(),
                           clk.sleeps, sorted(fault.registry())))
        assert not fault.active() and not fault.trips()
    assert traces[0] == traces[1]
    assert {"DeviceUnavailable", "FaultInjected"} <= set(traces[1][0])
    assert traces[1][3]  # the delays slept on the virtual clock
    with pytest.raises(pfault.PlanError):
        pfault.Plan({"faults": [{"point": "tpu.hash", "nth": 0}]})


# -- test_csp_tpu's deadline and race contracts ---------------------------------


def test_deadline_ewma_budget():
    """The stall deadline: the host anchor until the EWMA is primed, then
    1.5x the predicted flush wall within [0.15 s, anchor], in both."""
    for mod, make in ((jprov, jprov.TPUCSP),
                      (prov, lambda **kw: CUDACSP(device="cpu", **kw))):
        csp = make(stall_factor=1.0, host_rate_hint=10000.0)
        assert csp._deadline_for(4000) == 0.4
        assert csp._deadline_for(100) == 0.2
        for _ in range(4):
            csp._note_device_wall(4000, 0.08)
        assert csp._deadline_for(4000) == 0.15
        assert abs(csp._deadline_for(16000)
                   - 1.5 * (0.08 / 4000) * 16000) < 1e-9
        for _ in range(12):
            csp._note_device_wall(4000, 3.2)
        assert csp._deadline_for(4000) == 0.4
        assert make(stall_factor=None)._deadline_for(4000) is None


def test_sole_flush_deadline_is_absolute_budget():
    got = []
    for mod, make in ((jprov, jprov.TPUCSP),
                      (prov, lambda **kw: CUDACSP(device="cpu", **kw))):
        csp = make(stall_factor=1.0, host_rate_hint=9000.0)
        for _ in range(8):
            csp._note_device_wall(3000, 0.25)
        pipelined = csp._deadline_for(3000)
        sole = csp._sole_deadline_for(3000)
        assert pipelined == max(0.2, 3000 / 9000.0)
        assert sole + 3000 / 9000.0 <= 0.421 and sole >= 0.05
        mod._note_host_rate(3000, 0.5)  # 6000 lanes/s observed
        got.append((pipelined, sole, csp._sole_deadline_for(3000)))
    assert got[0] == got[1]
    assert got[1][2] == 0.05


class StalledEvent:
    """A CUDA event of a chunk the device has not finished until
    `release` is set: the seam a stalled card shows the provider."""

    def __init__(self, release: threading.Event):
        self.release = release

    def query(self) -> bool:
        return self.release.is_set()

    def synchronize(self) -> None:
        self.release.wait(30)


def _stalled_chunk(mask, release):
    ev = StalledEvent(release)

    def collect():
        ev.synchronize()
        return list(mask)

    return (collect, ev)


def test_flush_deadline_host_race_beats_stalled_device(items):
    """A device that does not answer is beaten by the host race after the
    deadline; the mask is the host's, and the late device mask (all
    True) is never read."""
    release = threading.Event()
    sw = HostOracle()
    res = _FlushResult([_stalled_chunk([True] * 12, release)], 12, sw=sw,
                       device_items=items[:12], deadline=0.05,
                       stats=prov._Stats())
    got = res.collect()
    release.set()
    assert got == sw.verify_batch(items[:12]) != [True] * 12
    assert res.idle(time.monotonic() + 30)
    assert res.collect() == got  # the late device mask lost the seal
    assert not res.device_ok
    assert res._stats.counts["race_wins"] == 1


def test_flush_race_yields_to_device_completion(items):
    release = threading.Event()
    release.set()
    res = _FlushResult([_stalled_chunk([True] * 8, release)], 8,
                       sw=HostOracle(), device_items=items[:8],
                       deadline=0.01)
    assert res.collect() == [True] * 8
    assert res.device_ok


def test_flush_waiter_failure_degrades_to_host(items):
    def broken():
        raise RuntimeError("device lost")

    outcomes = []
    res = _FlushResult([(broken, None)], 10, sw=HostOracle(),
                       device_items=items[:10],
                       on_device_outcome=outcomes.append)
    assert res.collect() == HostOracle().verify_batch(items[:10])
    assert outcomes == [False]


def test_armed_race_beats_a_delayed_collect(items):
    """Through the provider: a `delay` at tpu.collect stalls the flush
    past its sole deadline (0.2 s for 24 lanes), the host race answers
    with the oracle's mask, the device's late mask loses the seal, and
    no device wall feeds the EWMA."""
    csp = CUDACSP(device="cpu", sw=HostOracle(), min_device_batch=1,
                  coalesce_lanes=1, host_rate_hint=9000.0)
    want = HostOracle().verify_batch(items)
    with pfault.use_plan({"faults": [
        {"point": "tpu.collect", "action": "delay", "delay_s": 0.6,
         "nth": 1},
    ]}):
        col = csp.verify_batch_async(list(items))  # flushed: dispatched
        t0 = time.perf_counter()
        assert col() == want
        wall = time.perf_counter() - t0
    assert 0.2 <= wall < 0.55
    assert csp.drain(timeout=30)
    stats = csp.degraded_stats()
    assert (stats["races"], stats["race_wins"], stats["host_lanes"]) \
        == (1, 1, 24)
    assert csp._lane_wall_ewma is None
    assert not csp.breaker_open and csp.breaker._consecutive == 0
    csp.close()


def test_host_fraction_tail_is_verified_on_the_host(items, monkeypatch):
    """host_fraction=0.25 on a 2048-lane flush: the device gets the first
    1536 lanes and the host verifies the last 512 while it runs, in lane
    order after them (the device stands in as all-True lanes here: the
    split is under test, not the kernel)."""
    lanes = (list(items) * 86)[:2048]
    launched = []

    def device(t):
        launched.append(t["d1"].shape[1])
        return torch.ones(t["d1"].shape[1], dtype=torch.bool)

    monkeypatch.setattr(pk, "verify_packed", device)
    csp = CUDACSP(device="cpu", min_device_batch=1, host_fraction=0.25,
                  sw=HostOracle())
    got = csp.verify_batch(lanes)
    assert launched == [1536]
    want = HostOracle().verify_batch(items) * 86  # the lanes repeat
    assert got == [True] * 1536 + want[1536:2048]
    assert csp.degraded_stats()["host_lanes"] == 512
    small = csp.verify_batch(lanes[:2047])  # under 2048: no tail
    assert launched == [1536, 2047] and small == [True] * 2047
    csp.close()


# -- the host verifier -----------------------------------------------------------


def test_ecdsa_verify_host_matches_sw_on_the_corpus(corpus):
    """libcrypto's batch gives SWCSP's verdicts on the corpus and the
    Wycheproof vectors (and the JAX package's native verifier's)."""
    names, lanes, expect = corpus
    port_items = [VerifyBatchItem(api.P256PublicKey(x, y), d, der)
                  for x, y, d, der in lanes]
    got = native.ecdsa_verify_host(port_items)
    assert native.ecdsa_impl() == "libcrypto"
    assert got == list(expect), [n for n, a, b in zip(names, got, expect)
                                 if a != b]
    assert got == jnative.ecdsa_verify_host(port_items)
    assert got == hostref.verify_batch(port_items)
    short = [VerifyBatchItem(port_items[0].key, port_items[0].digest[:31],
                             port_items[0].signature)]
    assert native.ecdsa_verify_host(short) == [False]
    assert native.ecdsa_verify_host([]) == []


def test_ecdsa_verify_host_keeps_its_verdicts_lane_by_lane(corpus):
    """The verifier keeps the keys it wrapped across calls: the corpus one
    lane a call (a key off P-256 among them), twice over and in reverse,
    gives the batch's verdicts."""
    names, lanes, expect = corpus
    port_items = [VerifyBatchItem(api.P256PublicKey(x, y), d, der)
                  for x, y, d, der in lanes]
    for order in (port_items, port_items, port_items[::-1]):
        got = [native.ecdsa_verify_host([it])[0] for it in order]
        want = list(expect) if order is port_items else list(expect)[::-1]
        assert got == want


def test_host_verify_takes_the_oracle_without_libcrypto(items, monkeypatch):
    monkeypatch.setattr(native, "ecdsa_verify_host", lambda its: None)
    calls = []

    class Oracle(HostOracle):
        def verify_batch(self, its):
            calls.append(len(its))
            return super().verify_batch(its)

    assert prov._host_verify_batch(Oracle(), items[:8]) == \
        HostOracle().verify_batch(items[:8])
    assert calls == [8]


# -- a build failure is never a device failure ------------------------------------

BUILD_FAILURES = {
    "kernel": lambda: build.KernelBuildError("nvcc failed: no luck"),
    "native": lambda: native.NativeBuildError("g++ failed: no luck"),
}


@pytest.mark.parametrize("kind", sorted(BUILD_FAILURES))
def test_build_error_reaches_every_verify_collector(kind, items, monkeypatch):
    """A build failure in dispatch (the packer's library, the kernel's)
    raises out of every collector of the flush; the breaker counts
    nothing and the host answers nothing."""

    def broken(*a, **k):
        raise BUILD_FAILURES[kind]()

    monkeypatch.setattr(pk, "pack_items" if kind == "native"
                        else "verify_packed", broken)
    monkeypatch.setattr(prov, "_host_verify_batch", _no_host)
    csp = CUDACSP(device="cpu", min_device_batch=1, coalesce_lanes=10**6,
                  breaker_threshold=1, breaker_probe_every=8)
    cols = [csp.verify_batch_async(items[:4]),
            csp.verify_batch_async(items[4:])]
    for col in cols:
        with pytest.raises(RuntimeError, match="no luck"):
            col()
    assert _breaker(csp) == (False, 0, 0, 1, 8)
    assert csp.degraded_stats()["device_failures"] == 0
    csp.close()


def _no_host(*a, **k):
    raise AssertionError("the host answered")


@pytest.mark.parametrize("armed", [False, True])
@pytest.mark.parametrize("kind", sorted(BUILD_FAILURES))
def test_build_error_in_collect_is_not_resealed(kind, armed, items):
    """A build error raised in a flush's device phase is the flush's
    exception, not a reseal, whether or not a fault plan is armed (it
    arms the race's polling of the device)."""
    def broken():
        raise BUILD_FAILURES[kind]()

    outcomes = []
    res = _FlushResult([(broken, None)], 8, sw=_NoHost(),
                       device_items=items[:8], deadline=5.0,
                       on_device_outcome=outcomes.append)
    with pfault.use_plan({"faults": [{"point": "tpu.hash", "nth": 1}]}) \
            if armed else _nothing():
        with pytest.raises(RuntimeError, match="no luck"):
            res.collect()
    assert res.idle(time.monotonic() + 30)
    assert outcomes == []


@contextlib.contextmanager
def _nothing():
    yield


class _NoHost:
    def verify_batch(self, its):
        raise AssertionError("the host answered")


@pytest.mark.parametrize("kind", sorted(BUILD_FAILURES))
def test_build_error_reaches_hash_batch(kind, monkeypatch, card_route):
    def broken(msgs, device):
        raise BUILD_FAILURES[kind]()

    monkeypatch.setattr(sha, "sha256_batch", broken)
    csp = CUDACSP(device="cpu", breaker_threshold=1)
    with pytest.raises(RuntimeError, match="no luck"):
        csp.hash_batch(card_route)
    assert _breaker(csp) == (False, 0, 0, 1, 8)
    assert csp.degraded_stats()["host_hashes"] == 0


@pytest.mark.parametrize("kind", sorted(BUILD_FAILURES))
def test_build_error_in_the_probe_raises(kind, monkeypatch, items):
    """An open breaker's probe that meets a build failure raises it; the
    breaker stays open and the call is not served by the host."""
    csp = CUDACSP(device="cpu", min_device_batch=1, breaker_threshold=1,
                  breaker_probe_every=1, sw=HostOracle())
    with pfault.use_plan({"faults": [dict(COLLECT_RAISE, nth=1)]}):
        csp.verify_batch(list(items[:8]))
    assert csp.breaker_open

    def broken(*a, **k):
        raise BUILD_FAILURES[kind]()

    monkeypatch.setattr(pk, "verify_packed", broken)
    with pytest.raises(RuntimeError, match="no luck"):
        csp.verify_batch(list(items[:8]))
    assert csp.breaker_open and csp.breaker.probes == {"ok": 0, "fail": 0}
    csp.close()


@pytest.mark.parametrize("seam", ["kernel", "probe", "native"])
@pytest.mark.parametrize("lib", ["garbage", "no-symbols"])
def test_a_library_that_will_not_load_is_a_build_error(seam, lib, tmp_path,
                                                       monkeypatch):
    """A built library that the loader refuses, or that lacks an entry
    point (the C library's file), raises the build error of its seam,
    never a device fault."""
    body = (b"not an ELF file" if lib == "garbage"
            else open(_libc_file(), "rb").read())
    path = tmp_path / "lib.so"
    if seam == "probe":
        nvcc = str(tmp_path / "nvcc")
        monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        path = (tmp_path / f"p256_field_probe-"
                f"{build._build_key(build.PROBE, nvcc)}"
                / "libp256_field_probe.so")
        path.parent.mkdir()
    path.write_bytes(body)
    if seam == "kernel":
        monkeypatch.setattr(build, "_libs", {})
        monkeypatch.setattr(build, "build_all",
                            lambda: {"p256_verify": path})
        with pytest.raises(build.KernelBuildError, match="does not load"):
            build.load()
    elif seam == "probe":
        with pytest.raises(build.KernelBuildError, match="does not load"):
            build.load_probe()
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "build", lambda: path)
        with pytest.raises(native.NativeBuildError, match="does not load"):
            native.load()


def _libc_file() -> str:
    """The C library's file: it loads, and has none of the port's entry
    points."""
    name = ctypes.util.find_library("c") or "libc.so.6"
    for d in ("/lib/x86_64-linux-gnu", "/lib64", "/usr/lib64", "/usr/lib",
              "/lib/aarch64-linux-gnu", "/lib"):
        cand = os.path.join(d, name)
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(name)


def test_a_packer_that_will_not_load_reaches_every_collector(items, tmp_path,
                                                             monkeypatch):
    """The packer's library failing to load in a flush's dispatch raises
    out of every collector; the breaker counts nothing."""
    bad = tmp_path / "libfabricnative.so"
    bad.write_bytes(b"not an ELF file")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", lambda: bad)
    monkeypatch.setattr(prov, "_host_verify_batch", _no_host)
    csp = CUDACSP(device="cpu", min_device_batch=1, coalesce_lanes=10**6,
                  breaker_threshold=1)
    cols = [csp.verify_batch_async(items[:4]),
            csp.verify_batch_async(items[4:])]
    for col in cols:
        with pytest.raises(native.NativeBuildError, match="does not load"):
            col()
    assert _breaker(csp) == (False, 0, 0, 1, 8)
    csp.close()


# -- on a card the host answers nothing ---------------------------------------------


def _card(**kw) -> CUDACSP:
    """CUDACSP on the CPU with a card's policy: the plain version stands
    in for the kernel, and no host answers for it."""
    kw.setdefault("sw", _NoHost())
    csp = CUDACSP(device="cpu", min_device_batch=1, **kw)
    csp._host_answers = False
    return csp


def test_card_collect_fault_reaches_every_collector(items, monkeypatch):
    monkeypatch.setattr(prov, "_host_verify_batch", _no_host)
    csp = _card(coalesce_lanes=10**6, breaker_threshold=2)
    with pfault.use_plan({"faults": [dict(COLLECT_RAISE, nth=1)]}):
        cols = [csp.verify_batch_async(items[:10]),
                csp.verify_batch_async(items[10:])]
        for col in cols:
            with pytest.raises(pfault.DeviceUnavailable):
                col()
    assert _breaker(csp) == (False, 0, 1, 2, 8)
    assert csp.verify_batch(list(items)) == HostOracle().verify_batch(items)
    assert _breaker(csp) == (False, 0, 0, 2, 8)
    stats = csp.degraded_stats()
    assert (stats["host_lanes"], stats["races"], stats["device_failures"]) \
        == (0, 0, 1)
    csp.close()


def test_card_breaker_refuses_then_probe_closes(items, monkeypatch):
    """`threshold` dispatch faults each raise and open the breaker; a held
    call raises BreakerOpenError with nothing queued and no launch; the
    next held call probes through the kernel, closes the breaker and runs
    on the device."""
    monkeypatch.setattr(prov, "_host_verify_batch", _no_host)
    launches = []
    real = pk.verify_packed

    def counting(t):
        launches.append(t["d1"].shape[1])
        return real(t)

    monkeypatch.setattr(pk, "verify_packed", counting)
    csp = _card(breaker_threshold=2, breaker_probe_every=2)
    with pfault.use_plan({"faults": [
            {"point": "tpu.dispatch", "action": "raise",
             "error": "DeviceUnavailable", "count": 2}]}):
        for _ in range(2):
            with pytest.raises(pfault.DeviceUnavailable):
                csp.verify_batch(list(items[:8]))
    assert _breaker(csp) == (True, 1, 2, 2, 2) and launches == []
    gen = csp._gen
    with pytest.raises(prov.BreakerOpenError, match="8 lanes refused"):
        csp.verify_batch_async(list(items[:8]))
    assert csp._gen == gen and launches == []
    with pytest.raises(RuntimeError, match="refused until a probe"):
        csp.health_checker()()
    assert csp.verify_batch(list(items[:8])) == \
        HostOracle().verify_batch(items[:8])
    assert launches == [2, 8] and not csp.breaker_open
    assert csp.breaker.probes == {"ok": 1, "fail": 0}
    assert csp.degraded_stats()["host_lanes"] == 0
    csp.close()


def test_card_hash_fault_raises_and_open_breaker_refuses(card_route):
    csp = _card(breaker_threshold=1, breaker_probe_every=8)
    with pfault.use_plan({"faults": [
            {"point": "tpu.hash", "action": "raise",
             "error": "DeviceUnavailable", "nth": 1}]}):
        with pytest.raises(pfault.DeviceUnavailable):
            csp.hash_batch(card_route)
        assert csp.breaker_open
        with pytest.raises(prov.BreakerOpenError):
            csp.hash_batch(card_route)
    assert csp.degraded_stats()["host_hashes"] == 0


def test_card_delayed_collect_waits_for_the_device(items, monkeypatch):
    """No race on a card: a `delay` at tpu.collect is sat out and the
    device's mask returned."""
    monkeypatch.setattr(prov, "_host_verify_batch", _no_host)
    csp = _card(coalesce_lanes=1, host_rate_hint=9000.0)
    with pfault.use_plan({"faults": [
            {"point": "tpu.collect", "action": "delay", "delay_s": 0.3,
             "nth": 1}]}):
        col = csp.verify_batch_async(list(items))
        t0 = time.perf_counter()
        assert col() == HostOracle().verify_batch(items)
        assert time.perf_counter() - t0 >= 0.3
    stats = csp.degraded_stats()
    assert (stats["races"], stats["host_lanes"]) == (0, 0)
    csp.close()


def test_card_refuses_host_fraction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="host_fraction"):
        CUDACSP(host_fraction=0.25)
    assert CUDACSP()._host_answers is False


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
