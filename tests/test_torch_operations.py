"""The port's operations endpoint (`common.operations.System`) against the
JAX package's: both served on loopback, each endpoint asked the same
requests; the status codes, the JSON bodies that carry no clock, and the
metric family names of /metrics (with every bundle registered, the
CSPMetrics of the card provider among them) are equal; /logspec's PUT
round trips in both; a failing checker turns /healthz to 503 in both."""

import http.client
import json
import re

import pytest

from fabric_tpu.common import flogging as jax_flogging
from fabric_tpu.common import operations as jax_ops
from fabric_tpu_torch.common import flogging as port_flogging
from fabric_tpu_torch.common import operations as port_ops

BUNDLES = ("snapshot", "commit", "validate", "csp", "raft", "workpool",
           "gossip", "deliver", "gateway", "ledger", "lock")


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def systems():
    out = {}
    for name, mod in (("jax", jax_ops), ("port", port_ops)):
        sysm = mod.System(("127.0.0.1", 0), process_metrics=True)
        for b in BUNDLES:
            getattr(sysm, f"{b}_metrics")()
        sysm.register_checker("ok", lambda: True)
        sysm.start()
        out[name] = sysm
    yield out
    for sysm in out.values():
        sysm.stop()


def _families(text: str) -> list[str]:
    return sorted(re.findall(r"^# TYPE (\S+) ", text, re.M))


def test_metrics_carry_the_same_families(systems):
    got = {}
    for name, sysm in systems.items():
        status, body = _request(sysm.addr[1], "GET", "/metrics")
        assert status == 200
        got[name] = _families(body.decode())
    assert got["port"] == got["jax"]
    assert "csp_tpu_device_failures_total" in got["port"]
    assert "csp_tpu_breaker_state" in got["port"]


REQUESTS = [
    ("GET", "/healthz", None),
    ("GET", "/healthz?detail=1", None),
    ("GET", "/version", None),
    ("GET", "/logspec", None),
    ("GET", "/traces", None),
    ("GET", "/traces?since=abc", None),
    ("GET", "/profile?seconds=abc", None),
    ("GET", "/nope", None),
    ("PUT", "/nope", b"{}"),
    ("PUT", "/logspec", b"{not json"),
    ("PUT", "/logspec", b'{"spec": "bogus=level=x"}'),
]


@pytest.mark.parametrize("method,path,body", REQUESTS)
def test_each_endpoint_answers_as_the_reference(systems, method, path, body):
    got = {}
    for name, sysm in systems.items():
        status, raw = _request(sysm.addr[1], method, path, body)
        got[name] = status, raw
    assert got["port"][0] == got["jax"][0]
    if path.startswith(("/healthz", "/version", "/logspec", "/nope",
                        "/traces?", "/profile")):
        assert got["port"][1] == got["jax"][1]
    if path == "/traces":
        docs = {n: json.loads(r) for n, (_, r) in got.items()}
        assert docs["port"]["otherData"]["armed"] \
            == docs["jax"]["otherData"]["armed"]
        assert docs["port"]["otherData"]["source"] \
            == "fabric_tpu_torch.tracelens"


def test_logspec_put_round_trips(systems):
    saved = {"jax": jax_flogging.spec(), "port": port_flogging.spec()}
    try:
        for name, sysm in systems.items():
            port = sysm.addr[1]
            status, _ = _request(port, "PUT", "/logspec",
                                 b'{"spec": "gossip=debug:warning"}')
            assert status == 204
            status, body = _request(port, "GET", "/logspec")
            assert status == 200
            assert json.loads(body) == {"spec": "gossip=debug:warning"}
    finally:
        jax_flogging.activate_spec(saved["jax"])
        port_flogging.activate_spec(saved["port"])


def test_a_failing_checker_turns_healthz_to_503():
    got = {}
    for name, mod in (("jax", jax_ops), ("port", port_ops)):
        sysm = mod.System(("127.0.0.1", 0), provider="disabled")
        sysm.register_checker("ledgers", lambda: False)

        def broken():
            raise RuntimeError("card gone")

        sysm.register_checker("csp.tpu.breaker", broken)
        sysm.start()
        try:
            port = sysm.addr[1]
            got[name] = [_request(port, "GET", p)
                         for p in ("/healthz", "/healthz?detail=1",
                                   "/metrics")]
        finally:
            sysm.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 503 and got["port"][2][0] == 404
    assert json.loads(got["port"][0][1])["failed_checks"] == [
        "csp.tpu.breaker: card gone", "ledgers"]
