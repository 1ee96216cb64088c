"""The port's netsplit against the JAX package's.

The same partition plans and the same script of connects, accepts and
tracked connections go through both modules; the verdict of every
attempt (allowed, or the NetsplitDenied message), the denial log and the
cut log must be equal, exactly, as must the plans' validation errors.
Every plan is armed through `use_plan`, so nothing stays armed.
"""

import socket

import pytest

from fabric_tpu.devtools import netsplit as jax_ns
from fabric_tpu_torch.devtools import netsplit as port_ns

GROUPS = [["orderer0", "org1-peer0"], ["orderer2", "org2-peer0"],
          ["org3-peer0"]]
ADDRS = {"127.0.0.1:9101": "orderer0", "127.0.0.1:9201": "org2-peer0"}

PLANS = {
    "full": {"seed": 7, "mode": "full", "groups": GROUPS,
             "node": "org1-peer0", "addrs": ADDRS},
    "oneway": {"seed": 7, "mode": "oneway", "groups": GROUPS,
               "node": "org2-peer0", "addrs": ADDRS, "label": "half"},
    "flaky": {"seed": 3, "mode": "flaky", "p": 0.4, "groups": GROUPS,
              "node": "org1-peer0", "addrs": ADDRS},
}

# (direction, node id, address) attempts from the plan's local node
SCRIPT = [("connect", "orderer0", None), ("connect", "orderer2", None),
          ("connect", None, ("127.0.0.1", 9201)), ("connect", None,
          "127.0.0.1:9101"), ("connect", "org3-peer0", None),
          ("connect", "stranger", None), ("connect", None, "10.0.0.1:1"),
          ("accept", "orderer2", None), ("accept", "org1-peer0", None),
          ("accept", None, "127.0.0.1:9201"), ("accept", "org3-peer0", None)]


def run(ns, plan: dict) -> dict:
    ns.reset_log()
    before = ns.lookup_count()
    pairs = [socket.socketpair() for _ in range(3)]
    # long-lived connections, tracked before the plan arrives
    toks = [ns.track(pairs[0][0], peer="orderer2"),
            ns.track(pairs[1][0], addr="127.0.0.1:9101"),
            ns.track(pairs[2][0], addr=("127.0.0.1", 9201))]
    verdicts = []
    with ns.use_plan(plan) as p:
        for _ in range(3):  # flaky links draw a new verdict each attempt
            for direction, node, addr in SCRIPT:
                fn = getattr(ns, direction)
                try:
                    fn(node, addr=addr)
                    verdicts.append("ok")
                except ns.NetsplitDenied as exc:
                    verdicts.append(str(exc))
        armed = p.as_dict()
    closed = [s.fileno() == -1 for s, _ in pairs]
    for t in toks:
        ns.untrack(t)
    for a, b in pairs:
        a.close()
        b.close()
    return {"verdicts": verdicts, "denials": ns.denial_log(),
            "cuts": ns.cut_log(), "closed": closed, "plan": armed,
            "lookups": ns.lookup_count() - before,
            "disarmed": not ns.active()}


@pytest.mark.parametrize("mode", sorted(PLANS))
def test_the_same_plan_gives_the_same_logs(mode):
    got = run(port_ns, PLANS[mode])
    assert got == run(jax_ns, PLANS[mode])
    assert got["disarmed"] and got["lookups"] == len(SCRIPT) * 3
    if mode == "full":
        # the tracked links to orderer2 and org2-peer0 are cut at arming
        assert got["closed"] == [True, False, True]
        assert len(got["cuts"]) == 2


BAD = [
    "not json", [], {"groups": [["a"]]}, {"groups": [["a"], []]},
    {"groups": [["a"], ["a"]]}, {"groups": [["a"], ["b"]], "mode": "x"},
    {"groups": [["a"], ["b"]], "p": 2}, {"groups": [["a"], ["b"]], "seed": "x"},
    {"groups": [["a"], ["b"]], "addrs": {"h": 1}},
    {"groups": [["a"], ["b"]], "node": ""},
]


@pytest.mark.parametrize("spec", BAD, ids=[str(i) for i in range(len(BAD))])
def test_the_same_plans_are_refused(spec):
    msgs = []
    for ns in (jax_ns, port_ns):
        with pytest.raises(ns.PlanError) as exc:
            ns.Plan(spec)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_unarmed_the_checks_consult_nothing():
    before = port_ns.lookup_count()
    port_ns.connect("orderer2", addr="127.0.0.1:9101")
    port_ns.accept(addr=("127.0.0.1", 1))
    assert port_ns.lookup_count() == before and not port_ns.active()
