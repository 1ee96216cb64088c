"""The port's YAML reader (`common.yamlsub`) against `yaml.safe_load`, and
the port's `Config` against the JAX package's on the same files and
environment.

- The reader gives `yaml.safe_load`'s value on every file it must read
  (the sample configs, `tests/test_nwo.py`'s crypto-config.yaml and
  configtx.yaml, the network of `chip_smoke.phase_nodes`, an MSP folder's
  config.yaml) and on each case of a list of the subset's forms; input
  outside the subset raises ValueError naming its line.
- `Config.get`, `get_int`, `get_bool`, `get_duration`, `get_bytesize`
  and `get_file` give equal values in both packages, with and without
  `CORE_*` overrides and `FABRIC_CFG_PATH`.
"""

import os

import pytest
import yaml

import chip_smoke
from fabric_tpu.common import config as jax_config
from fabric_tpu_torch.common import config as port_config
from fabric_tpu_torch.common import yamlsub
from fabric_tpu_torch.msp.config import _NODE_OUS_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "sampleconfig")

# tests/test_nwo.py's network files (Network._generate)
NWO_CRYPTO = (
    "OrdererOrgs:\n"
    "  - Name: Orderer\n    Domain: example.com\n"
    "    Specs: [{Hostname: orderer}]\n"
    "PeerOrgs:\n"
    "  - Name: Org1\n    Domain: org1.example.com\n"
    "    Template: {Count: 1}\n    Users: {Count: 1}\n"
)
NWO_CONFIGTX = (
    "Organizations:\n"
    "  - Name: OrdererOrg\n    ID: OrdererMSP\n"
    "    MSPDir: crypto-config/ordererOrganizations/example.com/msp\n"
    "  - Name: Org1\n    ID: Org1MSP\n"
    "    MSPDir: crypto-config/peerOrganizations/org1.example.com/msp\n"
    "Profiles:\n"
    "  OneOrg:\n"
    "    Orderer:\n"
    "      OrdererType: solo\n      BatchTimeout: 250ms\n"
    "      BatchSize: {MaxMessageCount: 10}\n"
    "      Organizations: [OrdererOrg]\n"
    "    Application:\n      Organizations: [Org1]\n"
)


def _sample(name):
    with open(os.path.join(SAMPLE, name)) as f:
        return f.read()


@pytest.mark.parametrize("doc", [
    pytest.param(lambda: _sample("core.yaml"), id="core.yaml"),
    pytest.param(lambda: _sample("orderer.yaml"), id="orderer.yaml"),
    pytest.param(lambda: NWO_CRYPTO, id="nwo-crypto-config"),
    pytest.param(lambda: NWO_CONFIGTX, id="nwo-configtx"),
    pytest.param(lambda: chip_smoke.nodes_crypto_config(), id="nodes-crypto"),
    pytest.param(lambda: chip_smoke.nodes_configtx(), id="nodes-configtx"),
    pytest.param(lambda: _NODE_OUS_YAML, id="msp-config.yaml"),
])
def test_the_reader_reads_the_repositorys_files_as_safe_load(doc):
    text = doc()
    assert yamlsub.loads(text) == yaml.safe_load(text)


FORMS = [
    "a: 1\nb: two\n",
    "a:\n  b:\n    c: [1, 2, 3]\n",
    "- 1\n- two\n- 3.5\n",
    "a:\n- x\n- y\nb: z\n",
    "a:\n  - x: 1\n    y: 2\n  - x: 3\n",
    "- - 1\n  - 2\n- - 3\n",
    "-\n  a: 1\n- b\n",
    "a: {b: 1, c: [x, {d: e}]}\n",
    "a: []\nb: {}\nc: [[]]\n",
    "a: ''\nb: \"\"\nc: \"it's\"\nd: 'it''s'\n",
    "a: \"tab\\there \\u00e9\"\n",
    "'quoted key': 1\n\"k2\": 2\n",
    "a: 1 # trailing\n# whole line\nb: x#not-a-comment\n",
    "a: [1, 2] # after a flow\n",
    "t: true\nT: True\nu: TRUE\nf: false\ny: yes\nn: No\no: on\nff: OFF\n",
    "n1: ~\nn2: null\nn3:\nn4: Null\n",
    "i: 0\nj: -17\nk: +4\nf: 1.5\ng: -0.25\nh: 3.\ne: 1.0e+3\n",
    "s: 16 MB\nd: 500ms\nh: 1h\nip: 127.0.0.1:7050\nv: 1e3\nw: 0.1.2\n",
    "url: http://x.example.com:80/a#frag\n",
    "7: one\n2.5: x\ntrue: t\n",
    "a:\n  b: 1\n\n  c: 2\n",
    "k: v with spaces  \n",
    "emptydoc_value: [a, b, ]\n",
    "x: -5\n",
    "",
    "# only a comment\n",
]


@pytest.mark.parametrize("doc", FORMS, ids=range(len(FORMS)))
def test_each_form_of_the_subset_reads_as_safe_load(doc):
    assert yamlsub.loads(doc) == yaml.safe_load(doc)


OUTSIDE = [
    "a: &x 1\nb: *x\n",
    "a: !!str 1\n",
    "a: |\n  text\n",
    "a: >\n  text\n",
    "---\na: 1\n",
    "%YAML 1.1\n---\na: 1\n",
    "a: 0x10\n",
    "a: 017\n",
    "a: 1_000\n",
    "a: 1:30\n",
    "a: .inf\n",
    "a: .nan\n",
    "a: 2026-10-18\n",
    "a: [1,\n  2]\n",
    "a: {b: 1,\n  c: 2}\n",
    "a: b\n  continued\n",
    "a: 1\na: 2\n",
    "? a\n: b\n",
    "a: b: c\n",
    "a: 'open\n",
    "a:\n\t- 1\n",
    "<<: {a: 1}\n",
    "a: [b: 1]\n",
    "a: 1\n- b\n",
]


@pytest.mark.parametrize("doc", OUTSIDE, ids=range(len(OUTSIDE)))
def test_input_outside_the_subset_raises_naming_its_line(doc):
    with pytest.raises(ValueError, match=r"YAML line \d+"):
        yamlsub.loads(doc)


def test_the_reader_names_the_offending_line():
    with pytest.raises(ValueError, match="YAML line 3: "):
        yamlsub.loads("a: 1\nb: 2\nc: &anchor 3\n")


GETS = [
    ("get", "peer.listenAddress"),
    ("get", "PEER.LISTENADDRESS"),
    ("get", "peer.gossip.bootstrap"),
    ("get", "bccsp.tpu.batchBuckets"),
    ("get", "bccsp.sw.fileKeyStore.keyStorePath"),
    ("get", "vm.endpoint"),
    ("get", "no.such.key"),
    ("get_int", "peer.limits.concurrency.endorserService"),
    ("get_int", "peer.keepalive.interval"),
    ("get_bool", "peer.profile.enabled"),
    ("get_bool", "ledger.history.enableHistoryDatabase"),
    ("get_duration", "peer.gossip.pullInterval"),
    ("get_duration", "peer.gossip.identityExpiration"),
    ("get_duration", "chaincode.executetimeout"),
    ("get_duration", "no.such.duration"),
]


@pytest.mark.parametrize("method,key", GETS)
@pytest.mark.parametrize("env", [{}, {
    "CORE_PEER_LISTENADDRESS": "0.0.0.0:9051",
    "CORE_PEER_PROFILE_ENABLED": "yes",
    "CORE_PEER_GOSSIP_PULLINTERVAL": "250ms",
    "CORE_PEER_LIMITS_CONCURRENCY_ENDORSERSERVICE": "7",
}], ids=["file", "env"])
def test_config_gets_equal_values_in_both_packages(monkeypatch, method, key,
                                                   env):
    monkeypatch.setenv("FABRIC_CFG_PATH", SAMPLE)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    for name, mod in (("jax", jax_config), ("port", port_config)):
        cfg = mod.Config.load("core", "CORE")
        got[name] = getattr(cfg, method)(key)
    assert got["port"] == got["jax"]


def test_orderer_config_and_helpers_match(monkeypatch, tmp_path):
    monkeypatch.setenv("FABRIC_CFG_PATH", SAMPLE)
    monkeypatch.setenv("ORDERER_GENERAL_LISTENPORT", "7150")
    (tmp_path / "cert.pem").write_bytes(b"PEM")
    for key in ("general.listenAddress", "general.listenPort",
                "general.bootstrapMethod", "consensus.snapshotIntervalSize",
                "cluster.dialTimeout"):
        assert (port_config.Config.load("orderer", "ORDERER").get(key)
                == jax_config.Config.load("orderer", "ORDERER").get(key))
    for mod in (jax_config, port_config):
        cfg = mod.Config.load("orderer", "ORDERER")
        assert cfg.get_int("general.listenPort") == 7150
        assert cfg.get_bytesize("consensus.snapshotIntervalSize") == 16 << 20
        assert cfg.get_duration("consensus.tickInterval") == 0.5
        assert mod.parse_bytesize("100 MB") == 100 << 20
        assert mod.resolve_file_ref("file:cert.pem", str(tmp_path)) == b"PEM"
        assert mod.Config.load("absent", "X").get("a") is None
    assert port_config.cfg_path() == jax_config.cfg_path() == SAMPLE
