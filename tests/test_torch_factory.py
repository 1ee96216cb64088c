"""The port's CSP factory and hash seam against the JAX package's.

Each `bccsp.default` is mapped and pinned (ROADMAP Queue C, "Deliberate
divergences"): SW is the port's host route (`HostRouteCSP`: hostref's
keys, the provider's host verify) where the JAX package's is `SWCSP`;
TPU is `CUDACSP` on `bccsp.tpu.device` (the card by default; `cpu` asks
for the plain versions, and without a card the default raises, never
falling back), where the JAX package's is `TPUCSP`; TPU is also what a
config without a `bccsp` block, `get_default()` and `init_factories()`
give, where the JAX package's give SW; CUSTODY gives the JAX package's
errors; `bccsp.sw.fileKeyStore.keyStorePath` is the port's
`FileKeyStore`; `bccsp.tpu.batchBuckets` is read by nobody.  The seam
refuses a provider whose hashes are not SHA-256 with the JAX package's
message, and routes `sha256` / `sha256_many` to the installed provider.
"""

import hashlib

import pytest
import torch

from fabric_tpu.common import config as jax_config
from fabric_tpu.common import hashing as jax_hashing
from fabric_tpu.csp import factory as jax_factory
from fabric_tpu.csp.sw import SWCSP
from fabric_tpu_torch.common import config as port_config
from fabric_tpu_torch.common import hashing as port_hashing
from fabric_tpu_torch.csp import factory as port_factory
from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import VerifyBatchItem
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.csp.keystore import FileKeyStore

PKGS = {"jax": (jax_config, jax_factory, jax_hashing),
        "port": (port_config, port_factory, port_hashing)}


@pytest.fixture(autouse=True)
def _fresh_factories():
    """Each test starts and ends with no process default and no seam
    backend in either package."""
    for _, fac, hsh in PKGS.values():
        fac._default = None
        hsh.set_hash_backend(None)
    yield
    for _, fac, hsh in PKGS.values():
        fac._default = None
        hsh.set_hash_backend(None)


def _cfg(pkg, data: dict):
    return PKGS[pkg][0].Config(data, env_prefix="CORE")


def test_sw_maps_to_the_host_route_where_the_reference_has_swcsp():
    data = {"bccsp": {"default": "SW"}}
    jax_csp = jax_factory.csp_from_config(_cfg("jax", data))
    port_csp = port_factory.csp_from_config(_cfg("port", data))
    assert type(jax_csp) is SWCSP
    assert type(port_csp) is port_factory.HostRouteCSP
    assert isinstance(port_csp, hostref.HostCSP)
    # the first configured provider is the default and the seam's backend
    assert port_factory.get_default() is port_csp
    assert port_hashing._HASH_BACKEND is port_csp
    assert jax_hashing._HASH_BACKEND is jax_csp
    # the same verdicts on a batch (valid, tampered, foreign key)
    key = port_csp.key_gen()
    other = hostref.key_gen()
    digs = [hashlib.sha256(b"m%d" % i).digest() for i in range(4)]
    sigs = [port_csp.sign(key, d) for d in digs]
    items = [VerifyBatchItem(key.public_key(), digs[0], sigs[0]),
             VerifyBatchItem(key.public_key(), digs[1], sigs[2]),
             VerifyBatchItem(other.public_key(), digs[2], sigs[2]),
             VerifyBatchItem(key.public_key(), digs[3], sigs[3])]
    assert port_csp.verify_batch(items) == [True, False, False, True]
    assert port_csp.verify_batch(items) == hostref.verify_batch(items)


def test_tpu_on_cpu_is_cudacsp_on_the_plain_versions(monkeypatch):
    monkeypatch.setenv("CORE_BCCSP_TPU_DEVICE", "cpu")
    data = {"bccsp": {"default": "TPU", "tpu": {
        "minDeviceBatch": 4, "batchBuckets": [32, 128]}}}
    csp = port_factory.csp_from_config(_cfg("port", data))
    assert type(csp) is CUDACSP
    assert csp.device == torch.device("cpu")
    assert csp._min_device_batch == 4
    assert type(csp._sw) is port_factory.HostRouteCSP
    assert csp._host is csp._sw  # keys in the host route's keystore
    assert port_hashing._HASH_BACKEND is csp
    # the seam's sha256 is the provider's hash
    calls = []
    monkeypatch.setattr(csp, "hash", lambda m: calls.append(m) or
                        hashlib.sha256(m).digest())
    assert port_hashing.sha256(b"tx") == hashlib.sha256(b"tx").digest()
    assert calls == [b"tx"]


def test_tpu_without_a_card_raises_and_never_falls_back(monkeypatch):
    monkeypatch.delenv("CORE_BCCSP_TPU_DEVICE", raising=False)
    data = {"bccsp": {"default": "TPU"}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_factory.csp_from_config(_cfg("port", data))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDACSP()
    # nothing was installed: no default, no seam backend
    assert port_factory._default is None
    assert port_hashing._HASH_BACKEND is None


def test_the_file_keystore_keeps_keys_across_providers(tmp_path, monkeypatch):
    monkeypatch.setenv("CORE_BCCSP_TPU_DEVICE", "cpu")
    data = {"bccsp": {"default": "TPU", "sw": {"fileKeyStore": {
        "keyStorePath": str(tmp_path / "ks")}}}}
    csp = port_factory.csp_from_config(_cfg("port", data))
    assert isinstance(csp._sw.keystore, FileKeyStore)
    key = csp.key_gen()
    again = port_factory.csp_from_config(_cfg("port", data))
    got = again.get_key(key.ski())
    assert got.public_key().x == key.public_key().x
    jax_csp = jax_factory.csp_from_config(_cfg("jax", {"bccsp": {"sw": {
        "fileKeyStore": {"keyStorePath": str(tmp_path / "jks")}}}}))
    assert jax_csp.get_key(jax_csp.key_gen().ski()) is not None


CUSTODY_ERRORS = [
    ({}, "custody.endpoint is not set"),
    ({"endpoint": "127.0.0.1:7599"}, "custody.tokenFile is not set"),
    ({"endpoint": "127.0.0.1:7599", "tokenFile": "TOKEN",
      "tls": {"certFile": "c.pem"}}, "needs BOTH certFile and keyFile"),
    ({"endpoint": "127.0.0.1:7599", "tokenFile": "TOKEN",
      "tls": {"caFiles": ["ca.pem"]}}, "needs BOTH certFile and keyFile"),
]


@pytest.mark.parametrize("custody,message", CUSTODY_ERRORS)
def test_custody_errors_are_the_references(tmp_path, custody, message):
    (tmp_path / "TOKEN").write_bytes(b"secret")
    custody = {k: (str(tmp_path / v) if k == "tokenFile" else v)
               for k, v in custody.items()}
    got = {}
    for pkg in PKGS:
        with pytest.raises(ValueError) as exc:
            PKGS[pkg][1].csp_from_config(_cfg(pkg, {"bccsp": {
                "default": "CUSTODY", "custody": custody}}))
        got[pkg] = str(exc.value)
    assert got["port"] == got["jax"]
    assert message in got["port"]


def test_custody_verifies_on_the_host_route_or_cudacsp(tmp_path, monkeypatch):
    from fabric_tpu_torch.csp.custody import CustodyCSP

    (tmp_path / "TOKEN").write_bytes(b"secret")
    base = {"endpoint": "127.0.0.1:7599", "tokenFile": str(tmp_path / "TOKEN")}
    csp = port_factory.csp_from_config(_cfg("port", {"bccsp": {
        "default": "CUSTODY", "custody": base}}))
    assert type(csp) is CustodyCSP
    assert type(csp._local) is port_factory.HostRouteCSP
    monkeypatch.setenv("CORE_BCCSP_TPU_DEVICE", "cpu")
    csp = port_factory.csp_from_config(_cfg("port", {"bccsp": {
        "default": "CUSTODY", "custody": dict(base, verify="TPU")}}))
    assert type(csp._local) is CUDACSP
    assert csp._local.device == torch.device("cpu")


def test_init_factories_and_get_default_as_the_reference(monkeypatch):
    monkeypatch.setenv("CORE_BCCSP_TPU_DEVICE", "cpu")
    for pkg, kind in (("jax", SWCSP), ("port", CUDACSP)):
        fac = PKGS[pkg][1]
        first = fac.get_default()
        assert type(first) is kind
        assert fac.init_factories("sw") is first  # the first call wins
        forced = fac.init_factories("sw", force=True)
        assert forced is not first and fac.get_default() is forced
        with pytest.raises(ValueError, match="unknown CSP provider"):
            fac.init_factories("nope", force=True)
    cpu = port_factory.init_factories("tpu", force=True, device="cpu")
    assert type(cpu) is CUDACSP and port_hashing._HASH_BACKEND is cpu


# where the configuration names no provider, the port's is CUDACSP on the
# card (the JAX package's is SWCSP): each way of asking for the default
DEFAULTS = {
    "no bccsp block": lambda: port_factory.csp_from_config(_cfg("port", {})),
    "get_default": lambda: port_factory.get_default(),
    "init_factories": lambda: port_factory.init_factories(),
}


@pytest.mark.parametrize("ask", DEFAULTS)
def test_the_ports_default_is_the_card_where_the_references_is_sw(
        ask, monkeypatch):
    jax_asks = {"no bccsp block": lambda: jax_factory.csp_from_config(
        _cfg("jax", {})), "get_default": jax_factory.get_default,
        "init_factories": jax_factory.init_factories}
    assert type(jax_asks[ask]()) is SWCSP
    for k in ("CORE_BCCSP_TPU_DEVICE", "CORE_BCCSP_DEFAULT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULTS[ask]()
    assert port_factory._default is None
    assert port_hashing._HASH_BACKEND is None
    if ask != "init_factories":  # the config's environment layer
        monkeypatch.setenv("CORE_BCCSP_TPU_DEVICE", "cpu")
        csp = DEFAULTS[ask]()
        assert type(csp) is CUDACSP and csp.device == torch.device("cpu")
        assert port_factory._default is csp
        assert port_hashing._HASH_BACKEND is csp


def test_an_unknown_provider_name_raises_where_the_reference_takes_sw():
    data = {"bccsp": {"default": "PKCS11"}}
    assert type(jax_factory.csp_from_config(_cfg("jax", data))) is SWCSP
    with pytest.raises(ValueError, match="unknown CSP provider 'pkcs11'"):
        port_factory.csp_from_config(_cfg("port", data))
    assert port_factory._default is None


class _BadBatch:
    """A provider whose single hash is right and whose batch is not."""

    def hash(self, m):
        return hashlib.sha256(m).digest()

    def hash_batch(self, msgs):
        return [hashlib.sha256(m + b"x").digest() for m in msgs]


class _BadHash(_BadBatch):
    def hash(self, m):
        return b"\x00" * 32

    def hash_batch(self, msgs):
        return [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("bad", [_BadBatch, _BadHash])
def test_the_seam_refuses_a_wrong_provider_with_the_references_message(bad):
    got = {}
    for pkg in PKGS:
        with pytest.raises(ValueError) as exc:
            PKGS[pkg][2].set_hash_backend(bad())
        got[pkg] = str(exc.value)
        assert PKGS[pkg][2]._HASH_BACKEND is None
    assert got["port"] == got["jax"]
    assert "not byte-identical SHA-256" in got["port"]


def test_the_seam_routes_to_the_installed_provider(monkeypatch):
    msgs = [b"", b"a", b"b" * 200]
    want = [hashlib.sha256(m).digest() for m in msgs]
    for _, _, hsh in PKGS.values():
        assert hsh.sha256(b"a") == want[1]
        assert hsh.sha256_many(msgs) == want
    csp = CUDACSP(device="cpu")
    port_hashing.set_hash_backend(csp)
    seen = []
    real = csp.hash_batch
    monkeypatch.setattr(csp, "hash_batch",
                        lambda m: seen.append(len(m)) or real(m))
    assert port_hashing.sha256_many(iter(msgs)) == want
    assert seen == [3]
    assert port_hashing.sha256(b"b" * 200) == want[2]
