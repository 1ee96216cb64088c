"""The port's key custody and keystore against the JAX package's.

- Each package's `FileKeyStore` reads the other's directory: the same
  file names, the same private scalars and public points.
- A port `CustodyCSP` against a JAX `KeyCustodyServer`, and the reverse:
  key generation, signing, key lookup (a held SKI as a signable handle,
  an unknown one from the local provider), a wrong token and a private
  import refused.  Signatures made through either package verify under
  the other (nonces differ, so they are not compared byte for byte).
- `verify_batch` through the port's `CustodyCSP` and the JAX one, on a
  corpus of custody-signed lanes with tampered digests and signatures,
  high-S, a wrong key and malformed DER: the masks are equal, exactly.
  The port's local provider is `CUDACSP(device="cpu")`, on its host route
  and on B1's plain version.
"""

import hashlib

import pytest

from fabric_tpu.comm.rpc import RPCError as JaxRPCError
from fabric_tpu.csp import SWCSP
from fabric_tpu.csp import api as jax_api
from fabric_tpu.csp import custody as jax_cust
from fabric_tpu.csp import keystore as jax_ks
from fabric_tpu_torch.comm.rpc import RPCError as PortRPCError
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.csp import api as port_api
from fabric_tpu_torch.csp import custody as port_cust
from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp import keystore as port_ks
from fabric_tpu_torch.csp.api import P256_N, VerifyBatchItem
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.devtools import lockwatch as port_lw

TOKEN = b"custody-pin"


@pytest.fixture(autouse=True, scope="module")
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


def _names(path) -> list:
    return sorted(p.name for p in path.iterdir())


def test_the_port_reads_a_jax_key_directory(tmp_path):
    store = jax_ks.FileKeyStore(str(tmp_path))
    priv = jax_api.ECDSAP256PrivateKey.generate()
    pub = jax_api.ECDSAP256PrivateKey.generate().public_key()
    store.store_key(priv)
    store.store_key(pub)
    port = port_ks.FileKeyStore(str(tmp_path))
    got = port.get_key(priv.ski())
    assert got.is_private and got.ski() == priv.ski()
    assert got.d == priv.crypto_key.private_numbers().private_value
    got_pub = port.get_key(pub.ski())
    assert not got_pub.is_private and got_pub.raw() == pub.raw()
    assert _names(tmp_path) == sorted([f"{priv.ski().hex()}_sk.pem",
                                       f"{pub.ski().hex()}_pk.pem"])
    with pytest.raises(KeyError):
        port.get_key(b"\x00" * 32)


def test_jax_reads_a_port_key_directory(tmp_path):
    store = port_ks.FileKeyStore(str(tmp_path))
    priv = hostref.key_gen()
    pub = hostref.key_gen().public_key()
    store.store_key(priv)
    store.store_key(pub)
    jax = jax_ks.FileKeyStore(str(tmp_path))
    got = jax.get_key(priv.ski())
    assert got.crypto_key.private_numbers().private_value == priv.d
    assert jax.get_key(pub.ski()).raw() == pub.raw()
    assert (tmp_path / f"{priv.ski().hex()}_sk.pem").stat().st_mode & 0o777 \
        == 0o600


SIDES = {
    "jax": (jax_cust, SWCSP, JaxRPCError),
    "port": (port_cust, hostref.HostCSP, PortRPCError),
}


def _verify_elsewhere(pkg: str, pub_raw: bytes, sig: bytes, digest) -> bool:
    """The other package's verdict on a signature."""
    if pkg == "jax":
        x, y = pub_raw[1:33], pub_raw[33:]
        return SWCSP().verify(jax_api.ECDSAP256PublicKey.from_point(
            int.from_bytes(x, "big"), int.from_bytes(y, "big")), sig, digest)
    return hostref.verify(port_api.P256PublicKey.from_raw(pub_raw), sig,
                          digest)


@pytest.mark.parametrize("daemon_pkg", ["jax", "port"])
def test_custody_crosses_the_packages(tmp_path, daemon_pkg):
    client_pkg = "port" if daemon_pkg == "jax" else "jax"
    daemon = SIDES[daemon_pkg][0].KeyCustodyServer(str(tmp_path / "keys"),
                                                   TOKEN)
    daemon.start()
    try:
        mod, local, rpc_error = SIDES[client_pkg]
        csp = mod.CustodyCSP(daemon.addr, TOKEN, verify_csp=local())
        keys = [csp.key_gen() for _ in range(2)]
        assert len(_names(tmp_path / "keys")) == 2
        for i, key in enumerate(keys):
            digest = hashlib.sha256(b"custody %d" % i).digest()
            sig = csp.sign(key, digest)
            assert csp.verify(key, sig, digest)
            # the daemon's signature verifies under the daemon's package
            assert _verify_elsewhere(daemon_pkg, key.public_key().raw(), sig,
                                     digest)
            assert not csp.verify(key, sig, hashlib.sha256(b"x").digest())
        fresh = mod.CustodyCSP(daemon.addr, TOKEN, verify_csp=local())
        held = fresh.get_key(keys[0].ski())
        assert isinstance(held, mod.CustodyKeyHandle)
        assert held.public_key().raw() == keys[0].public_key().raw()
        with pytest.raises(KeyError):
            fresh.get_key(b"\x01" * 32)
        with pytest.raises(mod.CustodyError):
            fresh.key_import(b"\x01" * 32, private=True)
        with pytest.raises(mod.CustodyError):
            keys[0].raw()
        with pytest.raises(rpc_error, match="bad token"):
            mod.CustodyCSP(daemon.addr, b"wrong",
                           verify_csp=local()).key_gen()
    finally:
        daemon.stop()


@pytest.mark.parametrize("route", ["host", "plain_b1"])
def test_verify_batch_masks_equal_the_jax_custody(tmp_path, route):
    daemon = port_cust.KeyCustodyServer(str(tmp_path / "keys"), TOKEN)
    daemon.start()
    try:
        local = (CUDACSP(device="cpu", min_device_batch=1) if route ==
                 "plain_b1" else CUDACSP(device="cpu",
                                         min_device_batch=1 << 30))
        port = port_cust.CustodyCSP(daemon.addr, TOKEN, verify_csp=local)
        jax = jax_cust.CustodyCSP(daemon.addr, TOKEN, verify_csp=SWCSP())
        keys = [port.key_gen() for _ in range(3)]
        lanes = []
        for i in range(30):
            key = keys[i % 3]
            digest = hashlib.sha256(b"lane %d" % i).digest()
            lanes.append([key.ski(), digest, port.sign(key, digest)])
        lanes[1][1] = bytes([lanes[1][1][0] ^ 1]) + lanes[1][1][1:]
        lanes[4][1] = hashlib.sha256(b"other").digest()
        r, s = port_api.unmarshal_ecdsa_signature(lanes[7][2])
        lanes[7][2] = port_api.marshal_ecdsa_signature(r, P256_N - s)  # high-S
        lanes[9][2] = port_api.marshal_ecdsa_signature(r, (s + 1) % P256_N)
        lanes[12][2] = b"\x30\x00"
        lanes[15][2] = lanes[15][2][:-3]
        lanes[18][0] = keys[(18 + 1) % 3].ski()  # another custody key
        port_items = [VerifyBatchItem(port.get_key(ski), d, sig)
                      for ski, d, sig in lanes]
        jax_items = [jax_api.VerifyBatchItem(jax.get_key(ski), d, sig)
                     for ski, d, sig in lanes]
        got = port.verify_batch(port_items)
        want = jax.verify_batch(jax_items)
        assert got == want
        assert [i for i, ok in enumerate(got) if not ok] == [
            1, 4, 7, 9, 12, 15, 18]
        assert port.verify_batch_async(port_items)() == want
        if route == "plain_b1":
            assert local.dispatched_lanes > 0
    finally:
        daemon.stop()


def test_the_local_verifier_is_the_card_unless_named(tmp_path):
    """With no `verify_csp`, the port's `CustodyCSP` verifies on
    `CUDACSP()`: on the card there, and where there is no card the
    constructor raises rather than verifying on the host."""
    import torch

    daemon = port_cust.KeyCustodyServer(str(tmp_path / "keys"), TOKEN)
    daemon.start()
    try:
        if torch.cuda.is_available():
            csp = port_cust.CustodyCSP(daemon.addr, TOKEN)
            assert isinstance(csp._local, CUDACSP)
            assert csp._local.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_cust.CustodyCSP(daemon.addr, TOKEN)
        host = hostref.HostCSP()
        csp = port_cust.CustodyCSP(daemon.addr, TOKEN, verify_csp=host)
        assert csp._local is host
    finally:
        daemon.stop()
