"""The port's X.509 parser, MSP and minting against `cryptography` and the
JAX package.

- `msp/x509.py` reads the fields `cryptography` reads, on certificates of
  a CA, of an intermediate, expired, revoked, without an OU, and of
  another CA; about half of the CA signatures are high-S, and the port
  verifies them all (certificates carry no low-S rule).
- The port's MSP gives the JAX MSP's verdicts for `validate` and
  `satisfies_principal`, and serializes identities to the same bytes.
- The port's CA certificates, keys and CRLs load in `cryptography` with
  the same fields, and its genesis block in the JAX package's
  `bundle_from_genesis` with the same MSPs and policies.
"""

import datetime
import random

import numpy as np
import pytest

from cryptography import x509 as cx
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives import serialization as ser
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.common.crypto import CA as JaxCA
from fabric_tpu.csp import SWCSP
from fabric_tpu.msp import MSP as JaxMSP
from fabric_tpu.msp import msp_config_from_ca as jax_msp_config
from fabric_tpu.msp.identity import Identity as JaxIdentity
from fabric_tpu.protos.common import common_pb2, configtx_pb2
from fabric_tpu.protos.msp import identities_pb2, msp_config_pb2
from fabric_tpu.protos.msp import msp_principal_pb2 as mp
from fabric_tpu.protoutil import SignedData
from fabric_tpu_torch.common import configtx_builder as port_ctx
from fabric_tpu_torch.common.crypto import CA as PortCA
from fabric_tpu_torch.csp.api import P256_HALF_N, unmarshal_ecdsa_signature
from fabric_tpu_torch.msp import x509
from fabric_tpu_torch.msp.config import msp_config_from_ca as port_msp_config
from fabric_tpu_torch.msp.identity import SigningIdentity as PortSigner
from fabric_tpu_torch.msp.msp import MSP as PortMSP
from fabric_tpu_torch.protos import common as port_common
from fabric_tpu_torch.protos import msp as port_msp


@pytest.fixture(scope="module")
def corpus():
    """An org CA (with an intermediate) and another CA, and their
    certificates: (name, CertKeyPair or certificate)."""
    ca = JaxCA("ca.org1.example.com", "Org1MSP")
    ica = ca.new_intermediate("ica.org1.example.com")
    other = JaxCA("ca.other.example.com", "OtherMSP")
    past = datetime.datetime.now(datetime.timezone.utc) - datetime.timedelta(days=1)
    certs = {
        "peer": ca.issue("peer0", ous=["peer"]),
        "client": ca.issue("user1", ous=["client"]),
        "admin": ca.issue("admin", ous=["admin"]),
        "no_ou": ca.issue("nobody"),
        "two_roles": ca.issue("both", ous=["peer", "client"]),
        "extra_ou": ca.issue("dept", ous=["peer", "sales"]),
        "intermediate_peer": ica.issue("peer1", ous=["peer"]),
        "expired": ca.issue("old", ous=["peer"], not_after=past),
        "revoked": ca.issue("gone", ous=["client"]),
        "other_ca": other.issue("stranger", ous=["peer"]),
    }
    ca.revoke(certs["revoked"].cert)
    for i in range(12):  # more CA signatures, for the high-S share
        certs[f"bulk{i}"] = ca.issue(f"bulk{i}", ous=["client"])
    return ca, ica, other, certs


def _all_certs(corpus):
    ca, ica, other, certs = corpus
    return ([("ca", ca.cert), ("ica", ica.cert), ("other", other.cert)]
            + [(n, p.cert) for n, p in certs.items()])


def test_x509_fields_equal_cryptography(corpus):
    high_s = 0
    ca, ica, other, _ = corpus
    issuers = {"ca": ca.cert, "ica": ca.cert, "other": other.cert,
               "intermediate_peer": ica.cert, "other_ca": other.cert}
    for name, c in _all_certs(corpus):
        pem = c.public_bytes(ser.Encoding.PEM)
        (p,) = x509.load_pem_certificates(pem)
        assert p.der == c.public_bytes(ser.Encoding.DER)
        assert p.pem() == pem
        assert p.tbs == c.tbs_certificate_bytes
        assert p.signature == c.signature
        assert p.serial_number == c.serial_number
        assert p.subject == c.subject.public_bytes()
        assert p.issuer == c.issuer.public_bytes()
        assert p.not_valid_before == c.not_valid_before_utc
        assert p.not_valid_after == c.not_valid_after_utc
        assert p.ous == [a.value for a in c.subject.get_attributes_for_oid(
            NameOID.ORGANIZATIONAL_UNIT_NAME)]
        nums = c.public_key().public_numbers()
        assert (p.public_key.x, p.public_key.y) == (nums.x, nums.y)
        ski = c.extensions.get_extension_for_class(cx.SubjectKeyIdentifier)
        assert p.subject_key_identifier == ski.value.digest
        try:
            aki = c.extensions.get_extension_for_class(
                cx.AuthorityKeyIdentifier).value.key_identifier
        except cx.ExtensionNotFound:
            aki = None
        assert p.authority_key_identifier == aki
        issuer = issuers.get(name, ca.cert)
        (ip,) = x509.load_pem_certificates(issuer.public_bytes(ser.Encoding.PEM))
        assert x509.verify_signed(ip.public_key, p.tbs, p.signature,
                                  p.signature_algorithm)
        assert not x509.verify_signed(ip.public_key, p.tbs + b"\x00",
                                      p.signature, p.signature_algorithm)
        high_s += unmarshal_ecdsa_signature(p.signature)[1] > P256_HALF_N
    assert high_s >= 1  # OpenSSL's signatures are high-S about half the time


def _principal(kind, mspid, **kw):
    if kind == "role":
        body = mp.MSPRole(msp_identifier=mspid, role=kw["role"])
        cls = mp.MSPPrincipal.ROLE
    elif kind == "ou":
        body = mp.OrganizationUnit(msp_identifier=mspid,
                                   organizational_unit_identifier=kw["ou"])
        cls = mp.MSPPrincipal.ORGANIZATION_UNIT
    elif kind == "identity":
        return mp.MSPPrincipal(principal_classification=mp.MSPPrincipal.IDENTITY,
                               principal=kw["serialized"])
    else:
        return mp.MSPPrincipal(
            principal_classification=mp.MSPPrincipal.COMBINED,
            principal=mp.CombinedPrincipal(principals=kw["subs"]).SerializeToString())
    return mp.MSPPrincipal(principal_classification=cls,
                           principal=body.SerializeToString())


def _verdict(fn) -> bool:
    try:
        fn()
        return True
    except Exception:
        return False


def test_msp_verdicts_equal_the_jax_msp(corpus):
    ca, ica, other, certs = corpus
    admin_der = certs["admin"].cert.public_bytes(ser.Encoding.PEM)
    conf = jax_msp_config(ca, "Org1MSP", intermediates=[ica],
                          crls=[ca.gen_crl()], admins=[admin_der])
    csp = SWCSP()
    jax_msp = JaxMSP.from_config(conf, csp)
    port_msp_ = PortMSP.from_config(
        port_msp.MSPConfig.decode(conf.SerializeToString()))
    R = mp.MSPRole
    serialized = {n: JaxIdentity("Org1MSP", p.cert, csp).serialize()
                  for n, p in certs.items()}
    principals = [_principal("role", "Org1MSP", role=r)
                  for r in (R.MEMBER, R.ADMIN, R.CLIENT, R.PEER, R.ORDERER)]
    principals += [_principal("role", "Org2MSP", role=R.MEMBER),
                   _principal("ou", "Org1MSP", ou="sales"),
                   _principal("ou", "Org1MSP", ou="peer"),
                   _principal("identity", "Org1MSP",
                              serialized=serialized["peer"])]
    principals.append(_principal("combined", "Org1MSP",
                                 subs=[principals[0], principals[3]]))
    verdicts = []
    for name, raw in serialized.items():
        ji = jax_msp.deserialize_identity(raw)
        pi = port_msp_.deserialize_identity(raw)
        assert pi.serialize() == ji.serialize() == raw
        assert pi.id == ji.id and pi.ous == ji.ous
        jv = _verdict(lambda: jax_msp.validate(ji))
        assert _verdict(lambda: port_msp_.validate(pi)) == jv, name
        verdicts.append(jv)
        for k, pr in enumerate(principals):
            port_pr = port_common.MSPPrincipal.decode(pr.SerializeToString())
            want = _verdict(lambda: jax_msp.satisfies_principal(ji, pr))
            got = _verdict(lambda: port_msp_.satisfies_principal(pi, port_pr))
            assert got == want, (name, k)
    assert True in verdicts and False in verdicts


def test_port_signer_loads_the_jax_key_pem(corpus):
    _, _, _, certs = corpus
    pair = certs["peer"]
    signer = PortSigner.from_pem("Org1MSP", pair.cert_pem, pair.key_pem,
                                 np.random.default_rng(3))
    assert signer.public_key.x == pair.key.public_key().public_numbers().x
    sig = signer.sign(b"message")
    pair.key.public_key().verify(sig, b"message", ec.ECDSA(hashes.SHA256()))


def test_port_ca_certificates_keys_and_crls_load_in_cryptography():
    rng = np.random.default_rng(7)
    ca = PortCA("ca.port.example.com", "PortMSP", rng=rng)
    ica = ca.new_intermediate("ica.port.example.com")
    leaf = ica.issue("peer0", ous=["peer"])
    cca = cx.load_pem_x509_certificate(ca.cert_pem)
    cica = cx.load_pem_x509_certificate(ica.cert_pem)
    cleaf = cx.load_pem_x509_certificate(leaf.cert_pem)
    cca.public_key().verify(cica.signature, cica.tbs_certificate_bytes,
                            ec.ECDSA(hashes.SHA256()))
    cica.public_key().verify(cleaf.signature, cleaf.tbs_certificate_bytes,
                             ec.ECDSA(hashes.SHA256()))
    assert cca.subject.rfc4514_string() == "O=PortMSP,CN=ca.port.example.com"
    assert cleaf.subject.rfc4514_string() == "OU=peer,CN=peer0"
    assert cleaf.issuer == cica.subject
    assert cleaf.serial_number == leaf.cert.serial_number
    assert cca.extensions.get_extension_for_class(cx.BasicConstraints).value.ca
    key = ser.load_pem_private_key(leaf.key_pem, None)
    assert key.private_numbers().private_value == leaf.key.d
    ica.revoke(leaf.cert)
    crl = cx.load_pem_x509_crl(ica.gen_crl())
    assert crl.get_revoked_certificate_by_serial_number(
        leaf.cert.serial_number) is not None
    assert crl.is_signature_valid(cica.public_key())
    # the port's MSP and the JAX MSP agree on the port's chain and CRL
    conf = port_msp_config(ca, "PortMSP", intermediates=[ica],
                           crls=[ica.gen_crl()])
    jax_msp = JaxMSP.from_config(
        msp_config_pb2.MSPConfig.FromString(conf.encode()), SWCSP())
    port_msp_ = PortMSP.from_config(conf)
    good = ica.issue("user", ous=["client"])
    for pair, ok in ((good, True), (leaf, False)):
        raw = port_msp.SerializedIdentity(mspid="PortMSP",
                                          id_bytes=pair.cert_pem).encode()
        assert jax_msp.is_valid(jax_msp.deserialize_identity(raw)) is ok
        assert port_msp_.is_valid(port_msp_.deserialize_identity(raw)) is ok


def test_port_genesis_block_loads_in_the_jax_bundle():
    rng = np.random.default_rng(11)
    cas = [PortCA(f"ca.org{i}", f"Org{i}MSP", rng=rng) for i in (1, 2, 3)]
    app = port_ctx.application_group({
        f"Org{i + 1}": port_ctx.org_group(f"Org{i + 1}MSP",
                                          port_msp_config(ca, f"Org{i + 1}MSP"))
        for i, ca in enumerate(cas)})
    oca = PortCA("ca.orderer", "OrdererMSP", rng=rng)
    ordg = port_ctx.orderer_group({"O": port_ctx.org_group(
        "OrdererMSP", port_msp_config(oca, "OrdererMSP"))})
    genesis = port_ctx.genesis_block("portch", port_ctx.channel_group(app, ordg),
                                     nonce=rng.bytes(24), timestamp=1)
    raw = genesis.encode()
    jblock = common_pb2.Block.FromString(raw)
    bundle = bundle_from_genesis(jblock, SWCSP())
    assert bundle.channel_id == "portch"
    assert sorted(m.mspid for m in bundle.msp_manager.msps()) == \
        ["OrdererMSP", "Org1MSP", "Org2MSP", "Org3MSP"]
    for ca, i in zip(cas, (1, 2, 3)):
        msp = bundle.msp_manager.get_msp(f"Org{i}MSP")
        nums = msp.root_certs[0].public_key().public_numbers()
        assert (nums.x, nums.y) == (ca.key.public_key().x, ca.key.public_key().y)
        assert msp.node_ous_enabled and msp.ou_roles["peer"] == "peer"
    assert bundle.orderer_config.consensus_type == "solo"
    pm = bundle.policy_manager
    assert type(pm.get_policy("/Channel/Application/Endorsement")).__name__ == \
        "ImplicitMetaPolicy"
    assert type(pm.get_policy("/Channel/Application/Org2/Endorsement")).__name__ \
        == "SignaturePolicy"
    # the config re-encodes byte for byte in both codecs
    env = common_pb2.Envelope.FromString(jblock.data.data[0])
    payload = common_pb2.Payload.FromString(env.payload)
    assert configtx_pb2.ConfigEnvelope.FromString(payload.data) == \
        configtx_pb2.ConfigEnvelope.FromString(
            port_common.ConfigEnvelope.decode(payload.data).encode())
    # a port-minted peer satisfies the JAX bundle's org endorsement policy
    pair = cas[1].issue("peer0", ous=["peer"])
    signer = PortSigner("Org2MSP", pair.cert, pair.key, rng)
    sd = SignedData(b"msg", signer.serialize(), signer.sign(b"msg"))
    assert pm.get_policy("/Channel/Application/Org2/Endorsement") \
        .evaluate_signed_data([sd], SWCSP())
    assert not pm.get_policy("/Channel/Application/Org1/Endorsement") \
        .evaluate_signed_data([sd], SWCSP())


def _pem_mutants(rng, base: bytes, n: int):
    for _ in range(n):
        b = bytearray(base)
        kind = rng.randrange(4)
        if kind == 0:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        elif kind == 1:
            b = b[:rng.randrange(len(b))]
        elif kind == 2:
            i = rng.randrange(len(b) + 1)
            b[i:i] = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 9)))
        else:
            i = rng.randrange(len(b) - 1)
            j = rng.randrange(i + 1, min(len(b), i + 64))
            b = b[:j] + b[i:j] + b[j:]
        yield bytes(b)


def test_mutated_pems_read_as_cryptography_reads_them(corpus):
    """Where both read a mutated PEM they read the same certificate; the
    port never reads one `cryptography` refuses; and where only
    `cryptography` reads it (it parses some DER lazily), the certificate
    changed, so its signature fails in both MSPs."""
    ca, _, _, certs = corpus
    conf = jax_msp_config(ca, "Org1MSP")
    jax_msp = JaxMSP.from_config(conf, SWCSP())
    port_msp_ = PortMSP.from_config(
        port_msp.MSPConfig.decode(conf.SerializeToString()))
    rng = random.Random(17)
    both = only_crypto = 0
    for base_cert in (ca.cert, certs["peer"].cert):
        base = base_cert.public_bytes(ser.Encoding.PEM)
        orig = base_cert.public_bytes(ser.Encoding.DER)
        for raw in _pem_mutants(rng, base, 500):
            try:
                want = [c.public_bytes(ser.Encoding.DER)
                        for c in cx.load_pem_x509_certificates(raw)]
            except Exception:  # ValueError, and InvalidVersion
                want = None
            try:
                got = [c.der for c in x509.load_pem_certificates(raw)]
            except x509.X509Error:
                got = None
            if want is None:
                assert got is None, raw
            elif got is not None:
                assert got == want, raw
                both += 1
            else:
                assert want[0] != orig, raw
                sid = identities_pb2.SerializedIdentity(
                    mspid="Org1MSP", id_bytes=raw).SerializeToString()
                assert not _verdict(lambda: jax_msp.validate(
                    jax_msp.deserialize_identity(sid)))
                assert not _verdict(lambda: port_msp_.validate(
                    port_msp_.deserialize_identity(sid)))
                only_crypto += 1
    assert both > 30 and only_crypto > 0
