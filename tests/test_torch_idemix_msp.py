"""The port's idemix remainder against the JAX package's: nym signatures,
weak Boneh-Boyen signatures, the revocation authority's CRI on the port's
P-384 (`csp/hostref384.py`, held against `cryptography` both ways), the
idemix MSP's messages and identities, and the rest of `IdemixCSP`.

Both packages get the same seeded inputs (`random.Random`); signatures,
messages and identities must be the same bytes, and each package must
accept what the other makes and refuse what it refuses, with the same
error text.
"""

import dataclasses
import json
import random
import types

import pytest
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec

import chip_smoke
import fabric_tpu.idemix as jidemix
import fabric_tpu_torch.idemix as pidemix
from fabric_tpu.csp import idemix_provider as jax_provider
from fabric_tpu.idemix import nymsignature as jnym
from fabric_tpu.idemix import revocation as jrev
from fabric_tpu.idemix import weakbb as jwbb
from fabric_tpu.idemix.issuer import IssuerKey as JIssuerKey
from fabric_tpu.msp import idemixmsp as jmsp
from fabric_tpu.protos.msp import identities_pb2, msp_config_pb2
from fabric_tpu.protos.msp import msp_principal_pb2 as jpr
from fabric_tpu_torch.csp import hostref384
from fabric_tpu_torch.csp import idemix_provider as port_provider
from fabric_tpu_torch.idemix import bn254 as bn
from fabric_tpu_torch.idemix import nymsignature as pnym
from fabric_tpu_torch.idemix import revocation as prev
from fabric_tpu_torch.idemix import weakbb as pwbb
from fabric_tpu_torch.idemix.issuer import IssuerKey
from fabric_tpu_torch.msp import idemixmsp as pmsp
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb

MSP_ID = chip_smoke.MSP_ID
P384 = ec.SECP384R1()
ECDSA = ec.ECDSA(hashes.SHA256())


class MSPWorld:
    """One issuer (the MSP's 4 attributes) and a member and an admin
    signer config, made by both packages from the same seed; each
    package's MSP from its own config bytes."""

    def __init__(self):
        self.issuers = [m.generate_issuer(random.Random(7))
                        for m in (pmsp, jmsp)]
        self.member = [m.issue_signer_config(i, MSP_ID, "ou1",
                                             m.ROLE_MEMBER, "alice",
                                             rng=random.Random(8))
                       for m, i in zip((pmsp, jmsp), self.issuers)]
        self.admin = [m.issue_signer_config(i, MSP_ID, "ou2", m.ROLE_ADMIN,
                                            "boss", rng=random.Random(9))
                      for m, i in zip((pmsp, jmsp), self.issuers)]
        self.confs = [m.idemix_msp_config(i, MSP_ID, s, epoch=3)
                      for m, i, s in zip((pmsp, jmsp), self.issuers,
                                         self.member)]
        self.port = pmsp.IdemixMSP.from_config(
            mb.MSPConfig.decode(self.confs[0].encode()),
            rng=random.Random(10))
        self.jax = jmsp.IdemixMSP.from_config(
            msp_config_pb2.MSPConfig.FromString(
                self.confs[1].SerializeToString()))

    def signing(self, pkg, signer, seed):
        """A signing identity of `signer` (a member or admin config) made
        by `pkg` with random.Random(seed)."""
        from fabric_tpu.idemix.credential import Credential as JCredential
        from fabric_tpu_torch.idemix.credential import Credential

        k = 0 if pkg is pmsp else 1
        sc = signer[k]
        cred = (Credential if k == 0 else JCredential).from_bytes(sc.cred)
        return pkg.IdemixSigningIdentity(
            MSP_ID, int.from_bytes(sc.sk, "big"), cred, self.issuers[k].ipk,
            sc.organizational_unit_identifier, sc.role,
            rng=random.Random(seed))


@pytest.fixture(scope="module")
def world():
    return MSPWorld()


# -- messages -----------------------------------------------------------------


def test_the_idemix_messages_are_upbs_bytes(world):
    assert world.issuers[0].ipk.to_dict() == world.issuers[1].ipk.to_dict()
    for port, jax in (world.member, world.admin):
        assert port.encode() == jax.SerializeToString()
        assert mb.IdemixMSPSignerConfig.decode(
            jax.SerializeToString()).encode() == port.encode()
    assert world.confs[0].encode() == world.confs[1].SerializeToString()
    ic = mb.IdemixMSPConfig.decode(
        mb.MSPConfig.decode(world.confs[0].encode()).config)
    jic = msp_config_pb2.IdemixMSPConfig.FromString(
        world.confs[1].config)
    assert (ic.name, ic.epoch, ic.ipk, ic.signer) == \
        (jic.name, jic.epoch, jic.ipk, jic.signer)
    full = mb.IdemixMSPSignerConfig(
        cred=b"c", sk=b"\x01" * 32, organizational_unit_identifier="ou",
        role=-1, enrollment_id=b"e", credential_revocation_information=b"r")
    assert full.encode() == msp_config_pb2.IdemixMSPSignerConfig(
        cred=b"c", sk=b"\x01" * 32, organizational_unit_identifier="ou",
        role=-1, enrollment_id=b"e",
        credential_revocation_information=b"r").SerializeToString()
    big = mb.IdemixMSPConfig(name="n", ipk=b"i", signer=b"s",
                             revocation_pk=b"r", epoch=(1 << 64) - 1)
    assert big.encode() == msp_config_pb2.IdemixMSPConfig(
        name="n", ipk=b"i", signer=b"s", revocation_pk=b"r",
        epoch=(1 << 64) - 1).SerializeToString()


@pytest.mark.parametrize("signer", ["member", "admin"])
def test_signing_identities_are_the_same_bytes(world, signer):
    sc = getattr(world, signer)
    port = world.signing(pmsp, sc, 11)
    jax = world.signing(jmsp, sc, 11)
    assert port.serialize() == jax.serialize()
    sii = identities_pb2.SerializedIdemixIdentity.FromString(
        identities_pb2.SerializedIdentity.FromString(
            port.serialize()).id_bytes)
    assert mb.SerializedIdemixIdentity.decode(
        sii.SerializeToString()).encode() == sii.SerializeToString()
    assert (port.nym, port.ou, port.role, port.is_admin) == \
        (jax.nym, jax.ou, jax.role, jax.is_admin)
    assert port.get_identifier() == jax.get_identifier()
    # each package's MSP takes the other's identity
    back = world.port.deserialize_identity(jax.serialize())
    assert (back.nym, back.ou, back.role) == (jax.nym, jax.ou, jax.role)
    jback = world.jax.deserialize_identity(port.serialize())
    assert (jback.nym, jback.ou, jback.role) == \
        (port.nym, port.ou, port.role)
    world.port.validate(back)
    assert b"alice" not in port.serialize()  # anonymous: no enrollment id


def test_the_default_signers_sign_and_verify_across_packages(world):
    port = world.port.get_default_signing_identity()
    jax = world.jax.get_default_signing_identity()
    assert (port.ou, port.role) == (jax.ou, jax.role) == ("ou1", 1)
    psig, jsig = port.sign(b"tx-payload"), jax.sign(b"tx-payload")
    jport = world.jax.deserialize_identity(port.serialize())
    pjax = world.port.deserialize_identity(jax.serialize())
    assert world.jax.verify(jport, b"tx-payload", psig)
    assert world.port.verify(pjax, b"tx-payload", jsig)
    assert world.port.verify(port, b"tx-payload", psig)
    for msp, ident, sig in ((world.port, pjax, jsig),
                            (world.jax, jport, psig)):
        assert not msp.verify(ident, b"other", sig)
        assert not msp.verify(ident, b"tx-payload", b"garbage")
        assert not msp.verify(ident, b"tx-payload", b'{"c": 1}')


# -- deserialize_identity: every rejection, with the reference's text ---------


@pytest.mark.parametrize("how", list(chip_smoke.MSP_LIES) + [
    "proof:missing_response", "proof:disclosure_length", "proof:off_curve",
    "non_utf8_ou", "empty"])
def test_every_rejection_matches_the_reference(world, how):
    raw = world.signing(pmsp, world.member, 21).serialize()
    other = world.signing(pmsp, world.admin, 22).serialize()
    if how == "non_utf8_ou":
        sid = mb.SerializedIdentity.decode(raw)
        sii = mb.SerializedIdemixIdentity.decode(sid.id_bytes)
        sii.ou = b"\xff\xfe"
        sid.id_bytes = sii.encode()
        bad = sid.encode()
    elif how == "empty":
        bad = mb.SerializedIdentity(mspid=MSP_ID).encode()
    else:
        bad = chip_smoke.identity_with(raw, how, other)
    errors = []
    for msp in (world.port, world.jax):
        with pytest.raises(Exception) as e:
            msp.deserialize_identity(bad)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    if how in chip_smoke.MSP_LIES:
        assert errors[0][0] == "IdemixMSPError"
        assert errors[0][1].startswith(chip_smoke.MSP_LIES[how])


def test_config_errors_match_the_reference(world):
    for mod, conf_cls in ((pmsp, mb.MSPConfig),
                          (jmsp, msp_config_pb2.MSPConfig)):
        with pytest.raises(mod.IdemixMSPError, match="not an idemix MSP"):
            mod.IdemixMSP.from_config(conf_cls(type=0, config=b""))
    bare = [m.IdemixMSP.from_config(m.idemix_msp_config(i, "Bare"))
            for m, i in zip((pmsp, jmsp), world.issuers)]
    for mod, msp in zip((pmsp, jmsp), bare):
        with pytest.raises(mod.IdemixMSPError,
                           match="no signing identity configured"):
            msp.get_default_signing_identity()
    wrong = [IssuerKey.generate(["OU", "Role"], rng=random.Random(3)),
             JIssuerKey.generate(["OU", "Role"], rng=random.Random(3))]
    texts = []
    for mod, isk in zip((pmsp, jmsp), wrong):
        with pytest.raises(mod.IdemixMSPError) as e:
            mod.IdemixMSP("X", isk.ipk)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    ident = world.signing(pmsp, world.member, 30)
    with pytest.raises(pmsp.IdemixMSPError, match="different MSP"):
        bare[0].validate(world.port.deserialize_identity(ident.serialize()))


# -- satisfies_principal ------------------------------------------------------


PRINCIPALS = {
    "member": ("ROLE", ("MSPRole", MSP_ID, "MEMBER")),
    "admin": ("ROLE", ("MSPRole", MSP_ID, "ADMIN")),
    "client": ("ROLE", ("MSPRole", MSP_ID, "CLIENT")),
    "member_other_msp": ("ROLE", ("MSPRole", "OtherOrg", "MEMBER")),
    "ou1": ("ORGANIZATION_UNIT", ("OrganizationUnit", MSP_ID, "ou1")),
    "ou2": ("ORGANIZATION_UNIT", ("OrganizationUnit", MSP_ID, "ou2")),
    "ou_other_msp": ("ORGANIZATION_UNIT",
                     ("OrganizationUnit", "OtherOrg", "ou1")),
    "identity_self": ("IDENTITY", None),
    "identity_other": ("IDENTITY", b"not-this-identity"),
    "anonymity": ("ANONYMITY", b""),
    "combined": ("COMBINED", b""),
}


def _principals(name, ident_bytes):
    kind, body = PRINCIPALS[name]
    if body is None:
        raw = ident_bytes
    elif isinstance(body, bytes):
        raw = body
    elif body[0] == "MSPRole":
        raw = jpr.MSPRole(msp_identifier=body[1],
                          role=getattr(jpr.MSPRole, body[2])
                          ).SerializeToString()
    else:
        raw = jpr.OrganizationUnit(
            msp_identifier=body[1], organizational_unit_identifier=body[2]
        ).SerializeToString()
    port = cb.MSPPrincipal(
        principal_classification=getattr(cb.MSPPrincipal, kind),
        principal=raw)
    jax = jpr.MSPPrincipal(
        principal_classification=getattr(jpr.MSPPrincipal, kind),
        principal=raw)
    assert port.encode() == jax.SerializeToString()
    return port, jax


@pytest.mark.parametrize("name", list(PRINCIPALS))
@pytest.mark.parametrize("signer", ["member", "admin"])
def test_satisfies_principal_matches_the_reference(world, name, signer):
    raw = world.signing(pmsp, getattr(world, signer), 40).serialize()
    pid = world.port.deserialize_identity(raw)
    jid = world.jax.deserialize_identity(raw)
    pprin, jprin = _principals(name, raw)
    outcomes = []
    for msp, ident, prin in ((world.port, pid, pprin),
                             (world.jax, jid, jprin)):
        try:
            msp.satisfies_principal(ident, prin)
            outcomes.append(None)
        except Exception as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]
    satisfied = outcomes[0] is None
    assert satisfied == (name in ("member", "identity_self") or
                         (name == "admin" and signer == "admin") or
                         (name == "ou1" and signer == "member") or
                         (name == "ou2" and signer == "admin"))


# -- nym signatures and weak BB -----------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_nym_signatures_are_the_same_bytes_and_cross_verify(world, seed):
    ipk, jipk = world.issuers[0].ipk, world.issuers[1].ipk
    ident = world.signing(pmsp, world.member, 50 + seed)
    sk, r_nym, nym = ident._sk, ident._r_nym, ident.nym
    msg = b"message-%d" % seed
    psig = pnym.new_nym_signature(sk, nym, r_nym, ipk, msg,
                                  rng=random.Random(seed))
    jsig = jnym.new_nym_signature(sk, nym, r_nym, jipk, msg,
                                  rng=random.Random(seed))
    assert dataclasses.asdict(psig) == dataclasses.asdict(jsig)
    assert pnym.verify_nym(pnym.NymSignature(**dataclasses.asdict(jsig)),
                           nym, ipk, msg)
    assert jnym.verify_nym(jnym.NymSignature(**dataclasses.asdict(psig)),
                           nym, jipk, msg)
    cases = {
        "other message": (psig, nym, msg + b"!"),
        "z_sk + 1": (dataclasses.replace(psig, z_sk=psig.z_sk + 1), nym,
                     msg),
        "challenge + 1": (dataclasses.replace(
            psig, challenge=psig.challenge + 1), nym, msg),
        "other nym": (psig, bn.g1_mul(bn.G1_GEN, 5), msg),
        "nym off curve": (psig, (nym[0], (nym[1] + 1) % bn.P), msg),
        "no nym": (psig, None, msg),
    }
    for label, (sig, n, m) in cases.items():
        jsig_ = jnym.NymSignature(**dataclasses.asdict(sig))
        assert pnym.verify_nym(sig, n, ipk, m) is \
            jnym.verify_nym(jsig_, n, jipk, m) is False, label


def test_weak_bb_verdicts_match_the_reference():
    sk, pk = pwbb.wbb_key_gen(random.Random(4))
    jsk, jpk = jwbb.wbb_key_gen(random.Random(4))
    assert (sk, pk) == (jsk, jpk)
    m = 123456789
    sig = pwbb.wbb_sign(sk, m)
    assert sig == jwbb.wbb_sign(jsk, m)
    _, other_pk = pwbb.wbb_key_gen(random.Random(5))
    cases = {
        "valid": (pk, sig, m, True),
        "off curve": (pk, (sig[0], (sig[1] + 1) % bn.P), m, False),
        "no signature": (pk, None, m, False),
        "wrong message": (pk, sig, m + 1, False),
        "wrong key": (other_pk, sig, m, False),
        "another's signature": (pk, pwbb.wbb_sign(sk + 1, m), m, False),
    }
    for label, (k, s, msg, want) in cases.items():
        assert pwbb.wbb_verify(k, s, msg) is jwbb.wbb_verify(k, s, msg) \
            is want, label


# -- P-384 against cryptography -----------------------------------------------


def _crypto_ok(pub, sig: bytes, data: bytes) -> bool:
    try:
        pub.verify(sig, data, ECDSA)
        return True
    except (InvalidSignature, ValueError):
        return False


def _crypto_pub(x: int, y: int):
    return ec.EllipticCurvePublicNumbers(x, y, P384).public_key()


def _der_int(v: int) -> bytes:
    raw = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if raw[0] & 0x80:
        raw = b"\x00" + raw
    return b"\x02" + bytes([len(raw)]) + raw


def _seq(body: bytes) -> bytes:
    return b"\x30" + bytes([len(body)]) + body


def _der(r: int, s: int) -> bytes:
    return _seq(_der_int(r) + _der_int(s))


def _malformed(key, data):
    """(label, signature) pairs both verifiers must refuse, and the
    high-S twin both must accept."""
    sig = key.sign(data)
    body = sig[2:]
    rl = body[1]
    r = int.from_bytes(body[2:2 + rl], "big")
    s = int.from_bytes(body[4 + rl:], "big")
    n = hostref384.P384_N
    yield "high-S twin", _der(r, n - s), True
    yield "trailing byte", sig + b"\x00", False
    yield "short", sig[:-1], False
    yield "long-form length", b"\x30\x81" + bytes([len(body)]) + body, False
    yield "non-minimal r", _seq(b"\x02" + bytes([rl + 1]) + b"\x00"
                                + body[2:2 + rl] + body[2 + rl:]), False
    yield "negative r", _seq(b"\x02\x01\x80" + _der_int(s)), False
    yield "r = 0", _der(0, s), False
    yield "s = 0", _der(r, 0), False
    yield "r = n", _der(n, s), False
    yield "s = n", _der(r, n), False
    yield "r + n", _der(r + n, s), False
    yield "swapped", _der(s, r), False
    yield "empty", b"", False
    yield "not a sequence", b"\x31" + sig[1:], False


def test_p384_refuses_what_cryptography_refuses():
    key = hostref384.key_gen(random.Random(9))
    pub = _crypto_pub(key.x, key.y)
    data = b"idemix-cri" + bytes(20)
    seen = set()
    for label, sig, want in _malformed(key, data):
        seen.add(label)
        assert hostref384.verify(key.public_key(), sig, data) is want, label
        assert _crypto_ok(pub, sig, data) is want, label
    assert len(seen) == 14
    # a wrong key, and a point off the curve (cryptography will not load
    # one)
    other = hostref384.key_gen(random.Random(10))
    sig = key.sign(data)
    assert not hostref384.verify(other.public_key(), sig, data)
    assert not _crypto_ok(_crypto_pub(other.x, other.y), sig, data)
    assert not hostref384.verify((key.x, key.y + 1), sig, data)
    with pytest.raises(ValueError):
        _crypto_pub(key.x, key.y + 1)
    assert hostref384.verify(key, sig, data)  # a private key's point


# -- revocation ---------------------------------------------------------------


def test_cris_match_the_reference_and_cross_verify():
    pkey = prev.generate_long_term_revocation_key(random.Random(12))
    jkey = ec.derive_private_key(pkey.d, P384)
    pcri = prev.create_cri(pkey, 5, rng=random.Random(13))
    jcri = jrev.create_cri(jkey, 5, rng=random.Random(13))
    assert pcri.epoch_pk == jcri.epoch_pk
    pd, jd = json.loads(pcri.to_bytes()), json.loads(jcri.to_bytes())
    assert pd.pop("sig") != jd.pop("sig")  # cryptography's nonce is random
    assert pd == jd
    assert list(json.loads(pcri.to_bytes())) == \
        list(json.loads(jcri.to_bytes()))
    assert prev._cri_digest_material(5, 0, pcri.epoch_pk) == \
        jrev._cri_digest_material(5, 0, jcri.epoch_pk)
    # each package accepts the other's CRI, carried as bytes
    pub = pkey.public_key()
    assert prev.verify_epoch_pk(pub, prev.CredentialRevocationInformation
                                .from_bytes(jcri.to_bytes()))
    assert jrev.verify_epoch_pk(jkey.public_key(),
                                jrev.CredentialRevocationInformation
                                .from_bytes(pcri.to_bytes()))
    assert prev.verify_epoch_pk(pub, pcri)
    # refusals: each package's verdict on each mutation of each CRI
    other = prev.generate_long_term_revocation_key(random.Random(14))
    for cri_bytes in (pcri.to_bytes(), jcri.to_bytes()):
        base = prev.CredentialRevocationInformation.from_bytes(cri_bytes)
        sig = bytearray(base.epoch_pk_sig)
        sig[len(sig) // 2] ^= 1
        pk = bytearray(base.epoch_pk)
        pk[7] ^= 1
        cases = {
            "signature byte": (pub, dataclasses.replace(
                base, epoch_pk_sig=bytes(sig))),
            "epoch_pk byte": (pub, dataclasses.replace(
                base, epoch_pk=bytes(pk))),
            "epoch": (pub, dataclasses.replace(base, epoch=6)),
            "alg": (pub, dataclasses.replace(base, revocation_alg=1)),
            "alg out of range": (pub, dataclasses.replace(
                base, revocation_alg=256)),
            "wrong key": (other.public_key(), base),
        }
        for label, (key, cri) in cases.items():
            jcri_ = jrev.CredentialRevocationInformation(
                **dataclasses.asdict(cri))
            jpub = _crypto_pub(*key)
            assert prev.verify_epoch_pk(key, cri) is \
                jrev.verify_epoch_pk(jpub, jcri_) is False, label
    for mod, key in ((prev, pkey), (jrev, jkey)):
        with pytest.raises(NotImplementedError):
            mod.create_cri(key, 1, alg=1)


def test_an_epoch_pk_outside_the_subgroup_is_refused():
    """A CRI whose signature is good but whose epoch key is not a G2 point
    of the group: both packages refuse it."""
    pkey = prev.generate_long_term_revocation_key(random.Random(15))
    jkey = ec.derive_private_key(pkey.d, P384)
    junk = bytes(range(128))
    material = prev._cri_digest_material(2, 0, junk)
    cri = prev.CredentialRevocationInformation(2, 0, junk,
                                               pkey.sign(material))
    assert not prev.verify_epoch_pk(pkey.public_key(), cri)
    assert not jrev.verify_epoch_pk(
        jkey.public_key(), jrev.CredentialRevocationInformation(
            **dataclasses.asdict(cri)))


# -- IdemixCSP ----------------------------------------------------------------


def test_idemixcsp_has_every_method_of_the_reference(world):
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    missing = public(jax_provider.IdemixCSP) - public(
        port_provider.IdemixCSP)
    assert not missing, missing
    csp = port_provider.IdemixCSP(rng=random.Random(16), device="cpu")
    jcsp = jax_provider.IdemixCSP(rng=random.Random(16))
    ident = world.signing(pmsp, world.member, 60)
    ipk, jipk = world.issuers[0].ipk, world.issuers[1].ipk
    sig = csp.nym_sign(ident._sk, ident.nym, ident._r_nym, ipk, b"m")
    jsig = jcsp.nym_sign(ident._sk, ident.nym, ident._r_nym, jipk, b"m")
    assert dataclasses.asdict(sig) == dataclasses.asdict(jsig)
    assert csp.nym_verify(sig, ident.nym, ipk, b"m")
    assert not csp.nym_verify(sig, ident.nym, ipk, b"n")
    ra = csp.revocation_key_gen()
    cri = csp.create_cri(ra, 4)
    assert csp.verify_cri(ra.public_key(), cri)
    assert jcsp.verify_cri(_crypto_pub(*ra.public_key()),
                           jrev.CredentialRevocationInformation(
                               **dataclasses.asdict(cri)))
    jra = jcsp.revocation_key_gen()
    jcri = jcsp.create_cri(jra, 4)
    n = jra.public_key().public_numbers()
    assert csp.verify_cri((n.x, n.y), prev.CredentialRevocationInformation
                          .from_bytes(jcri.to_bytes()))
    assert not csp.verify_cri(ra.public_key(), prev
                              .CredentialRevocationInformation
                              .from_bytes(jcri.to_bytes()))


def test_the_idemix_exports_are_the_references():
    """The port's `idemix` exports (loaded at first use) are the JAX
    package's names, each resolving to the port's counterpart in the
    module of the same name."""
    names = sorted(n for n, v in vars(jidemix).items()
                   if not n.startswith("_")
                   and not isinstance(v, types.ModuleType))
    assert pidemix.__all__ == names
    for name in names:
        got, want = getattr(pidemix, name), getattr(jidemix, name)
        if isinstance(want, int):
            assert got == want, name
            continue
        assert got.__name__ == want.__name__ == name
        assert got.__module__ == want.__module__.replace(
            "fabric_tpu.", "fabric_tpu_torch.", 1)
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        getattr(pidemix, "nope")
