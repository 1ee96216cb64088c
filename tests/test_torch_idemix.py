"""The PyTorch port's idemix (fabric_tpu_torch) held against the JAX
package, exactly.

Issuer keys and signatures are made by the JAX package (native host
backend) and carried into the port with `csp.cuda.convert`; a signature
the port makes is carried back the other way.  The port's host verify,
its batched verify with the Schnorr ladder on the CPU (the kernel's
plain PyTorch version) and its `IdemixCSP` must give the JAX package's
hashes, challenges and masks on valid, tampered, malformed and
forged-pairing signatures, at 2 and at 4 attributes (the idemix MSP's
own credential).
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import random  # noqa: E402

from fabric_tpu.idemix import bn254 as jbn  # noqa: E402
from fabric_tpu.idemix import signature as jsig  # noqa: E402
from fabric_tpu.idemix.credential import (  # noqa: E402
    Credential as JCredential,
    attribute_to_scalar,
    new_cred_request,
    new_credential,
)
from fabric_tpu.idemix.issuer import IssuerKey  # noqa: E402
from fabric_tpu.idemix.issuer import (  # noqa: E402
    IssuerPublicKey as JIssuerPublicKey,
)
from fabric_tpu_torch.csp import idemix_provider as ip  # noqa: E402
from fabric_tpu_torch.csp.cuda import bn254_batch as bb  # noqa: E402
from fabric_tpu_torch.csp.cuda import convert  # noqa: E402
from fabric_tpu_torch.idemix import bn254 as bn  # noqa: E402
from fabric_tpu_torch.idemix import signature as psig  # noqa: E402

MSP_ATTRS = ["OU", "Role", "EnrollmentID", "RevocationHandle"]
MSP_DISCLOSURE = [True, True, False, False]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _world(names, seed):
    """A JAX-package issuer key, credential and secret key."""
    rng = random.Random(seed)
    isk = IssuerKey.generate(names, rng=rng)
    sk = jbn.rand_zr(rng)
    req = new_cred_request(sk, b"nonce", isk.ipk, rng=rng)
    attrs = [attribute_to_scalar(v) for v in
             ["org1", 2, "alice", 100][:len(names)]]
    cred = new_credential(isk, req, attrs, rng=rng)
    return isk, sk, cred, rng


def _cases(world):
    """(name, JAX signature, message, host verdict): valid in three
    disclosures, a wrong message, a tampered challenge, an off-curve a',
    a missing response, a wrong disclosure length, and a forged pairing
    (signed over a credential whose A is not the issuer's: the Schnorr
    part holds, the pairing fails)."""
    isk, sk, cred, rng = world
    n = len(isk.ipk.attr_names)
    ipk = isk.ipk

    def sign(msg, disclosure, c=cred):
        return jsig.new_signature(c, sk, ipk, msg, disclosure=disclosure,
                                  rng=rng)

    shapes = [MSP_DISCLOSURE[:n], [False] * n, [True] * n]
    base = [sign(b"valid-%d" % i, d) for i, d in enumerate(shapes)]
    forged_cred = JCredential(a=jbn.g1_mul(jbn.G1_GEN, 5), b=cred.b,
                              e=cred.e, s=cred.s, attrs=list(cred.attrs))
    s = base[0]
    cases = [
        ("valid_msp", base[0], b"valid-0", True),
        ("valid_hidden", base[1], b"valid-1", True),
        ("valid_disclosed", base[2], b"valid-2", True),
        ("wrong_message", base[1], b"not-the-message", False),
        ("tampered_challenge",
         dataclasses.replace(s, challenge=(s.challenge + 1) % jbn.R),
         b"valid-0", False),
        ("off_curve",
         dataclasses.replace(s, a_prime=(s.a_prime[0], s.a_prime[1] + 1)),
         b"valid-0", False),
        ("missing_response",
         dataclasses.replace(s, responses={k: v for k, v in
                                           s.responses.items()
                                           if k != "sk"}),
         b"valid-0", False),
        ("bad_disclosure_length",
         dataclasses.replace(s, disclosure=[True]), b"valid-0", False),
        ("forged_pairing", sign(b"forged", shapes[0], forged_cred),
         b"forged", False),
    ]
    for name, sig, msg, want in cases:
        assert jsig.verify(sig, ipk, msg) == want, name
    return cases


def _to_port(sig):
    """A JAX signature into the port: through bytes where it encodes
    (an off-curve point does not: it is carried field by field)."""
    try:
        return convert.signature_from_jax(sig.to_bytes())
    except ValueError:
        return psig.Signature(**dataclasses.asdict(sig))


@pytest.fixture(scope="module")
def msp():
    world = _world(MSP_ATTRS, 11)
    return world, _cases(world), convert.ipk_from_jax(world[0].ipk.to_dict())


@pytest.fixture(scope="module")
def two_attrs():
    world = _world(["a0", "a1"], 12)
    return world, _cases(world), convert.ipk_from_jax(world[0].ipk.to_dict())


def test_state_carries_across(msp):
    """Issuer key hash and digest, signature bytes, and the Fiat-Shamir
    challenge over the same commitments."""
    (isk, _, _, _), cases, pipk = msp
    jipk = isk.ipk
    assert pipk.hash() == jipk.hash()
    assert pipk.digest_material() == jipk.digest_material()
    assert pipk.to_dict() == jipk.to_dict()
    pipk.check()
    for name, sig, msg, _ in cases:
        if name == "off_curve":
            continue
        ps = convert.signature_from_jax(sig.to_bytes())
        assert ps.to_bytes() == sig.to_bytes(), name
        ts = [jbn.g1_mul(jbn.G1_GEN, k) for k in (3, 4, 5)]
        args = (ts, sig.a_prime, sig.a_bar, sig.b_prime, sig.nym,
                sig.disclosure, sig.disclosed_attrs, msg, sig.nonce)
        assert psig._challenge_bytes(pipk, *args) == jsig._challenge_bytes(
            jipk, *args), name


def test_host_verify_matches_jax(msp):
    (isk, _, _, _), cases, pipk = msp
    for name, sig, msg, want in cases:
        if name in ("valid_hidden", "valid_disclosed", "bad_disclosure_length"):
            continue  # the same paths as valid_msp / missing_response
        assert psig.verify(_to_port(sig), pipk, msg) == want, name


def test_host_verify_batch_matches_jax(two_attrs):
    (isk, _, _, _), cases, pipk = two_attrs
    pick = [c for c in cases if c[0] in
            ("valid_msp", "tampered_challenge", "forged_pairing",
             "valid_hidden")]
    want = jsig.verify_batch([c[1] for c in pick], isk.ipk,
                             [c[2] for c in pick], rng=random.Random(1))
    got = psig.verify_batch([_to_port(c[1]) for c in pick], pipk,
                            [c[2] for c in pick], rng=random.Random(1))
    assert got == want == [c[3] for c in pick]


@pytest.mark.parametrize("world_name", ["two_attrs", "msp"])
def test_device_verify_batch_matches_jax(world_name, request):
    """The port's batched verify with the ladder's plain version on the
    CPU, against the JAX package's host batched verify (the combined
    pairing check fails on the forged lane and isolates it)."""
    (isk, _, _, _), cases, pipk = request.getfixturevalue(world_name)
    want = jsig.verify_batch([c[1] for c in cases], isk.ipk,
                             [c[2] for c in cases], rng=random.Random(2))
    got = psig.verify_batch_device(
        [_to_port(c[1]) for c in cases], pipk, [c[2] for c in cases],
        rng=random.Random(2), device="cpu",
    )
    assert want == [c[3] for c in cases]
    assert got == want, [c[0] for c, g, w in zip(cases, got, want) if g != w]


def test_device_commitments_match_jax_host(msp):
    """The affine T1..T3 of the batched path against the JAX package's
    host recomputation on every well-formed signature."""
    (isk, _, _, _), cases, pipk = msp
    sigs = [_to_port(c[1]) for c in cases]
    got = bb.schnorr_commitments_batch(sigs, pipk, device="cpu")
    for (name, sig, _, _), tri in zip(cases, got):
        if name in ("off_curve", "missing_response", "bad_disclosure_length"):
            assert tri is None, name
            continue
        rels = jsig._relations(isk.ipk, sig.a_prime, sig.a_bar, sig.b_prime,
                               sig.nym, sig.disclosure, sig.disclosed_attrs)
        want = jsig.schnorr.recompute_commitments(rels, sig.challenge,
                                                  sig.responses)
        assert list(tri) == list(want), name


def test_port_signs_what_jax_verifies():
    """Key generation, credential issue and signing in the port (pure
    Python, from a seed), verified by both packages."""
    csp = ip.IdemixCSP(rng=random.Random(5), device="cpu")
    issuer = csp.issuer_key_gen(["OU", "Role"])
    sk = csp.user_secret_key_gen()
    req = csp.cred_request(sk, b"n", issuer.ipk)
    assert csp.cred_request_verify(req, issuer.ipk)
    cred = csp.cred_issue(issuer, req, [7, 8])
    assert csp.cred_verify(cred, sk, issuer.ipk)
    assert not csp.cred_verify(cred, sk + 1, issuer.ipk)
    sig = csp.sign(cred, sk, issuer.ipk, b"msg", disclosure=[True, False])
    assert csp.verify(sig, issuer.ipk, b"msg")
    assert not csp.verify(sig, issuer.ipk, b"other")
    jk = JIssuerPublicKey.from_dict(issuer.ipk.to_dict())
    js = jsig.Signature.from_bytes(sig.to_bytes())
    assert jsig.verify(js, jk, b"msg")
    nym, r_nym = csp.make_nym(sk, issuer.ipk)
    assert nym == bn.g1_add(bn.g1_mul(issuer.ipk.h_sk, sk),
                            bn.g1_mul(issuer.ipk.h_rand, r_nym))


# -- IdemixCSP's choice of path --------------------------------------------------


def _record_dispatch(monkeypatch):
    calls = []

    def host(sigs, ipk, msgs, rng=None):
        calls.append("host")
        return [True] * len(sigs)

    def device(sigs, ipk, msgs, rng=None, device=None, on_device_fault=None):
        calls.append(("device", str(device)))
        return [True] * len(sigs)

    monkeypatch.setattr(ip.signature, "verify_batch", host)
    monkeypatch.setattr(ip.signature, "verify_batch_device", device)
    return calls


def test_idemixcsp_auto_select_by_batch_size(monkeypatch):
    calls = _record_dispatch(monkeypatch)
    csp = ip.IdemixCSP(device="cpu")
    assert csp._crossover == ip.IdemixCSP.DEVICE_CROSSOVER >= 1
    small = [ip.IdemixVerifyItem(None, b"m")] * (csp.DEVICE_CROSSOVER - 1)
    large = [ip.IdemixVerifyItem(None, b"m")] * csp.DEVICE_CROSSOVER
    csp.verify_batch(small, None)
    csp.verify_batch(large, None)
    assert calls == ["host", ("device", "cpu")]


def test_idemixcsp_forced_and_overridden(monkeypatch):
    calls = _record_dispatch(monkeypatch)
    items = [ip.IdemixVerifyItem(None, b"m")] * 8
    ip.IdemixCSP(device="cpu", use_device=True).verify_batch(items, None)
    ip.IdemixCSP(device="cpu", use_device=False).verify_batch(items * 40,
                                                              None)
    ip.IdemixCSP(device="cpu", device_crossover=8).verify_batch(items, None)
    assert calls == [("device", "cpu"), "host", ("device", "cpu")]


def test_idemixcsp_device_path_is_correct(two_attrs):
    """Real dispatch above a lowered crossover, on the plain version."""
    (_, _, _, _), cases, pipk = two_attrs
    pick = [c for c in cases if c[0] in
            ("valid_msp", "valid_hidden", "forged_pairing", "off_curve",
             "valid_disclosed")]
    items = [ip.IdemixVerifyItem(_to_port(c[1]), c[2]) for c in pick]
    csp = ip.IdemixCSP(rng=random.Random(3), device="cpu",
                       device_crossover=4)
    assert csp.verify_batch(items, pipk) == [c[3] for c in pick]


def test_idemixcsp_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        ip.IdemixCSP(device="meta")


def test_device_error_propagates(msp, monkeypatch):
    """A failing engine at run time raises out of the batched verify on a
    card, with no host verify in its place.  On the CPU the host answers,
    as the JAX package's verify_batch_device does: the masks are the host
    verify's, and the provider counts the signatures and the fault.  A
    build failure raises everywhere (test_build_error_propagates)."""
    (_, _, _, _), cases, pipk = msp
    host_calls = []
    real_verify_batch = psig.verify_batch

    def boom(*a, **k):
        raise RuntimeError("device exploded")

    def host(*a, **k):
        host_calls.append("verify_batch")
        return real_verify_batch(*a, **k)

    monkeypatch.setattr(bb, "schnorr_commitments_batch", boom)
    monkeypatch.setattr(psig, "verify_batch", host)
    sigs = [_to_port(c[1]) for c in cases[:2]]
    msgs = [c[2] for c in cases[:2]]
    want = [c[3] for c in cases[:2]]
    answered = []
    with pytest.raises(RuntimeError, match="device exploded"):
        psig.verify_batch_device(sigs, pipk, msgs, device="cuda",
                                 on_device_fault=answered.append)
    assert answered == [0] and host_calls == []
    assert psig.verify_batch_device(sigs, pipk, msgs, device="cpu",
                                    on_device_fault=answered.append) == want
    assert answered == [0, 2] and host_calls == ["verify_batch"]
    csp = ip.IdemixCSP(device="cpu", use_device=True)
    assert csp.verify_batch([ip.IdemixVerifyItem(s, m)
                             for s, m in zip(sigs, msgs)], pipk) == want
    assert csp.degraded_stats() == {"host_lanes": 2, "device_failures": 1}
    assert host_calls == ["verify_batch"] * 2


@pytest.mark.parametrize("error", ["kernel", "native"])
def test_build_error_propagates(error, msp, monkeypatch):
    """A kernel or C++ library that cannot build raises out of the
    batched verify; no host verify runs in its place."""
    from fabric_tpu_torch import native
    from fabric_tpu_torch.csp.cuda import build

    (_, _, _, _), cases, pipk = msp
    exc = (build.KernelBuildError("nvcc failed") if error == "kernel"
           else native.NativeBuildError("g++ failed"))
    host_calls = []

    def boom(*a, **k):
        raise exc

    monkeypatch.setattr(bb, "schnorr_commitments_batch", boom)
    monkeypatch.setattr(psig, "verify_batch",
                        lambda *a, **k: host_calls.append("verify_batch"))
    sigs = [_to_port(c[1]) for c in cases[:2]]
    msgs = [c[2] for c in cases[:2]]
    with pytest.raises(type(exc)):
        psig.verify_batch_device(sigs, pipk, msgs, device="cpu")
    csp = ip.IdemixCSP(device="cpu", use_device=True)
    with pytest.raises(type(exc)):
        csp.verify_batch([ip.IdemixVerifyItem(s, m)
                          for s, m in zip(sigs, msgs)], pipk)
    assert host_calls == []
    assert csp.degraded_stats() == {"host_lanes": 0, "device_failures": 0}
