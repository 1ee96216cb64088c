"""Idemix issuer keys (reference idemix/issuerkey.go; the port's copy of
`fabric_tpu/idemix/issuer.py`).

The issuer key pair consists of a secret exponent isk = x and a public key
holding W = g2^x plus the commitment bases used by credentials:

    HSk    — base for the user secret key
    HRand  — base for the randomizer
    HAttrs — one base per attribute name

The reference derives all bases as random-scalar multiples of GenG1
(issuerkey.go NewIssuerKey: Ecp().Mul(RandModOrder)) — the issuer knowing
their discrete logs is acceptable because the issuer is trusted for
issuance.  Well-formedness is a Schnorr proof that the same x underlies
W = g2^x and BarG2 = BarG1^x (issuerkey.go proofC/proofS).
"""

from __future__ import annotations

import dataclasses
import json

from fabric_tpu_torch.idemix import bn254 as bn


def _challenge(*chunks: bytes) -> int:
    return bn.hash_to_zr(b"idemix-issuer-pok", *chunks)


@dataclasses.dataclass
class IssuerPublicKey:
    attr_names: list[str]
    h_sk: tuple
    h_rand: tuple
    h_attrs: list[tuple]
    w: tuple  # G2
    bar_g1: tuple
    bar_g2: tuple
    proof_c: int
    proof_s: int

    def check(self) -> None:
        """Verify well-formedness (reference issuerkey.go Check)."""
        for pt in (self.h_sk, self.h_rand, self.bar_g1, *self.h_attrs):
            if pt is None or not bn.g1_is_on_curve(pt):
                raise ValueError("issuer public key: bad G1 element")
        if not bn.g2_is_on_curve(self.w):
            raise ValueError("issuer public key: bad W")
        # t1 = g2^s * W^-c ; t2 = BarG1^s * BarG2^-c
        t1 = bn.g2_add(
            bn.g2_mul(bn.G2_GEN, self.proof_s),
            bn.g2_mul(self.w, (-self.proof_c) % bn.R),
        )
        t2 = bn.g1_add(
            bn.g1_mul(self.bar_g1, self.proof_s),
            bn.g1_mul(self.bar_g2, (-self.proof_c) % bn.R),
        )
        c = _challenge(
            bn.g2_to_bytes(t1),
            bn.g1_to_bytes(t2),
            self.digest_material(),
        )
        if c != self.proof_c:
            raise ValueError("issuer public key: proof of knowledge fails")

    def digest_material(self) -> bytes:
        return b"".join(
            [
                bn.g1_to_bytes(self.h_sk),
                bn.g1_to_bytes(self.h_rand),
                *[bn.g1_to_bytes(h) for h in self.h_attrs],
                bn.g2_to_bytes(self.w),
                bn.g1_to_bytes(self.bar_g1),
                bn.g1_to_bytes(self.bar_g2),
                json.dumps(self.attr_names).encode(),
            ]
        )

    def hash(self) -> bytes:
        import hashlib

        # fabriclint: allow[csp-seam] idemix issuer-key fingerprint,
        # part of the BN254 credential domain, not the P-256 seam
        return hashlib.sha256(self.digest_material()).digest()

    def to_dict(self) -> dict:
        return {
            "attr_names": self.attr_names,
            "h_sk": bn.g1_to_bytes(self.h_sk).hex(),
            "h_rand": bn.g1_to_bytes(self.h_rand).hex(),
            "h_attrs": [bn.g1_to_bytes(h).hex() for h in self.h_attrs],
            "w": bn.g2_to_bytes(self.w).hex(),
            "bar_g1": bn.g1_to_bytes(self.bar_g1).hex(),
            "bar_g2": bn.g1_to_bytes(self.bar_g2).hex(),
            "proof_c": self.proof_c,
            "proof_s": self.proof_s,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "IssuerPublicKey":
        return cls(
            attr_names=list(d["attr_names"]),
            h_sk=bn.g1_from_bytes(bytes.fromhex(d["h_sk"])),
            h_rand=bn.g1_from_bytes(bytes.fromhex(d["h_rand"])),
            h_attrs=[
                bn.g1_from_bytes(bytes.fromhex(h)) for h in d["h_attrs"]
            ],
            w=bn.g2_from_bytes(bytes.fromhex(d["w"])),
            bar_g1=bn.g1_from_bytes(bytes.fromhex(d["bar_g1"])),
            bar_g2=bn.g1_from_bytes(bytes.fromhex(d["bar_g2"])),
            proof_c=int(d["proof_c"]),
            proof_s=int(d["proof_s"]),
        )


@dataclasses.dataclass
class IssuerKey:
    isk: int
    ipk: IssuerPublicKey

    @classmethod
    def generate(cls, attr_names: list[str], rng=None) -> "IssuerKey":
        if len(set(attr_names)) != len(attr_names):
            raise ValueError("attribute names must be unique")
        x = bn.rand_zr(rng)
        w = bn.g2_mul(bn.G2_GEN, x)
        h_sk = bn.g1_mul(bn.G1_GEN, bn.rand_zr(rng))
        h_rand = bn.g1_mul(bn.G1_GEN, bn.rand_zr(rng))
        h_attrs = [
            bn.g1_mul(bn.G1_GEN, bn.rand_zr(rng)) for _ in attr_names
        ]
        bar_g1 = bn.g1_mul(bn.G1_GEN, bn.rand_zr(rng))
        bar_g2 = bn.g1_mul(bar_g1, x)
        # PoK of x: t1 = g2^rho, t2 = BarG1^rho.
        rho = bn.rand_zr(rng)
        t1 = bn.g2_mul(bn.G2_GEN, rho)
        t2 = bn.g1_mul(bar_g1, rho)
        ipk = IssuerPublicKey(
            attr_names=list(attr_names),
            h_sk=h_sk,
            h_rand=h_rand,
            h_attrs=h_attrs,
            w=w,
            bar_g1=bar_g1,
            bar_g2=bar_g2,
            proof_c=0,
            proof_s=0,
        )
        c = _challenge(
            bn.g2_to_bytes(t1), bn.g1_to_bytes(t2), ipk.digest_material()
        )
        ipk.proof_c = c
        ipk.proof_s = (rho + c * x) % bn.R
        key = cls(isk=x, ipk=ipk)
        ipk.check()
        return key
