"""The idemix MSP (reference msp/idemixmsp.go, msp/idemix_roles.go; the
port's copy of `fabric_tpu/msp/idemixmsp.py`).

An MSP whose identities are anonymous credentials instead of X.509
certificates.  A serialized idemix identity (`SerializedIdemixIdentity`
inside a `SerializedIdentity`, the same bytes as the JAX package's)
carries:

    nym_x/nym_y  the pseudonym, fresh per identity
    ou           the disclosed organizational unit
    role         the disclosed role (MEMBER/ADMIN as idemix_roles.go
                 encodes them)
    proof        an idemix presentation signature that discloses exactly
                 (OU, Role) and binds the nym to the hidden sk

Each message is then signed with a nym signature under the same
pseudonym.  The attributes follow the reference's layout: OU 0, Role 1,
EnrollmentID 2, RevocationHandle 3.  Random draws take the caller's
generator (`rng`, a `random.Random`), else `secrets`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from fabric_tpu_torch.idemix import bn254 as bn
from fabric_tpu_torch.idemix import nymsignature
from fabric_tpu_torch.idemix import signature as idemix_signature
from fabric_tpu_torch.idemix.credential import (
    Credential,
    attribute_to_scalar,
    new_cred_request,
    new_credential,
)
from fabric_tpu_torch.idemix.issuer import IssuerKey, IssuerPublicKey
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb

ATTR_OU = 0
ATTR_ROLE = 1
ATTR_ENROLLMENT_ID = 2
ATTR_REVOCATION_HANDLE = 3
ATTR_NAMES = ["OU", "Role", "EnrollmentID", "RevocationHandle"]
DISCLOSURE = [True, True, False, False]  # OU and Role

ROLE_MEMBER = 1
ROLE_ADMIN = 2

IDEMIX = 1  # ProviderType (reference msp/msp.go ProviderType IDEMIX)


class IdemixMSPError(Exception):
    pass


@dataclasses.dataclass
class IdemixIdentity:
    """A deserialized (verified) anonymous identity."""

    mspid: str
    nym: tuple
    ou: str
    role: int
    proof: idemix_signature.Signature
    _serialized: bytes = b""

    def serialize(self) -> bytes:
        return self._serialized

    def get_identifier(self) -> str:
        # fabriclint: allow[csp-seam] pseudonym fingerprint over a BN254
        # G1 point — idemix credential domain, not the P-256 seam
        return hashlib.sha256(bn.g1_to_bytes(self.nym)).hexdigest()

    @property
    def is_admin(self) -> bool:
        return self.role == ROLE_ADMIN


class IdemixSigningIdentity(IdemixIdentity):
    """Holds the user secret and credential; signs with nym signatures."""

    def __init__(
        self,
        mspid: str,
        sk: int,
        cred: Credential,
        ipk: IssuerPublicKey,
        ou: str,
        role: int,
        rng=None,
    ):
        nym, r_nym = idemix_signature.make_nym(sk, ipk, rng)
        proof = idemix_signature.new_signature(
            cred, sk, ipk, msg=b"", disclosure=list(DISCLOSURE), nym=nym,
            r_nym=r_nym, rng=rng,
        )
        serialized = mb.SerializedIdentity(
            mspid=mspid,
            id_bytes=mb.SerializedIdemixIdentity(
                nym_x=nym[0].to_bytes(32, "big"),
                nym_y=nym[1].to_bytes(32, "big"),
                ou=ou.encode(),
                role=role.to_bytes(4, "big"),
                proof=proof.to_bytes(),
            ).encode(),
        ).encode()
        super().__init__(
            mspid=mspid, nym=nym, ou=ou, role=role, proof=proof,
            _serialized=serialized,
        )
        self._sk = sk
        self._r_nym = r_nym
        self._ipk = ipk
        self._rng = rng

    def sign(self, msg: bytes) -> bytes:
        sig = nymsignature.new_nym_signature(
            self._sk, self.nym, self._r_nym, self._ipk, msg, rng=self._rng
        )
        return json.dumps(
            {"c": sig.challenge, "z_sk": sig.z_sk, "z_rnym": sig.z_rnym}
        ).encode()


class IdemixMSP:
    """The MSP interface over idemix credentials (reference
    msp/idemixmsp.go Setup, DeserializeIdentity, Validate,
    SatisfiesPrincipal)."""

    provider_type = IDEMIX

    def __init__(self, mspid: str, ipk: IssuerPublicKey,
                 revocation_pk=None, epoch: int = 0):
        ipk.check()
        if ipk.attr_names != ATTR_NAMES:
            raise IdemixMSPError(
                f"issuer key must carry attributes {ATTR_NAMES}"
            )
        self.mspid = mspid
        self.ipk = ipk
        self.revocation_pk = revocation_pk
        self.epoch = epoch
        self._signer: IdemixSigningIdentity | None = None

    # -- config ---------------------------------------------------------------

    @classmethod
    def from_config(cls, conf: mb.MSPConfig, rng=None) -> "IdemixMSP":
        """The MSP of an `MSPConfig` of type IDEMIX; `rng` draws the
        signer's pseudonym and proof."""
        if conf.type != IDEMIX:
            raise IdemixMSPError("not an idemix MSP config")
        ic = mb.IdemixMSPConfig.decode(conf.config)
        ipk = IssuerPublicKey.from_dict(json.loads(ic.ipk))
        msp = cls(ic.name, ipk, epoch=ic.epoch)
        if ic.signer:
            sc = mb.IdemixMSPSignerConfig.decode(ic.signer)
            msp._signer = IdemixSigningIdentity(
                ic.name,
                int.from_bytes(sc.sk, "big"),
                Credential.from_bytes(sc.cred),
                ipk,
                sc.organizational_unit_identifier,
                sc.role,
                rng=rng,
            )
        return msp

    def get_default_signing_identity(self) -> IdemixSigningIdentity:
        if self._signer is None:
            raise IdemixMSPError("no signing identity configured")
        return self._signer

    # -- identity lifecycle ---------------------------------------------------

    def deserialize_identity(self, serialized: bytes) -> IdemixIdentity:
        sid = mb.SerializedIdentity.decode(serialized)
        if sid.mspid != self.mspid:
            raise IdemixMSPError(
                f"expected MSP ID {self.mspid}, got {sid.mspid}"
            )
        return self._deserialize_inner(sid.id_bytes, serialized)

    def _deserialize_inner(
        self, id_bytes: bytes, serialized: bytes
    ) -> IdemixIdentity:
        sii = mb.SerializedIdemixIdentity.decode(id_bytes)
        try:
            nym = (
                int.from_bytes(sii.nym_x, "big"),
                int.from_bytes(sii.nym_y, "big"),
            )
            proof = idemix_signature.Signature.from_bytes(sii.proof)
        except Exception as exc:  # wire bytes are untrusted: any shape error
            raise IdemixMSPError(f"malformed idemix identity: {exc}") from exc
        if not bn.g1_is_on_curve(nym):
            raise IdemixMSPError("idemix identity: nym not on curve")
        ou = sii.ou.decode()
        role = int.from_bytes(sii.role, "big")
        # the proof must disclose exactly OU and Role, match the claimed
        # values, and bind the nym (reference idemixmsp.go Validate)
        if proof.disclosure != DISCLOSURE:
            raise IdemixMSPError("idemix identity: wrong disclosure")
        if proof.nym != nym:
            raise IdemixMSPError("idemix identity: proof not bound to nym")
        if proof.disclosed_attrs.get(ATTR_OU) != attribute_to_scalar(ou):
            raise IdemixMSPError("idemix identity: OU mismatch")
        if proof.disclosed_attrs.get(ATTR_ROLE) != attribute_to_scalar(role):
            raise IdemixMSPError("idemix identity: role mismatch")
        if not idemix_signature.verify(proof, self.ipk, b""):
            raise IdemixMSPError("idemix identity: credential proof invalid")
        return IdemixIdentity(
            mspid=self.mspid, nym=nym, ou=ou, role=role, proof=proof,
            _serialized=serialized,
        )

    def validate(self, identity: IdemixIdentity) -> None:
        if identity.mspid != self.mspid:
            raise IdemixMSPError("identity from a different MSP")
        # deserialize_identity already verified the proof

    # -- verification ---------------------------------------------------------

    def verify(self, identity: IdemixIdentity, msg: bytes, sig: bytes) -> bool:
        try:
            d = json.loads(sig)
            nsig = nymsignature.NymSignature(
                challenge=int(d["c"]),
                z_sk=int(d["z_sk"]),
                z_rnym=int(d["z_rnym"]),
            )
        except (ValueError, KeyError, TypeError):
            return False
        return nymsignature.verify_nym(nsig, identity.nym, self.ipk, msg)

    def satisfies_principal(self, identity: IdemixIdentity,
                            principal: cb.MSPPrincipal) -> None:
        """Reference idemixmsp.go SatisfiesPrincipal: ROLE (member or
        admin), ORGANIZATION_UNIT, IDENTITY by bytes."""
        kind = principal.principal_classification
        P = cb.MSPPrincipal
        if kind == P.ROLE:
            role = cb.MSPRole.decode(principal.principal)
            if role.msp_identifier != self.mspid:
                raise IdemixMSPError("role principal for a different MSP")
            if role.role == cb.MSPRole.MEMBER:
                return
            if role.role == cb.MSPRole.ADMIN:
                if not identity.is_admin:
                    raise IdemixMSPError("identity is not an admin")
                return
            raise IdemixMSPError(f"unsupported idemix role {role.role}")
        if kind == P.ORGANIZATION_UNIT:
            ou = cb.OrganizationUnit.decode(principal.principal)
            if ou.msp_identifier != self.mspid:
                raise IdemixMSPError("OU principal for a different MSP")
            if ou.organizational_unit_identifier != identity.ou:
                raise IdemixMSPError("OU mismatch")
            return
        if kind == P.IDENTITY:
            if bytes(principal.principal) != identity.serialize():
                raise IdemixMSPError("identity bytes mismatch")
            return
        raise IdemixMSPError(f"unsupported principal class {kind}")


# ---------------------------------------------------------------------------
# Config generation (the idemixgen surface, reference cmd/idemixgen).
# ---------------------------------------------------------------------------


def generate_issuer(rng=None) -> IssuerKey:
    return IssuerKey.generate(ATTR_NAMES, rng=rng)


def issue_signer_config(
    issuer: IssuerKey,
    mspid: str,
    ou: str,
    role: int,
    enrollment_id: str,
    revocation_handle: int = 0,
    rng=None,
) -> mb.IdemixMSPSignerConfig:
    """Run the request -> issue flow and emit a signer config (reference
    idemixgen's signerconfig output)."""
    sk = bn.rand_zr(rng)
    req = new_cred_request(sk, b"idemixgen", issuer.ipk, rng=rng)
    attrs = [
        attribute_to_scalar(ou),
        attribute_to_scalar(role),
        attribute_to_scalar(enrollment_id),
        attribute_to_scalar(revocation_handle),
    ]
    cred = new_credential(issuer, req, attrs, rng=rng)
    cred.ver(sk, issuer.ipk)
    return mb.IdemixMSPSignerConfig(
        cred=cred.to_bytes(),
        sk=sk.to_bytes(32, "big"),
        organizational_unit_identifier=ou,
        role=role,
        enrollment_id=enrollment_id.encode(),
    )


def idemix_msp_config(
    issuer: IssuerKey,
    mspid: str,
    signer: mb.IdemixMSPSignerConfig | None = None,
    epoch: int = 0,
) -> mb.MSPConfig:
    ic = mb.IdemixMSPConfig(
        name=mspid,
        ipk=json.dumps(issuer.ipk.to_dict()).encode(),
        epoch=epoch,
    )
    if signer is not None:
        ic.signer = signer.encode()
    return mb.MSPConfig(type=IDEMIX, config=ic.encode())


__all__ = [
    "IdemixMSP",
    "IdemixIdentity",
    "IdemixSigningIdentity",
    "IdemixMSPError",
    "generate_issuer",
    "issue_signer_config",
    "idemix_msp_config",
    "ROLE_MEMBER",
    "ROLE_ADMIN",
    "IDEMIX",
]
