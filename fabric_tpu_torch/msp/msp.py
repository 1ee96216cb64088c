"""The X.509 membership service provider (the port's copy of
`fabric_tpu/msp/msp.py`: setup, validate, deserialize, satisfies_principal
and the per-channel manager).

As in the reference: chains are built issuer to subject by the raw DER
bytes of the Names, with a signature check per hop (no low-S rule); a
serial found in any configured CRL revokes the identity, without checking
the CRL's own signature; with NodeOUs an identity must carry exactly one
role OU."""

from __future__ import annotations

import datetime

from fabric_tpu_torch.msp import x509
from fabric_tpu_torch.msp.identity import Identity
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb

FABRIC = 0  # MSPConfig.type of the X.509 provider


class MSPError(Exception):
    pass


def _load_pem_cert(pem: bytes) -> x509.Certificate:
    try:
        certs = x509.load_pem_certificates(pem)
    except x509.X509Error as exc:
        raise MSPError(f"bad certificate PEM: {exc}") from exc
    if len(certs) != 1:
        raise MSPError("expected exactly one certificate in PEM")
    return certs[0]


def _verify_issued(issuer: x509.Certificate, cert: x509.Certificate) -> bool:
    if cert.issuer != issuer.subject:
        return False
    return x509.verify_signed(issuer.public_key, cert.tbs, cert.signature,
                              cert.signature_algorithm)


class MSP:
    """One organization's membership rules (an X.509 trust domain)."""

    def __init__(self, mspid: str):
        self.mspid = mspid
        self.root_certs: list[x509.Certificate] = []
        self.intermediate_certs: list[x509.Certificate] = []
        self.admins: list[bytes] = []  # DER of admin certificates
        self.crls: list[x509.CertificateRevocationList] = []
        self.node_ous_enabled = False
        self.ou_roles: dict[str, str] = {}  # OU -> role name

    @classmethod
    def from_config(cls, conf: mb.MSPConfig) -> "MSP":
        if conf.type != FABRIC:
            raise MSPError(f"unsupported MSP type {conf.type} for X.509 MSP")
        fconf = mb.FabricMSPConfig.decode(conf.config)
        msp = cls(fconf.name)
        msp._setup(fconf)
        return msp

    def _setup(self, fconf: mb.FabricMSPConfig) -> None:
        if not fconf.root_certs:
            raise MSPError("expected at least one CA certificate")
        self.root_certs = [_load_pem_cert(c) for c in fconf.root_certs]
        self.intermediate_certs = [_load_pem_cert(c)
                                   for c in fconf.intermediate_certs]
        self.admins = [_load_pem_cert(c).der for c in fconf.admins]
        try:
            self.crls = [x509.load_pem_crl(c) for c in fconf.revocation_list]
        except x509.X509Error as exc:
            raise MSPError(f"bad CRL: {exc}") from exc
        if fconf.has("fabric_node_ous") and fconf.fabric_node_ous.enable:
            self.node_ous_enabled = True
            nou = fconf.fabric_node_ous
            for role, ident in (
                ("client", nou.client_ou_identifier),
                ("peer", nou.peer_ou_identifier),
                ("admin", nou.admin_ou_identifier),
                ("orderer", nou.orderer_ou_identifier),
            ):
                if ident.organizational_unit_identifier:
                    self.ou_roles[ident.organizational_unit_identifier] = role

    # -- identities ---------------------------------------------------------

    def deserialize_identity(self, serialized: bytes) -> Identity:
        sid = mb.SerializedIdentity.decode(serialized)
        if sid.mspid != self.mspid:
            raise MSPError(f"expected MSP ID {self.mspid}, got {sid.mspid}")
        return Identity(self.mspid, _load_pem_cert(sid.id_bytes))

    # -- validation ---------------------------------------------------------

    def _chain(self, cert: x509.Certificate) -> list[x509.Certificate]:
        """[leaf, intermediates..., root]; raises without a trusted path."""
        by_subject: dict[bytes, list[x509.Certificate]] = {}
        for c in self.intermediate_certs:
            by_subject.setdefault(c.subject, []).append(c)
        roots_by_subject: dict[bytes, list[x509.Certificate]] = {}
        for c in self.root_certs:
            roots_by_subject.setdefault(c.subject, []).append(c)
        chain = [cert]
        current = cert
        for _ in range(10):  # path length bound
            for root in roots_by_subject.get(current.issuer, []):
                if _verify_issued(root, current):
                    chain.append(root)
                    return chain
            advanced = False
            for inter in by_subject.get(current.issuer, []):
                if inter in chain:
                    continue
                if _verify_issued(inter, current):
                    chain.append(inter)
                    current = inter
                    advanced = True
                    break
            if not advanced:
                break
        raise MSPError("could not build certification chain to a trusted root")

    def validate(self, identity: Identity) -> None:
        """Raises MSPError when the identity's chain is untrusted, outside
        its validity, revoked, or (with NodeOUs) not of exactly one role."""
        chain = self._chain(identity.cert)
        now = datetime.datetime.now(datetime.timezone.utc)
        for c in chain:
            if now < c.not_valid_before or now > c.not_valid_after:
                raise MSPError("certificate outside its validity period")
        for crl in self.crls:
            for c in chain[:-1]:
                if crl.is_revoked(c.serial_number):
                    raise MSPError("certificate has been revoked")
        if self.node_ous_enabled:
            roles = {self.ou_roles[ou] for ou in identity.ous
                     if ou in self.ou_roles}
            if len(roles) != 1:
                raise MSPError(
                    "NodeOUs enabled: identity must carry exactly one of the "
                    f"role OUs, found {sorted(roles)}")

    def is_valid(self, identity: Identity) -> bool:
        try:
            self.validate(identity)
            return True
        except MSPError:
            return False

    def _role_of(self, identity: Identity) -> str | None:
        roles = {self.ou_roles[ou] for ou in identity.ous
                 if ou in self.ou_roles}
        return next(iter(roles)) if len(roles) == 1 else None

    def _is_admin(self, identity: Identity) -> bool:
        if identity.cert.der in self.admins:
            return True
        return self.node_ous_enabled and self._role_of(identity) == "admin"

    def satisfies_principal(self, identity: Identity,
                            principal: cb.MSPPrincipal) -> None:
        """Raises MSPError when the identity does not satisfy it."""
        kind = principal.principal_classification
        P = cb.MSPPrincipal
        if kind == P.ROLE:
            role = cb.MSPRole.decode(principal.principal)
            if role.msp_identifier != self.mspid:
                raise MSPError(f"principal is for MSP {role.msp_identifier}, "
                               f"identity is {self.mspid}")
            self.validate(identity)
            R = cb.MSPRole
            if role.role == R.MEMBER:
                return
            if role.role == R.ADMIN:
                if self._is_admin(identity):
                    return
                raise MSPError("identity is not an admin")
            want = {R.CLIENT: "client", R.PEER: "peer",
                    R.ORDERER: "orderer"}.get(role.role)
            if want is None:
                raise MSPError(f"invalid MSP role type {role.role}")
            if self.node_ous_enabled and self._role_of(identity) == want:
                return
            raise MSPError(f"identity is not a {want}")
        if kind == P.IDENTITY:
            if principal.principal == identity.serialize():
                return
            raise MSPError("identity does not match IDENTITY principal")
        if kind == P.ORGANIZATION_UNIT:
            ou = cb.OrganizationUnit.decode(principal.principal)
            if ou.msp_identifier != self.mspid:
                raise MSPError("OU principal is for a different MSP")
            self.validate(identity)
            if ou.organizational_unit_identifier in identity.ous:
                return
            raise MSPError("identity lacks the required OU")
        if kind == P.ANONYMITY:
            anon = cb.MSPIdentityAnonymity.decode(principal.principal)
            if anon.anonymity_type == cb.MSPIdentityAnonymity.NOMINAL:
                return
            raise MSPError("X.509 identities cannot be anonymous")
        if kind == P.COMBINED:
            comb = cb.CombinedPrincipal.decode(principal.principal)
            if not comb.principals:
                raise MSPError("empty combined principal")
            for sub in comb.principals:
                self.satisfies_principal(identity, sub)
            return
        raise MSPError(f"unknown principal classification {kind}")


class MSPManager:
    """A channel's MSPs, routing by MSP ID."""

    def __init__(self, msps: list[MSP] | None = None):
        self._msps: dict[str, MSP] = {m.mspid: m for m in msps or []}

    def get_msp(self, mspid: str) -> MSP:
        try:
            return self._msps[mspid]
        except KeyError:
            raise MSPError(f"MSP {mspid} is unknown") from None

    def deserialize_identity(self, serialized: bytes) -> Identity:
        sid = mb.SerializedIdentity.decode(serialized)
        return self.get_msp(sid.mspid).deserialize_identity(serialized)

    def satisfies_principal(self, identity, principal) -> None:
        self.get_msp(identity.mspid).satisfies_principal(identity, principal)

    def validate(self, identity) -> None:
        self.get_msp(identity.mspid).validate(identity)


__all__ = ["MSP", "MSPManager", "MSPError", "FABRIC"]
