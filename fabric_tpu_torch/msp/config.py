"""MSP configuration builders (the port's copy of
`fabric_tpu/msp/config.py`): an MSP from an in-memory CA, and the MSP
folder layout of reference msp/configbuilder.go (cacerts/
intermediatecerts/ admincerts/ signcerts/ keystore/ crls/ config.yaml),
read (`load_msp_dir`) and written (`write_msp_dir`, cryptogen's msp/
output).  The folder's config.yaml is read with the port's YAML reader
(`common.yamlsub`) and written as `yaml.safe_dump` writes the JAX
package's."""

from __future__ import annotations

import os

from fabric_tpu_torch.common import yamlsub
from fabric_tpu_torch.protos import msp as mb

ROLE_OUS = {"client": "client", "peer": "peer", "admin": "admin",
            "orderer": "orderer"}


def msp_config_from_ca(ca, mspid: str, intermediates: list | None = None,
                       crls: list[bytes] | None = None) -> mb.MSPConfig:
    """An X.509 MSP with NodeOUs (client, peer, admin and orderer OUs)
    rooted at `ca` (anything with `cert_pem`: the port's
    `common.crypto.CA`), its intermediates and CRLs."""
    fconf = mb.FabricMSPConfig(
        name=mspid,
        root_certs=[ca.cert_pem],
        intermediate_certs=[ic.cert_pem for ic in intermediates or []],
        revocation_list=crls or [],
        crypto_config=mb.FabricCryptoConfig(
            signature_hash_family="SHA2",
            identity_identifier_hash_function="SHA256"),
        fabric_node_ous=mb.FabricNodeOUs(enable=True, **{
            f"{role}_ou_identifier": mb.FabricOUIdentifier(
                organizational_unit_identifier=role)
            for role in ("client", "peer", "admin", "orderer")}),
    )
    return mb.MSPConfig(type=0, config=fconf.encode())


def _read_pems(d: str) -> list[bytes]:
    if not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out.append(f.read())
    return out


_NODE_OU_FIELDS = (
    ("ClientOUIdentifier", "client_ou_identifier"),
    ("PeerOUIdentifier", "peer_ou_identifier"),
    ("AdminOUIdentifier", "admin_ou_identifier"),
    ("OrdererOUIdentifier", "orderer_ou_identifier"),
)


def load_msp_dir(path: str, mspid: str,
                 load_signer: bool = False) -> mb.MSPConfig:
    """Read the standard MSP directory layout into an MSPConfig."""
    fconf = mb.FabricMSPConfig(
        name=mspid,
        root_certs=_read_pems(os.path.join(path, "cacerts")),
        intermediate_certs=_read_pems(os.path.join(path,
                                                   "intermediatecerts")),
        admins=_read_pems(os.path.join(path, "admincerts")),
        revocation_list=_read_pems(os.path.join(path, "crls")),
        tls_root_certs=_read_pems(os.path.join(path, "tlscacerts")),
        tls_intermediate_certs=_read_pems(
            os.path.join(path, "tlsintermediatecerts")),
        crypto_config=mb.FabricCryptoConfig(
            signature_hash_family="SHA2",
            identity_identifier_hash_function="SHA256"),
    )
    cfg_yaml = os.path.join(path, "config.yaml")
    if os.path.exists(cfg_yaml):
        doc = yamlsub.load(cfg_yaml) or {}
        nou = doc.get("NodeOUs") or {}
        if nou.get("Enable"):
            fconf.fabric_node_ous = mb.FabricNodeOUs(enable=True, **{
                field: mb.FabricOUIdentifier(
                    organizational_unit_identifier=(nou.get(key) or {}).get(
                        "OrganizationalUnitIdentifier", ""))
                for key, field in _NODE_OU_FIELDS})
    if load_signer:
        signcerts = _read_pems(os.path.join(path, "signcerts"))
        keys = _read_pems(os.path.join(path, "keystore"))
        if signcerts and keys:
            fconf.signing_identity = mb.SigningIdentityInfo(
                public_signer=signcerts[0],
                private_signer=mb.KeyInfo(key_material=keys[0]))
    return mb.MSPConfig(type=0, config=fconf.encode())


# config.yaml of an MSP folder with NodeOUs, byte for byte what
# `yaml.safe_dump` writes for the JAX package's (keys sorted)
_NODE_OUS_YAML = "NodeOUs:\n" + "".join(
    f"  {role.capitalize()}OUIdentifier:\n"
    "    Certificate: cacerts/ca.pem\n"
    f"    OrganizationalUnitIdentifier: {role}\n"
    + ("  Enable: true\n" if role == "client" else "")
    for role in ("admin", "client", "orderer", "peer"))


def write_msp_dir(
    path: str,
    ca,
    node_ous: bool = True,
    signer_cert_pem: bytes | None = None,
    signer_key_pem: bytes | None = None,
) -> None:
    """Materialize the standard layout on disk (cryptogen's msp/ output)."""
    os.makedirs(os.path.join(path, "cacerts"), exist_ok=True)
    with open(os.path.join(path, "cacerts", "ca.pem"), "wb") as f:
        f.write(ca.cert_pem)
    if node_ous:
        with open(os.path.join(path, "config.yaml"), "w") as f:
            f.write(_NODE_OUS_YAML)
    if signer_cert_pem:
        os.makedirs(os.path.join(path, "signcerts"), exist_ok=True)
        os.makedirs(os.path.join(path, "keystore"), exist_ok=True)
        with open(os.path.join(path, "signcerts", "cert.pem"), "wb") as f:
            f.write(signer_cert_pem)
        with open(os.path.join(path, "keystore", "key.pem"), "wb") as f:
            f.write(signer_key_pem or b"")


__all__ = ["msp_config_from_ca", "load_msp_dir", "write_msp_dir"]
