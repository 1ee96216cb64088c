"""idemixgen: generate idemix issuer keys and signer credentials (the
port's copy of `fabric_tpu/cmd/idemixgen.py`; reference cmd/idemixgen +
msp idemix config generation).

    idemixgen ca-keygen --output idemix-config
    idemixgen signerconfig --output idemix-config \
        --org-unit org1 --enrollment-id user1 [--admin]

The issuer key is written as `ca/IssuerKey.pkl`, a pickle, as the
reference writes it; it is read back with `load_issuer`, which admits
only the port's own idemix key classes.  So an `IssuerKey.pkl` written by
the JAX package, whose classes live in that package, is refused (and
nothing of it is imported).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

from fabric_tpu_torch.msp.idemixmsp import generate_issuer, issue_signer_config

# the only globals an IssuerKey pickle names: its fields (ints, strings,
# tuples and lists of them) need none
_ALLOWED = frozenset([("fabric_tpu_torch.idemix.issuer", "IssuerKey"),
                      ("fabric_tpu_torch.idemix.issuer", "IssuerPublicKey")])


class _IssuerUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"IssuerKey.pkl names {module}.{name}: only the port's "
                "idemix issuer key (fabric_tpu_torch.idemix.issuer) is "
                "loaded; regenerate the key with this idemixgen")
        return super().find_class(module, name)


def load_issuer(path: str):
    """The IssuerKey pickled at `path` by `ca-keygen`."""
    with open(path, "rb") as f:
        return _IssuerUnpickler(f).load()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="idemixgen")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ca = sub.add_parser("ca-keygen")
    ca.add_argument("--output", default="idemix-config")
    sc = sub.add_parser("signerconfig")
    sc.add_argument("--output", default="idemix-config")
    sc.add_argument("--org-unit", default="")
    sc.add_argument("--enrollment-id", default="user")
    sc.add_argument("--admin", action="store_true")
    args = ap.parse_args(argv)

    ca_dir = os.path.join(args.output, "ca")
    if args.cmd == "ca-keygen":
        os.makedirs(ca_dir, exist_ok=True)
        issuer = generate_issuer()
        with open(os.path.join(ca_dir, "IssuerKey.pkl"), "wb") as f:
            pickle.dump(issuer, f)
        print(f"issuer key material written to {ca_dir}")
        return 0

    from fabric_tpu_torch.msp.idemixmsp import ROLE_ADMIN, ROLE_MEMBER

    issuer = load_issuer(os.path.join(ca_dir, "IssuerKey.pkl"))
    conf = issue_signer_config(
        issuer,
        mspid="IdemixMSP",
        ou=args.org_unit,
        role=ROLE_ADMIN if args.admin else ROLE_MEMBER,
        enrollment_id=args.enrollment_id,
    )
    user_dir = os.path.join(args.output, "user")
    os.makedirs(user_dir, exist_ok=True)
    with open(os.path.join(user_dir, "SignerConfig.pb"), "wb") as f:
        f.write(conf.encode())
    print(f"signer config written to {user_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
