"""The chaincode runtime of the port (copies of the JAX package's
`fabric_tpu/chaincode/` modules of the same names): the shim, the peer's
chaincode support, the system chaincodes, `_lifecycle` and key-level
endorsement policies, the legacy lifecycle (`lscc`), the chaincode
packagers (`platforms`) and the external builders (`externalbuilder`)."""

from fabric_tpu_torch.chaincode.shim import Chaincode, ChaincodeStub, shim_main
from fabric_tpu_torch.chaincode.support import ChaincodeSupport, InProcStream

__all__ = [
    "Chaincode",
    "ChaincodeStub",
    "shim_main",
    "ChaincodeSupport",
    "InProcStream",
]
