"""PyTorch/CUDA port of the fabric-tpu device layer.

Runs on an NVIDIA H100 through PyTorch, with hand-written CUDA kernels
in place of the Pallas TPU kernels of `fabric_tpu`.  The package imports
torch, numpy and the standard library only: nothing of `fabric_tpu`,
JAX, `cryptography` or `protobuf`.
"""
