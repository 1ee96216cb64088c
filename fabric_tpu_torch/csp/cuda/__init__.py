"""Batched ECDSA-P256 verification on a CUDA card.

`p256_kernel.verify_packed` launches the hand-written kernel of
`csrc/p256_verify.cu` for CUDA tensors and runs its plain PyTorch
version for CPU tensors; `provider.CUDACSP` drives it behind the CSP
SPI.  Kernels are compiled at first use by `build.load`.
"""
