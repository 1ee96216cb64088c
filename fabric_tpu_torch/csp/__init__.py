"""Crypto service provider of the port: the SPI, a pure-Python P-256
reference, and the CUDA provider (`csp.cuda.provider.CUDACSP`)."""
