"""The X.509 membership service provider of the port (copy of
`fabric_tpu/msp`), on the pure-Python certificate parser in `x509`."""
