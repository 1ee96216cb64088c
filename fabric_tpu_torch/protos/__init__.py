"""Fabric's wire messages without `protobuf`: the codec (`wire`) and the
schemas the validation path reads and writes (`common`, `msp`, `peer`,
`rwset`, `orderer`)."""
