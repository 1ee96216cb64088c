"""Ledger pieces of the port: so far only the key-naming constants the
validator shares with the ledger (`txmgmt`)."""
