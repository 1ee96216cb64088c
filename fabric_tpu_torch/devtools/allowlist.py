"""Reviewed cross-file suppressions of the port's fabriclint.

The JAX package's three entries at their port counterparts: the deliver
client's endpoint shuffle and ``KVLedger``'s two group-commit flushes.

Every entry must carry a reason; unused entries are themselves lint
violations (lint.py reports them), so this file can only shrink as code
is fixed — it never accumulates dead grants.  Prefer inline pragmas for
single-line local exemptions; entries here are for cases where the
suppression is a reviewed DESIGN decision rather than a line-local one.
"""

from __future__ import annotations

from fabric_tpu_torch.devtools.lint import AllowEntry

ALLOWLIST: list[AllowEntry] = [
    AllowEntry(
        rule="determinism",
        path="fabric_tpu_torch/peer/deliverclient.py",
        match="random.shuffle(order)",
        reason="endpoint shuffle is deliberately randomized per peer "
               "for orderer load-spreading; connection order never "
               "enters consensus state",
    ),
    AllowEntry(
        rule="lock-discipline",
        path="fabric_tpu_torch/ledger/kvledger.py",
        match="self._flush_group(g)",
        reason="the approved group-commit seam: KVLedger.commit flushes "
               "one fsync + one atomic KV txn per group boundary under "
               "the commit lock BY DESIGN (the pipeline invariant)",
    ),
    AllowEntry(
        rule="lock-discipline",
        path="fabric_tpu_torch/ledger/kvledger.py",
        match="self._flush_group(group)",
        reason="the approved group-commit seam: commit_group_flush is "
               "the explicit group boundary — the single coalesced "
               "fsync + KV txn must be atomic w.r.t. concurrent "
               "snapshot exports, so it runs under the commit lock",
    ),
]

__all__ = ["ALLOWLIST"]
