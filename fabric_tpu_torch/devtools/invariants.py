"""invariants — the reusable consistency oracle behind chaos fuzzing (the
port's copy of `fabric_tpu/devtools/invariants.py`).

Per-test asserts judge one recovery at a time; faultfuzz needs the same
judgments as DATA, reusable across thousands of generated
fault schedules.  Each check here returns a list of :class:`Violation`
records (empty = invariant holds) instead of raising, so a fuzzing
campaign can attribute failures to plans, shrink them, and serialize the
verdict into a repro artifact.

The checks (the consistency contracts the ledger/snapshot stack already
documents — here machine-checkable):

- **chain**: every block below the advertised height is readable from
  the store, numbered contiguously, hash-chained (``previous_hash`` =
  the previous header's hash), and the store's ``last_block_hash``
  matches the tail — the block-file-first invariant made observable (a
  skipped recovery truncation or an index pointing into torn bytes
  surfaces here as an unreadable/mischained block).
- **heights**: ``durable_height`` ≤ ``height`` = block-store height,
  with the state savepoint at ``height - 1`` — and, fed a sequence of
  watermark samples from the workload, ``durable_height`` monotonicity.
- **workload state**: given the per-block write model the workload
  committed, state/history must agree with the RECOVERED height h:
  every modeled write below h present (with its history entry at
  ``(n, 0)``), every write at or above h absent — torn state is a
  violation regardless of where recovery landed.
- **snapshot**: a completed snapshot directory must verify
  (``verify_snapshot``); a torn/partial staging directory must REFUSE
  to verify (the export-side tamper contract).
- **import**: a channel whose snapshot-import marker is mid-flight must
  refuse to open; a completed import must agree with the source
  snapshot's state records byte-for-byte.
- **breaker**: TPUCSP circuit-breaker metrics sanity (state is a known
  value, counters non-negative and ordered).
- **partition**: the split-brain contract over a netsplit episode
  (``partition_violations``): the quorum side keeps committing, the
  quorum-less side stalls WITHOUT forking (per-height digest
  agreement), judged on evidence sampled just before the heal.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant: which check, and a human-readable detail
    (deterministic content only — repro artifacts embed these)."""

    check: str
    detail: str

    def as_dict(self) -> dict:
        return {"check": self.check, "detail": self.detail}

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"[{self.check}] {self.detail}"


# -- chain integrity ----------------------------------------------------------


def check_chain(ledger) -> list[Violation]:
    from fabric_tpu_torch import protoutil

    out: list[Violation] = []
    height = ledger.height
    prev = None
    for num in range(height):
        try:
            blk = ledger.get_block_by_number(num)
        except Exception as exc:
            out.append(Violation(
                "chain",
                f"block {num} unreadable below height {height}: "
                f"{type(exc).__name__}: {exc}",
            ))
            return out
        if blk is None:
            # snapshot-bootstrapped ledgers legitimately have no blocks
            # below their bootstrap height
            boot = getattr(ledger.block_store, "bootstrap_height", 0)
            if num < boot:
                continue
            out.append(Violation(
                "chain", f"block {num} missing below height {height}"
            ))
            return out
        if blk.header.number != num:
            out.append(Violation(
                "chain",
                f"block at index {num} carries number {blk.header.number}",
            ))
            return out
        if prev is not None and blk.header.previous_hash != \
                protoutil.block_header_hash(prev.header):
            out.append(Violation(
                "chain", f"hash chain broken between {num - 1} and {num}"
            ))
            return out
        if prev is None and num > 0:
            # the first present block after a snapshot bootstrap: its
            # previous_hash must anchor on the bootstrap record's hash,
            # or the oracle would be blind at exactly the
            # join-by-snapshot seam
            boot_hash = getattr(
                ledger.block_store, "bootstrap_hash", b""
            )
            if boot_hash and blk.header.previous_hash != boot_hash:
                out.append(Violation(
                    "chain",
                    f"block {num} does not chain onto the snapshot "
                    "bootstrap hash",
                ))
                return out
        prev = blk
    if prev is not None:
        tail = protoutil.block_header_hash(prev.header)
        if ledger.block_store.last_block_hash != tail:
            out.append(Violation(
                "chain",
                "store last_block_hash disagrees with the tail header "
                f"at height {height}",
            ))
    return out


# -- heights & durability -----------------------------------------------------


def check_heights(ledger, watermarks=None) -> list[Violation]:
    out: list[Violation] = []
    height = ledger.height
    durable = getattr(ledger, "durable_height", height)
    if durable > height:
        out.append(Violation(
            "heights", f"durable_height {durable} > height {height}"
        ))
    if height != ledger.block_store.height:
        out.append(Violation(
            "heights",
            f"ledger height {height} != block store height "
            f"{ledger.block_store.height}",
        ))
    sp = ledger.state_db.savepoint()
    if height > 0:
        if sp is None:
            out.append(Violation(
                "heights", f"no state savepoint at height {height}"
            ))
        elif sp.block_num != height - 1:
            out.append(Violation(
                "heights",
                f"state savepoint at block {sp.block_num}, height is "
                f"{height}",
            ))
    if watermarks:
        last = None
        for i, w in enumerate(watermarks):
            if last is not None and w < last:
                out.append(Violation(
                    "heights",
                    f"durable_height regressed at sample {i}: "
                    f"{last} -> {w}",
                ))
                break
            last = w
    return out


# -- workload state/history agreement ----------------------------------------


def check_workload_state(ledger, writes_by_block) -> list[Violation]:
    """``writes_by_block[n]`` = [(ns, key, value)] the workload's block
    `n` wrote.  Judged against the RECOVERED height: below it every
    write is present with a matching history entry; at/above it absent
    (recovery must never keep half a block)."""
    out: list[Violation] = []
    height = ledger.height
    for n, writes in enumerate(writes_by_block):
        expected_present = n < height
        for ns, key, value in writes:
            got = ledger.get_state(ns, key)
            if expected_present and got != value:
                out.append(Violation(
                    "state",
                    f"block {n} write {ns}/{key} expected "
                    f"{value!r} below height {height}, got {got!r}",
                ))
            elif not expected_present and got is not None:
                out.append(Violation(
                    "state",
                    f"block {n} write {ns}/{key} present at {got!r} "
                    f"but block is AT/ABOVE recovered height {height}",
                ))
            hist = ledger.get_history_for_key(ns, key)
            saw = [h for h in hist if h[0] == n]
            if expected_present and not saw:
                out.append(Violation(
                    "history",
                    f"no history entry for {ns}/{key} at block {n} "
                    f"(height {height})",
                ))
            elif not expected_present and saw:
                out.append(Violation(
                    "history",
                    f"history entry {saw} for {ns}/{key} above the "
                    f"recovered height {height}",
                ))
    return out


# -- snapshots ---------------------------------------------------------------


def check_snapshot_verifies(snapshot_dir: str, csp=None) -> list[Violation]:
    """A COMPLETED snapshot directory must verify."""
    from fabric_tpu_torch.ledger import snapshot as snap

    try:
        snap.verify_snapshot(snapshot_dir, csp=csp)
    except Exception as exc:
        return [Violation(
            "snapshot",
            f"completed snapshot {os.path.basename(snapshot_dir)!r} "
            f"fails verification: {type(exc).__name__}: {exc}",
        )]
    return []


def check_completed_snapshots(snapshots_root: str, csp=None) -> list[Violation]:
    """Every snapshot under <root>/completed/ must verify — staging
    (in_progress/) directories are exempt: a crash may legitimately
    leave torn files there, and verify_snapshot REFUSING them is the
    contract (see check_snapshot_rejected)."""
    out: list[Violation] = []
    completed = os.path.join(snapshots_root, "completed")
    if not os.path.isdir(completed):
        return out
    for lid in sorted(os.listdir(completed)):
        ldir = os.path.join(completed, lid)
        for h in sorted(os.listdir(ldir)):
            out.extend(check_snapshot_verifies(os.path.join(ldir, h), csp))
    return out


def check_snapshot_rejected(snapshot_dir: str, csp=None) -> list[Violation]:
    """The inverse contract: a tampered/torn directory must NOT verify
    — verification succeeding on it is the violation."""
    from fabric_tpu_torch.ledger import snapshot as snap

    try:
        snap.verify_snapshot(snapshot_dir, csp=csp)
    except Exception:
        return []
    return [Violation(
        "snapshot",
        f"torn/tampered snapshot {os.path.basename(snapshot_dir)!r} "
        "passed verification",
    )]


def check_import_state(ledger, snapshot_dir: str) -> list[Violation]:
    """A COMPLETED import must agree with the source snapshot's state
    records byte-for-byte: the imported ledger's raw export stream must
    contain every (key, value) record of the snapshot's public + hashed
    files (capped at 5 reported mismatches)."""
    from fabric_tpu_torch.ledger import snapshot as snap

    out: list[Violation] = []
    imported = dict(ledger.state_db.export_records())
    for fname in (snap.PUBLIC_STATE_FILE, snap.PVT_HASHES_FILE):
        path = os.path.join(snapshot_dir, fname)
        if not os.path.isfile(path):
            continue
        for raw_key, raw_val in snap.read_records(path):
            if imported.get(raw_key) != raw_val:
                out.append(Violation(
                    "import",
                    f"imported ledger disagrees with snapshot record "
                    f"{raw_key!r} from {fname}",
                ))
                if len(out) >= 5:
                    return out
    return out


# -- cross-peer agreement -----------------------------------------------------


def state_digest(ledger) -> str:
    """Canonical sha256 over the ledger's raw state export — the
    cross-peer agreement probe: two peers that committed the same chain
    must produce the identical digest, regardless of which of them was
    killed and caught up via state transfer or join-by-snapshot (the
    netharness oracle compares this across every node)."""
    from fabric_tpu_torch.common.hashing import sha256

    parts = []
    for k, v in sorted(ledger.state_db.export_records()):
        parts.append(len(k).to_bytes(4, "big"))
        parts.append(k)
        parts.append(len(v).to_bytes(4, "big"))
        parts.append(v)
    return sha256(b"".join(parts)).hex()


def partition_violations(
    mode: str,
    split_tip: int,
    pre_heal_heights: dict | None,
    minority_digests: dict | None,
    majority: list,
    minority: list,
    orderer_names: list,
    peer_names: list,
    slack: int = 1,
    expect_progress: bool = True,
    stall_tip: int | None = None,
) -> list[Violation]:
    """The split-brain judgment over one netsplit episode, evaluated
    on evidence sampled just BEFORE the heal (netharness's partition
    executor collects it; see ``run_stream``):

    - ``partition.majority_stalled`` — under ``full``/``oneway`` the
      side holding raft quorum must have committed PAST the tip
      observed at the split (skipped when ``expect_progress`` is
      False: a partition fired after the stream quiesced has no
      traffic to prove progress with).
    - ``partition.minority_progressed`` — under ``full`` a minority
      peer committing more than ``slack`` blocks past ``stall_tip``
      (the minority's height sampled right AFTER the cut landed;
      falls back to ``split_tip``) means the quorum-less side kept
      ordering.  Blocks replicated in the fire→cut window plus one
      fully in-flight block are legitimate, hence the post-cut
      baseline and the one-block slack.  ``oneway``/``flaky`` leave
      paths open by design, so no stall contract there.
    - ``partition.minority_forked`` — the NO-FORK invariant, every
      mode: minority peers sampled at the SAME height must agree on
      their state digest.  Comparing per-height keeps a one-block
      delivery skew from masquerading as a fork.
    - ``partition.sample`` — the evidence itself is missing (the
      pre-heal probe failed); the episode cannot be judged green.
    """
    out: list[Violation] = []
    if pre_heal_heights is None:
        return [Violation(
            "partition.sample", "no pre-heal height sample recorded"
        )]
    orderer_set = set(orderer_names)
    peer_set = set(peer_names)
    if mode in ("full", "oneway") and expect_progress:
        maj_ord = [n for n in majority if n in orderer_set]
        maj_tip = max(
            (pre_heal_heights.get(n, 0) for n in maj_ord), default=0
        )
        if maj_tip <= split_tip:
            out.append(Violation(
                "partition.majority_stalled",
                f"majority tip {maj_tip} never passed the split tip "
                f"{split_tip} (quorum side must keep committing)",
            ))
    if mode == "full":
        base = split_tip if stall_tip is None else stall_tip
        for n in sorted(minority):
            if n not in peer_set:
                continue
            h = pre_heal_heights.get(n)
            if h is not None and h > base + slack:
                out.append(Violation(
                    "partition.minority_progressed",
                    f"{n} reached height {h} > stall tip {base} "
                    f"+ slack {slack} on the quorum-less side",
                ))
    by_height: dict[int, dict] = {}
    for name, rec in sorted((minority_digests or {}).items()):
        h, digest = rec[0], rec[1]
        if h is None:
            out.append(Violation(
                "partition.sample", f"{name}: {digest}"
            ))
            continue
        by_height.setdefault(int(h), {})[name] = digest
    for h, members in sorted(by_height.items()):
        if len(set(members.values())) > 1:
            out.append(Violation(
                "partition.minority_forked",
                f"minority peers at height {h} disagree on state "
                f"digest: {sorted(members)}",
            ))
    return out


# -- TPU breaker sanity -------------------------------------------------------


def check_breaker(csp) -> list[Violation]:
    """Degraded-mode circuit-breaker sanity on a TPUCSP (or anything
    exposing its metrics shape); no-op for providers without one."""
    out: list[Violation] = []
    breaker = getattr(csp, "_breaker", None)
    if breaker is None:
        return out
    state = getattr(breaker, "state", None)
    if state not in ("open", "closed", None):
        out.append(Violation("breaker", f"unknown breaker state {state!r}"))
    for name in ("trips", "failures", "probes"):
        v = getattr(breaker, name, 0)
        if isinstance(v, int) and v < 0:
            out.append(Violation("breaker", f"negative counter {name}={v}"))
    return out


# -- aggregate ----------------------------------------------------------------


def check_ledger(ledger, writes_by_block=None,
                 watermarks=None) -> list[Violation]:
    """The standard post-chaos judgment over one reopened ledger."""
    out = check_chain(ledger)
    out.extend(check_heights(ledger, watermarks))
    if writes_by_block is not None:
        out.extend(check_workload_state(ledger, writes_by_block))
    return out


__all__ = [
    "Violation",
    "check_chain",
    "check_heights",
    "check_workload_state",
    "check_snapshot_verifies",
    "check_completed_snapshots",
    "check_snapshot_rejected",
    "check_import_state",
    "check_breaker",
    "check_ledger",
    "partition_violations",
    "state_digest",
]
