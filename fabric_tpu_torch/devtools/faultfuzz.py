"""faultfuzz — invariant-oracle chaos fuzzing over the faultline registry
(the port's copy of `fabric_tpu/devtools/faultfuzz.py`).

Hand-written fault plans test only the failures already imagined.  This module generates them instead (the
lineage-driven-fault-injection idea of Molly, the schedule-exploration
idea of CrashMonkey): a seeded :class:`random.Random` samples plans from
the LIVE fault-point registry (discovered by running the canned workload
once under ``faultline.observe()``), each plan drives the workload, and
the end state is judged by the reusable ``devtools.invariants`` oracle —
no per-plan asserts, just "do the consistency contracts still hold".

Failing plans are SHRUNK (drop rules, halve trigger counts, while the
oracle still fails) and written as replayable JSON repro artifacts; the
whole campaign is deterministic — ``Campaign(seed=7, plans=25)`` twice
yields byte-identical verdicts and canonical trip ledgers, because every
random draw comes from ``Random(f"{seed}:{plan_index}")``, the workload
is serialized (one hitter per fault point), and trips are canonicalized
by (rule, trip) order.

The canned workload per plan (all phases run UNDER the armed plan, in a
fresh working directory):

1. **commit stream** — 6 single-block commits + a 2-block commit group,
   through every ``commit.stage``/``kvstore.txn``/``store.shard_flush``/
   ``blkstorage.*`` point; a FaultCrash closes the provider and REOPENS
   it with the plan still armed, so recovery itself is fuzzed (this is
   where a ``skip`` on ``store.shard_recover`` — the sharded statedb's
   roll-forward of a committed-but-unapplied flush — turns into
   detectable corruption);
2. **snapshot export + import** — ``SnapshotManager.generate`` through
   the ``snapshot.export.stage``/``snapshot.manifest`` points, then
   ``create_from_snapshot`` into a second provider through the
   ``snapshot.import.stage`` points (a crash leaves the half-import
   marker the provider must refuse);
3. **rpc traffic** — three sequential echo calls through
   ``rpc.accept``/``rpc.server.*``/``rpc.client.*``.

Then the plan is DISARMED and the oracle judges the on-disk end state:
reopen, chain integrity, height/savepoint agreement, the per-block
write/history model against the recovered height, a continuation
commit, completed-snapshot verification, and half-import refusal.

``scripts/chaos.py`` wraps a campaign as a CI step (single JSON summary
line, nonzero exit on any oracle failure, repro artifacts under
``.faultfuzz/``, gitignored).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import random

from fabric_tpu_torch.devtools import faultline, invariants

CHANNEL = "fuzz"
NS = "cc"
DEFAULT_BLOCKS = 6  # single-block commits; +2 grouped ride on top

# The canned workload runs on the storage-v2 engine: a 2-way sharded
# statedb (so the two-phase group flush and its recovery seams are
# inside the fuzzed surface) with the flush fan-out pinned SERIAL —
# parallel shard prepare/apply would race the nth-counters of ctx-less
# rules and break the byte-identical trip-ledger acceptance.  Reopens
# ignore the env (the persisted shard count wins), so only creation
# needs the pin.
STORE_SHARDS = 2
_STORE_ENV = {
    "FABRIC_TPU_STORE_SHARDS": str(STORE_SHARDS),
    "FABRIC_TPU_STORE_POOL": "0",
}


@contextlib.contextmanager
def _store_env():
    saved = {k: os.environ.get(k) for k in _STORE_ENV}
    os.environ.update(_STORE_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

_RAISE_ERRORS = ["FaultInjected", "OSError", "ECONNRESET", "TimeoutError"]


def workload_writes(blocks: int = DEFAULT_BLOCKS) -> list[list[tuple]]:
    """The per-block write model (block n writes key k<n> = v<n>),
    including the trailing 2-block commit group — what the oracle
    judges state/history against."""
    return [
        [(NS, f"k{n:02d}", b"v%04d" % n)] for n in range(blocks + 2)
    ]


def _endorsed_block(ledger, num: int, writes) -> object:
    """One endorser tx writing `writes` through the ledger's own
    simulator — same construction as the ledger test helpers, kept
    stdlib+protos only so devtools stays importable everywhere."""
    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.protos import common as cb
    from fabric_tpu_torch.protos import peer as pb

    sim = ledger.new_tx_simulator()
    for ns, k, v in writes:
        sim.set_state(ns, k, v)
    rw = sim.get_tx_simulation_results()

    action = pb.ChaincodeAction(results=rw)
    prp = pb.ProposalResponsePayload(
        proposal_hash=b"\x00" * 32, extension=action.encode()
    )
    cap = pb.ChaincodeActionPayload(
        action=pb.ChaincodeEndorsedAction(
            proposal_response_payload=prp.encode()
        )
    )
    tx = pb.Transaction(actions=[
        pb.TransactionAction(payload=cap.encode())
    ])
    # fixed authoring timestamp: canned-workload blocks must be
    # byte-identical across runs (same-seed campaign replays, the
    # profiled-vs-unprofiled parity test), and a wall-clock second
    # boundary between two runs would poison the hash chain
    chdr = protoutil.make_channel_header(
        cb.ENDORSER_TRANSACTION, CHANNEL, tx_id=f"fuzz-tx-{num}",
        timestamp=1_700_000_000.0,
    )
    shdr = protoutil.make_signature_header(b"fuzzer", b"nonce%d" % num)
    env = cb.Envelope(
        payload=protoutil.make_payload_bytes(chdr, shdr, tx.encode())
    )
    blk = protoutil.new_block(num, ledger.block_store.last_block_hash)
    blk.data = cb.BlockData(data=[env.encode()])
    blk.header.data_hash = protoutil.block_data_hash(blk.data)
    protoutil.set_tx_filter(blk, bytearray(1))
    return blk


# -- the canned workload ------------------------------------------------------


def _src_root(root: str) -> str:
    return os.path.join(root, "src")


def _reopen(src_root: str):
    """Reopen the ledger after a simulated process death — with the
    plan STILL ARMED, so the recovery scan itself is inside the fuzzed
    surface.  Returns (provider, ledger) or (None, None) when recovery
    died too (the judge phase reports what is then on disk)."""
    from fabric_tpu_torch.ledger import LedgerProvider

    provider = None
    try:
        provider = LedgerProvider(src_root)
        return provider, provider.open(CHANNEL)
    except faultline.FaultCrash:
        pass
    except Exception:
        pass
    if provider is not None:
        try:
            provider.close()
        except Exception:
            pass
    return None, None


def _drive(root: str, blocks: int = DEFAULT_BLOCKS,
           comm: bool = True) -> dict:
    """Run the canned workload under whatever plan is armed; never
    raises (every injected failure is caught and recorded — judging is
    the ORACLE's job, on the end state, after disarm)."""
    from fabric_tpu_torch.ledger import LedgerProvider

    writes = workload_writes(blocks)
    stats: dict = {
        "committed": 0, "watermarks": [], "events": [],
        "export": None, "import": None, "rpc_ok": 0,
    }
    src = _src_root(root)
    os.makedirs(src, exist_ok=True)

    provider = None
    ledger = None
    try:
        provider, ledger = _reopen(src)
        if ledger is None:
            stats["events"].append("open:failed")
            return stats

        # phase 1a: single-block commit stream with crash-reopen
        n = 0
        attempts = 0
        recoveries = 0
        while n < blocks and ledger is not None:
            blk = _endorsed_block(ledger, n, writes[n])
            try:
                ledger.commit(blk)
            except faultline.FaultCrash:
                stats["events"].append(f"commit:{n}:crash")
                try:
                    provider.close()
                except Exception:
                    pass
                provider, ledger = _reopen(src)
                recoveries += 1
                if ledger is None or recoveries > 3:
                    break
                n = ledger.height
                attempts = 0
                continue
            except Exception as exc:
                # graceful failure: the ledger rolled back; bounded
                # retries, then give up on the stream (the oracle only
                # cares that what DID commit is consistent)
                stats["events"].append(
                    f"commit:{n}:{type(exc).__name__}"
                )
                attempts += 1
                if attempts >= 3:
                    break
                continue
            stats["committed"] += 1
            stats["watermarks"].append(ledger.durable_height)
            n = ledger.height
            attempts = 0

        # phase 1b: a 2-block commit group (the coalesced-flush path)
        if ledger is not None and ledger.height == blocks:
            try:
                group = ledger.begin_commit_group()
                for gn in (blocks, blocks + 1):
                    ledger.commit(
                        _endorsed_block(ledger, gn, writes[gn]),
                        group=group,
                    )
                ledger.commit_group_flush(group)
                stats["committed"] += 2
                stats["watermarks"].append(ledger.durable_height)
            except faultline.FaultCrash:
                stats["events"].append("group:crash")
                try:
                    provider.close()
                except Exception:
                    pass
                provider, ledger = _reopen(src)
            except Exception as exc:
                stats["events"].append(f"group:{type(exc).__name__}")

        # phase 2: snapshot export + import
        export_dir = None
        if ledger is not None and ledger.durable_height > 0:
            try:
                export_dir = ledger.snapshots.generate()
                stats["export"] = export_dir
            except faultline.FaultCrash:
                stats["events"].append("export:crash")
            except Exception as exc:
                stats["events"].append(f"export:{type(exc).__name__}")
        if export_dir is not None:
            dst = None
            try:
                dst = LedgerProvider(os.path.join(root, "dst"))
                dst.create_from_snapshot(export_dir)
                stats["import"] = "done"
            except faultline.FaultCrash:
                stats["events"].append("import:crash")
                stats["import"] = "crashed"
            except Exception as exc:
                stats["import"] = f"refused:{type(exc).__name__}"
            finally:
                if dst is not None:
                    try:
                        dst.close()
                    except Exception:
                        pass

        # phase 3: serialized rpc traffic (one hitter per point, so the
        # trip ledger stays deterministic)
        if comm:
            from fabric_tpu_torch.comm.rpc import RPCClient, RPCServer

            srv = RPCServer()
            srv.register("echo", lambda body, stream: body)
            srv.start()
            try:
                cli = RPCClient(*srv.addr, timeout=2.0)
                for _ in range(3):
                    try:
                        if cli.call("echo", b"E" * 64) == b"E" * 64:
                            stats["rpc_ok"] += 1
                    except Exception:
                        stats["events"].append("rpc:error")
            finally:
                srv.stop()
    finally:
        if provider is not None:
            try:
                provider.close()
            except Exception:
                pass
    return stats


# -- the oracle judgment ------------------------------------------------------


def _judge(root: str, stats: dict, writes) -> list[invariants.Violation]:
    """Reopen everything with NO plan armed and check the invariants.
    A reopen failure is itself a violation: whatever the faults did,
    the stores must always recover to a servable (or loudly refused
    half-import) state."""
    from fabric_tpu_torch.ledger import LedgerProvider
    from fabric_tpu_torch.ledger import snapshot as snap

    out: list[invariants.Violation] = []
    src = _src_root(root)
    provider = None
    try:
        try:
            provider = LedgerProvider(src)
            ledger = provider.open(CHANNEL)
        except Exception as exc:
            out.append(invariants.Violation(
                "reopen",
                f"ledger failed to reopen after the chaos run: "
                f"{type(exc).__name__}: {exc}",
            ))
            return out
        out.extend(invariants.check_ledger(
            ledger, writes, stats.get("watermarks")
        ))
        # block-file-first liveness: the chain must continue cleanly
        # from wherever recovery landed
        try:
            ledger.commit(_endorsed_block(
                ledger, ledger.height, [("probe", "cont", b"x")]
            ))
        except Exception as exc:
            out.append(invariants.Violation(
                "continuation",
                f"post-recovery commit failed: "
                f"{type(exc).__name__}: {exc}",
            ))
        out.extend(invariants.check_completed_snapshots(
            os.path.join(src, "snapshots")
        ))
    finally:
        if provider is not None:
            try:
                provider.close()
            except Exception:
                pass

    dst_root = os.path.join(root, "dst")
    if os.path.isdir(dst_root):
        try:
            dst = LedgerProvider(dst_root)
        except Exception as exc:
            # a provider that cannot even construct over the imported
            # stores is a violation to ATTRIBUTE, not a harness crash
            out.append(invariants.Violation(
                "import",
                f"destination provider failed to reopen: "
                f"{type(exc).__name__}: {exc}",
            ))
            return out
        try:
            marker = snap.import_marker(dst.kv, CHANNEL)
            if marker == snap.IMPORT_IN_PROGRESS:
                # the contract is a LOUD refusal, not silent service
                try:
                    dst.open(CHANNEL)
                except Exception:
                    pass  # refused: invariant holds
                else:
                    out.append(invariants.Violation(
                        "import",
                        "half-finished snapshot import opened without "
                        "complaint",
                    ))
            elif marker == snap.IMPORT_DONE and stats.get("export"):
                try:
                    led2 = dst.open(CHANNEL)
                except Exception as exc:
                    out.append(invariants.Violation(
                        "import",
                        f"completed import failed to open: "
                        f"{type(exc).__name__}: {exc}",
                    ))
                else:
                    out.extend(invariants.check_import_state(
                        led2, stats["export"]
                    ))
        finally:
            try:
                dst.close()
            except Exception:
                pass
    return out


def _canonical_trips(trips: list[dict], label: str) -> list[dict]:
    """This plan's trips in canonical (rule, trip) order — stable
    across scheduling interleavings, the byte-identical ledger the
    determinism acceptance pins."""
    own = [t for t in trips if t.get("plan") == label]
    return sorted(own, key=lambda t: (t["rule"], t["trip"]))


def run_plan(plan: dict, workdir: str, blocks: int = DEFAULT_BLOCKS,
             comm: bool = True) -> dict:
    """Drive the workload under `plan` in `workdir`, then judge with
    the plan disarmed.  Returns {"trips", "violations", "stats"} —
    plus "trace" (the flight-recorder export for THIS plan's run) when
    tracelens is armed: the recorder and its id counter reset before
    the drive, so same-seed plans replay to identical span sequences
    and a failing plan's dump can ship beside its repro artifact.
    With profscope armed the same contract holds for "profile": the
    profiler's aggregate resets before the drive, so the returned
    speedscope doc covers exactly this plan's workload."""
    from fabric_tpu_torch.common import profile, tracing

    os.makedirs(workdir, exist_ok=True)
    parsed = faultline.Plan(plan)
    if tracing.enabled():
        tracing.reset()
    if profile.enabled():
        profile.reset()
    with faultline.use_plan(parsed), _store_env():
        stats = _drive(workdir, blocks, comm=comm)
        trips = _canonical_trips(faultline.trips(), parsed.label)
    trace = tracing.export() if tracing.enabled() else None
    prof = profile.export() if profile.enabled() else None
    violations = _judge(workdir, stats, workload_writes(blocks))
    out = {
        "trips": trips,
        "violations": [v.as_dict() for v in violations],
        "stats": stats,
    }
    if trace is not None:
        out["trace"] = trace
    if prof is not None:
        out["profile"] = prof
    return out


# -- plan generation ----------------------------------------------------------


def _action_pool(name: str, kinds) -> list[str]:
    """The fault-action pool matched to a point's kind (no crash on rpc
    points — a dead handler thread is noise, not signal; torn only at
    write points, partial only at io points, skip only at guard
    points).  Shared by generate_plan and mutate_plan so a mutant's
    swapped action is always one the generator itself could draw."""
    if "io" in kinds:
        return ["raise", "delay", "partial"]
    if "write" in kinds:
        return ["torn", "raise", "crash", "delay"]
    if "guard" in kinds:
        return ["skip", "raise", "delay"]
    if name.startswith("rpc."):
        return ["raise", "delay"]
    # no "skew" here: the campaign workload runs on the system clock,
    # where a skew rule is a recorded no-op — generating one would
    # waste a fuzz slot (skew plans are exercised under
    # clockskew.use_virtual in tests/test_clockskew.py)
    return ["raise", "crash", "delay"]


_TRIGGER_KEYS = ("nth", "every", "prob", "count")
_ACTION_PARAM_KEYS = ("error", "delay_s", "cut")


def _set_action(f: dict, action: str, rng: random.Random) -> None:
    """Install `action` (and its freshly sampled parameters) on a fault
    rule, dropping any previous action's parameters."""
    for k in _ACTION_PARAM_KEYS:
        f.pop(k, None)
    f["action"] = action
    if action == "raise":
        f["error"] = rng.choice(_RAISE_ERRORS)
    elif action == "delay":
        f["delay_s"] = rng.choice([0.0, 0.001, 0.003])
    elif action == "torn":
        f["cut"] = round(rng.uniform(0.1, 0.9), 2)


def _set_trigger(f: dict, rng: random.Random) -> None:
    """Sample a fresh trigger (nth/every/prob/always with bounded
    counts) onto a fault rule, dropping the previous trigger keys."""
    for k in _TRIGGER_KEYS:
        f.pop(k, None)
    trig = rng.choice(["nth", "every", "prob", "always"])
    if trig == "nth":
        f["nth"] = rng.randint(1, 6)
    elif trig == "every":
        f["every"] = rng.randint(2, 4)
        f["count"] = rng.randint(1, 4)
    elif trig == "prob":
        f["prob"] = round(rng.uniform(0.05, 0.4), 3)
        f["count"] = rng.randint(1, 4)
    else:
        f["count"] = rng.randint(1, 3)


def generate_plan(rng: random.Random, registry: dict, label: str,
                  tripped=frozenset()) -> dict:
    """Sample one plan from the discovered fault-point registry: 1-3
    rules, action pool matched to the point's kind (no crash on rpc
    points — a dead handler thread is noise, not signal; torn only at
    write/io points; skip only at guard points), trigger mix of
    nth/every/prob/always with bounded counts, and 50% ctx targeting
    from the registry's sampled ctx values.

    ``tripped`` is the set of point names already tripped earlier in
    the campaign: selection is coverage-weighted toward the cold
    remainder (all-cold → uniform over the points).  The weighting costs
    exactly one ``rng.choice`` draw either way, so two same-seed
    campaigns — whose trip ledgers are themselves deterministic — stay
    byte-identical."""
    points = sorted(registry)
    if not points:
        raise ValueError("empty fault-point registry: run discovery first")
    faults = []
    for _ in range(rng.randint(1, 3)):
        cold = [p for p in points if p not in tripped]
        name = rng.choice(cold or points)
        ent = registry[name]
        f: dict = {"point": name}
        _set_action(
            f, rng.choice(_action_pool(name, ent.get("kinds", []))), rng
        )
        _set_trigger(f, rng)
        ctx = ent.get("ctx") or {}
        if ctx and rng.random() < 0.5:
            k = rng.choice(sorted(ctx))
            if ctx[k]:
                f["ctx"] = {k: rng.choice(ctx[k])}
        faults.append(f)
    return {
        "seed": rng.randint(0, 2 ** 31 - 1),
        "label": label,
        # the campaign snapshots the registry ONCE at discovery; its
        # generated plans never read it again, so they skip the per-hit
        # registration cost like soak plans do
        "register": False,
        "faults": faults,
    }


def mutate_plan(rng: random.Random, plan: dict, registry: dict,
                label: str) -> dict:
    """One seeded single-edit mutant of a failing plan: tweak one
    rule's trigger, swap one rule's action within its point's pool, or
    drop one rule.  Everything else — the plan seed included — carries
    over verbatim, so a mutant isolates exactly one variable against
    its parent: does the failure need THIS trigger cadence, THIS
    action, THIS rule?  Mutants ride the same run/judge/shrink/repro
    path as generated plans, and the same (campaign seed, plan index,
    mutant index) always derives the same mutant."""
    mut = copy.deepcopy(plan)
    mut["label"] = label
    faults = mut["faults"]
    edits = ["trigger", "action"] + (["drop"] if len(faults) > 1 else [])
    edit = rng.choice(edits)
    i = rng.randrange(len(faults))
    if edit == "drop":
        del faults[i]
        return mut
    f = faults[i]
    if edit == "action":
        kinds = (registry.get(f["point"]) or {}).get("kinds", [])
        pool = [
            a for a in _action_pool(f["point"], kinds)
            if a != f["action"]
        ]
        if pool:
            _set_action(f, rng.choice(pool), rng)
            return mut
        # single-action pool: fall through to a trigger tweak so the
        # edit never silently degenerates into a no-op
    _set_trigger(f, rng)
    return mut


# -- shrinking ----------------------------------------------------------------


def shrink_plan(plan: dict, still_fails, max_runs: int = 16):
    """Minimize a failing plan: repeatedly try dropping whole rules,
    then halving count/nth/every, keeping any candidate the oracle
    still fails.  `still_fails(candidate_plan) -> bool` re-runs the
    workload.  Returns (shrunk_plan, runs_used)."""
    current = copy.deepcopy(plan)
    runs = 0
    progress = True
    while progress and runs < max_runs:
        progress = False
        faults = current["faults"]
        if len(faults) > 1:
            for i in range(len(faults)):
                cand = {**current, "faults": faults[:i] + faults[i + 1:]}
                runs += 1
                if still_fails(cand):
                    current = cand
                    progress = True
                    break
                if runs >= max_runs:
                    return current, runs
            if progress:
                continue
        for i, f in enumerate(faults):
            for key in ("count", "nth", "every"):
                v = f.get(key)
                if isinstance(v, int) and v > 1:
                    nf = {**f, key: v // 2}
                    cand = {
                        **current,
                        "faults": [*faults[:i], nf, *faults[i + 1:]],
                    }
                    runs += 1
                    if still_fails(cand):
                        current = cand
                        progress = True
                        break
                    if runs >= max_runs:
                        return current, runs
            if progress:
                break
    return current, runs


# -- repro artifacts ----------------------------------------------------------

REPRO_FORMAT = "faultfuzz-repro-v1"


def write_trace_doc(path: str, doc: dict) -> str:
    """Write a flight-recorder export (Chrome trace JSON) beside its
    repro artifact — one serialization, owned by the tracing module."""
    from fabric_tpu_torch.common import tracing

    return tracing.dump_doc(path, doc)


def write_profile_doc(path: str, doc: dict) -> str:
    """Write a profscope export (speedscope JSON) beside its repro
    artifact — one serialization, owned by the profile module."""
    from fabric_tpu_torch.common import profile

    return profile.dump_to(path, doc)


def write_repro(path: str, plan: dict, original: dict, violations: list,
                trips: list, seed: int, index: int,
                blocks: int = DEFAULT_BLOCKS) -> str:
    """A self-contained, replayable failure artifact: arm `plan` over
    the canned workload (``replay``) and the oracle fails again."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = {
        "format": REPRO_FORMAT,
        "campaign_seed": seed,
        "plan_index": index,
        "workload": {"blocks": blocks},
        "plan": plan,
        "original_plan": original,
        "violations": violations,
        "trips": trips,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def replay(repro_path: str, workdir: str) -> dict:
    """Re-arm a repro artifact's (shrunk) plan over a fresh workload
    directory; returns the run_plan result — `violations` non-empty
    means the failure reproduced."""
    with open(repro_path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("format") != REPRO_FORMAT:
        raise ValueError(f"not a faultfuzz repro artifact: {repro_path}")
    blocks = int(doc.get("workload", {}).get("blocks", DEFAULT_BLOCKS))
    return run_plan(doc["plan"], workdir, blocks=blocks)


# -- campaigns ----------------------------------------------------------------


class Campaign:
    """An N-plan chaos campaign: discovery pass, generate/run/judge per
    plan, shrink + repro artifact per failure, deterministic summary.

    The summary contains no wall-clock material, so two campaigns with
    the same (seed, plans, blocks) compare equal — the determinism
    acceptance test pins exactly that."""

    def __init__(self, seed: int = 7, plans: int = 25,
                 workdir: str | None = None, out_dir: str = ".faultfuzz",
                 blocks: int = DEFAULT_BLOCKS, shrink: bool = True,
                 comm: bool = True, trace_dir: str | None = None,
                 profile_dir: str | None = None, mutants: int = 0):
        self.seed = int(seed)
        self.plans = int(plans)
        self.workdir = workdir
        self.out_dir = out_dir
        self.blocks = blocks
        self.shrink = shrink
        self.comm = comm
        # single-edit mutants derived from each FAILING plan (0 = off,
        # the default): does the failure survive a
        # trigger tweak, an action swap, a dropped rule?
        self.mutants = int(mutants)
        # where failing plans' flight-recorder dumps land (next to the
        # repro JSON by default); only written while tracelens is armed
        self.trace_dir = trace_dir
        # where failing plans' profscope speedscope docs land (next to
        # the repro JSON by default); only written while profiling is
        # armed — same contract as trace_dir
        self.profile_dir = profile_dir

    def discover(self, root: str) -> dict:
        """Run the workload once under the observer plan to enumerate
        the live fault-point registry this campaign samples from."""
        faultline.reset_registry()
        with faultline.observe(), _store_env():
            _drive(os.path.join(root, "discover"), self.blocks,
                   comm=self.comm)
        return faultline.registry()

    def run(self) -> dict:
        import shutil
        import tempfile

        own_root = self.workdir is None
        root = self.workdir or tempfile.mkdtemp(prefix="faultfuzz-")
        try:
            return self._run(root)
        finally:
            if own_root:
                # a campaign leaves ~plans full ledger trees behind (a
                # nightly CI job would fill the runner's tmpfs); repro
                # artifacts live in out_dir and survive this
                shutil.rmtree(root, ignore_errors=True)

    def _run(self, root: str) -> dict:
        registry = self.discover(root)
        results = []
        ledger: list[dict] = []
        repro_paths: list[str] = []
        trace_paths: list[str] = []
        profile_paths: list[str] = []
        tripped: set = set()
        for i in range(self.plans):
            rng = random.Random(f"{self.seed}:{i}")
            label = f"fuzz:{self.seed}:{i}"
            plan = generate_plan(rng, registry, label, tripped=tripped)
            res = run_plan(
                plan, os.path.join(root, f"plan{i:03d}"),
                blocks=self.blocks, comm=self.comm,
            )
            entry: dict = {
                "index": i,
                "plan": plan,
                "verdict": "fail" if res["violations"] else "pass",
                "violations": res["violations"],
                "trips": res["trips"],
            }
            if res["violations"]:
                shrunk = plan
                if self.shrink:
                    shrink_root = os.path.join(root, f"shrink{i:03d}")
                    counter = [0]

                    def still_fails(cand):
                        counter[0] += 1
                        sub = os.path.join(
                            shrink_root, f"s{counter[0]:03d}"
                        )
                        return bool(run_plan(
                            cand, sub, blocks=self.blocks,
                            comm=self.comm,
                        )["violations"])

                    shrunk, entry["shrink_runs"] = shrink_plan(
                        plan, still_fails
                    )
                path = write_repro(
                    os.path.join(
                        self.out_dir,
                        f"repro_seed{self.seed}_plan{i:03d}.json",
                    ),
                    shrunk, plan, res["violations"], res["trips"],
                    self.seed, i, self.blocks,
                )
                entry["shrunk"] = shrunk
                entry["repro"] = path
                repro_paths.append(path)
                if res.get("trace") is not None:
                    # the ORIGINAL failing run's flight recorder, next
                    # to the repro artifact: what the pipeline was doing
                    # in the spans before the oracle violation
                    entry["trace"] = write_trace_doc(
                        os.path.join(
                            self.trace_dir or self.out_dir,
                            f"repro_seed{self.seed}_plan{i:03d}"
                            ".trace.json",
                        ),
                        res["trace"],
                    )
                    trace_paths.append(entry["trace"])
                if res.get("profile") is not None:
                    # the ORIGINAL failing run's CPU/lock profile, next
                    # to the repro artifact: where the pipeline spent
                    # its time in the run the oracle failed
                    entry["profile"] = write_profile_doc(
                        os.path.join(
                            self.profile_dir or self.out_dir,
                            f"repro_seed{self.seed}_plan{i:03d}"
                            ".profile.json",
                        ),
                        res["profile"],
                    )
                    profile_paths.append(entry["profile"])
            if res["violations"] and self.mutants:
                # single-edit mutants of the failing plan, each fully
                # seed-derived from (campaign seed, plan index, mutant
                # index) and riding the same judge/shrink/repro path
                mutant_entries = []
                for j in range(self.mutants):
                    mrng = random.Random(f"{self.seed}:{i}:m{j}")
                    mplan = mutate_plan(
                        mrng, plan, registry, f"{label}:m{j}"
                    )
                    mres = run_plan(
                        mplan, os.path.join(root, f"plan{i:03d}_m{j}"),
                        blocks=self.blocks, comm=self.comm,
                    )
                    mentry: dict = {
                        "index": j,
                        "plan": mplan,
                        "verdict":
                            "fail" if mres["violations"] else "pass",
                        "violations": mres["violations"],
                        "trips": mres["trips"],
                    }
                    if mres["violations"]:
                        mshrunk = mplan
                        if self.shrink:
                            mroot = os.path.join(
                                root, f"shrink{i:03d}_m{j}"
                            )
                            mcounter = [0]

                            def m_still_fails(cand, _mr=mroot,
                                              _mc=mcounter):
                                _mc[0] += 1
                                sub = os.path.join(
                                    _mr, f"s{_mc[0]:03d}"
                                )
                                return bool(run_plan(
                                    cand, sub, blocks=self.blocks,
                                    comm=self.comm,
                                )["violations"])

                            mshrunk, mentry["shrink_runs"] = \
                                shrink_plan(mplan, m_still_fails)
                        mpath = write_repro(
                            os.path.join(
                                self.out_dir,
                                f"repro_seed{self.seed}"
                                f"_plan{i:03d}_m{j}.json",
                            ),
                            mshrunk, mplan, mres["violations"],
                            mres["trips"], self.seed, i, self.blocks,
                        )
                        mentry["shrunk"] = mshrunk
                        mentry["repro"] = mpath
                        repro_paths.append(mpath)
                    mutant_entries.append(mentry)
                    ledger.extend(mres["trips"])
                    tripped.update(
                        t["point"] for t in mres["trips"]
                    )
                entry["mutants"] = mutant_entries
            results.append(entry)
            ledger.extend(res["trips"])
            # feed the coverage weighting: the NEXT plan prefers points
            # this campaign has not yet tripped
            tripped.update(t["point"] for t in res["trips"])
        failures = sum(1 for e in results if e["verdict"] == "fail")
        mutant_failures = sum(
            1 for e in results for m in e.get("mutants", ())
            if m["verdict"] == "fail"
        )
        return {
            "experiment": "faultfuzz",
            "seed": self.seed,
            "plans": self.plans,
            "blocks": self.blocks,
            "registry_points": len(registry),
            "verdicts": [e["verdict"] for e in results],
            "failures": failures,
            "mutants_per_failure": self.mutants,
            "mutant_failures": mutant_failures,
            "trips_total": len(ledger),
            "trip_ledger": ledger,
            "repro": repro_paths,
            "trace": trace_paths,
            "profile": profile_paths,
            "results": results,
        }


# -- chaos-coverage registry export -------------------------------------------


def export_registry(blocks: int = DEFAULT_BLOCKS, comm: bool = True) -> dict:
    """Build the pinned chaos-coverage registry that the port's
    fabriclint chaos-coverage rule cross-checks its static faultmap
    against: observer-plan discovery on the canned campaign workload,
    unioned with every seam some pinned plan rule in the tree (exact
    name or prefix wildcard — the bare ``"*"`` soak rule deliberately
    proves nothing) can arm.

    Only statically enumerated seams are eligible, so the registry is
    a subset of the faultmap by construction — the export can record
    coverage, never invent it.  Refresh with ``python -m
    fabric_tpu_torch.devtools.faultfuzz --export-registry`` after adding
    a seam plus the chaos test that arms it."""
    import shutil
    import tempfile

    from . import lint as lintmod

    root = tempfile.mkdtemp(prefix="faultmap-")
    try:
        runtime = Campaign(
            seed=0, plans=0, blocks=blocks, comm=comm
        ).discover(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fm = lintmod.lint_tree(cache=False).faultmap()
    seam_kinds: dict = {}
    for s in fm["seams"]:
        seam_kinds.setdefault(s["name"], set()).add(s["kind"])
    exact = set()
    prefixes = []
    for rule in fm["plans"]:
        if rule["wildcard"]:
            if rule["point"] != "*":
                prefixes.append(rule["point"][:-1])  # "x.*" -> "x."
        else:
            exact.add(rule["point"])
    points = {}
    for name, kinds in sorted(seam_kinds.items()):
        armable = (
            name in runtime
            or name in exact
            or any(name.startswith(p) for p in prefixes)
        )
        if armable:
            points[name] = {"kinds": sorted(kinds)}
    return {"points": points}


def main(argv=None) -> int:
    """``python -m fabric_tpu_torch.devtools.faultfuzz --export-registry
    [PATH]``: refresh the pinned chaos-coverage registry (the port's
    counterpart of the JAX package's ``scripts/chaos.py
    --export-registry``) and print one JSON line."""
    import argparse

    from . import lint as lintmod

    ap = argparse.ArgumentParser(
        prog="python -m fabric_tpu_torch.devtools.faultfuzz",
        description="the port's chaos-coverage registry export",
    )
    ap.add_argument("--export-registry", nargs="?", default=None,
                    const="", metavar="PATH",
                    help="refresh the pinned chaos-coverage registry "
                         "(observer-plan discovery on the canned "
                         "workload unioned with every seam a pinned "
                         "plan rule can arm, restricted to statically "
                         "enumerated seams) and exit; PATH defaults to "
                         "the in-tree fabric_tpu_torch/devtools/"
                         "faultmap_registry.json that the port's "
                         "chaos-coverage rule cross-checks")
    args = ap.parse_args(argv)
    if args.export_registry is None:
        ap.error("nothing to do: pass --export-registry [PATH]")
    path = args.export_registry or lintmod.FAULTMAP_REGISTRY_PATH
    reg = export_registry()
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(reg, indent=2, sort_keys=True) + "\n")
    print(json.dumps({
        "experiment": "faultmap-registry",
        "path": path,
        "points": len(reg["points"]),
    }, sort_keys=True))
    return 0


__all__ = [
    "CHANNEL",
    "DEFAULT_BLOCKS",
    "workload_writes",
    "run_plan",
    "generate_plan",
    "mutate_plan",
    "shrink_plan",
    "write_repro",
    "write_trace_doc",
    "write_profile_doc",
    "replay",
    "Campaign",
    "export_registry",
]


if __name__ == "__main__":
    raise SystemExit(main())
