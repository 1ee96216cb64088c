"""CI wrapper around the port's fabriclint: run the full-tree pass
(``fabric_tpu_torch`` at the strict profile, the port's tests and
``chip_smoke.py`` at the relaxed profile) and emit one JSON summary line,
``"experiment": "fabriclint"``, beside the artifacts asked for.  The exit
code mirrors the linter (non-zero on any unsuppressed error-severity
violation, after the optional baseline ratchet, or over ``--budget-s``).

The port's counterpart of the JAX package's ``scripts/lint.py``:

    python -m fabric_tpu_torch.devtools.lintci [--show-suppressed]
        [--baseline FILE] [--write-baseline FILE] [--summaries-out P]
        [--guards-out P] [--lockgraph-out P] [--faultmap-out P]
        [--rpcmap-out P] [--knobs-out P] [--metricmap-out P]
        [--budget-s S] [--no-cache]

The baseline ratchet lets a new rule land loud-but-not-fatal: a JSON
{"rule": count} file tolerates up to COUNT unsuppressed errors per rule.
Stale budgets (looser than reality) fail, so the carve-out dies the
moment the tree is cleaner than it claims — the ratchet only tightens.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from fabric_tpu_torch.devtools.lint import (
    apply_baseline,
    lint_tree,
    load_baseline,
)


def _graph_counts(g: dict) -> dict:
    return {"roles": len(g["roles"]),
            "edges": sum(len(d) for d in g["edges"].values())}


# artifact -> (the report's JSON document, its counts in the summary line)
ARTIFACTS = {
    "guards": (lambda r: r.guard_map(), lambda d: {"fields": len(d)}),
    "lockgraph": (lambda r: r.lock_graph(), _graph_counts),
    "faultmap": (lambda r: r.faultmap(),
                 lambda d: {"seams": len(d["seams"]),
                            "plans": len(d["plans"])}),
    "rpcmap": (lambda r: r.rpcmap(),
               lambda d: {"methods": len(d["methods"])}),
    "knobs": (lambda r: r.knobmap(),
              lambda d: {"knobs": len(d["registry"]),
                         "reads": len(d["reads"])}),
    "metricmap": (lambda r: r.metricmap(),
                  lambda d: {"producers": len(d["producers"]),
                             "exposed": len(d["exposed"])}),
}

_HELP = {
    "guards": "racecheck's guarded-by map (declared + majority-inferred, "
              "with per-field site counts)",
    "lockgraph": "the static role-level lock acquisition-order graph "
                 "(production sites, edges[src][dst] -> [[file, line], "
                 "...]): the static twin of lockwatch's runtime graph",
    "faultmap": "the chaos-coverage faultmap (every statically enumerated "
                "faultline seam + every pinned plan rule)",
    "rpcmap": "the rpc-conformance map (every RPC method with its "
              "register and call sites, handler shapes inferred)",
    "knobs": "the knob-conformance map (the reviewed FABRIC_TPU_* "
             "registry joined with every read site)",
    "metricmap": "the metrics-conformance map (producer/derived/consumer "
                 "planes + the exposable series set)",
}


def write_artifacts(report, paths: dict) -> dict:
    """Write each asked-for artifact (``{kind: path}``) as sorted,
    indented JSON; returns ``{kind: {"path": ..., <counts>}}`` for the
    summary line.  The bytes depend only on the report's documents, so
    a cold pass and a cache hit write the same files."""
    out = {}
    for kind, path in paths.items():
        doc_of, counts = ARTIFACTS[kind]
        doc = doc_of(report)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        out[kind] = {"path": path, **counts(doc)}
    return out


def write_summaries(report, path: str) -> dict:
    """The per-function dataflow summaries as JSON lines."""
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for s in report.function_summaries():
            f.write(json.dumps(s, sort_keys=True) + "\n")
            n += 1
    return {"path": path, "functions": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_tpu_torch.devtools.lintci",
        description="CI wrapper around the port's fabriclint",
    )
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed violations (with their "
                         "reasons)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="JSON {rule: count} ratchet of tolerated per-rule "
                         "errors")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="record current per-rule error counts and exit 0")
    ap.add_argument("--summaries-out", default=None, metavar="PATH",
                    help="write the dataflow engine's per-function "
                         "summaries as JSON lines")
    for kind in ARTIFACTS:
        ap.add_argument(f"--{kind}-out", default=None, metavar="PATH",
                        help=f"write {_HELP[kind]} as a JSON artifact")
    ap.add_argument("--no-cache", action="store_true",
                    help="bypass the .fabriclint_torch_cache dataflow cache")
    ap.add_argument("--budget-s", type=float, default=None,
                    metavar="SECONDS",
                    help="fail (exit 1) when the lint pass exceeds this "
                         "wall-time budget")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    report = lint_tree(cache=not args.no_cache)
    elapsed = time.perf_counter() - t0

    for v in report.unsuppressed + report.warnings:
        print(str(v), file=sys.stderr)
    if args.show_suppressed:
        for v in report.suppressed:
            print(str(v), file=sys.stderr)

    summary = report.summary()
    out = {
        "experiment": "fabriclint",
        **{k: summary[k] for k in ("files", "violations", "warnings",
                                   "suppressed", "by_rule",
                                   "warn_by_rule", "clean", "cache")},
        "seconds": round(elapsed, 4),
    }
    if args.summaries_out:
        out["summaries"] = write_summaries(report, args.summaries_out)
    out.update(write_artifacts(report, {
        kind: getattr(args, f"{kind}_out") for kind in ARTIFACTS
        if getattr(args, f"{kind}_out")
    }))
    budget_ok = True
    if args.budget_s is not None:
        budget_ok = elapsed <= args.budget_s
        out["budget"] = {"budget_s": args.budget_s, "ok": budget_ok}
    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            json.dump(summary["by_rule"], f, indent=2, sort_keys=True)
            f.write("\n")
        out["baseline_written"] = args.write_baseline
        print(json.dumps(out))
        return 0
    if args.baseline:
        ratchet = apply_baseline(report, load_baseline(args.baseline))
        out["baseline"] = ratchet
        print(json.dumps(out))
        return 0 if ratchet["ok"] and budget_ok else 1
    print(json.dumps(out))
    return 0 if summary["clean"] and budget_ok else 1


if __name__ == "__main__":
    sys.exit(main())
