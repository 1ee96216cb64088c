"""The port's fabriclint (`fabric_tpu_torch/devtools/{dataflow,lint,
guards,allowlist,lintci}.py`) against the JAX package's, and the port's
tree held clean under it.

- Fixture parity: every case of the JAX package's `tests/
  test_lint_fixtures.py`, and the rule cases of its
  `tests/test_lint_clean.py`, is run as written against the JAX
  package's engine while each `lint_source` / `lint_sources` call (and
  each `dataflow.Project` built directly) is recorded; the same inputs,
  through the substitution table `SUBS` below (one line at a time), then
  go through the port's engine.  Both must give the same
  `(path, rule, line, severity, suppressed)` lists, `jax-hygiene` read as
  `device-hygiene`.  No fixture file is written.
- The taint sink's precision: `.encode()` marshals only a message of the
  codec's schema classes.
- The tree: one `lint_tree(cache=False)` report of the port's tree
  serves the tree-level tests: clean with no baseline file; every
  allowlist entry reviewed and used; the lock graph acyclic with
  `kvledger.commit_lock` before the snapshot manager's locks and equal
  to the JAX package's on their common roles; the rpcmap's methods and
  verbs the JAX package's but for the orderer node's
  `ab.BroadcastStream`; the faultmap byte-deterministic, the registry
  inside it and equal to the JAX package's; `lintci`'s artifacts the
  same bytes cold and from the cache.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys

import pytest

from fabric_tpu.devtools import dataflow as jax_df
from fabric_tpu.devtools import lint as jax_lint
from fabric_tpu_torch.devtools import dataflow as port_df
from fabric_tpu_torch.devtools import lint as port_lint
from fabric_tpu_torch.devtools import lintci
from fabric_tpu_torch.devtools.allowlist import ALLOWLIST

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# -- the substitution table --------------------------------------------------

# exact single-line replacements first, then the package's name
SUBS = [
    ("from fabric_tpu.protos.common import common_pb2",
     "from fabric_tpu_torch.protos import common as common_pb2"),
    ("from fabric_tpu.protos.gossip import message_pb2 as gpb",
     "from fabric_tpu_torch.protos import gossip as gpb"),
    ("SerializeToString", "encode"),
    ("block_until_ready", "synchronize"),
    ("device_get", "item"),
    ("<!-- knob-table:begin -->", "<!-- knob-table-torch:begin -->"),
    ("<!-- knob-table:end -->", "<!-- knob-table-torch:end -->"),
]
PACKAGE = (re.compile(r"\bfabric_tpu\b"), "fabric_tpu_torch")
RULE = {"jax-hygiene": "device-hygiene"}


def sub_line(line: str) -> str:
    for old, new in SUBS:
        line = line.replace(old, new)
    return PACKAGE[0].sub(PACKAGE[1], line)


def sub_text(text: str) -> str:
    return "".join(sub_line(ln) for ln in text.splitlines(keepends=True))


def sub_value(v):
    """The table applied through the recorded arguments."""
    if isinstance(v, str):
        return sub_text(v)
    if isinstance(v, dict):
        return {sub_value(k): sub_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(sub_value(x) for x in v)
    if isinstance(v, set):
        return {sub_value(x) for x in v}
    if isinstance(v, jax_lint.AllowEntry):
        return port_lint.AllowEntry(**sub_value(dataclasses.asdict(v)))
    if isinstance(v, ast.AST):
        # a parsed fixture: the same lines, its names and strings through
        # the table
        tree = copy.deepcopy(v)
        for node in ast.walk(tree):
            for field, x in ast.iter_fields(node):
                if isinstance(x, str):
                    setattr(node, field, sub_line(x))
        return tree
    return v


def findings(violations, port: bool) -> list:
    out = []
    for v in violations:
        path = v.path if port else sub_text(v.path)
        rule = v.rule if port else RULE.get(v.rule, v.rule)
        out.append((path, rule, v.line, v.severity, v.suppressed))
    return sorted(out)


def flows(project, port: bool) -> list:
    out = []
    for kind in ("taint_flows", "alias_violations", "race_flows",
                 "stale_guard_flows", "lifecycle_flows"):
        for f in getattr(project, kind):
            out.append((kind, f.rel if port else sub_text(f.rel), f.line))
    return sorted(out)


# -- the reference's cases, recorded -----------------------------------------

SOURCES = {
    "test_lint_fixtures": (os.path.join(HERE, "test_lint_fixtures.py"),
                           None),
    # the rule cases: csp-seam through the relaxed profile
    "test_lint_clean": (os.path.join(HERE, "test_lint_clean.py"),
                        (97, 488)),
}
LINT_CALLS = {"lint_source", "lint_sources", "Project"}


def _linting_tests(path: str, span) -> list:
    """The module's test functions that reach a lint call, directly or
    through a module-level helper, within `span` of lines."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def names(fn):
        return {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)} | {
            n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}

    lints = {k for k, fn in fns.items() if names(fn) & LINT_CALLS}
    changed = True
    while changed:
        changed = False
        for k, fn in fns.items():
            if k not in lints and names(fn) & lints:
                lints.add(k)
                changed = True
    return [k for k in fns if k.startswith("test_") and k in lints
            and (span is None or span[0] <= fns[k].lineno < span[1])]


CASES = [(mod, name) for mod, (path, span) in SOURCES.items()
         for name in _linting_tests(path, span)]


class _Stop(Exception):
    """A reference test reached a whole-tree pass (its lint_tree half is
    held by the tree-level tests below)."""


def _load(mod: str):
    path = SOURCES[mod][0]
    spec = importlib.util.spec_from_file_location(f"_jaxcases_{mod}", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _record(mod: str, name: str, tmp_path) -> list:
    """Run the reference test `name` with its lint calls recorded:
    [(kind, args, kwargs, result)]."""
    m = _load(mod)
    calls: list = []
    depth = [0]
    real_project = jax_df.Project

    def wrap(kind, fn):
        def rec(*args, **kwargs):
            depth[0] += 1
            try:
                res = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((kind, args, kwargs, res))
            return res
        return rec

    def stop(*a, **k):
        raise _Stop

    m.lint_source = wrap("lint_source", jax_lint.lint_source)
    m.lint_sources = wrap("lint_sources", jax_lint.lint_sources)
    m.lint_tree = stop
    jax_df.Project = wrap("Project", real_project)
    try:
        fn = getattr(m, name)
        kw = {p: tmp_path for p in inspect.signature(fn).parameters
              if p == "tmp_path"}
        try:
            fn(**kw)
        except _Stop:
            pass
    finally:
        jax_df.Project = real_project
    return calls


def _port_run(kind, args, kwargs):
    """The recorded call through the port's engine; its result and the
    allowlist entries it used."""
    args, kwargs = sub_value(args), sub_value(kwargs)
    if kind == "Project":
        return port_df.Project(*args, **kwargs), None
    used = kwargs["used_entries"] = set() \
        if "used_entries" in kwargs else None
    fn = port_lint.lint_source if kind == "lint_source" else \
        port_lint.lint_sources
    return fn(*args, **kwargs), used


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}::{n}" for m, n in CASES])
def test_the_fixture_case_gives_the_references_findings(mod, name,
                                                        tmp_path):
    calls = _record(mod, name, tmp_path)
    assert calls, f"{name} made no lint call"
    for kind, args, kwargs, ref in calls:
        got, used = _port_run(kind, args, kwargs)
        if kind == "Project":
            assert flows(got, True) == flows(ref, False)
            continue
        if kind == "lint_sources":
            ref, got = ref.violations, got.violations
        assert findings(got, True) == findings(ref, False)
        assert used == kwargs.get("used_entries")


def test_the_cases_cover_both_files_and_every_rule():
    covered = {m for m, _ in CASES}
    assert covered == set(SOURCES) and len(CASES) >= 90
    names = " ".join(n for _, n in CASES)
    for word in ("taint", "seam", "lock", "thread", "racecheck", "hb",
                 "lifecycle", "coverage", "rpc", "knob", "metric",
                 "jax_hygiene", "pragma", "allowlist", "exception",
                 "determinism", "relaxed"):
        assert word in names, word


# -- the taint sink's precision ----------------------------------------------


def test_encode_is_a_sink_only_on_a_message_of_the_codec():
    quiet = (
        "import time\n"
        "def stamp() -> bytes:\n"
        "    return f'{time.time()}'.encode()\n"
    )
    assert port_lint.lint_source(
        quiet, "fabric_tpu_torch/orderer/x.py") == []
    loud = (
        "import time\n"
        "from fabric_tpu_torch.protos import common as cb\n"
        "def header() -> bytes:\n"
        "    hdr = cb.BlockHeader(number=1)\n"
        "    hdr.data_hash = f'{time.time()}'.encode()\n"
        "    return hdr.encode()\n"
    )
    vs = port_lint.lint_source(loud, "fabric_tpu_torch/orderer/x.py")
    assert [(v.rule, v.line) for v in vs] == [("taint", 6)]
    # the message reached through an annotation and a summarised callee
    typed = (
        "import time\n"
        "from fabric_tpu_torch.protos import common as cb\n"
        "def make() -> cb.BlockHeader:\n"
        "    return cb.BlockHeader(number=1)\n"
        "def fill(hdr: cb.BlockHeader) -> bytes:\n"
        "    hdr.number = int(time.time())\n"
        "    return hdr.encode()\n"
        "def built() -> bytes:\n"
        "    hdr = make()\n"
        "    hdr.number = int(time.time())\n"
        "    return hdr.encode()\n"
        "def plain(s: str) -> bytes:\n"
        "    s = s + str(time.time())\n"
        "    return s.encode()\n"
    )
    vs = port_lint.lint_source(typed, "fabric_tpu_torch/orderer/x.py")
    assert [(v.rule, v.line) for v in vs] == [("taint", 7), ("taint", 11)]


# -- the port's tree ---------------------------------------------------------


@pytest.fixture(scope="module")
def report():
    return port_lint.lint_tree(cache=False)


@pytest.fixture(scope="module")
def jax_report():
    """The JAX package's production tree (its lock graph and rpcmap
    depend on nothing of its tests or scripts)."""
    return jax_lint.lint_tree(targets=("fabric_tpu",), cache=False)


def test_the_ports_tree_is_clean_with_no_baseline(report):
    assert report.files > 200  # the package, its tests, chip_smoke.py
    pretty = "\n".join(str(v) for v in report.unsuppressed)
    assert not report.unsuppressed, f"fabriclint violations:\n{pretty}"
    assert report.summary()["clean"] is True
    assert all(v.path.startswith(("tests/test_torch_", "chip_smoke.py"))
               for v in report.warnings)
    paths = {v.path for v in report.violations}
    assert "chip_smoke.py" in {v.path for v in report.suppressed}
    assert not any(p.startswith("tests/") and not
                   p.startswith("tests/test_torch_") for p in paths)
    # every pragma names a rule and a reason and suppresses something
    assert not [v for v in report.violations
                if v.rule in ("pragma", "allowlist")]


def test_every_allowlist_entry_is_reviewed_and_used(report):
    assert len(ALLOWLIST) == 3
    for e in ALLOWLIST:
        assert e.rule in port_lint.RULES, e
        assert e.path.startswith("fabric_tpu_torch/"), e
        assert len(e.reason.strip()) >= 20, e
        assert any(v.suppression == f"allowlist: {e.reason}"
                   for v in report.suppressed), e


def test_the_lock_graph_is_acyclic_and_orders_commit_before_snapshot(
        report):
    graph = report.lock_graph()
    assert list(port_lint._lock_order_cycles(graph)) == []
    commit = graph["edges"]["kvledger.commit_lock"]
    assert "snapshot.manager" in commit and "snapshot.idle" in commit
    for role in ("snapshot.manager", "snapshot.idle"):
        assert "kvledger.commit_lock" not in graph["edges"].get(role, {})


def _role(name: str) -> str:
    """A JAX role under the port's name."""
    name = name.replace("csp.tpu.provider.TPUCSP", "csp.cuda.provider.CUDACSP")
    name = name.replace("csp.tpu.provider.", "csp.cuda.provider.")
    return PACKAGE[0].sub(PACKAGE[1], name)


def test_the_role_edges_are_the_references_on_common_roles(report,
                                                           jax_report):
    port = report.lock_graph()
    ref = jax_report.lock_graph()
    common = set(port["roles"]) & {_role(r) for r in ref["roles"]}
    assert {"kvledger.commit_lock", "snapshot.manager", "snapshot.idle",
            "csp.tpu.pend", "kvstore.shard_flush"} <= common

    def edges(g, rename):
        return sorted((rename(s), rename(d)) for s, ds in g["edges"].items()
                      for d in ds if rename(s) in common
                      and rename(d) in common)

    assert edges(port, str) == edges(ref, _role)


# RPC methods whose production surface differs on purpose: the port's
# orderer node also serves the gateway's duplex broadcast
RPC_DIFFERENCES = {"ab.BroadcastStream"}
NOT_PRODUCTION = ("tests", "scripts", "chip_smoke")


def _verbs(rpcmap: dict) -> dict:
    out = {}
    for method, d in rpcmap["methods"].items():
        calls = sorted({c["verb"] for c in d["calls"]
                        if c["component"] not in NOT_PRODUCTION})
        regs = sorted({(r["component"], r["shape"]) for r in d["registers"]
                       if r["component"] not in NOT_PRODUCTION})
        if calls or regs:
            out[method] = (calls, regs)
    return out


def test_the_rpcmap_methods_and_verbs_are_the_references(report,
                                                         jax_report):
    port, ref = _verbs(report.rpcmap()), _verbs(jax_report.rpcmap())
    assert set(port) == set(ref)
    differ = {m for m in port if port[m] != ref[m]}
    assert differ == RPC_DIFFERENCES
    # the orderer node registers the server half; the JAX package's
    # orderer serves only the netnode harness's
    assert "orderer" in {c for c, _ in port["ab.BroadcastStream"][1]}
    assert "orderer" not in {c for c, _ in ref["ab.BroadcastStream"][1]}


@pytest.fixture(scope="module")
def lintci_runs(tmp_path_factory):
    """Two runs of the CI wrapper in processes of their own, every
    artifact asked for: the first computes (or, on a tree an earlier
    session linted, reads the cache), the second reads the cache."""
    d = tmp_path_factory.mktemp("lintci")
    outs = []
    for tag in ("first", "hit"):
        argv = []
        for k in lintci.ARTIFACTS:
            argv += [f"--{k}-out", str(d / f"{k}_{tag}.json")]
        argv += ["--summaries-out", str(d / f"sum_{tag}.jsonl")]
        proc = subprocess.run(
            [sys.executable, "-m", "fabric_tpu_torch.devtools.lintci",
             *argv], capture_output=True, text=True, cwd=ROOT)
        assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return d, outs


def test_the_faultmap_is_deterministic_and_holds_the_registry(
        report, lintci_runs):
    d, _ = lintci_runs
    a = json.dumps(report.faultmap(), indent=2, sort_keys=True) + "\n"
    # another run, in another process (another hash seed)
    assert open(d / "faultmap_first.json").read() == a
    seams = {s["name"]: set() for s in report.faultmap()["seams"]}
    for s in report.faultmap()["seams"]:
        seams[s["name"]].add(s["kind"])
    registry = port_lint.load_faultmap_registry()
    assert registry and set(registry) <= set(seams)
    for name, ent in registry.items():
        assert set(ent["kinds"]) <= seams[name], name


# seams that one tree has and the other lacks (none today: every seam of
# the JAX package's registry has its port counterpart)
REGISTRY_ONLY_JAX: set = set()
REGISTRY_ONLY_PORT: set = set()


def test_the_registry_is_the_references_point_for_point():
    port = port_lint.load_faultmap_registry()
    ref = jax_lint.load_faultmap_registry()
    assert set(ref) - set(port) == REGISTRY_ONLY_JAX
    assert set(port) - set(ref) == REGISTRY_ONLY_PORT
    for name in set(port) & set(ref):
        assert port[name] == ref[name], name


def test_lintci_artifacts_are_the_same_bytes_cold_and_from_the_cache(
        report, lintci_runs, tmp_path):
    d, outs = lintci_runs
    cold = lintci.write_artifacts(
        report, {k: str(tmp_path / f"{k}_cold.json")
                 for k in lintci.ARTIFACTS})
    assert outs[1]["cache"] == "hit" and outs[1]["clean"] is True
    assert outs[0]["experiment"] == "fabriclint"
    for k in lintci.ARTIFACTS:
        want = open(cold[k]["path"], "rb").read()
        for tag in ("first", "hit"):
            assert open(d / f"{k}_{tag}.json", "rb").read() == want, k
        assert {x: y for x, y in outs[1][k].items() if x != "path"} == \
            {x: y for x, y in cold[k].items() if x != "path"}
    assert open(d / "sum_first.jsonl", "rb").read() == \
        open(d / "sum_hit.jsonl", "rb").read()
    assert outs[1]["knobs"]["knobs"] == 18
    assert outs[1]["lockgraph"]["edges"] >= 10


def test_the_cli_exits_0_on_the_tree_and_1_on_a_dirty_file(lintci_runs,
                                                           tmp_path):
    """(After the wrapper's runs: this one reads their cache.)"""
    proc = subprocess.run(
        [sys.executable, "-m", "fabric_tpu_torch.devtools.lint", "--json"],
        capture_output=True, text=True, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["clean"] is True and summary["violations"] == 0
    bad = tmp_path / "bad.py"
    bad.write_text("import hashlib\nD = hashlib.sha256(b'x').digest()\n")
    proc = subprocess.run(
        [sys.executable, "-m", "fabric_tpu_torch.devtools.lint", "--json",
         "--root", str(tmp_path), "bad.py"],
        capture_output=True, text=True, cwd=ROOT,
    )
    assert proc.returncode == 1
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["by_rule"] == {"csp-seam": 1}
