"""The port's graftlint (``hydragnn_tpu_torch/analysis``) against the JAX
package's (``hydragnn_tpu/analysis``).

- The rule families that judge framework-neutral Python (suppression,
  config-schema, nondet's plan scope, thread-discipline, lock-order,
  guarded-field, barrier-discipline's counter-mint and asymmetric
  rendezvous sub-checks) give the same ``(rule, path, line)`` findings
  on the same fixture source, with the same messages except where the
  port's message names its own API (``MESSAGE_DIFFERS``).
- The torch counterparts (host-sync, hot-coverage, torch-api) flag their
  positive fixtures and pass their negative ones.
- config-schema on the repo's JSON configs: every key the JAX rule
  accepts, the port's rule accepts too.
- The repo gate: the port's default scope is clean against
  ``hydragnn_tpu_torch/analysis/baseline.json``, with no stale entry.
- The CLI contract: exit codes 0, 1 and 2, ``--write-baseline`` refusing
  a restricted run, ``--explain`` printing the seed registry.

Host-side AST work only; torch is imported by the torch-api rule when it
runs, not at collection, and runs on one thread.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

import tests._cpu  # noqa: F401  (side effect: pin CPU platform)

from hydragnn_tpu import analysis as jax_lint
from hydragnn_tpu.analysis.rules import (
    barrier_discipline as jax_barrier,
    config_schema as jax_config,
    guarded_field as jax_guarded,
    lock_order as jax_lock,
    nondet as jax_nondet,
    suppression as jax_suppression,
    thread_discipline as jax_thread,
)
from hydragnn_tpu_torch import analysis as port_lint
from hydragnn_tpu_torch.analysis.__main__ import main as port_cli
from hydragnn_tpu_torch.analysis.rules import (
    barrier_discipline as port_barrier,
    config_schema as port_config,
    guarded_field as port_guarded,
    host_sync as port_host_sync,
    hot_coverage as port_hot_coverage,
    lock_order as port_lock,
    nondet as port_nondet,
    suppression as port_suppression,
    thread_discipline as port_thread,
    torch_api as port_torch_api,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "hydragnn_tpu_torch", "analysis", "baseline.json")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch

    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# neutral families: the same fixture through both packages

PLAN_FIXTURE = '''
import time

import numpy as np


def _order(n):
    return np.random.permutation(n)


def _seeded_order(n, seed):
    return np.random.default_rng(seed).permutation(n)


class GraphLoader:
    def epoch_plan(self, epoch):
        t0 = time.time()
        idx = _order(8)
        ok = _seeded_order(8, epoch)

        def _stamp():
            return time.time()

        return t0, idx, ok, _stamp()


def host_timer():
    return time.time()
'''

NEVER_BLOCK_FIXTURE = '''
import queue
import time


class TelemetryStream:
    def __init__(self):
        self._q = queue.Queue(maxsize=4)

    def emit(self, row):
        self._q.put(row)
        self._q.put_nowait(row)
        self._q.put(row, block=True)
        return True


def cold_path(q, t):
    q.put(1)
    time.sleep(t)
'''

EPOCH_FIXTURE = '''
import time


def _run_epoch(step_fn, state, loader, ev, worker):
    ev.wait()
    worker.join()
    time.sleep(0.1)
    with open("/tmp/x", "w") as f:
        f.write("row")
    ev.wait(timeout=1.0)
    ", ".join(["a"])
    return state
'''

WORKER_FIXTURE = '''
import threading


class Writer:
    def __init__(self):
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()

    def _main(self):
        pass

    def close(self):
        pass


class Leaky:
    def start(self):
        self._thread = threading.Thread(target=self._main)
        self._thread.start()

    def _main(self):
        pass


def trial(cfg):
    w = Writer()
    w.close()
    return cfg


def good_trial(cfg):
    w = Writer()
    try:
        return cfg
    finally:
        w.close()


def factory():
    w = Writer()
    return w
'''

ABBA_FIXTURE = '''
import threading


class Pipeline:
    def __init__(self):
        self._head = threading.Lock()
        self._tail = threading.Lock()
        threading.Thread(target=self._fill).start()
        threading.Thread(target=self._drain).start()

    def _fill(self):
        with self._head:
            self._append()

    def _append(self):
        with self._tail:
            pass

    def _drain(self):
        with self._tail:
            with self._head:
                pass
'''

BLOCKING_FIXTURE = '''
import queue
import threading
import time


class Feeder:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q = queue.Queue(maxsize=2)
        threading.Thread(target=self._main).start()

    def _main(self):
        with self._lock:
            self._q.put(1)
            time.sleep(0.1)
            self._q.get()
            open("/tmp/y")
        with self._lock:
            self._q.put_nowait(2)
            self._q.put(3, block=False)
        with self._cv:
            self._cv.wait()
        with self._lock:
            ev = threading.Event()
            ev.wait()
'''

GUARDED_FIXTURE = '''
import queue
import threading


class Handle:
    def __init__(self):
        self._lock = threading.Lock()
        self._q = queue.Queue()
        self.engine = None
        self.beat = 0.0
        threading.Thread(target=self._pump).start()

    def swap(self, eng):
        with self._lock:
            self.engine = eng
            self._q.put_nowait(eng)
            self._flush()

    def _flush(self):
        self.engine = None

    def _pump(self):
        e = self.engine
        self.beat = 1.0
        self._q.put_nowait(e)

    def qsize(self):
        with self._lock:
            e = self.engine
        return e


class Cold:
    def __init__(self):
        self._lock = threading.Lock()
        self.x = 0

    def locked(self):
        with self._lock:
            self.x = 1

    def unlocked(self):
        return self.x
'''

# One line calls the coordination client (the JAX rule's rendezvous
# surface) and a store (the port's): both rules anchor at the mint.
MINT_FIXTURE = '''
import itertools
import time

_COUNTER = itertools.count()


def publish(client, store, tag):
    seq = next(_COUNTER)
    name = f"ckpt:{tag}:{seq}"
    client.key_value_set(name, "1"); store.set(name, "1")


def stamp(client, store):
    n = f"walltime:{time.time()}"
    client.key_value_set(n, "1"); store.set(n, "1")


def prefix(client, store, tag):
    p = f"orbax:{_barrier_seq(tag)}"
    client.key_value_set(p, "1"); store.set(p, "1")


def publish_ok(client, store, tag, job_seq):
    client.key_value_set(f"ckpt:{tag}:{job_seq}", "1"); store.set(f"ckpt:{tag}:{job_seq}", "1")
'''

RENDEZVOUS_FIXTURE = '''
class CheckpointWriter:
    def save(self, ok, payload):
        if process_index() == 0:
            _processes_agree_finite(ok)
        if world_size > 1:
            _processes_agree_finite(ok)
        return payload
'''

SUPPRESSION_FIXTURE = '''
import time


class GraphLoader:
    def epoch_plan(self, epoch):
        a = time.time()  # graftlint: disable=nondet -- wall clock for the log only
        b = time.time()  # graftlint: disable=nondet
        # graftlint: disable-next-line=nondet -- the log again
        c = time.time()
        d = time.time()  # graftlint: disable=all
        e = time.time()  # graftlint: disable=host-sync -- another rule
        return a, b, c, d, e
'''

READER_FIXTURE = '''
def read(config):
    arch = config["NeuralNetwork"]["Architecture"]
    verbosity = config.get("Verbosity", {}).get("level", 0)
    for split in ("train", "validate", "test"):
        _ = config["Dataset"]["path"].get(split)
    return arch.get("hidden_dim"), verbosity, "batch_size" in arch
'''

CONFIG_FIXTURE = json.dumps({
    "Verbosity": {"level": 0},
    "Dataset": {"path": {"train": "x", "test": "y"}},
    "NeuralNetwork": {"Architecture": {"hidden_dmi": 32, "batch_size": 8}},
    "_private": 1,
    "heads": {"branch-0": {}},
}, indent=1)

NEUTRAL_CASES = {
    "suppression": ({"pkg/data/loader.py": SUPPRESSION_FIXTURE}, ("suppression", "nondet")),
    "config-schema": ({"pkg/reader.py": READER_FIXTURE,
                       "examples/a/a.json": CONFIG_FIXTURE,
                       "tests/inputs/c.json": CONFIG_FIXTURE,
                       "bench/b.json": CONFIG_FIXTURE}, ("config-schema",)),
    "nondet-plan": ({"pkg/data/loader.py": PLAN_FIXTURE}, ("nondet",)),
    "thread-never-block": ({"pkg/utils/telemetry.py": NEVER_BLOCK_FIXTURE,
                            "pkg/train/loop.py": EPOCH_FIXTURE}, ("thread-discipline",)),
    "thread-worker": ({"pkg/utils/writer.py": WORKER_FIXTURE}, ("thread-discipline",)),
    "lock-order-abba": ({"pkg/serve/pipe.py": ABBA_FIXTURE}, ("lock-order",)),
    "lock-order-blocking": ({"pkg/serve/feeder.py": BLOCKING_FIXTURE}, ("lock-order",)),
    "guarded-field": ({"pkg/serve/handle.py": GUARDED_FIXTURE}, ("guarded-field",)),
    "barrier-mint": ({"pkg/utils/publish.py": MINT_FIXTURE}, ("barrier-discipline",)),
    "barrier-rendezvous": ({"pkg/utils/checkpoint.py": RENDEZVOUS_FIXTURE},
                           ("barrier-discipline",)),
}

# Cases whose messages name each package's own API: compared by
# (rule, path, line), then the port's wording checked.
MESSAGE_DIFFERS = {
    # "no reader in hydragnn_tpu/ or examples/" vs "hydragnn_tpu_torch/"
    "config-schema": "hydragnn_tpu_torch/ accepts it",
    # the port's message drops the JAX package's PR reference
    "barrier-mint": "enqueue-time job sequence",
    # a rank test and the store's timeout vs process_index and the
    # coordination service's
    "barrier-rendezvous": "under a rank test",
}

JAX_RULES = {
    "suppression": jax_suppression.SuppressionRule,
    "config-schema": jax_config.ConfigSchemaRule,
    "nondet": jax_nondet.NondetRule,
    "thread-discipline": jax_thread.ThreadDisciplineRule,
    "lock-order": jax_lock.LockOrderRule,
    "guarded-field": jax_guarded.GuardedFieldRule,
    "barrier-discipline": jax_barrier.BarrierDisciplineRule,
}
PORT_RULES = {
    "suppression": port_suppression.SuppressionRule,
    "config-schema": port_config.ConfigSchemaRule,
    "nondet": port_nondet.NondetRule,
    "thread-discipline": port_thread.ThreadDisciplineRule,
    "lock-order": port_lock.LockOrderRule,
    "guarded-field": port_guarded.GuardedFieldRule,
    "barrier-discipline": port_barrier.BarrierDisciplineRule,
}

# what each case must find (rule, count) — the parity is not vacuous
EXPECTED = {
    "suppression": {("suppression", 2), ("nondet", 1)},
    "config-schema": {("config-schema", 4)},
    "nondet-plan": {("nondet", 3)},
    "thread-never-block": {("thread-discipline", 6)},
    "thread-worker": {("thread-discipline", 2)},
    "lock-order-abba": {("lock-order", 1)},
    "lock-order-blocking": {("lock-order", 5)},
    "guarded-field": {("guarded-field", 1)},
    "barrier-mint": {("barrier-discipline", 3)},
    "barrier-rendezvous": {("barrier-discipline", 1)},
}


@pytest.mark.parametrize("case", sorted(NEUTRAL_CASES))
def test_neutral_family_parity(case, tmp_path):
    sources, rules = NEUTRAL_CASES[case]
    for rel, text in sources.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    paths = sorted({rel.split("/")[0] for rel in sources})
    ref = jax_lint.run_lint(str(tmp_path), paths=paths,
                            rules=[JAX_RULES[r]() for r in rules]).findings
    got = port_lint.run_lint(str(tmp_path), paths=paths,
                             rules=[PORT_RULES[r]() for r in rules]).findings
    # the in-memory helper agrees with the on-disk run
    mem = port_lint.lint_sources(sources, [PORT_RULES[r]() for r in rules])
    assert [(f.rule, f.path, f.line) for f in mem] == [
        (f.rule, f.path, f.line) for f in got]
    key = sorted((f.rule, f.path, f.line) for f in got)
    assert key == sorted((f.rule, f.path, f.line) for f in ref), (
        [f.render() for f in got], [f.render() for f in ref])
    counts = {(r, sum(f.rule == r for f in got)) for r in {f.rule for f in got}}
    assert counts == EXPECTED[case], [f.render() for f in got]
    if case in MESSAGE_DIFFERS:
        assert all(MESSAGE_DIFFERS[case] in f.message for f in got), [
            f.message for f in got]
    else:
        assert sorted(f.message for f in got) == sorted(f.message for f in ref)


# ---------------------------------------------------------------------------
# host-sync: the torch counterpart

HOT_FIXTURE = '''
import numpy as np
import torch


def _run_epoch(step, state, loader, ev, stream):
    loss = state.loss.item()
    rows = state.rows.tolist()
    host = state.acc.cpu()
    arr = host.numpy()
    torch.cuda.synchronize()
    ev.synchronize()
    stream.synchronize()
    plan = np.asarray(rows)
    _capture(state)
    return loss, arr, plan


def _body(x):
    return np.asarray(x) + x.item()


def _capture(state):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _body(state.x)


def cold(state):
    torch.cuda.synchronize()
    return state.loss.item(), np.asarray(state.rows)
'''


def _host_sync(sources):
    return port_lint.lint_sources(sources, [port_host_sync.HostSyncRule()])


def test_host_sync_flags_each_sync_form_in_the_step_path_only():
    f = _host_sync({"pkg/train/loop.py": HOT_FIXTURE})
    by_fn = {}
    for x in f:
        by_fn.setdefault(x.message.split("`")[3], []).append(x.message.split("`")[1])
    # _run_epoch: seven forms; its np.asarray is host code (not captured)
    assert sorted(by_fn["_run_epoch"]) == sorted([
        ".item()", ".tolist()", ".cpu()", ".numpy()",
        "torch.cuda.synchronize(...)", ".synchronize()", ".synchronize()"])
    # the captured body: np.asarray and .item()
    assert sorted(by_fn["_body"]) == [".item()", "np.asarray(...)"]
    assert "cold" not in by_fn
    assert any("captured `_body`" in x.message for x in f)


def test_host_sync_suppression_justified_and_bare():
    src = '''
def _run_epoch(state):
    a = state.loss.item()  # graftlint: disable=host-sync -- the epoch's one fetch
    b = state.loss.item()  # graftlint: disable=host-sync
    return a, b
'''
    f = port_lint.lint_sources({"pkg/train/loop.py": src}, [
        port_host_sync.HostSyncRule(), port_suppression.SuppressionRule()])
    assert [(x.rule, x.line) for x in f] == [("suppression", 4)], [x.render() for x in f]


def test_host_sync_follows_the_graph_cache_to_the_step_body():
    """The callable handed to a capture parameter (``fn`` of a function
    that calls it inside ``torch.cuda.graph``) through a builder that
    returns its nested def, a partial, a lambda and a ``self`` attribute
    bound to a builder's result, is captured code."""
    src = '''
import functools

import numpy as np
import torch


class Cache:
    def run(self, key, fn, batches):
        return self._record(fn, batches)

    def record(self, fn, batches):
        return self._record(fn, batches)

    def _record(self, fn, batches):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            return fn(batches)


def make_body(model):
    def body(b):
        return np.array(b)
    return body


def _dispatch(run, graphs, batches):
    return graphs.run("k", run, batches)


def superstep(model, graphs, batches):
    body = make_body(model)
    fn = functools.partial(body)
    _dispatch(fn, graphs, batches)
    graphs.run("k2", lambda b: _helper(b), batches)


def _helper(b):
    return np.asarray(b)


def not_captured(b):
    return np.asarray(b)


def make_fwd(model):
    def fwd(b):
        return np.array(b)
    return fwd


class Engine:
    def __init__(self, model, graphs):
        self.graphs = graphs
        self._fwd = make_fwd(model)

    def _warm(self, fn):
        step = lambda batches: fn(batches[0])
        return self.graphs.record(step, [])

    def warm(self):
        return self._warm(self._fwd)
'''
    ctx = port_lint.engine.LintContext("/virtual", [
        port_lint.engine.SourceFile("/virtual/pkg/m.py", "pkg/m.py", src)], [])
    captured = sorted(f.key[1] for f in ctx.callgraph.captured())
    assert captured == ["_helper", "make_body.body", "make_fwd.fwd"], captured
    f = port_lint.engine.run_on_context(ctx, rules=[port_host_sync.HostSyncRule()]).findings
    assert sorted(x.message.split("`")[3] for x in f) == [
        "_helper", "make_body.body", "make_fwd.fwd"]


def test_site_verdict_classifies_card_sites():
    src = HOT_FIXTURE
    sf = port_lint.engine.SourceFile("/virtual/pkg/train/loop.py", "pkg/train/loop.py", src)
    ctx = port_lint.engine.LintContext("/virtual", [sf], [])
    lines = src.splitlines()
    item = lines.index("    loss = state.loss.item()") + 1
    cold = lines.index("    return state.loss.item(), np.asarray(state.rows)") + 1
    hot_plain = lines.index("    _capture(state)") + 1
    got = port_host_sync.site_verdict(ctx, [
        ("pkg/train/loop.py", item), ("pkg/train/loop.py", cold),
        ("pkg/train/loop.py", hot_plain), ("pkg/other.py", 3)])
    assert got == {
        ("pkg/train/loop.py", item): "flagged",
        ("pkg/train/loop.py", cold): "out of scope",
        ("pkg/train/loop.py", hot_plain): "missed",
        ("pkg/other.py", 3): "out of scope",
    }


# ---------------------------------------------------------------------------
# hot-coverage and torch-api

COVERAGE_RUNNER = '''
from pkg.train.steps import drive, make_step


def run_training(cfg, graphs):
    step = make_step(cfg)
    drive(graphs, step)
'''

COVERAGE_STEPS = '''
import torch


def make_step(cfg):
    def step(batches):
        return batches
    return step


def drive(graphs, fn):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn([])
'''


def test_hot_coverage_flags_an_uncovered_captured_step():
    rule = port_hot_coverage.HotCoverageRule()
    f = port_lint.lint_sources({"pkg/runner.py": COVERAGE_RUNNER,
                                "pkg/train/steps.py": COVERAGE_STEPS}, [rule])
    assert len(f) == 1, [x.render() for x in f]
    assert "captured `make_step.step`" in f[0].message
    assert "('train/steps.py', 'make_step')" in f[0].message
    # the same step built by a seeded builder is covered
    covered = {"pkg/runner.py": COVERAGE_RUNNER.replace("pkg.train.steps", "pkg.train.loop")
               .replace("make_step", "_train_body"),
               "pkg/train/loop.py": COVERAGE_STEPS.replace("make_step", "_train_body")}
    assert port_lint.lint_sources(covered, [rule]) == []


def test_torch_api_resolves_chains_against_installed_torch():
    src = '''
import torch
import torch.nn.functional as F
from torch import cuda
from torch.cuda import graph


def f(x):
    torch.cuda.no_such_attr(x)
    cuda.also_missing()
    torch.ops.hydragnn.edge_pipeline(x)
    torch.classes.anything.here
    torch.cuda.graph
    F.relu(x)
    return graph
'''
    f = port_lint.lint_sources({"pkg/m.py": src}, [port_torch_api.TorchApiRule()])
    lines = src.splitlines()
    assert sorted((x.line, x.message) for x in f) == [
        (lines.index("    torch.cuda.no_such_attr(x)") + 1,
         "`torch.cuda.no_such_attr` does not exist in the installed torch"),
        (lines.index("    cuda.also_missing()") + 1,
         "`torch.cuda.also_missing` does not exist in the installed torch"),
    ]
    bad_import = port_lint.lint_sources(
        {"pkg/n.py": "from torch.cuda import no_such_name\n"},
        [port_torch_api.TorchApiRule()])
    assert [x.message for x in bad_import] == [
        "`torch.cuda.no_such_name` does not exist in the installed torch"]


# ---------------------------------------------------------------------------
# the repo: config parity and the gate


def _json_keys(path):
    out = set()

    def walk(doc):
        if isinstance(doc, dict):
            for k, v in doc.items():
                out.add(k)
                walk(v)
        elif isinstance(doc, list):
            for v in doc:
                walk(v)

    with open(path) as fh:
        walk(json.load(fh))
    return out


def test_config_schema_accepts_every_key_the_jax_rule_accepts():
    """On examples/ and tests/inputs/: the two rules' findings name the
    same keys at the same lines, and every key of those configs the JAX
    package's vocabulary holds, the port's holds too."""
    scope = ["examples", "tests/inputs"]
    ref = jax_lint.run_lint(REPO, paths=scope, rules=[jax_config.ConfigSchemaRule()])
    got = port_lint.run_lint(REPO, paths=scope, rules=[port_config.ConfigSchemaRule()])

    def keyed(findings):
        return sorted((f.path, f.line, f.message.split("`")[1]) for f in findings)

    assert keyed(got.findings) == keyed(ref.findings)
    jax_vocab = jax_config._default_scope_keys(REPO)
    port_vocab = port_config._default_scope_keys(REPO)
    keys = set()
    for top in scope:
        for dirpath, _, names in os.walk(os.path.join(REPO, top)):
            keys |= {k for n in names if n.endswith(".json")
                     for k in _json_keys(os.path.join(dirpath, n))}
    assert sorted((keys & jax_vocab) - port_vocab) == []
    # the python harvested is the port's own: no JAX example script
    ctx = port_lint.engine.collect_files(REPO, list(port_lint.DEFAULT_PATHS))
    assert ctx.py_files and not any(
        sf.relpath.startswith(("examples/", "tests/")) for sf in ctx.py_files)


@pytest.fixture(scope="module")
def repo_run():
    return port_lint.run_lint(REPO, baseline_path=BASELINE)


def test_repo_gate_is_clean_against_the_baseline(repo_run):
    assert repo_run.ok, "new findings:\n" + "\n".join(f.render() for f in repo_run.new)
    assert not repo_run.stale_baseline, "stale baseline entries: prune with --write-baseline"


def test_baseline_holds_only_config_schema(repo_run):
    with open(BASELINE) as fh:
        entries = json.load(fh)["findings"]
    assert {e["rule"] for e in entries} == {"config-schema"}
    assert sorted(e["path"] for e in entries) == ["examples/lsms/lsms.json",
                                                  "tests/inputs/ci.json"]
    assert len(repo_run.baselined) == 2
    # every family ran over the tree
    assert set(repo_run.per_rule) == {r.name for r in port_lint.all_rules()}
    assert repo_run.per_rule["host-sync"]["suppressed"] > 0


# ---------------------------------------------------------------------------
# the CLI


def _cli(*argv):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = port_cli(list(argv))
    return rc, buf.getvalue(), err.getvalue()


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "drifted.py"
    bad.write_text("import torch\n\nx = torch.cuda.no_such_attr\n")
    good = tmp_path / "fine.py"
    good.write_text("import torch\n\nx = torch.cuda.graph\n")
    r = subprocess.run(
        [sys.executable, "-m", "hydragnn_tpu_torch.analysis", str(bad), "--check",
         "--baseline", ""], capture_output=True, text=True, cwd=REPO, timeout=240)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "torch.cuda.no_such_attr" in r.stdout
    rc, out, _ = _cli(str(good), "--check", "--baseline", "", "--json", "--rules",
                      "torch-api")
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] and doc["new"] == 0
    assert doc["torch_version"] == port_torch_api.installed_torch_version()
    rc, out, _ = _cli(str(good), "--check", "--baseline", "", "--stats", "--rules",
                      "torch-api")
    assert rc == 0 and "torch-api" in out and f"(torch {doc['torch_version']})" in out
    rc, _, err = _cli(str(tmp_path / "missing.py"), "--check")
    assert rc == 2 and "no such file" in err
    rc, _, err = _cli("--rules", "no-such-rule")
    assert rc == 2 and "unknown rule" in err


def test_cli_write_baseline_refuses_restricted_runs(tmp_path):
    target = tmp_path / "b.json"
    for argv in (["hydragnn_tpu_torch/analysis"], ["--rules", "nondet"], ["--diff", "HEAD"]):
        rc, _, err = _cli(*argv, "--write-baseline", "--baseline", str(target))
        assert rc == 2 and "full default-scope run" in err, argv
    assert not target.exists()


def test_cli_explain_and_list_rules():
    rc, out, _ = _cli("--explain", "host-sync")
    assert rc == 0
    assert "seed registry (path suffix, qualname):" in out
    assert "StaticBatches.load" in out and "edge_pipeline_planned" in out
    rc, out, _ = _cli("--explain", "hot-coverage")
    assert rc == 0 and "recalibrate_batch_stats" in out and "exemptions:" in out
    rc, out, _ = _cli("--list-rules")
    names = {line.split()[0] for line in out.splitlines() if line.strip()}
    assert rc == 0 and names == {r.name for r in port_lint.all_rules()}
    assert {"torch-api", "host-sync", "hot-coverage"} <= names
    assert not names & {"jax-api", "retrace", "donation", "fp-contract"}
