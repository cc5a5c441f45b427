"""The port's run telemetry (``utils/telemetry.py``, ``utils/flops.py``,
``utils/tracer.py``) against the JAX package's, on the CPU.

- ``model_flops_per_graph`` equals the JAX package's exactly on bench's
  headline SchNet, md17.json's PaiNN, oc20.json's MACE and zinc.json's
  PNAPlus; the peak tables resolve the H100 by name and nothing for the
  CPU;
- ci.json's SchNet through ``run_training`` with ``Telemetry`` on, in both
  packages from the same config and seed (the JAX package's TPU roofline
  anchor pointed at a missing file, so neither side resolves a peak on
  the CPU): the same row types and keys per type, with the differences
  stated in ``PORT_ONLY``/``JAX_ONLY``; the same ``step`` rows' spec, k,
  lanes and plan-domain sizes bit for bit; the same
  ``model_flops_per_graph`` per rollup; the port's ``epoch`` rows equal
  to its ``History`` bit for bit, and its ``spec_rollup`` ``mfu``-path
  fields reproducible from the rows; ``graftboard report``/``roofline``
  read the port's stream;
- telemetry on equals telemetry off bit for bit (parameters, optimizer
  state, history), also with supersteps of K = 4, the guard and the
  profiler window on, whose trace holds ``steps`` ``train_step`` ranges;
- the compile observer driven by its hook; the dispatch-mode counter on
  K1 and K2 against ``k1_work``/``k2_work``; a CPU ``memory`` row;
  the settings grammar and the environment overrides (JAX
  tests/test_telemetry.py:248-267).
"""

import json
import os
import sys

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import hydragnn_tpu
from hydragnn_tpu.config import load_config as jload_config
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jdgd
from hydragnn_tpu.utils import flops as jflops

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Fields one package's rows carry and the other's cannot.
# - header: the framework's version;
# - executable: XLA's cost and memory analysis has fields the dispatch
#   counter cannot measure (and never estimates); the port's rows keep
#   K1/K2 apart (``kernels``); the CPU has no graph pool (``temp_bytes``);
# - memory: the JAX package samples memory after each XLA compile, the
#   port after each CUDA-graph capture, and the CPU captures nothing, so
#   only the JAX rows carry the compile tag's epoch.
PORT_ONLY = {"header": {"torch_version"}, "executable": {"kernels"}}
JAX_ONLY = {
    "header": {"jax_version"},
    "executable": {"transcendentals", "optimal_seconds", "alias_bytes",
                   "generated_code_bytes", "temp_bytes", "cost_unavailable"},
}


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import config, runner
    from hydragnn_tpu_torch.data import synthetic
    from hydragnn_tpu_torch.models import create
    from hydragnn_tpu_torch.ops import edge_pipeline
    from hydragnn_tpu_torch.utils import flops, telemetry, tracer

    class NS:
        pass

    ns = NS()
    ns.torch, ns.config, ns.runner, ns.synthetic, ns.create = torch, config, runner, synthetic, create
    ns.edge_pipeline, ns.flops, ns.telemetry, ns.tracer = edge_pipeline, flops, telemetry, tracer
    return ns


def _ci_config(path, **training):
    config = jload_config(os.path.join(HERE, "inputs", "ci.json"))
    config["Dataset"]["path"] = {"total": path}
    t = config["NeuralNetwork"]["Training"]
    t["num_epoch"] = 2
    t["batch_size"] = 4
    t["Parallelism"] = {"scheme": "single", "packing": {"enabled": False},
                        "superstep": {"steps": 1}, "pipeline": {"workers": 0}}
    t["Telemetry"] = {"enabled": True, "heartbeat_interval_s": 600}
    t.update(training)
    return config


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _stream(config):
    return os.path.join("logs", config["_log_name"], "telemetry.jsonl")


def _params(state):
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    return sd, opt


def _equal_trees(a, b):
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_trees(x, y) for x, y in zip(a, b))
    return a == b


def _hist_equal(h1, h2):
    for name in ("train_loss", "val_loss", "test_loss", "lr", "epoch_captures"):
        if getattr(h1, name) != getattr(h2, name):
            return False
    return all(np.array_equal(x, y) for name in ("train_tasks", "val_tasks", "test_tasks")
               for x, y in zip(getattr(h1, name), getattr(h2, name)))


@pytest.fixture(scope="module")
def runs(port, tmp_path_factory):
    """The JAX run and the port's runs, each in its own directory:
    ``jax``, ``on``, ``off`` (ci.json's SchNet, 24 BCC configurations,
    batches of 4, two epochs) and ``k4_on``/``k4_off`` (supersteps of 4,
    the guard, checkpoints every 2 steps; the profiler window on epoch 1,
    3 dispatches, in the telemetry-on run)."""
    root = tmp_path_factory.mktemp("telemetry")
    cwd = os.getcwd()
    saved = {k: os.environ.get(k) for k in ("HYDRAGNN_TPU_ROOFLINE", "HYDRAGNN_TPU_NO_NATIVE")}
    tb = sys.modules.get("torch.utils.tensorboard", "absent")
    out = {}
    try:
        os.environ["HYDRAGNN_TPU_NO_NATIVE"] = "1"
        os.environ["HYDRAGNN_TPU_ROOFLINE"] = str(root / "no_roofline.txt")
        sys.modules["torch.utils.tensorboard"] = None
        for name in ("jax", "on", "off", "k4_on", "k4_off"):
            d = root / name
            d.mkdir()
            os.chdir(d)
            if name == "jax":
                jdgd("data", number_configurations=24, seed=5)
                _, _, _, hist, full = hydragnn_tpu.run_training(_ci_config("data"))
                out[name] = {"hist": hist, "rows": _rows(_stream(full))}
                continue
            port.synthetic.deterministic_graph_data("data", number_configurations=24, seed=5)
            training = {}
            if name.startswith("k4"):
                training = {"Parallelism": {"scheme": "single", "packing": {"enabled": False},
                                            "superstep": {"steps": 4}},
                            "Guard": {"enabled": True},
                            "Checkpoint": {"enabled": True, "interval_steps": 2},
                            "Profiling": {"epoch": 1, "steps": 3, "trace_dir": "trace"}}
            config = _ci_config("data", **training)
            if name.endswith("off"):
                config["NeuralNetwork"]["Training"].pop("Telemetry")
                config["NeuralNetwork"]["Training"].pop("Profiling", None)
            state, _, _, hist, full = port.runner.run_training(config, device="cpu")
            out[name] = {"hist": hist, "state": _params(state), "dir": str(d)}
            if not name.endswith("off"):
                out[name]["rows"] = _rows(_stream(full))
                out[name]["stream"] = str(d / _stream(full))
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if tb == "absent":
            sys.modules.pop("torch.utils.tensorboard", None)
        else:
            sys.modules["torch.utils.tensorboard"] = tb
    return out


# ---------------------------------------------------------------- flops


def _cfg_of(path, arch=None, mlip=False):
    config = jload_config(path) if isinstance(path, str) else path
    a = dict(config["NeuralNetwork"]["Architecture"])
    a.update(arch or {})
    fields = {f: a.get(f) for f in ("mpnn_type", "hidden_dim", "num_conv_layers",
                                    "num_filters", "num_gaussians", "num_radial", "max_ell",
                                    "node_max_ell", "num_nodes")}
    return fields, bool(a.get("global_attn_engine")), mlip or bool(
        a.get("enable_interatomic_potential"))


CASES = {
    "schnet_headline": (os.path.join(HERE, "inputs", "ci.json"),
                        {"hidden_dim": 128, "num_filters": 128, "num_conv_layers": 4,
                         "num_gaussians": 50}),
    "md17_painn": (os.path.join(ROOT, "examples", "md17", "md17.json"), None),
    "oc20_mace": (os.path.join(ROOT, "examples", "open_catalyst_2020", "oc20.json"), None),
    "zinc_pnaplus": (os.path.join(ROOT, "examples", "zinc", "zinc.json"), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_flops_per_graph_equals_jax(port, case):
    import types

    path, arch = CASES[case]
    fields, attn, mlip = _cfg_of(path, arch)
    cfg = types.SimpleNamespace(**fields, use_global_attn=attn,
                                enable_interatomic_potential=mlip)
    for n, e in ((17.5, 250.25), (9.0, 18.0), (120.0, 578.0)):
        want = jflops.model_flops_per_graph(cfg, n, e)
        assert want is not None
        assert port.flops.model_flops_per_graph(cfg, n, e) == want


def test_peak_tables(port):
    assert port.flops.resolve_peak_flops("NVIDIA H100 80GB HBM3") == (989.4e12, "device")
    assert port.flops.resolve_peak_bandwidth("NVIDIA H100 80GB HBM3") == (3.35e12, "device")
    assert port.flops.resolve_peak_flops("cpu") == (None, None)
    assert port.flops.resolve_peak_bandwidth("cpu") == (None, None)
    assert port.flops.resolve_peak_flops(None) == (None, None)


# ---------------------------------------------------------------- against JAX


def _keys_by_type(rows):
    out = {}
    for r in rows:
        out.setdefault(r["t"], set()).update(r)
    return out


def test_row_types_and_keys_match_jax(runs):
    jax_keys = _keys_by_type(runs["jax"]["rows"])
    port_keys = _keys_by_type(runs["on"]["rows"])
    # the CPU captures no CUDA graph, so the port has no compile row
    assert set(port_keys) == set(jax_keys) - {"compile"}
    for t, keys in port_keys.items():
        want = (jax_keys[t] - JAX_ONLY.get(t, set())) | PORT_ONLY.get(t, set())
        assert keys == want, (t, keys ^ want)


def test_step_rows_match_jax_bit_for_bit(runs):
    """``feed`` differs by design: the JAX runner wraps its serial feed in
    a prefetch thread ("prefetch"); the port's feed is serial (ROADMAP
    item 10b ports data/prefetch.py)."""
    fields = ("region", "epoch", "step", "k", "lanes", "spec", "nodes_pad", "edges_pad",
              "graphs_pad", "nodes", "edges", "graphs_plan", "scheme")
    steps = {w: [tuple(r.get(f) for f in fields) for r in runs[w]["rows"] if r["t"] == "step"]
             for w in ("jax", "on")}
    assert len(steps["on"]) == len(steps["jax"]) > 0
    assert steps["on"] == steps["jax"]


def test_spec_rollup_model_flops_match_jax(runs):
    def mf(w):
        return {(r["region"], r["epoch"], r["spec"]): r["model_flops_per_graph"]
                for r in runs[w]["rows"] if r["t"] == "spec_rollup"}

    assert mf("on") == mf("jax") and mf("on")


def test_rollup_fields_reproduce_from_rows(runs, port):
    """``mean_*``, ``model_flops_per_graph`` and the counted intensity
    come from the rollup's own fields (the reader contract)."""
    rolls = [r for r in runs["on"]["rows"] if r["t"] == "spec_rollup"]
    assert rolls
    for r in rolls:
        assert r["mean_nodes"] == r["nodes"] / r["graphs"]
        assert r["hw_dispatches"] == r["dispatches"] and "hw_missing_dispatches" not in r
        assert r["intensity"] == r["hw_flops"] / r["hw_bytes_accessed"]
        assert r["hw_over_model_flops"] == r["hw_flops"] / (
            r["model_flops_per_graph"] * r["graphs"])
        assert "mfu" not in r and "hw_mfu" not in r  # no peak on the CPU


def test_epoch_rows_equal_history(runs):
    for w in ("on", "k4_on"):
        hist = runs[w]["hist"]
        epochs = [r for r in runs[w]["rows"] if r["t"] == "epoch"]
        assert [r["train_loss"] for r in epochs] == hist.train_loss
        assert [r["val_loss"] for r in epochs] == hist.val_loss
        assert [r["test_loss"] for r in epochs] == hist.test_loss
        assert [r["lr"] for r in epochs] == hist.lr
        assert [r["seconds"] for r in epochs] == hist.epoch_seconds
        assert [r["train_tasks"] for r in epochs] == [t.tolist() for t in hist.train_tasks]


def test_executables_counted_once_per_key(runs):
    rows = runs["on"]["rows"]
    execs = [r for r in rows if r["t"] == "executable"]
    keys = [(r["region"], r["spec"], r["k"], r["lanes"]) for r in execs]
    steps = {(r["region"], r["spec"], r["k"], r["lanes"]) for r in rows if r["t"] == "step"}
    assert sorted(keys) == sorted(steps)
    for r in execs:
        assert "capture_error" not in r and r["flops"] > 0 and r["bytes_accessed"] > 0
        k1 = r["kernels"]["hydragnn::edge_pipeline"]
        assert k1["calls"] == 2  # ci.json's two CFConv layers
        if r["region"] == "train":
            assert r["kernels"]["hydragnn::edge_pipeline_bwd"]["calls"] == 2
    close = rows[-1]
    assert close["t"] == "close" and close["executables"] == len(execs)
    assert close["exec_capture_failures"] == 0


def test_graftboard_reads_port_stream(runs, capsys):
    import tools.graftboard as gb

    for cmd in ("report", "roofline"):
        assert gb.main([cmd, runs["on"]["stream"], "--json"]) == 0
        json.loads(capsys.readouterr().out)
    rep = gb.build_report(runs["on"]["stream"])
    assert rep["train_loss_by_epoch"] == runs["on"]["hist"].train_loss


# ---------------------------------------------------------------- on == off


@pytest.mark.parametrize("pair", [("on", "off"), ("k4_on", "k4_off")])
def test_telemetry_on_equals_off(runs, pair):
    on, off = (runs[w] for w in pair)
    assert _hist_equal(on["hist"], off["hist"])
    assert _equal_trees(on["state"], off["state"])


def test_superstep_guard_and_profiler_rows(runs):
    rows = runs["k4_on"]["rows"]
    steps = [r for r in rows if r["t"] == "step" and r["region"] == "train"]
    assert any(r["k"] == 4 and "loss_sum" in r for r in steps)
    health = [r for r in rows if r["t"] == "health"]
    assert [r["action"] for r in health] == ["epoch", "epoch"]
    events = [r["event"] for r in rows if r["t"] == "checkpoint"]
    assert "save" in events and "write" in events
    prof = [r for r in rows if r["t"] == "profile"]
    assert [(r["event"], r.get("reason")) for r in prof] == [("start", None),
                                                            ("stop", "step_budget")]
    with open(os.path.join(runs["k4_on"]["dir"], "trace", "trace.p0.json")) as f:
        trace = json.load(f)
    ranges = [e for e in trace["traceEvents"] if e.get("name") in ("train_step", "eval_step")
              and e.get("cat") == "user_annotation"]
    assert len(ranges) == 3


# ---------------------------------------------------------------- pieces


def test_compile_observer_hook(port, tmp_path):
    tel = port.telemetry
    s = tel.TelemetryStream(str(tmp_path / "t.jsonl"))
    obs = tel.install_observer(s)
    try:
        tel.note_epoch(0)
        tel.note_capture(0.010)
        tel.note_capture(0.020)
        with tel.suppress_compile_events():
            tel.note_capture(0.5)  # a deliberate warm-up: not counted
        tel.note_epoch(1)
        tel.note_capture(0.030)
        tel.end_of_training()
        tel.note_capture(0.040)  # post-training: new by design
    finally:
        obs.close()
        s.close()
    assert tel.observer() is None
    rows = _rows(str(tmp_path / "t.jsonl"))
    comp = [r for r in rows if r["t"] == "compile"]
    assert [(r["epoch"], r["retrace_leak"]) for r in comp] == [
        (0, False), (0, False), (1, True), (-1, False)]
    assert [r["ms"] for r in comp] == [10.0, 20.0, 30.0, 40.0]
    summ = [r for r in rows if r["t"] == "compile_summary"]
    assert len(summ) == 1 and summ[0]["compile_count"] == 4
    assert summ[0]["post_warmup_compiles"] == 1


def test_counter_k1_k2_equal_work(port):
    torch = port.torch
    ep = port.edge_pipeline
    rng = np.random.default_rng(0)
    n, e, f_in, f_out = 40, 150, 24, 16
    seg = np.sort(rng.integers(0, n, e))
    mask = rng.random(e) > 0.2
    plan = ep.plan_blocks_static(seg, n, ep.static_block_bound(e, n) + 1, edge_valid=mask)
    plan = tuple(torch.from_numpy(p) for p in plan)
    a = torch.tensor(rng.normal(size=(e, f_in)), dtype=torch.float32, requires_grad=True)
    b = torch.tensor(rng.normal(size=(e, f_in)), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.normal(size=(f_in, f_out)), dtype=torch.float32, requires_grad=True)

    def step(batches):
        out = ep.edge_pipeline_planned(a, b, w, *plan, n)
        out.square().sum().backward()
        return (out.detach(),)

    ctr = port.telemetry.ExecCounter()
    ctr.run(step, [])
    assert ctr.error is None and ctr.ran
    e_valid = int(mask.sum())
    slots, blocks = plan[0].numel(), plan[3].numel()
    k1 = ep.k1_work(e_valid, n, f_in, f_out, slots, blocks, a.dtype, w.dtype, True, True)
    k2 = ep.k2_work(e, e_valid, n, f_in, f_out, slots, blocks, a.dtype, w.dtype, True, True)
    got1 = ctr.kernels["hydragnn::edge_pipeline"]
    got2 = ctr.kernels["hydragnn::edge_pipeline_bwd"]
    assert (got1["calls"], got1["flops"], got1["bytes_accessed"]) == (1, k1[1], k1[0])
    assert (got2["calls"], got2["flops"], got2["bytes_accessed"]) == (1, k2[1], k2[0])
    assert got1["e_valid"] == e_valid and got1["slots"] == slots
    # torch's flop formulas cover matmuls and convolutions only, so the
    # elementwise square and sum add bytes and no flops
    assert ctr.flops == k1[1] + k2[1]
    assert ctr.bytes > k1[0] + k2[0]
    assert ctr.output_bytes == n * f_out * 4


def test_cpu_memory_row_has_host_keys_only(port):
    row = port.telemetry.memory_row("x", epoch=3)
    assert set(row) <= {"t", "tag", "epoch", "host_rss_bytes", "host_peak_rss_bytes"}
    assert row["host_rss_bytes"] > 0 and row["epoch"] == 3


def test_settings_block_and_envs(port, monkeypatch):
    tel = port.telemetry
    for k in ("HYDRAGNN_TPU_TELEMETRY", "HYDRAGNN_TPU_TELEMETRY_STREAM",
              "HYDRAGNN_TPU_TELEMETRY_SYNC"):
        monkeypatch.delenv(k, raising=False)
    st = tel.telemetry_settings({"Telemetry": {"enabled": True, "sync_interval_steps": 7}})
    assert st.enabled and st.sync_interval_steps == 7
    assert tel.telemetry_settings({"Telemetry": True}).enabled
    assert not tel.telemetry_settings({}).enabled
    monkeypatch.setenv("HYDRAGNN_TPU_TELEMETRY", "1")
    monkeypatch.setenv("HYDRAGNN_TPU_TELEMETRY_STREAM", "/tmp/x.jsonl")
    monkeypatch.setenv("HYDRAGNN_TPU_TELEMETRY_SYNC", "5")
    st = tel.telemetry_settings({})
    assert st.enabled and st.stream_path == "/tmp/x.jsonl" and st.sync_interval_steps == 5
    monkeypatch.setenv("HYDRAGNN_TPU_TELEMETRY", "0")
    assert not tel.telemetry_settings({"Telemetry": {"enabled": True}}).enabled


@pytest.mark.parametrize("block,match", [
    ("Telemetry", "Telemetry"),
    ("Profiling", "Profiling"),
])
def test_update_config_rejects_unknown_keys(port, tmp_path, block, match):
    path = str(tmp_path / "data")
    port.synthetic.deterministic_graph_data(path, number_configurations=6, seed=1)
    config = _ci_config(path)
    config["NeuralNetwork"]["Training"][block] = {"enabled": True, "sync_interval": 5}
    from hydragnn_tpu_torch.data.raw import process_raw_samples, read_lsms_directory

    samples = process_raw_samples(read_lsms_directory(path, config["Dataset"]), config)
    with pytest.raises(ValueError, match=match):
        port.config.update_config(config, samples)
