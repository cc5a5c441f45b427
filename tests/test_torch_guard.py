"""The port's divergence guard (``train/guard.py``) and fault grammar
(``utils/faults.py``) against the JAX package's, on the CPU.

- the fault spec grammar: the same strings accepted (with the same
  parsed rules) and rejected by both ``faults`` modules
  (tests/test_durability.py:69 and :770-785, tests/test_guard.py:194);
- ``guard_settings``: the same resolutions and the same errors;
- ``GuardMonitor``: both monitors fed the same predicate and norm
  sequences escalate alike at the same steps (skip, rollback, halt,
  windows across epochs, the sampled cadence), and with the multibranch
  guard's per-slot predicates (``branches``) alike with the same
  ``window_bad_by_branch`` in every ``health`` row; the two packages'
  ``branch_guard_labels``;
- ci.json's SchNet through ``run_training`` with ``Guard`` on and
  ``nan:loss@3`` armed in both packages from the same initial
  parameters: per-epoch losses within the f32 gradient tolerance (rtol
  1e-4, atol 1e-3 x min(max|ref|, 1)), and both report bad step 3;
- the port's guarded step alone, bit for bit: a healthy guarded run
  equals the unguarded run (losses, parameters, optimizer state; single
  steps and supersteps of 4); ``nan:loss@3`` and ``nan:batch@3`` skipped
  equal a run that never took step 3; ``nan:grad`` leaves the state as
  it was; the unguarded control goes non-finite;
- the ladder end to end through ``run_training``: a rollback (restore,
  learning rate halved, finite losses), and a halt where no checkpoint
  was written.
"""

import copy
import dataclasses
import os
import re
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax

import hydragnn_tpu
from hydragnn_tpu import runner as jrunner
from hydragnn_tpu.config import load_config as jload_config
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jdgd
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.train import guard as jguard
from hydragnn_tpu.utils import faults as jfaults

HERE = os.path.dirname(os.path.abspath(__file__))
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import config, runner
    from hydragnn_tpu_torch.data import loader, synthetic
    from hydragnn_tpu_torch.models import convert, create
    from hydragnn_tpu_torch.parallel import multibranch
    from hydragnn_tpu_torch.train import guard, loop, optimizer, state
    from hydragnn_tpu_torch.utils import faults, telemetry

    return types.SimpleNamespace(torch=torch, config=config, runner=runner, loader=loader,
                                 synthetic=synthetic, convert=convert, create=create,
                                 guard=guard, loop=loop, optimizer=optimizer, state=state,
                                 faults=faults, multibranch=multibranch, telemetry=telemetry)


@pytest.fixture(autouse=True)
def _disarmed(port):
    yield
    port.faults.reset()
    jfaults.reset()


# ---------------------------------------------------------------- grammar

ACCEPTED = [
    "write_fail:resume:1;slow_write:epoch:0.01:2;crash:write_tmp:3",
    "nan:loss@5;nan:loss@7;nan:grad@2;nan:batch@0",
    "stall:barrier@3@proc0:0.25",
    "stall:barrier@proc1@2",
    "kill:train_step@proc1:16",
    "kill:train_step:34",
    "write_fail:target:2",
]
REJECTED = [
    "write_fail:only_two_parts",
    "no_such_kind:a:1",
    "kill:train_step@procX:3",
    "kill:@proc1:3",
    "stall:barrier",
    "stall:barrier@x",
    "stall:barrier@1@proc0@2",
    "stall:barrier@proc0@proc1@1",
    "nan:params@3",
]


def _rules(plan):
    return {k: getattr(plan, k) for k in
            ("write_fail", "slow_write", "crashes", "kills", "stalls", "nans")}


@pytest.mark.parametrize("spec", ACCEPTED)
def test_fault_grammar_accepts_as_jax(port, spec):
    jfaults.install(spec)
    port.faults.install(spec)
    assert _rules(port.faults._plan()) == _rules(jfaults._plan())
    assert port.faults.nan_rules() == jfaults.nan_rules()
    assert port.faults.plan_spec() == jfaults.plan_spec() == spec


@pytest.mark.parametrize("spec", REJECTED)
def test_fault_grammar_rejects_as_jax(port, spec):
    with pytest.raises(ValueError):
        jfaults.install(spec)
    with pytest.raises(ValueError):
        port.faults.install(spec)


def test_fault_hooks_count_and_disarm(port, monkeypatch):
    """write_fail counts down, crash_point fires on its arrival, a kill
    scoped to another rank never fires."""
    f = port.faults
    f.install("write_fail:target:2;crash:write_tmp:2")
    for _ in range(2):
        with pytest.raises(OSError):
            f.on_write("/some/target/path")
    f.on_write("/some/target/path")
    f.crash_point("write_tmp")
    with pytest.raises(f.InjectedCrash):
        f.crash_point("write_tmp")
    monkeypatch.setenv("HYDRAGNN_TPU_PROCESS_ID", "0")
    f.install("kill:train_step@proc1:2")
    for _ in range(4):
        f.tick("train_step")
    assert f._plan()._counters["train_step"] == 4
    f.reset()
    assert not f.active() and f.nan_rules() == {}


# ---------------------------------------------------------------- settings


GUARD_BLOCKS = [
    {}, {"Guard": True}, {"Guard": False}, {"Guard": {"enabled": True}},
    {"Guard": {"enabled": True, "policy": "rollback", "max_bad_steps": 1,
               "max_rollbacks": 5, "window_steps": 0, "check_interval_steps": -3}},
    {"Guard": {"policy": "halt", "lr_backoff": 1.0}},
]
BAD_GUARDS = [{"Guard": {"policy": "panic"}}, {"Guard": {"lr_backoff": 1.5}},
              {"Guard": {"lr_backoff": 0.0}}, {"Guard": "yes"}]


@pytest.mark.parametrize("training", GUARD_BLOCKS + BAD_GUARDS)
def test_guard_settings_match_jax(port, training):
    try:
        want = jguard.guard_settings(training)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e).split()[0])):
            port.guard.guard_settings(training)
        return
    assert dataclasses.asdict(port.guard.guard_settings(training)) == dataclasses.asdict(want)


# ---------------------------------------------------------------- the monitor


def _drive(mod, settings, epochs, branches=None):
    """Feed a monitor of ``mod`` the (k, oks, gnorms) dispatches of each
    epoch; record what it raised and its counts."""
    m = mod.GuardMonitor(settings, branches=branches)
    events = []
    for e, dispatches in enumerate(epochs):
        m.note_epoch(e)
        step = 0
        try:
            for k, oks, gns in dispatches:
                step += k
                m.observe(step=step, k=k, ok_ref=np.asarray(oks, bool),
                          gnorm_ref=np.asarray(gns, np.float32))
            m.epoch_end()
        except Exception as exc:
            kind = type(exc).__name__
            events.append((e, kind, list(getattr(exc, "bad_steps", []))))
            if kind == "GuardRollback":
                m.note_rollback(step, 0.1)
            else:
                break
    return events, m.skipped_total, m.rollbacks, m.bad_steps_all, m.gnorm_stats()


def _epochs(rng, n_epochs, bad_at, k=1, n=12):
    out = []
    for e in range(n_epochs):
        dispatches = []
        for s in range(0, n, k):
            oks = [(e, s + j) not in bad_at for j in range(k)]
            gns = [float(rng.uniform(0.1, 2.0)) if ok else float("nan") for ok in oks]
            dispatches.append((k, oks, gns))
        out.append(dispatches)
    return out


@pytest.mark.parametrize("case", ["skip", "rollback", "halt", "window", "cadence", "macro"])
def test_guard_monitor_escalates_as_jax(port, case, capsys):
    rng = np.random.default_rng(3)
    bad = {(0, 3), (1, 5), (1, 6), (2, 1), (2, 2), (2, 9)}
    policy = {"skip": "skip", "halt": "halt"}.get(case, "rollback")
    block = {"enabled": True, "policy": policy, "max_bad_steps": 1,
             "window_steps": 10 if case == "window" else 100, "max_rollbacks": 2,
             "check_interval_steps": 4 if case == "cadence" else 0}
    epochs = _epochs(rng, 3, bad, k=4 if case == "macro" else 1)
    got = _drive(port.guard, port.guard.guard_settings({"Guard": block}), epochs)
    want = _drive(jguard, jguard.guard_settings({"Guard": block}), epochs)
    assert got[:4] == want[:4]
    assert got[4] == pytest.approx(want[4], rel=1e-6)
    assert "SKIPPED" in capsys.readouterr().out


def _slot_epochs(rng, n_epochs, bad_at, k=1, n=12, slots=3):
    """Per-slot dispatches: ``bad_at`` maps (epoch, step) to its bad
    slots; a bad slot's partial norm is NaN."""
    out = []
    for e in range(n_epochs):
        dispatches = []
        for s in range(0, n, k):
            oks = [[j not in bad_at.get((e, s + i), ()) for j in range(slots)]
                   for i in range(k)]
            gns = [[float(rng.uniform(0.1, 2.0)) if ok else float("nan") for ok in row]
                   for row in oks]
            dispatches.append((k, oks if k > 1 else oks[0], gns if k > 1 else gns[0]))
        out.append(dispatches)
    return out


@pytest.mark.parametrize("case", ["isolated", "same-slot", "halt", "macro"])
def test_guard_monitor_branches_escalate_as_jax(port, case, monkeypatch, capsys):
    """The per-slot windows (tests/test_guard.py's isolation case): both
    monitors with ``branches`` fed the same per-slot predicates escalate
    at the same steps with the same counts, and every ``health`` row's
    ``window_bad_by_branch`` is the same; two branches' single bad steps
    never add up, one branch's two do."""
    from hydragnn_tpu.utils import telemetry as jtel

    rng = np.random.default_rng(5)
    bad = {"isolated": {(0, 1): (0,), (0, 2): (1,), (1, 4): (0,)},
           "same-slot": {(0, 1): (0, 2), (0, 2): (1,), (0, 5): (0, 2)},
           "halt": {(0, 3): (1,), (1, 2): (1,), (1, 7): (2,)},
           "macro": {(0, 1): (0,), (0, 2): (0, 2), (1, 6): (1,)}}[case]
    block = {"enabled": True, "policy": "halt" if case == "halt" else "rollback",
             "max_bad_steps": 1, "window_steps": 100, "max_rollbacks": 1}
    epochs = _slot_epochs(rng, 2, bad, k=4 if case == "macro" else 1)
    rows = {"port": [], "jax": []}
    monkeypatch.setattr(port.telemetry, "active", lambda: True)
    monkeypatch.setattr(port.telemetry, "emit", rows["port"].append)
    monkeypatch.setattr(jtel, "emit", rows["jax"].append)
    labels = port.multibranch.branch_guard_labels(2)
    got = _drive(port.guard, port.guard.guard_settings({"Guard": block}), epochs, labels)
    want = _drive(jguard, jguard.guard_settings({"Guard": block}), epochs, labels)
    assert got[:4] == want[:4]
    assert got[4] == pytest.approx(want[4], rel=1e-6)
    by_branch = [r["window_bad_by_branch"] for r in rows["port"]]
    assert by_branch == [r["window_bad_by_branch"] for r in rows["jax"]] and by_branch
    assert [r["action"] for r in rows["port"]] == [r["action"] for r in rows["jax"]]
    assert "[slots: " in capsys.readouterr().out


def test_branch_guard_labels_match_jax(port):
    from hydragnn_tpu.parallel.multibranch import branch_guard_labels

    for n in (1, 2, 5):
        assert port.multibranch.branch_guard_labels(n) == branch_guard_labels(n)


# ---------------------------------------------------------------- against JAX


def _ci_config(path, epochs=2, **training):
    config = jload_config(os.path.join(HERE, "inputs", "ci.json"))
    config["Dataset"]["path"] = {"total": path}
    t = config["NeuralNetwork"]["Training"]
    t["num_epoch"] = epochs
    t["Parallelism"] = {"scheme": "single", "packing": {"enabled": False},
                        "superstep": {"steps": 1}, "pipeline": {"workers": 0}}
    t.update(training)
    return config


def test_guarded_run_training_matches_jax(port, tmp_path, monkeypatch):
    """ci.json's SchNet (2 epochs, batch 32 on 28 train graphs of the
    40-configuration BCC set) with ``Guard`` on and ``nan:loss@3`` armed,
    from the same initial parameters in both packages."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    jdgd("jax_data", number_configurations=40, seed=7)
    port.synthetic.deterministic_graph_data("port_data", number_configurations=40, seed=7)
    captured, monitors = {}, {"jax": [], "port": []}

    def spy(model, example, seed=0):
        out = jax.jit(lambda b: init_params(model, b, seed=seed))(example)
        captured["params"] = jax.device_get(out[0])
        return out

    def recording(mod, key):
        plain = mod.GuardMonitor

        class Recorded(plain):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                monitors[key].append(self)

        monkeypatch.setattr(mod, "GuardMonitor", Recorded)

    recording(jguard, "jax")
    recording(port.guard, "port")
    monkeypatch.setattr(jrunner, "init_params", spy)
    guard = {"Guard": {"enabled": True}, "batch_size": 8}
    jfaults.install("nan:loss@3")
    _, _, _, j_hist, _ = hydragnn_tpu.run_training(_ci_config("jax_data", **guard))
    sd = port.convert.params_from_jax(captured["params"])
    make = port.runner.create_model_config

    def with_jax_params(config, device=None, *, seed=0):
        model, cfg = make(config, device, seed=seed)
        model.load_state_dict(sd)
        return model, cfg

    monkeypatch.setattr(port.runner, "create_model_config", with_jax_params)
    port.faults.install("nan:loss@3")
    _, _, _, t_hist, _ = port.runner.run_training(_ci_config("port_data", **guard),
                                                  device="cpu")
    for name in ("train_loss", "val_loss", "test_loss"):
        want = np.asarray(getattr(j_hist, name))
        assert np.isfinite(want).all()
        np.testing.assert_allclose(getattr(t_hist, name), want, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * min(float(np.abs(want).max()), 1.0),
                                   err_msg=name)
    assert monitors["port"][0].bad_steps_all == monitors["jax"][0].bad_steps_all == [(0, 3)]


# ---------------------------------------------------------------- the port's step


@pytest.fixture(scope="module")
def tiny(port, tmp_path_factory):
    """ci.json's SchNet on 24 BCC configurations, batches of 4."""
    path = str(tmp_path_factory.mktemp("guard") / "data")
    port.synthetic.deterministic_graph_data(path, number_configurations=24, seed=3)
    config = _ci_config(path)
    from hydragnn_tpu_torch.data.raw import process_raw_samples, read_lsms_directory

    samples = process_raw_samples(read_lsms_directory(path, config["Dataset"]), config)
    full = port.config.update_config(config, samples)
    model, cfg = port.create.create_model_config(full, "cpu", seed=0)
    sd = copy.deepcopy(model.state_dict())
    return samples[:16], model, cfg, full["NeuralNetwork"]["Training"], sd


def _fresh(port, tiny):
    _, model, cfg, training, sd = tiny
    model.load_state_dict(sd)
    opt = port.optimizer.select_optimizer(model.parameters(), training)
    return port.state.TrainState(model, opt), cfg


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [(k, v.clone()) for s in state.optimizer.state.values() for k, v in s.items()]
            + [(k, v.clone()) for g in state.optimizer.param_groups for k, v in g.items()
               if hasattr(v, "clone")])


def _same(port, a, b):
    torch = port.torch
    assert set(a[0]) == set(b[0])
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert len(a[1]) == len(b[1])
    assert all(ka == kb and torch.equal(va, vb) for (ka, va), (kb, vb) in zip(a[1], b[1]))


def _feed(port, samples, epoch, k):
    base = port.loader.GraphLoader(samples, 4, with_segment_plan=False)
    base.set_epoch(epoch)
    return port.loader.SuperstepLoader(base, k) if k > 1 else base


def _guarded_run(port, tiny, *, guard, k=1, spec=None, epochs=2):
    if spec:
        port.faults.install(spec)
    state, cfg = _fresh(port, tiny)
    step = port.loop.make_superstep_fn(state.model, state.optimizer, cfg, guard=guard)
    monitor = port.guard.GuardMonitor(port.guard.guard_settings({"Guard": True})) if guard \
        else None
    losses = []
    for ep in range(epochs):
        if monitor is not None:
            monitor.note_epoch(ep)
        state, loss, _ = port.loop._run_epoch(step, state, _feed(port, tiny[0], ep, k),
                                              train=True, guard=monitor)
        losses.append(loss)
    port.faults.reset()
    return losses, _snapshot(state), monitor


def _skipping_run(port, tiny, skip, epochs=2):
    """Single unguarded steps, with global step ``skip`` never taken (the
    counters still advance past it)."""
    state, cfg = _fresh(port, tiny)
    step = port.loop.make_superstep_fn(state.model, state.optimizer, cfg)
    losses = []
    for ep in range(epochs):
        acc = None
        for batch in _feed(port, tiny[0], ep, 1):
            if state.step == skip:
                state.step += 1
                state.step_t += 1
                continue
            state, acc = step(state, acc, [batch])
        losses.append(port.loop._fetch_epoch(*acc)[0])
    return losses, _snapshot(state)


@pytest.mark.parametrize("k", [1, 4])
def test_healthy_guard_identity(port, tiny, k):
    """Guard on against off on a healthy run, single steps and
    supersteps of 4: losses, parameters and optimizer state bit for
    bit, and no bad step."""
    off = _guarded_run(port, tiny, guard=False, k=k)
    on = _guarded_run(port, tiny, guard=True, k=k)
    assert on[0] == off[0]
    _same(port, on[1], off[1])
    assert on[2].skipped_total == 0 and on[2].gnorm_stats()["gnorm_steps"] == 4  # the last epoch


@pytest.mark.parametrize("site,k", [("loss", 1), ("batch", 1), ("loss", 4), ("batch", 4)])
def test_injected_skip_equals_baseline(port, tiny, site, k):
    """``nan:<site>@3`` guarded (inside a superstep of 4 for k = 4) equals
    the run that skips global step 3, bit for bit; the unguarded control
    goes non-finite."""
    base = _skipping_run(port, tiny, 3)
    got = _guarded_run(port, tiny, guard=True, k=k, spec=f"nan:{site}@3")
    assert got[0] == base[0]
    _same(port, got[1], base[1])
    assert got[2].bad_steps_all == [(0, 3)]
    ctrl = _guarded_run(port, tiny, guard=False, k=k, spec=f"nan:{site}@3", epochs=1)
    assert not np.isfinite(ctrl[0][0])


def test_grad_site_leaves_state_unchanged(port, tiny):
    """``nan:grad@0``: the first guarded step changes no parameter,
    buffer or optimizer tensor, and reports the step bad."""
    port.faults.install("nan:grad@0")
    state, cfg = _fresh(port, tiny)
    before = _snapshot(state)
    step = port.loop.make_train_step(state.model, state.optimizer, cfg, guard=True)
    batch = next(iter(_feed(port, tiny[0], 0, 1)))
    _, loss, tasks, ng, ok, gnorm = step(state, batch)
    assert not bool(ok) and not np.isfinite(float(gnorm))
    assert float(loss) == 0.0 and float(ng) == 0.0 and int(state.step_t) == 1
    _same(port, _snapshot(state), before)


# ---------------------------------------------------------------- the ladder


def test_rollback_end_to_end(port, tmp_path, monkeypatch, capsys):
    """run_training with the rollback policy, resume containers every 2
    steps and ``nan:batch@3``: the guard skips step 3, rolls back to the
    newest container with the learning rate halved, and the run ends
    with finite losses."""
    monkeypatch.chdir(tmp_path)
    port.synthetic.deterministic_graph_data("data", number_configurations=24, seed=3)
    config = _ci_config("data", batch_size=4,
                        Guard={"enabled": True, "policy": "rollback", "max_bad_steps": 0},
                        Checkpoint={"enabled": True, "interval_steps": 2})
    lr = float(config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"])
    port.faults.install("nan:batch@3")
    state, _, _, hist, _ = port.runner.run_training(config, device="cpu")
    out = capsys.readouterr().out
    assert "SKIPPED on-device at optimizer step(s) [3]" in out
    assert "ROLLBACK #1" in out and f"lr {lr:.3e} -> {lr / 2:.3e}" in out
    assert np.isfinite(hist.train_loss + hist.val_loss + hist.test_loss).all()
    assert float(state.optimizer.param_groups[0]["lr"]) == pytest.approx(lr / 2)


def test_halt_without_checkpoints(port, tmp_path, monkeypatch):
    """The rollback policy with checkpoints off has nothing to roll back
    to: ``GuardHalt`` with the report; the halt policy halts at once."""
    monkeypatch.chdir(tmp_path)
    port.synthetic.deterministic_graph_data("data", number_configurations=24, seed=3)
    for policy, match in (("rollback", "no restorable checkpoint"),
                          ("halt", "HALTED by the divergence guard")):
        config = _ci_config("data", batch_size=4,
                            Guard={"enabled": True, "policy": policy, "max_bad_steps": 0})
        config["Dataset"]["name"] = policy
        port.faults.install("nan:loss@1")
        with pytest.raises(port.guard.GuardHalt, match=match) as e:
            port.runner.run_training(config, device="cpu")
        assert "nan:loss@1" in str(e.value)
