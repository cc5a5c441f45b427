"""The port's durability layer (``utils/checkpoint.py``'s writer and
manifest, ``skip_to``, ``Training.continue``) on the CPU.

- host side against the JAX package, bit for bit: ``config_fingerprint``
  over tests/inputs/ci.json and examples/md17/md17.json, ``encode_acc``'s
  dict and ``decode_acc``'s values, the manifest's keys,
  ``drop_consumed_groups``, and ``skip_to``'s delivered suffix of a
  shuffled epoch (packing off and on, and superstep groups of 2);
- ``DPLoader.skip_to`` delivers the tail of a whole epoch's deliveries,
  and ``MultiBranchLoader.skip_to`` each slot's tail bit for bit, taking
  a lockstep list of per-branch cursors and refusing a drifted one
  (tests/test_durability.py:1060, :1082); the manifest's
  ``branch_steps`` against the JAX package's, through both formats'
  containers (:875);
- the writer: transient write failures retried, exhaustion kept on
  ``last_error`` and not raised, the validate-finite gate, single-writer
  backpressure, a crash mid-container keeping the previous container,
  the epoch files, ``latest`` and pruning;
- ``find_continue_log_name`` refuses a sibling run written under another
  config fingerprint;
- a real preemption: a child process killed by ``SIGKILL`` in its second
  epoch (``kill:train_step``), then ``continue`` in this process, equal
  to the uninterrupted run bit for bit (parameters, optimizer state,
  every loss of the history);
- the walltime stop (``HYDRAGNN_WALLCLOCK_DEADLINE``): a save, then
  ``continue`` equal to the uninterrupted run bit for bit;
- compatibility: a synchronous checkpoint, without a manifest,
  restores through ``run_prediction(config)`` and continues as
  a loud epoch-0 restart; a writer's container restores through
  ``run_prediction(config)`` with its manifest ignored.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data import loader as jloader
from hydragnn_tpu.utils import checkpoint as jckpt

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data import graph, loader, synthetic
    from hydragnn_tpu_torch.parallel import dp
    from hydragnn_tpu_torch.train import optimizer, state
    from hydragnn_tpu_torch.utils import checkpoint, faults

    return types.SimpleNamespace(torch=torch, runner=runner, graph=graph, loader=loader,
                                 synthetic=synthetic, dp=dp, optimizer=optimizer, state=state,
                                 ckpt=checkpoint, faults=faults)


@pytest.fixture(autouse=True)
def _disarmed(port):
    yield
    port.faults.reset()


# ---------------------------------------------------------------- host parity


@pytest.mark.parametrize("path", ["tests/inputs/ci.json", "examples/md17/md17.json"])
def test_config_fingerprint_matches_jax(port, path):
    with open(os.path.join(REPO, path)) as f:
        config = json.load(f)
    config["_log_name"] = "ignored"
    config["NeuralNetwork"]["Training"]["num_epoch"] = 99  # volatile
    got = port.ckpt.config_fingerprint(config)
    assert got == jckpt.config_fingerprint(config) and len(got) == 16
    config["NeuralNetwork"]["Training"]["batch_size"] = 3
    assert port.ckpt.config_fingerprint(config) != got


def test_encode_acc_matches_jax(port):
    rng = np.random.default_rng(0)
    acc = (np.float32(rng.normal()), rng.normal(size=3).astype(np.float32),
           np.float32(57.0))
    got = port.ckpt.encode_acc(tuple(port.torch.as_tensor(a) for a in acc))
    assert got == jckpt.encode_acc(acc)
    dec = port.ckpt.decode_acc(got)
    for a, b in zip(dec, acc):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert port.ckpt.encode_acc(None) is None and port.ckpt.decode_acc(None) is None
    keys = set(port.ckpt.build_manifest(epoch=1, step=2))
    assert keys == set(jckpt.build_manifest(epoch=1, step=2))


def test_drop_consumed_groups_matches_jax(port, capsys):
    groups = [[("a", 1), ("b", 1)], [("c", 1), ("d", 1)], [("e", 1)]]
    for skip in range(6):
        assert port.loader.drop_consumed_groups(groups, skip) == \
            jloader.drop_consumed_groups(groups, skip)
    assert "lands inside a superstep group" in capsys.readouterr().out


def _graphs(n, seed):
    """(port samples, JAX samples) of the same random graphs; y_graph
    names each sample."""
    rng = np.random.default_rng(seed)
    out = ([], [])
    for i in range(n):
        nodes = int(rng.integers(3, 14))
        e = int(rng.integers(nodes, 4 * nodes))
        arrays = dict(x=rng.normal(size=(nodes, 2)).astype(np.float32),
                      pos=rng.normal(size=(nodes, 3)).astype(np.float32),
                      edge_index=rng.integers(0, nodes, size=(2, e)).astype(np.int64),
                      y_graph=np.asarray([i], np.float32))
        for lst, cls in zip(out, (None, jgraph.GraphSample)):
            lst.append(cls(**arrays) if cls else arrays)
    return out


def _delivered(items):
    """Each delivery's samples and padded shape, per step."""
    rows = []
    for it in items:
        if hasattr(it, "batches"):  # the port's MacroBatch
            steps = it.batches
        elif hasattr(it, "k"):  # the JAX package's stacked MacroBatch
            b = it.batch
            steps = [types.SimpleNamespace(**{f: np.asarray(getattr(b, f))[j]
                                              for f in ("y_graph", "graph_mask", "x")})
                     for j in range(it.k)]
        else:
            steps = [it]
        rows.append([(np.asarray(s.y_graph)[np.asarray(s.graph_mask)].reshape(-1).tolist(),
                      tuple(np.asarray(s.x).shape)) for s in steps])
    return rows


@pytest.mark.parametrize("packing,k", [(False, 1), (True, 1), (True, 2), (False, 2)])
def test_skip_to_suffix_matches_jax(port, packing, k):
    """A cursor of half the epoch's steps: the port's and the JAX
    loader's resumed deliveries hold the same samples in the same
    shapes, and they are the whole epoch's tail."""
    arrays, jsamples = _graphs(64, seed=5)
    tsamples = [port.graph.GraphSample(**a) for a in arrays]

    def loaders():
        t = port.loader.GraphLoader(tsamples, 4, shuffle=True, seed=3, packing=packing,
                                    with_segment_plan=False, fixed_pad=False)
        j = jloader.GraphLoader(jsamples, 4, shuffle=True, seed=3, packing=packing,
                                fixed_pad=False)
        if k > 1:
            return (port.loader.SuperstepLoader(t, k),
                    jloader.SuperstepLoader(j, k, to_device=False))
        return t, j

    t, j = loaders()
    t.set_epoch(1)
    whole = _delivered(t)
    steps = sum(len(d) for d in whole)
    cut = [sum(len(d) for d in whole[:i]) for i in range(len(whole))]
    skip = cut[len(cut) // 2]
    t, j = loaders()
    for ld in (t, j):
        ld.set_epoch(1)
        ld.skip_to(skip)
    got, want = _delivered(t), _delivered(j)
    assert got == want and got == whole[len(cut) // 2:]
    assert sum(len(d) for d in got) == steps - skip
    t.set_epoch(2)  # an unused cursor does not outlive its epoch
    t.skip_to(3)
    t.set_epoch(2)
    fresh, _ = loaders()
    fresh.set_epoch(2)
    assert _delivered(t) == _delivered(fresh)


def test_dp_loader_skip_to_delivers_the_tail(port):
    arrays, _ = _graphs(30, seed=6)
    samples = [port.graph.GraphSample(**a) for a in arrays]
    mesh = types.SimpleNamespace(data=2, slot=lambda: 1)
    for k in (1, 3):
        ld = port.dp.DPLoader(port.loader.GraphLoader(samples, 4, shuffle=True, seed=1,
                                                      with_segment_plan=False), mesh, k)
        ld.set_epoch(0)
        whole = _delivered(ld)
        cut = [sum(len(d) for d in whole[:i]) for i in range(len(whole) + 1)]
        for i in (1, len(whole) - 1, len(whole)):
            ld.set_epoch(0)
            ld.skip_to(cut[i])
            assert _delivered(ld) == whole[i:]


def _batch_fields(batch) -> list:
    import dataclasses

    return [(f.name, None if getattr(batch, f.name) is None
             else np.asarray(getattr(batch, f.name)))
            for f in dataclasses.fields(batch)]


def _same_field(fa, fb) -> bool:
    (na, va), (nb, vb) = fa, fb
    if na != nb or (va is None) != (vb is None):
        return False
    return va is None or (va.dtype == vb.dtype and np.array_equal(va, vb))


def _same_batches(a, b) -> bool:
    """Every field of every batch equal, dtype and bits."""
    return len(a) == len(b) and all(
        _same_field(fa, fb)
        for x, y in zip(a, b) for fa, fb in zip(_batch_fields(x), _batch_fields(y)))


def test_multibranch_loader_skip_to(port):
    """Each slot of a two-branch ``MultiBranchLoader`` (shuffled, spec
    schedule "auto"): ``skip_to(3)`` delivers the whole epoch's batches
    from step 3 on, every field bit for bit; the next epoch iterates
    whole; the manifest's lockstep list ``[2, 2]`` is taken and a drifted
    ``[2, 3]`` raises; ``set_epoch`` clears an armed cursor."""
    from hydragnn_tpu_torch.parallel.multibranch import MultiBranchLoader

    arrays, _ = _graphs(40, seed=8)
    branches = [[port.graph.GraphSample(**a) for a in arrays[:24]],
                [port.graph.GraphSample(**a) for a in arrays[24:]]]
    for slot in (0, 1):
        def loader():
            return MultiBranchLoader(branches, (1, 1), 4, slot, seed=2, variable_pad="auto")

        ld = loader()
        ld.set_epoch(1)
        whole = list(ld)
        assert len(whole) == 4
        ld.set_epoch(1)
        ld.skip_to(3)
        assert _same_batches(list(ld), whole[3:])
        fresh = loader()
        fresh.set_epoch(1)
        fresh.skip_to([1, 1])
        assert _same_batches(list(fresh), whole[1:])
        ld.set_epoch(2)
        assert len(list(ld)) == len(whole)
        ld.skip_to([2, 2])
        assert ld._skip_next == 2
        with pytest.raises(ValueError, match="lockstep"):
            ld.skip_to([2, 3])
        ld.set_epoch(1)
        assert ld._skip_next == 0 and _same_batches(list(ld), whole)
    assert port.loader.feed_supports_skip(ld)


def test_manifest_branch_steps_round_trip(port, tmp_path, monkeypatch):
    """``build_manifest``'s ``branch_steps`` as the JAX package records
    it, and through the writer's container in both formats: ``[7, 7,
    7]`` back as saved, None without (tests/test_durability.py:875)."""
    monkeypatch.chdir(tmp_path)
    got = port.ckpt.build_manifest(epoch=2, step=7, branch_steps=(7, 7, 7))
    want = jckpt.build_manifest(epoch=2, step=7, branch_steps=(7, 7, 7))
    assert set(got) == set(want) and got["branch_steps"] == want["branch_steps"] == [7, 7, 7]
    for fmt in ("pt", "orbax"):
        for name, bs in ((f"mb_{fmt}", [7, 7, 7]), (f"single_{fmt}", None)):
            w = port.ckpt.CheckpointWriter(name, async_enabled=False, fmt=fmt)
            w.save(_state(port, 1), kind="auto", epoch=2, step=7, branch_steps=bs)
            w.close()
            _, manifest = port.ckpt.load_resume_checkpoint(name, _state(port, 0), fmt=fmt)
            assert manifest["branch_steps"] == bs and manifest["format"] == fmt
            assert manifest["step"] == 7


# ---------------------------------------------------------------- the writer


def _state(port, seed=0, nan=False):
    torch = port.torch
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 1))
    if nan:
        with torch.no_grad():
            model[0].weight[0, 0] = float("nan")
    opt = port.optimizer.select_optimizer(model.parameters(), {"type": "AdamW"})
    return port.state.TrainState(model, opt, step=seed)


def _restored(port, log_name, path=None):
    st = _state(port, seed=99)
    blob = port.torch.load(path or os.path.join("logs", log_name, "resume.pt"),
                           weights_only=True)
    port.ckpt._restore_blob(st, blob)
    return st, blob.get("manifest")


def _same_params(port, a, b):
    return all(port.torch.equal(x, y) for x, y in
               zip(a.model.state_dict().values(), b.model.state_dict().values()))


def test_writer_retries_then_surfaces_exhaustion(port, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w = port.ckpt.CheckpointWriter("run", retries=3, backoff_s=0.001)
    port.faults.install("write_fail:resume:2")
    a = _state(port, 1)
    w.save(a, epoch=0, step=5, acc=(port.torch.tensor(1.5), port.torch.ones(2),
                                    port.torch.tensor(3.0)))
    w.wait()
    assert w.last_error is None and w.retried == 2 and w.saves == 1
    st, manifest = _restored(port, "run")
    assert _same_params(port, st, a) and st.step == 1 and int(st.step_t) == 1
    assert manifest["step"] == 5 and manifest["acc"]["n_graphs"] == 0x40400000
    w2 = port.ckpt.CheckpointWriter("run", retries=1, backoff_s=0.001)
    port.faults.install("write_fail:resume:5")
    w2.save(_state(port, 2), epoch=0, step=9)
    w2.close()
    assert isinstance(w2.last_error, OSError) and w2.saves == 0
    st, manifest = _restored(port, "run")  # the previous container stands
    assert _same_params(port, st, a) and manifest["step"] == 5
    assert not any(n.endswith(".pt") and n != "resume.pt" for n in os.listdir("logs/run"))


def test_writer_validate_finite_gate(port, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    w = port.ckpt.CheckpointWriter("run", async_enabled=False)
    w.save(_state(port, 1, nan=True), kind="final", epoch=1)
    assert w.rejected_saves == 1 and w.last_error is None and not os.path.exists("logs/run")
    assert "REJECTED" in capsys.readouterr().out
    assert port.ckpt.nonfinite_leaves({"model": _state(port, 1, nan=True).model.state_dict()}) \
        == [("['model']['0.weight']", 1, 32)]
    off = port.ckpt.CheckpointWriter("run", async_enabled=False, validate_finite=False)
    off.save(_state(port, 1, nan=True), kind="final", epoch=1)
    assert off.rejected_saves == 0 and os.path.exists("logs/run/checkpoint.pt")


def test_writer_backpressure(port, tmp_path, monkeypatch):
    """One write in flight: the first save returns at once while its
    slow write runs; the next waits for it."""
    monkeypatch.chdir(tmp_path)
    port.faults.install("slow_write:resume:0.4:1")
    w = port.ckpt.CheckpointWriter("run")
    t0 = time.perf_counter()
    w.save(_state(port, 1), epoch=0, step=1)
    first = time.perf_counter() - t0
    w.save(_state(port, 2), epoch=0, step=2)
    second = time.perf_counter() - t0
    w.close()
    assert first < 0.2 <= second and w.saves == 2
    assert _restored(port, "run")[1]["step"] == 2


def test_writer_crash_mid_container_keeps_previous(port, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w = port.ckpt.CheckpointWriter("run")
    a = _state(port, 1)
    w.save(a, kind="epoch", epoch=1, label_epoch=0)
    w.wait()
    port.faults.install("crash:write_tmp:1")
    w.save(_state(port, 2), kind="epoch", epoch=2, label_epoch=1)
    w.close()
    assert isinstance(w.last_error, port.faults.InjectedCrash)
    assert os.path.exists("logs/run/resume.pt.tmp")  # the truncated write
    st, manifest = _restored(port, "run")
    assert _same_params(port, st, a) and manifest["epoch"] == 1
    assert sorted(n for n in os.listdir("logs/run") if not n.endswith(".tmp")) == [
        "checkpoint.pt", "checkpoint_epoch0.pt", "resume.pt"]


def test_writer_epoch_files_and_pruning(port, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w = port.ckpt.CheckpointWriter("run", keep=2)
    states = [_state(port, s) for s in range(4)]
    for e, st in enumerate(states):
        w.save(st, kind="epoch", epoch=e + 1, label_epoch=e)
    w.save(states[0], kind="auto", epoch=4, step=3)
    w.close()
    files = sorted(os.listdir("logs/run"))
    assert files == ["checkpoint.pt", "checkpoint_epoch2.pt", "checkpoint_epoch3.pt",
                     "resume.pt"]
    assert os.stat("logs/run/checkpoint.pt").st_ino == os.stat(
        "logs/run/checkpoint_epoch3.pt").st_ino
    st = port.ckpt.load_checkpoint("run", _state(port, 9))
    assert _same_params(port, st, states[3]) and st.step == 3
    assert _restored(port, "run")[1]["step"] == 3
    assert w.bytes_written > 0 and len(w.snapshot_ms) == 5 and w.stats()["saves"] == 5


def test_find_continue_log_name_checks_fingerprint(port, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for name, fp in (("run_e3", "aaaa"), ("run_e5", "bbbb")):
        w = port.ckpt.CheckpointWriter(name, fingerprint=fp)
        w.save(_state(port, 1), kind="final", epoch=1)
        w.close()
    os.utime("logs/run_e3", (1, 1))
    find = port.ckpt.find_continue_log_name
    assert find("run_e9", fingerprint="aaaa") == "run_e3"
    assert "not adopting 'run_e5'" in capsys.readouterr().out
    assert find("run_e9", fingerprint="cccc") == "run_e9"
    assert find("run_e9", preferred="run_e5", fingerprint="bbbb") == "run_e5"
    assert find("run_e9") == "run_e5"  # no fingerprint: the newest sibling
    assert port.ckpt._peek_fingerprint("run_e3") == "aaaa"


# ---------------------------------------------------------------- preemption

CHILD = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from hydragnn_tpu_torch import runner
runner.run_training(json.load(open("config.json")), device="cpu")
"""


def _drill_config(data, **training):
    with open(os.path.join(HERE, "inputs", "ci.json")) as f:
        config = json.load(f)
    config["Dataset"]["path"] = {"total": data}
    t = config["NeuralNetwork"]["Training"]
    t.update(num_epoch=2, batch_size=4,
             Checkpoint={"enabled": True, "async": True, "interval_steps": 2}, **training)
    return config


def _fingerprint(port, state, hist):
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = [v.clone() for s in state.optimizer.state.values() for v in s.values()]
    return sd, opt, (hist.train_loss, hist.val_loss, hist.test_loss, hist.lr)


def test_kill_and_continue_bit_for_bit(port, tmp_path, monkeypatch):
    """Two epochs of ci.json's SchNet (batch 4: 5 steps an epoch on 20
    train graphs), containers every 2 steps. A child process running it
    is killed by SIGKILL at its 10th step, the last of epoch 2: the save
    at cursor (1, 4) waited for the one at (1, 2), so a mid-epoch
    container is on disk. ``continue`` of its run here equals the
    uninterrupted run bit for bit."""
    torch = port.torch
    monkeypatch.chdir(tmp_path)
    port.synthetic.deterministic_graph_data("data", number_configurations=28, seed=4)
    os.makedirs("base")
    monkeypatch.chdir("base")
    state, _, _, hist, _ = port.runner.run_training(_drill_config("../data"), device="cpu")
    want = _fingerprint(port, state, hist)
    assert state.step == 10
    monkeypatch.chdir(tmp_path)
    os.makedirs("drill")
    monkeypatch.chdir("drill")
    with open("config.json", "w") as f:
        json.dump(_drill_config("../data"), f)
    env = dict(os.environ, HYDRAGNN_TPU_FAULTS="kill:train_step:10", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CHILD.format(repo=REPO)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-3000:]
    run = os.listdir("logs")[0]
    blob = torch.load(os.path.join("logs", run, "resume.pt"), weights_only=True)
    assert blob["manifest"]["epoch"] == 1 and blob["manifest"]["step"] in (2, 4)
    state, _, _, hist, _ = port.runner.run_training(
        _drill_config("../data", **{"continue": 1}), device="cpu")
    got = _fingerprint(port, state, hist)
    assert got[2] == want[2]
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert state.step == 10 and int(state.step_t) == 10


# ---------------------------------------------------------------- compatibility


def test_pr6_checkpoint_restores_and_continues_from_epoch_0(port, tmp_path, monkeypatch,
                                                            capsys):
    """A synchronous checkpoint (no manifest: the format before it) restores
    through run_prediction(config) and continues as a loud epoch-0
    restart from its weights; the writer's containers restore through
    run_prediction(config) with the manifest ignored."""
    monkeypatch.chdir(tmp_path)
    port.synthetic.deterministic_graph_data("data", number_configurations=28, seed=4)
    config = _drill_config("../data")
    config["NeuralNetwork"]["Training"]["num_epoch"] = 1
    os.makedirs("w")
    monkeypatch.chdir("w")
    state, model, cfg, hist, full = port.runner.run_training(config, device="cpu")
    log = full["_log_name"]
    blob = port.torch.load(os.path.join("logs", log, "checkpoint.pt"), weights_only=True)
    assert blob["manifest"]["epoch"] == 1 and blob["manifest"]["step"] == 0
    want = port.runner.run_prediction(full, state=state, model=model, cfg=cfg)
    got = port.runner.run_prediction(full, device="cpu")
    assert got[0] == want[0]
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)
    # the same run's state rewritten as a synchronous checkpoint alone
    for name in os.listdir(os.path.join("logs", log)):
        if name.endswith(".pt"):
            os.remove(os.path.join("logs", log, name))
    port.ckpt.save_checkpoint(log, state)
    assert "manifest" not in port.torch.load(os.path.join("logs", log, "checkpoint.pt"),
                                             weights_only=True)
    again = port.runner.run_prediction(full, device="cpu")
    assert again[0] == want[0]
    cont = dict(full, NeuralNetwork=dict(full["NeuralNetwork"]))
    cont["NeuralNetwork"]["Training"] = dict(full["NeuralNetwork"]["Training"], **{"continue": 1})
    capsys.readouterr()
    st2, _, _, hist2, _ = port.runner.run_training(cont, device="cpu")
    assert "without a resume manifest; restarting from epoch 0" in capsys.readouterr().out
    assert len(hist2.train_loss) == 1 and st2.step == 2 * state.step


def test_walltime_stop_then_continue(port, tmp_path, monkeypatch):
    """A job deadline inside ``walltime_min_seconds_left`` stops the run
    after its first epoch with a save; ``continue`` after the deadline is
    lifted runs the second epoch, equal to the uninterrupted run bit for
    bit."""
    torch = port.torch
    monkeypatch.chdir(tmp_path)
    port.synthetic.deterministic_graph_data("data", number_configurations=28, seed=4)
    os.makedirs("base")
    monkeypatch.chdir("base")
    state, _, _, hist, _ = port.runner.run_training(_drill_config("../data"), device="cpu")
    want = _fingerprint(port, state, hist)
    monkeypatch.chdir(tmp_path)
    os.makedirs("stop")
    monkeypatch.chdir("stop")
    monkeypatch.setenv("HYDRAGNN_WALLCLOCK_DEADLINE", str(time.time() + 60))
    _, _, _, hist, _ = port.runner.run_training(_drill_config("../data"), device="cpu")
    assert len(hist.train_loss) == 1
    monkeypatch.delenv("HYDRAGNN_WALLCLOCK_DEADLINE")
    state, _, _, hist, _ = port.runner.run_training(
        _drill_config("../data", **{"continue": 1}), device="cpu")
    got = _fingerprint(port, state, hist)
    assert got[2] == want[2]
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
