"""The port's synchronous checkpoints (``utils/checkpoint.py``) and
``run_prediction(config)`` restoring them, on the CPU (torch only).

- ``save_checkpoint``/``load_checkpoint`` round-trip a trained state bit
  for bit: parameters, running statistics, AdamW's moments and steps;
- a corrupt or missing ``latest`` falls back to the newest restorable
  epoch file, with a warning; an explicit epoch that is missing raises;
- ``keep`` prunes to the newest epoch files;
- ``find_continue_log_name`` resolves the run directory;
- a small ``run_training`` of polymers.json (its SAGE with the conv node
  head, full width, on 48 of the example's chains, ``Training.
  Checkpoint`` on), then ``run_prediction(config)`` with nothing else
  given equals the in-process prediction bit for bit;
- the sharded format (``checkpoint_format: "orbax"``), in one process,
  as the JAX package's drills run it (tests/test_durability.py): a crash
  between the two renames leaves ``final.old``, which the load falls
  back to and the next save sweeps; a stale ``LATEST`` falls back, an
  explicit missing epoch raises; the writer's ``autosave`` behind
  ``RESUME`` with its manifest, its ``.old`` after a crash between the
  renames, and a non-finite state refused with the pointers kept;
  ``keep`` pruning ``epoch_*``;
- ``continue`` is no longer refused for the sharded format, nor the
  parallel input pipeline: a run writing the format through two
  collation workers, continued, and ``run_prediction(config)`` restoring
  it (the writer, the manifest and ``continue`` itself are
  tests/test_torch_durability.py's); a dataset format other than the raw
  LSMS text is refused with ROADMAP item 10c.
"""

import os

import numpy as np
import pytest

from tests import _torch_polymers


@pytest.fixture(scope="module")
def port():
    """torch and the port's modules, imported when this file runs rather
    than at collection."""
    import types

    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import config, runner
    from hydragnn_tpu_torch.data import loader
    from hydragnn_tpu_torch.models import create
    from hydragnn_tpu_torch.train import loop, optimizer
    from hydragnn_tpu_torch.utils import checkpoint

    return types.SimpleNamespace(torch=torch, config=config, runner=runner, loader=loader,
                                 create=create, loop=loop, optimizer=optimizer,
                                 ckpt=checkpoint)


@pytest.fixture(scope="module")
def splits(port):
    return _torch_polymers.polymer_splits(48)


def _config(epochs=2):
    config = _torch_polymers.polymer_config()
    config["NeuralNetwork"]["Training"]["num_epoch"] = epochs
    config["Verbosity"] = {"level": 0}
    return config


def _trained_state(port, splits, steps=2):
    """polymers.json's model after ``steps`` AdamW steps on the CPU."""
    config = port.config.update_config(_config(), *splits)
    model, cfg = port.create.create_model_config(config, "cpu", seed=0)
    training = config["NeuralNetwork"]["Training"]
    opt = port.optimizer.select_optimizer(model.parameters(), training)
    state = port.loop.TrainState(model, opt)
    step = port.loop.make_train_step(model, opt, cfg)
    for batch, _ in zip(port.loader.GraphLoader(splits[0], 8), range(steps)):
        step(state, batch)
    return state, config


def _fresh_state(port, config, seed=5):
    model, _ = port.create.create_model_config(config, "cpu", seed=seed)
    opt = port.optimizer.select_optimizer(model.parameters(),
                                          config["NeuralNetwork"]["Training"])
    return port.loop.TrainState(model, opt)


def _assert_same_state(port, got, want):
    torch = port.torch
    sd_g, sd_w = got.model.state_dict(), want.model.state_dict()
    assert set(sd_g) == set(sd_w)
    for k in sd_w:
        assert torch.equal(sd_g[k], sd_w[k]), k
    og, ow = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert og["param_groups"] == ow["param_groups"]
    assert set(og["state"]) == set(ow["state"]) and ow["state"]
    for i, st in ow["state"].items():
        for k, v in st.items():
            assert torch.equal(og["state"][i][k], v), (i, k)
    assert got.step == want.step


def test_save_load_round_trip(port, splits, tmp_path, monkeypatch):
    """A trained state (batch-norm statistics moved, AdamW state
    present) saved and loaded into a freshly initialized one, bit for
    bit, from ``latest`` and from its epoch file."""
    monkeypatch.chdir(tmp_path)
    state, config = _trained_state(port, splits)
    state.step = 2
    path = port.ckpt.save_checkpoint("run", state, epoch=3)
    assert path.endswith(os.path.join("run", "checkpoint_epoch3.pt"))
    assert sorted(os.listdir("logs/run")) == ["checkpoint.pt", "checkpoint_epoch3.pt"]
    for epoch in (None, 3):
        fresh = _fresh_state(port, config)
        assert not port.torch.equal(next(fresh.model.parameters()),
                                    next(state.model.parameters()))
        _assert_same_state(port, port.ckpt.load_checkpoint("run", fresh, epoch=epoch), state)
    assert port.ckpt.checkpoint_exists("run") and not port.ckpt.checkpoint_exists("other")


def test_corrupt_latest_falls_back(port, splits, tmp_path, monkeypatch, capsys):
    """A truncated ``latest`` and then a missing one both restore the
    newest epoch file that loads (a corrupt newer one is skipped), with
    a warning; an explicit missing epoch, or no file at all, raises."""
    monkeypatch.chdir(tmp_path)
    state, config = _trained_state(port, splits, steps=1)
    port.ckpt.save_checkpoint("run", state, epoch=0)
    state2, _ = _trained_state(port, splits, steps=2)
    port.ckpt.save_checkpoint("run", state2, epoch=1)
    port.ckpt.save_checkpoint("run", state2, epoch=2)
    with open("logs/run/checkpoint_epoch2.pt", "wb") as f:
        f.write(b"not a checkpoint")
    latest = "logs/run/checkpoint.pt"
    with open(latest, "rb") as f:
        blob = f.read()
    with open(latest, "wb") as f:
        f.write(blob[: len(blob) // 2])
    got = port.ckpt.load_checkpoint("run", _fresh_state(port, config))
    _assert_same_state(port, got, state2)
    out = capsys.readouterr().out
    assert "not restorable" in out and "falling back to" in out and "epoch1" in out
    os.remove(latest)
    _assert_same_state(port, port.ckpt.load_checkpoint("run", _fresh_state(port, config)),
                       state2)
    with pytest.raises(FileNotFoundError):
        port.ckpt.load_checkpoint("run", _fresh_state(port, config), epoch=7)
    with pytest.raises(FileNotFoundError, match="No restorable checkpoint"):
        port.ckpt.load_checkpoint("nothing", _fresh_state(port, config))


def test_keep_prunes_epoch_files(port, splits, tmp_path, monkeypatch):
    """``keep`` leaves the newest per-epoch files (by epoch number, not
    by name order), and 0 keeps them all."""
    monkeypatch.chdir(tmp_path)
    state, _ = _trained_state(port, splits, steps=1)
    for epoch in (2, 9, 10, 11):
        port.ckpt.save_checkpoint("all", state, epoch=epoch)
        port.ckpt.save_checkpoint("pruned", state, epoch=epoch, keep=2)
    assert sorted(os.listdir("logs/pruned")) == [
        "checkpoint.pt", "checkpoint_epoch10.pt", "checkpoint_epoch11.pt"]
    assert len(os.listdir("logs/all")) == 5
    assert not any(n.endswith(".tmp") for n in os.listdir("logs/all"))


def test_find_continue_log_name(port, splits, tmp_path, monkeypatch, capsys):
    """The derived name when it has checkpoints; else the newest sibling
    differing only in ``_e<N>`` that has checkpoints (with a warning);
    else the derived name."""
    monkeypatch.chdir(tmp_path)
    find = port.ckpt.find_continue_log_name
    state, _ = _trained_state(port, splits, steps=1)
    assert find("poly_SAGE_e10") == "poly_SAGE_e10"
    port.ckpt.save_checkpoint("poly_SAGE_e3", state)
    port.ckpt.save_checkpoint("poly_SAGE_e5", state)
    os.utime("logs/poly_SAGE_e3", (1, 1))
    os.makedirs("logs/poly_SAGE_e7")  # newest, but holds no checkpoint
    assert find("poly_SAGE_e10") == "poly_SAGE_e5"
    assert "using 'poly_SAGE_e5'" in capsys.readouterr().out
    assert find("poly_SAGE_e3") == "poly_SAGE_e3"
    port.ckpt.save_checkpoint("poly_SAGE_e10", state)
    assert find("poly_SAGE_e10") == "poly_SAGE_e10"


def test_run_prediction_restores_checkpoint(port, splits, tmp_path, monkeypatch):
    """polymers.json trained 2 epochs on the CPU with Checkpoint on
    (epoch files on improvement, ``latest`` at the end), then
    run_prediction given only the config (the returned one, and a fresh
    one naming another num_epoch) and the data: predictions, errors and
    the restored tensors equal the in-process run's bit for bit. Without
    a card and without device="cpu" it raises."""
    monkeypatch.chdir(tmp_path)
    config = _config(2)
    config["NeuralNetwork"]["Training"]["Checkpoint"] = True
    state, model, cfg, hist, full = port.runner.run_training(config, datasets=splits,
                                                             device="cpu")
    files = os.listdir(os.path.join("logs", full["_log_name"]))
    assert "checkpoint.pt" in files and "checkpoint_epoch0.pt" in files
    want = port.runner.run_prediction(full, datasets=splits, state=state, model=model,
                                      cfg=cfg)
    got = port.runner.run_prediction(full, datasets=splits, device="cpu")
    renamed = _config(4)  # derives <name>_e4: no such run, so the _e2 sibling
    again = port.runner.run_prediction(renamed, datasets=splits, device="cpu")
    for res in (got, again):
        assert res[0] == want[0]
        np.testing.assert_array_equal(res[1], want[1])
        for a, b in zip(res[2] + res[3], want[2] + want[3]):
            np.testing.assert_array_equal(a, b)
    assert want[3][1].shape == (sum(s.num_nodes for s in splits[2]), 1)
    restored = port.runner.restore_checkpoint_state(
        full, port.create.create_model_config(full, "cpu", seed=9)[0])
    _assert_same_state(port, restored, state)
    if not port.torch.cuda.is_available():  # the entry point runs on the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.runner.run_prediction(full, datasets=splits)


def test_continue_still_refused(port, splits, tmp_path, monkeypatch):
    """Only a dataset format neither package reads is refused (every
    format of the JAX package is ported: ROADMAP item 10c), with the JAX
    package's ValueError; a ``continue`` in the sharded format
    through the parallel input pipeline (two collation workers) runs:
    polymers.json for one epoch writing ``orbax/`` (every epoch through
    the writer), continued to two, and ``run_prediction(config)``
    restoring ``final`` equal to the in-process prediction bit for
    bit."""
    monkeypatch.chdir(tmp_path)
    feed = {"Parallelism": {"pipeline": {"workers": 2, "chunk": 1}, "prefetch": 2}}
    refused = _config(1)
    refused["Dataset"] = {"format": "netcdf", "path": {"total": str(tmp_path)}}
    refused["NeuralNetwork"]["Training"].update({"continue": 1, **feed})
    with pytest.raises(ValueError, match="Unknown Dataset.format: netcdf"):
        port.runner.run_training(refused, device="cpu")
    config = _config(1)
    config["NeuralNetwork"]["Training"].update(
        checkpoint_format="orbax", Checkpoint={"enabled": True, "interval_steps": 2}, **feed)
    _, _, _, _, full = port.runner.run_training(config, datasets=splits, device="cpu")
    base = os.path.join("logs", full["_log_name"], "orbax")
    assert {"LATEST", "RESUME", "final", "epoch_0"} <= set(os.listdir(base))
    assert not os.path.exists(os.path.join("logs", full["_log_name"], "checkpoint.pt"))
    config = _config(2)
    config["NeuralNetwork"]["Training"].update(
        checkpoint_format="orbax", Checkpoint={"enabled": True, "interval_steps": 2},
        **{"continue": 1}, **feed)
    state, model, cfg, hist, full = port.runner.run_training(config, datasets=splits,
                                                             device="cpu")
    assert len(hist.train_loss) == 2 and state.step > 0
    want = port.runner.run_prediction(full, datasets=splits, state=state, model=model,
                                      cfg=cfg)
    got = port.runner.run_prediction(full, datasets=splits, device="cpu")
    assert got[0] == want[0]
    for a, b in zip(got[2] + got[3], want[2] + want[3]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the sharded format


def _small_state(port, seed, nan=False):
    """A two-layer model after one AdamW step, at step count ``seed``."""
    torch = port.torch
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 1))
    opt = port.optimizer.select_optimizer(model.parameters(), {"type": "AdamW"})
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    if nan:
        with torch.no_grad():
            model[0].weight[1, 1] = float("nan")
    return port.loop.TrainState(model, opt, step=seed)


def test_sharded_crash_between_replaces_falls_back_to_old(port, tmp_path, monkeypatch,
                                                           capsys):
    """A kill between the two renames (``crash:orbax_between_replaces``)
    leaves no ``final`` and a ``final.old``: the load restores it, with a
    warning, and the next save sweeps it (tests/test_durability.py:163)."""
    from hydragnn_tpu_torch.utils import faults

    monkeypatch.chdir(tmp_path)
    a, b = _small_state(port, 1), _small_state(port, 2)
    port.ckpt.save_checkpoint_sharded("run", a)
    faults.install("crash:orbax_between_replaces:1")
    try:
        with pytest.raises(faults.InjectedCrash):
            port.ckpt.save_checkpoint_sharded("run", b)
    finally:
        faults.reset()
    base = os.path.join("logs", "run", "orbax")
    assert not os.path.isdir(os.path.join(base, "final"))
    assert os.path.isdir(os.path.join(base, "final.old"))
    _assert_same_state(port, port.ckpt.load_checkpoint_sharded("run", _small_state(port, 9)),
                       a)
    assert "falling back" in capsys.readouterr().out
    port.ckpt.save_checkpoint_sharded("run", b)
    assert not os.path.isdir(os.path.join(base, "final.old"))
    _assert_same_state(port, port.ckpt.load_checkpoint("run", _small_state(port, 9),
                                                       fmt="orbax"), b)
    assert sorted(os.listdir(os.path.join(base, "final"))) == ["meta.json", "rank0.pt"]


def test_sharded_stale_latest_and_keep(port, tmp_path, monkeypatch, capsys):
    """A ``LATEST`` naming a directory a crash never wrote falls back to
    the newest restorable one, with a warning; a corrupt one is skipped;
    an explicit missing epoch raises (tests/test_durability.py:186);
    ``keep`` prunes ``epoch_*`` to the newest."""
    monkeypatch.chdir(tmp_path)
    states = [_small_state(port, s) for s in (1, 2, 3)]
    for e, st in zip((2, 9, 10), states):
        port.ckpt.save_checkpoint_sharded("run", st, epoch=e, keep=2)
    base = os.path.join("logs", "run", "orbax")
    assert sorted(os.listdir(base)) == ["LATEST", "epoch_10", "epoch_9"]
    port.ckpt._write_pointer(base, "LATEST", "epoch_99")
    with open(os.path.join(base, "epoch_10", "rank0.pt"), "wb") as f:
        f.write(b"not a shard")
    os.utime(os.path.join(base, "epoch_9"), (1, 1))
    got = port.ckpt.load_checkpoint_sharded("run", _small_state(port, 8))
    _assert_same_state(port, got, states[1])
    out = capsys.readouterr().out
    assert "LATEST pointer targets missing dir" in out and "not restorable" in out
    with pytest.raises(FileNotFoundError):
        port.ckpt.load_checkpoint_sharded("run", _small_state(port, 8), epoch=4)


def test_sharded_writer_resume_pointer_and_finite_gate(port, tmp_path, monkeypatch, capsys):
    """The writer in the sharded format: ``autosave`` behind ``RESUME``
    restores with its manifest (tests/test_durability.py:352); after a
    crash between the renames the resume takes ``autosave.old`` with its
    cursor intact; a non-finite state is refused and the pointers keep
    naming the good directory (:453)."""
    from hydragnn_tpu_torch.utils import faults

    monkeypatch.chdir(tmp_path)
    a = _small_state(port, 1)
    w = port.ckpt.CheckpointWriter("run", fmt="orbax", async_enabled=False)
    w.save(a, kind="auto", epoch=3, step=2, branch_steps=[2, 2, 2])
    st, manifest = port.ckpt.load_resume_checkpoint_sharded("run", _small_state(port, 9))
    assert (manifest["epoch"], manifest["step"], manifest["branch_steps"]) == (3, 2, [2, 2, 2])
    assert manifest["format"] == "orbax"
    _assert_same_state(port, st, a)
    faults.install("crash:orbax_between_replaces:1")
    w.save(_small_state(port, 2), kind="auto", epoch=3, step=4)
    faults.reset()
    assert isinstance(w.last_error, faults.InjectedCrash)
    st, manifest = port.ckpt.load_resume_checkpoint("run", _small_state(port, 9), fmt="orbax")
    assert manifest["step"] == 2 and "autosave.old" in capsys.readouterr().out
    _assert_same_state(port, st, a)
    w.save(_small_state(port, 3, nan=True), kind="final", epoch=4)
    w.close()
    assert w.rejected_saves == 1 and "REJECTED" in capsys.readouterr().out
    base = os.path.join("logs", "run", "orbax")
    assert not os.path.exists(os.path.join(base, "final"))
    assert not os.path.exists(os.path.join(base, "LATEST"))
    st, manifest = port.ckpt.load_resume_checkpoint_sharded("run", _small_state(port, 9))
    assert manifest["step"] == 2
    _assert_same_state(port, st, a)


def test_checkpoint_settings(port):
    settings = port.ckpt.checkpoint_settings
    assert not settings({}).enabled
    assert settings({"Checkpoint": True}).enabled
    assert settings({"Checkpoint": {"interval_steps": 5}}).enabled
    assert not settings({"Checkpoint": {"enabled": False}}).enabled
