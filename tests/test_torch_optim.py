"""The port's nine optimizers (``train/optimizer.py``) against optax.

No model and no JAX compile of a network: fixed numpy parameters and
three steps of fixed numpy gradients go through the JAX package's
``select_optimizer`` (optax, run eagerly) and the port's, with and
without ``clip_grad_norm``; the learning rate is halved with each
package's ``set_learning_rate`` before the third step. The updated
parameters agree at f32 rtol 1e-5, with the atol 1e-5 of each tensor's
largest magnitude: XLA computes optax's ``b ** count`` with its own f32
``pow``, which differs from torch's by a few ulps, and ``1 - 0.999 **
count`` cancels them up to ~2e-5 of Adam's update, so an entry that
moves to near zero misses a bare rtol by ``lr`` x 1e-5.

Also, per optimizer: ``set_learning_rate`` writes into the same device
tensor (a captured step reads it), and the optimizer's state (learning
rate, step count, moments) round-trips through ``save_checkpoint`` /
``load_checkpoint`` bit for bit, into the live tensors.
"""

import numpy as np
import pytest

KINDS = ("SGD", "Adam", "AdamW", "Adadelta", "Adagrad", "Adamax", "RMSprop",
         "LAMB", "FusedLAMB")
# One all-zero parameter exercises LAMB's trust ratio at |p| = 0.
SHAPES = {"w0": (5, 3), "b0": (3,), "w1": (4, 4), "z": (2, 3)}
LR = 0.05
CLIP = 1.0
RTOL = 1e-5


@pytest.fixture(scope="module")
def torch():
    import torch

    torch.set_num_threads(1)
    return torch


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: (np.zeros(s, np.float32) if k == "z"
                else rng.standard_normal(s).astype(np.float32))
            for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _training(kind, clip):
    opt = {"type": kind, "learning_rate": LR}
    if clip:
        opt["clip_grad_norm"] = CLIP
    return {"Optimizer": opt}


def _optax_run(kind, clip):
    import optax

    from hydragnn_tpu.train import optimizer as jopt

    tx = jopt.select_optimizer(_training(kind, clip))
    params = _params()
    state = tx.init(params)
    for t in range(3):
        if t == 2:
            state = jopt.set_learning_rate(state, LR / 2)
        updates, state = tx.update(_grads(t), state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def _port_module(torch, seed=0):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in _params(seed).items()})


def _port_steps(torch, module, opt, steps, clip=0.0, first=0):
    from hydragnn_tpu_torch.train import optimizer as popt

    for t in range(first, first + steps):
        if t == 2:
            popt.set_learning_rate(opt, LR / 2)
        for k, g in _grads(t).items():
            module[k].grad = torch.from_numpy(g)
        if clip:
            popt.clip_by_global_norm_(module.parameters(), clip)
        opt.step()


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clip"])
@pytest.mark.parametrize("kind", KINDS)
def test_three_steps_match_optax(torch, kind, clip):
    from hydragnn_tpu_torch.train import optimizer as popt

    want = _optax_run(kind, clip)
    module = _port_module(torch)
    opt = popt.select_optimizer(module.parameters(), _training(kind, clip))
    _port_steps(torch, module, opt, 3, clip=CLIP if clip else 0.0)
    for k, w in want.items():
        got = module[k].detach().numpy()
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
                                   err_msg=f"{kind} {k}")
        assert not np.array_equal(got, _params()[k]), f"{kind} {k} did not move"


@pytest.mark.parametrize("kind", KINDS)
def test_set_learning_rate_writes_in_place(torch, kind):
    from hydragnn_tpu_torch.train import optimizer as popt

    module = _port_module(torch)
    opt = popt.select_optimizer(module.parameters(), _training(kind, False))
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dim() == 0
    assert popt.get_learning_rate(opt) == np.float32(LR)
    popt.set_learning_rate(opt, 0.02)
    assert opt.param_groups[0]["lr"] is lr
    assert popt.get_learning_rate(opt) == np.float32(0.02)


@pytest.mark.parametrize("kind", KINDS)
def test_state_round_trips_through_checkpoint(torch, kind, tmp_path, monkeypatch):
    from hydragnn_tpu_torch.train import optimizer as popt
    from hydragnn_tpu_torch.train.state import TrainState
    from hydragnn_tpu_torch.utils import checkpoint

    monkeypatch.chdir(tmp_path)
    module = _port_module(torch)
    opt = popt.select_optimizer(module.parameters(), _training(kind, False))
    _port_steps(torch, module, opt, 3)
    checkpoint.save_checkpoint("run", TrainState(module, opt, step=3))

    fresh = _port_module(torch, seed=1)
    f_opt = popt.select_optimizer(fresh.parameters(), _training(kind, False))
    live = [t for g in f_opt.param_groups for t in (g["lr"], g["step"])]
    live += [t for s in f_opt.state.values() for t in s.values()]
    restored = checkpoint.load_checkpoint("run", TrainState(fresh, f_opt))
    assert restored.step == 3
    now = [t for g in f_opt.param_groups for t in (g["lr"], g["step"])]
    now += [t for s in f_opt.state.values() for t in s.values()]
    assert len(now) == len(live) and all(a is b for a, b in zip(now, live))
    got, want = f_opt.state_dict(), opt.state_dict()
    for gg, gw in zip(got["param_groups"], want["param_groups"]):
        assert set(gg) == set(gw)
        for k in gw:
            same = torch.equal(gg[k], gw[k]) if isinstance(gw[k], torch.Tensor) else gg[k] == gw[k]
            assert same, (kind, k)
    assert set(got["state"]) == set(want["state"])
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (kind, i, k)
    for k in SHAPES:
        assert torch.equal(fresh[k], module[k]), (kind, k)
    # The restored optimizer continues as the original does, bit for bit.
    _port_steps(torch, module, opt, 1, first=3)
    _port_steps(torch, fresh, f_opt, 1, first=3)
    for k in SHAPES:
        assert torch.equal(fresh[k], module[k]), (kind, k)
