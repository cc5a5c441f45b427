"""Training gates of the port that the JAX package holds in its own tests
(``slow``, on the CPU):

- tests/test_optimizer_precision_losses.py's bf16 converged-loss leg: a
  tiny SchNet trained 25 epochs with AdamW in bf16 (f32 master
  parameters, bf16 inputs through ``cast_batch``) converges (train loss
  below 0.15 from ~1.3) and lands within 25% (+0.02) of the fp32 run on
  the same seed, on the scatter path and with the block plan (every
  aggregation through K1's and K2's plain versions);
- tests/test_graphs.py:21-35's thresholds for PaiNN (0.60 / 0.60) and
  EGNN (0.20 / 0.20) (head RMSE, sample MAE) on the 300-configuration
  BCC set, trained by ``run_training`` and predicted by
  ``run_prediction(config)`` from the run's checkpoint.
"""

import copy
import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def torch():
    import torch

    torch.set_num_threads(1)
    return torch


def _schnet_samples(n=24, seed=0):
    """tests/test_optimizer_precision_losses.py's synthetic molecules."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        na = int(rng.integers(6, 12))
        pos = rng.uniform(0, 2.0 * na ** (1 / 3), size=(na, 3))
        x = rng.integers(0, 4, size=(na, 1)).astype(np.float32)
        y = float(x.mean() + 0.05 * na)
        out.append(GraphSample(x=x, pos=pos.astype(np.float32),
                               edge_index=radius_graph(pos, 3.0, max_neighbours=12),
                               y_graph=np.array([y], np.float32)))
    return out


def _train_tiny_schnet(torch, precision, epochs=25, seed=0, with_plan=False):
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.loop import _run_epoch, make_superstep_fn
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState, resolve_precision

    samples = _schnet_samples()
    config = {"NeuralNetwork": {
        "Architecture": {
            "mpnn_type": "SchNet", "radius": 3.0, "max_neighbours": 12, "num_gaussians": 8,
            "num_filters": 16, "hidden_dim": 16, "num_conv_layers": 2,
            "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 16,
                                       "num_headlayers": 1, "dim_headlayers": [16]}},
            "task_weights": [1.0],
        },
        "Variables_of_interest": {"input_node_features": [0], "output_names": ["y"],
                                  "output_index": [0], "type": ["graph"], "output_dim": [1]},
        "Training": {"batch_size": 8, "precision": precision,
                     "Optimizer": {"type": "AdamW", "learning_rate": 5e-3}},
    }}
    config = update_config(config, samples)
    training = config["NeuralNetwork"]["Training"]
    param_dtype, compute_dtype = resolve_precision(precision, "cpu")
    loader = GraphLoader(samples, 8, shuffle=True, seed=seed, with_segment_plan=with_plan)
    model, cfg = create_model_config(config, "cpu", seed=seed)
    model.to(param_dtype)
    state = TrainState(model, select_optimizer(model.parameters(), training))
    step = make_superstep_fn(model, state.optimizer, cfg, compute_dtype=compute_dtype,
                             device=torch.device("cpu"))
    loss = float("nan")
    for ep in range(epochs):
        loader.set_epoch(ep)
        state, loss, _ = _run_epoch(step, state, loader, train=True)
    return loss


@pytest.mark.slow
@pytest.mark.parametrize("with_plan", [False, True])
def test_bf16_converged_loss_parity(torch, with_plan):
    loss16 = _train_tiny_schnet(torch, "bf16", with_plan=with_plan)
    loss32 = _train_tiny_schnet(torch, "fp32", with_plan=with_plan)
    assert np.isfinite(loss16) and np.isfinite(loss32)
    assert loss32 < 0.15, loss32
    assert loss16 < 0.15, loss16
    assert abs(loss16 - loss32) <= 0.25 * abs(loss32) + 0.02, (loss16, loss32)


@pytest.mark.slow
@pytest.mark.parametrize("mpnn_type,limits", [("PAINN", (0.60, 0.60)), ("EGNN", (0.20, 0.20))])
def test_trains_to_threshold(torch, mpnn_type, limits, tmp_path, monkeypatch):
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "dataset" / "unit_test")
    deterministic_graph_data(path, number_configurations=300, seed=7)
    with open(os.path.join(ROOT, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    config["Dataset"]["path"] = {"total": path}
    config["NeuralNetwork"]["Architecture"]["mpnn_type"] = mpnn_type
    config["NeuralNetwork"]["Training"]["Parallelism"] = {"scheme": "single"}
    runner.run_training(copy.deepcopy(config), device="cpu")
    _, _, trues, preds = runner.run_prediction(config, device="cpu")
    for t, p in zip(trues, preds):
        rmse, mae = float(np.sqrt(np.mean((t - p) ** 2))), float(np.mean(np.abs(t - p)))
        assert rmse < limits[0] and mae < limits[1], (mpnn_type, rmse, mae)
