"""JSON configuration system.

Counterpart of ``hydragnn_tpu/config/config.py`` (``load_config``,
``save_config``, ``merge_config``, ``normalize_output_heads``,
``update_config`` and its helpers), copied: the module is plain Python,
but importing it from the JAX package would run that package's
``__init__`` and with it JAX. A config therefore derives to the same
dict in both packages.

Accepts the same configuration schema as the reference (sections
``Verbosity`` / ``Dataset`` / ``NeuralNetwork.{Architecture,
Variables_of_interest, Training}`` / ``Visualization``; documented example
/root/reference/tests/inputs/ci.json) and reimplements the defaulting /
derivation pass of ``update_config`` (reference:
hydragnn/utils/input_config_parsing/config_utils.py:26-163) plus
``merge_config`` (config_utils.py:388) and ``save_config``
(config_utils.py:360) — against this framework's dataset objects instead
of torch dataloaders.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np

# Architecture keys that default to None when absent (mirrors the long
# default block in reference config_utils.py:96-148).
_ARCH_NONE_DEFAULTS = (
    "radius",
    "radial_type",
    "distance_transform",
    "num_gaussians",
    "num_filters",
    "envelope_exponent",
    "num_after_skip",
    "num_before_skip",
    "basis_emb_size",
    "int_emb_size",
    "out_emb_size",
    "num_radial",
    "num_spherical",
    "correlation",
    "max_ell",
    "node_max_ell",
    "initial_bias",
    "equivariance",
    "max_neighbours",
)

_EDGE_MODELS = (
    "GAT",
    "PNA",
    "PNAPlus",
    "PAINN",
    "PNAEq",
    "CGCNN",
    "SchNet",
    "EGNN",
    "DimeNet",
    "MACE",
)

_PNA_MODELS = ("PNA", "PNAPlus", "PNAEq")


def load_config(source: str | Mapping[str, Any]) -> dict:
    """Load a config from a JSON file path or pass through a dict."""
    if isinstance(source, str):
        with open(source) as f:
            return json.load(f)
    return copy.deepcopy(dict(source))


def save_config(config: dict, log_name: str, path: str = "./logs/") -> str:
    """Save the (post-update) config next to the run logs (reference:
    config_utils.py:360 save_config)."""
    run_dir = os.path.join(path, log_name)
    os.makedirs(run_dir, exist_ok=True)
    out = os.path.join(run_dir, "config.json")
    with open(out, "w") as f:
        json.dump(config, f, indent=2, default=_json_default)
    return out


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def merge_config(base: dict, override: dict) -> dict:
    """Recursive deep merge; override wins (reference config_utils.py:388)."""
    out = copy.deepcopy(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge_config(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def normalize_output_heads(output_heads: dict) -> dict:
    """Convert legacy single-branch head configs into the multibranch list
    format (reference: update_multibranch_heads,
    hydragnn/utils/model/model.py:314-349).

    Output format per level: list of ``{"type": branch_name,
    "architecture": {...}}``.
    """
    out: dict[str, list] = {}
    for level, cfg in output_heads.items():
        if isinstance(cfg, list):
            out[level] = copy.deepcopy(cfg)
        else:
            out[level] = [
                {"type": "branch-0", "architecture": copy.deepcopy(cfg)}
            ]
    return out


def update_config(
    config: dict,
    train_dataset: Optional[Sequence] = None,
    val_dataset: Optional[Sequence] = None,
    test_dataset: Optional[Sequence] = None,
) -> dict:
    """Fill defaults and derive data-dependent fields.

    The TPU-framework analog of reference ``update_config``
    (config_utils.py:26-163): input/output dims from the dataset, PNA
    degree histograms, MACE average neighbor counts, edge-feature and
    equivariance validation, and ~30 scalar defaults.
    """
    config = copy.deepcopy(config)
    nn = config.setdefault("NeuralNetwork", {})
    arch = nn.setdefault("Architecture", {})
    voi = nn.setdefault("Variables_of_interest", {})
    training = nn.setdefault("Training", {})

    # GPS / positional-encoding defaults.
    arch.setdefault("global_attn_engine", None)
    arch.setdefault("global_attn_type", None)
    arch.setdefault("global_attn_heads", 0)
    arch.setdefault("pe_dim", 0)

    arch["output_heads"] = normalize_output_heads(arch.get("output_heads", {}))

    # Output dims/types from the variables of interest + first sample.
    first = train_dataset[0] if train_dataset is not None and len(train_dataset) else None
    _update_outputs(nn, first)

    arch["input_dim"] = len(voi.get("input_node_features", []))

    # Static per-graph node bound: needed by the GPS dense attention
    # layout and mlp_per_node heads (reference derives num_nodes from the
    # data in update_config, config_utils.py:49-56).
    if arch.get("num_nodes") is None:
        max_n = 0
        for ds in (train_dataset, val_dataset, test_dataset):
            if ds is not None:
                for s in ds:
                    max_n = max(max_n, s.num_nodes)
        if max_n:
            arch["num_nodes"] = int(max_n)

    if arch.get("mpnn_type") in _PNA_MODELS:
        deg = _dataset_attr(train_dataset, "pna_deg")
        if deg is None and train_dataset is not None:
            deg = gather_deg(train_dataset)
        if deg is not None:
            arch["pna_deg"] = list(np.asarray(deg).tolist())
            arch["max_neighbours"] = len(arch["pna_deg"]) - 1
    else:
        arch["pna_deg"] = None

    # CGCNN convolutions preserve dimensionality; without a GPS embedding
    # stage the hidden dim must equal the input dim (reference
    # config_utils.py:77-83).
    if arch.get("mpnn_type") == "CGCNN" and not arch.get("global_attn_engine"):
        arch["hidden_dim"] = arch["input_dim"]

    if arch.get("mpnn_type") == "MACE":
        avg = _dataset_attr(train_dataset, "avg_num_neighbors")
        if avg is None and train_dataset is not None:
            avg = calculate_avg_deg(train_dataset)
        arch["avg_num_neighbors"] = None if avg is None else float(avg)
        # MACE treats the first input column as the atomic number; warn
        # (like the reference's process_node_attributes,
        # MACEStack.py:510-541) when values fall outside 1..118 or are
        # not integer-like — they will be silently clamped at runtime.
        if train_dataset is not None:
            import warnings

            # Bounded sample: O(1) startup regardless of dataset size
            # (the check is advisory; a stride over <=256 samples sees
            # every composition in practice).
            n_ds = len(train_dataset)
            stride = max(n_ds // 256, 1)
            zs = np.concatenate(
                [
                    np.asarray(train_dataset[i].x[:, 0]).reshape(-1)
                    for i in range(0, n_ds, stride)
                ]
            )
            if not np.all(zs == np.round(zs)):
                warnings.warn(
                    "MACE expects integer atomic numbers in data.x[:, 0]; "
                    "found non-integer values."
                )
            if np.any(zs < 1) or np.any(zs > 118):
                warnings.warn(
                    "MACE atomic numbers outside 1..118 will be clamped; "
                    "distinct out-of-range types collapse onto the same "
                    "element embedding."
                )
    else:
        arch["avg_num_neighbors"] = None

    for key in _ARCH_NONE_DEFAULTS:
        arch.setdefault(key, None)
    arch.setdefault("enable_interatomic_potential", False)
    arch.setdefault("freeze_conv_layers", False)
    arch.setdefault("activation_function", "relu")
    arch.setdefault("SyncBatchNorm", False)
    arch.setdefault("graph_pooling", "mean")
    arch.setdefault("dropout", 0.25)
    arch.setdefault("use_graph_attr_conditioning", False)
    arch.setdefault("graph_attr_conditioning_mode", "concat_node")
    arch.setdefault("periodic_boundary_conditions", False)

    # Edge feature validation (reference: update_config_edge_dim).
    if arch.get("edge_features"):
        if arch.get("mpnn_type") not in _EDGE_MODELS:
            raise ValueError(
                f"Edge features are only supported for {_EDGE_MODELS}, "
                f"got {arch.get('mpnn_type')}"
            )
        arch["edge_dim"] = len(arch["edge_features"])
    else:
        arch.setdefault("edge_dim", None)

    # Superstep executor block (consumed by parallel/runtime.py):
    # validate eagerly — a misspelled key here silently reverts the run
    # to per-step dispatch, which only shows up in a trace.
    superstep = training.get("Parallelism", {}).get("superstep")
    if superstep is not None:
        if not isinstance(superstep, dict):
            raise ValueError(
                "Training.Parallelism.superstep must be an object "
                '{"steps": int | "auto", "max_host_bytes": int}'
            )
        unknown = set(superstep) - {"steps", "max_host_bytes"}
        if unknown:
            raise ValueError(
                "Training.Parallelism.superstep: unknown keys "
                f"{sorted(unknown)} (accepted: steps, max_host_bytes)"
            )

    # Run-telemetry block (consumed by utils/telemetry.py): validated
    # eagerly for the same reason as superstep — a misspelled
    # ``sync_interval_steps`` would silently measure nothing.
    tele = training.get("Telemetry")
    if tele is not None and not isinstance(tele, bool):
        if not isinstance(tele, dict):
            raise ValueError(
                "Training.Telemetry must be a bool or an object "
                '{"enabled": bool, "stream_path": str, '
                '"sync_interval_steps": int, "rollup": bool, '
                '"queue_depth": int, "cost_analysis": bool, '
                '"heartbeat_interval_s": float}'
            )
        unknown = set(tele) - {
            "enabled",
            "stream_path",
            "sync_interval_steps",
            "rollup",
            "queue_depth",
            "cost_analysis",
            "heartbeat_interval_s",
        }
        if unknown:
            raise ValueError(
                "Training.Telemetry: unknown keys "
                f"{sorted(unknown)} (accepted: enabled, stream_path, "
                "sync_interval_steps, rollup, queue_depth, "
                "cost_analysis, heartbeat_interval_s)"
            )

    # Divergence-guard block (consumed by train/guard.guard_settings):
    # same eager posture — a misspelled ``max_bad_steps`` would
    # silently never escalate, which is exactly the silent failure
    # class the guard exists to end.
    guard = training.get("Guard")
    if guard is not None and not isinstance(guard, bool):
        if not isinstance(guard, dict):
            raise ValueError(
                "Training.Guard must be a bool or an object "
                '{"enabled": bool, "policy": "skip"|"rollback"|"halt", '
                '"max_bad_steps": int, "window_steps": int, '
                '"check_interval_steps": int, "lr_backoff": float, '
                '"max_rollbacks": int}'
            )
        unknown = set(guard) - {
            "enabled",
            "policy",
            "max_bad_steps",
            "window_steps",
            "check_interval_steps",
            "lr_backoff",
            "max_rollbacks",
        }
        if unknown:
            raise ValueError(
                "Training.Guard: unknown keys "
                f"{sorted(unknown)} (accepted: enabled, policy, "
                "max_bad_steps, window_steps, check_interval_steps, "
                "lr_backoff, max_rollbacks)"
            )

    # Online-serving block (consumed by serve/engine.serving_settings,
    # docs/SERVING.md): same eager posture — a misspelled
    # ``deadline_ms`` would silently serve at the default deadline,
    # and a misspelled ``validate_snapshot`` would silently skip the
    # admission gate.
    serving = config.get("Serving")
    if serving is not None and not isinstance(serving, bool):
        if not isinstance(serving, dict):
            raise ValueError(
                "Serving must be a bool or an object "
                '{"enabled": bool, "deadline_ms": float, '
                '"max_open_bins": int, "batch_size": int, '
                '"max_budgets": int, "slack": float, '
                '"max_graphs": int, "validate_snapshot": bool}'
            )
        unknown = set(serving) - {
            "enabled",
            "deadline_ms",
            "max_open_bins",
            "batch_size",
            "max_budgets",
            "slack",
            "max_graphs",
            "validate_snapshot",
            "Fleet",
        }
        if unknown:
            raise ValueError(
                "Serving: unknown keys "
                f"{sorted(unknown)} (accepted: enabled, deadline_ms, "
                "max_open_bins, batch_size, max_budgets, slack, "
                "max_graphs, validate_snapshot, Fleet)"
            )
        # Fleet sub-block (consumed by serve/fleet.fleet_settings,
        # docs/SERVING.md "Fleet tier"): a misspelled ``queue_bound``
        # would silently serve with unbounded per-replica queues — no
        # load shedding, p99 collapse under overload.
        fleet = serving.get("Fleet")
        if fleet is not None:
            if not isinstance(fleet, dict):
                raise ValueError(
                    "Serving.Fleet must be an object "
                    '{"replicas": int, "policy": str, '
                    '"queue_bound": int, "heartbeat_interval_s": '
                    'float, "heartbeat_timeout_s": float, '
                    '"class_budgets_ms": [float|null, ...]}'
                )
            unknown = set(fleet) - {
                "replicas",
                "policy",
                "queue_bound",
                "heartbeat_interval_s",
                "heartbeat_timeout_s",
                "class_budgets_ms",
            }
            if unknown:
                raise ValueError(
                    "Serving.Fleet: unknown keys "
                    f"{sorted(unknown)} (accepted: replicas, policy, "
                    "queue_bound, heartbeat_interval_s, "
                    "heartbeat_timeout_s, class_budgets_ms)"
                )
            if fleet.get("policy") is not None and fleet[
                "policy"
            ] not in ("least_loaded", "spec_affinity"):
                raise ValueError(
                    "Serving.Fleet.policy must be 'least_loaded' or "
                    f"'spec_affinity', got {fleet['policy']!r}"
                )

    # MD-rollout block (consumed by simulate/engine.simulation_settings,
    # docs/SIMULATION.md): same eager posture — a misspelled
    # ``superstep_k`` silently reverts the rollout to per-step
    # dispatch, and a misspelled ``max_edges`` silently simulates at
    # the default neighbor capacity.
    sim = config.get("Simulation")
    if sim is not None:
        if not isinstance(sim, dict):
            raise ValueError(
                "Simulation must be an object "
                '{"steps", "dt", "superstep_k", "temperature_k", '
                '"thermostat", "friction", "kb", "mass", "seed", '
                '"record_trajectory", "log_name", "checkpoint", '
                '"neighbor", "guard"}'
            )
        unknown = set(sim) - {
            "steps",
            "dt",
            "superstep_k",
            "temperature_k",
            "thermostat",
            "friction",
            "kb",
            "mass",
            "seed",
            "record_trajectory",
            "log_name",
            "checkpoint",
            "neighbor",
            "guard",
        }
        if unknown:
            raise ValueError(
                "Simulation: unknown keys "
                f"{sorted(unknown)} (accepted: steps, dt, superstep_k, "
                "temperature_k, thermostat, friction, kb, mass, seed, "
                "record_trajectory, log_name, checkpoint, neighbor, "
                "guard)"
            )
        nb = sim.get("neighbor")
        if nb is not None:
            if not isinstance(nb, dict):
                raise ValueError(
                    "Simulation.neighbor must be an object "
                    '{"skin", "max_edges", "rebuild_policy"}'
                )
            unknown = set(nb) - {"skin", "max_edges", "rebuild_policy"}
            if unknown:
                raise ValueError(
                    "Simulation.neighbor: unknown keys "
                    f"{sorted(unknown)} (accepted: skin, max_edges, "
                    "rebuild_policy)"
                )
        gd = sim.get("guard")
        if gd is not None and not isinstance(gd, bool):
            if not isinstance(gd, dict):
                raise ValueError(
                    "Simulation.guard must be a bool or an object "
                    '{"enabled", "max_capacity_growths", '
                    '"capacity_growth", "max_dt_halvings", '
                    '"on_nonfinite"}'
                )
            unknown = set(gd) - {
                "enabled",
                "max_capacity_growths",
                "capacity_growth",
                "max_dt_halvings",
                "on_nonfinite",
            }
            if unknown:
                raise ValueError(
                    "Simulation.guard: unknown keys "
                    f"{sorted(unknown)} (accepted: enabled, "
                    "max_capacity_growths, capacity_growth, "
                    "max_dt_halvings, on_nonfinite)"
                )
        ck = sim.get("checkpoint")
        if ck is not None and not isinstance(ck, bool):
            if not isinstance(ck, dict):
                raise ValueError(
                    "Simulation.checkpoint must be a bool or an object "
                    '{"enabled", "interval_steps"}'
                )
            unknown = set(ck) - {"enabled", "interval_steps"}
            if unknown:
                raise ValueError(
                    "Simulation.checkpoint: unknown keys "
                    f"{sorted(unknown)} (accepted: enabled, "
                    "interval_steps)"
                )

    # Profiler-alignment block (consumed by utils/tracer.Profiler):
    # same eager posture — a misspelled ``epoch`` would silently
    # capture nothing while the run pays for the intent.
    prof = training.get("Profiling")
    if prof is not None:
        if not isinstance(prof, dict):
            raise ValueError(
                "Training.Profiling must be an object "
                '{"enabled": bool, "epoch": int, "steps": int, '
                '"trace_dir": str}'
            )
        unknown = set(prof) - {"enabled", "epoch", "steps", "trace_dir"}
        if unknown:
            raise ValueError(
                "Training.Profiling: unknown keys "
                f"{sorted(unknown)} (accepted: enabled, epoch, steps, "
                "trace_dir)"
            )

    training.setdefault("conv_checkpointing", False)
    training.setdefault("loss_function_type", "mse")
    training.setdefault("precision", "fp32")
    training.setdefault("batch_size", 32)
    training.setdefault("num_epoch", 1)
    training.setdefault("EarlyStopping", False)
    training.setdefault("patience", 10)
    training.setdefault("Checkpoint", False)
    training.setdefault("checkpoint_warmup", 0)
    opt = training.setdefault("Optimizer", {})
    opt.setdefault("type", "AdamW")
    opt.setdefault("learning_rate", 1e-3)

    voi.setdefault("denormalize_output", False)

    config.setdefault("Verbosity", {"level": 0}).setdefault("level", 0)
    return config


def _update_outputs(nn: dict, first_sample) -> None:
    """Derive output dims per head (reference: update_config_NN_outputs)."""
    voi = nn["Variables_of_interest"]
    arch = nn["Architecture"]
    out_types = voi.get("type", [])
    out_names = voi.get("output_names", [])
    if "output_dim" in voi and voi["output_dim"]:
        arch["output_dim"] = list(voi["output_dim"])
    elif first_sample is not None and out_types:
        dims = []
        for i, t in enumerate(out_types):
            if t == "graph":
                yg = getattr(first_sample, "y_graph", None)
                dims.append(
                    int(np.asarray(yg).size) if len(out_types) == 1 and yg is not None else 1
                )
            elif t == "node":
                n = first_sample.x.shape[0]
                yn = getattr(first_sample, "y_node", None)
                per_node = int(np.asarray(yn).size // n) if yn is not None else 1
                dims.append(per_node if len(out_types) == 1 else 1)
            else:
                raise ValueError(f"Unknown output type {t}")
        arch["output_dim"] = dims
        voi["output_dim"] = dims
    arch["output_type"] = list(out_types)
    arch.setdefault("num_heads", len(out_names) or len(out_types))
    arch.setdefault(
        "task_weights", list(arch.get("task_weights") or [1.0] * len(out_types))
    )
    if len(arch["task_weights"]) != len(out_types):
        raise ValueError(
            f"task_weights ({len(arch['task_weights'])}) must match the "
            f"number of output variables ({len(out_types)})"
        )


def _dataset_attr(dataset, name):
    return getattr(dataset, name, None) if dataset is not None else None


def gather_deg(dataset) -> np.ndarray:
    """In-degree histogram across a dataset (PNA scalers; reference:
    hydragnn/utils/model/model.py:355-438 gather_deg)."""
    max_deg = 0
    hists = []
    for sample in dataset:
        if sample.edge_index is None or sample.edge_index.size == 0:
            hists.append(np.zeros(1, dtype=np.int64))
            continue
        deg = np.bincount(
            np.asarray(sample.edge_index[1]), minlength=sample.num_nodes
        )
        h = np.bincount(deg)
        hists.append(h)
        max_deg = max(max_deg, h.shape[0] - 1)
    out = np.zeros(max_deg + 1, dtype=np.int64)
    for h in hists:
        out[: h.shape[0]] += h
    return out


def calculate_avg_deg(dataset) -> float:
    """Average in-degree (MACE normalization; reference model.py:441+)."""
    total_edges = 0
    total_nodes = 0
    for sample in dataset:
        total_edges += sample.num_edges
        total_nodes += sample.num_nodes
    return float(total_edges) / max(total_nodes, 1)
