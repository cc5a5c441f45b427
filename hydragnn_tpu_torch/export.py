"""The inference forward shared by every deployment path, and export to
a file on ``torch.export``.

Counterpart of ``hydragnn_tpu/export.py``: ``make_forward`` (eval mode,
the raw tuple of head outputs; or, with ``with_forces``, the MLIP pair
``(graph energies, forces)``), ``export_inference``, ``load_exported``
and the ``main`` CLI. The port's model carries its weights, so
``make_forward`` has no ``variables`` argument.

An artifact bakes the trained weights into one file that
``load_exported`` runs with no model code, config or checkpoint (the
port's package must be importable: the programs call K1 and K2 as the
operators ``torch.ops.hydragnn.*``). It differs from the JAX artifact
in two ways that torch imposes:

- **One program per device.** A StableHLO artifact is compiled at load
  for any platform it lists. A torch program bakes the device of every
  tensor it creates, so the artifact holds one exported program per
  entry of ``devices`` (by default the exporting device and ``"cpu"``),
  and ``load_exported(device=...)`` takes that device's program. An
  artifact without a program for the device raises, naming the devices
  it holds; it never runs another device's program.
- **Forces are taken at call time.** ``torch.export`` cannot trace
  ``torch.autograd.grad`` inside the exported function. A ``with_forces``
  artifact holds the graph-energy program (``train/mlip.
  predict_graph_energy``) and records ``with_forces``; the loaded
  callable differentiates that program with respect to the positions,
  through K1's registered derivative (K2), and returns ``(graph
  energies, forces)`` exactly as ``make_forward(with_forces=True)``
  does. The caller passes nothing extra.

Shapes are static, as in the JAX package: a program accepts batches with
the exact padded shapes (and block-plan shapes) of the example batch it
was exported with, so a serving deployment exports one artifact per
pack budget. The plan tensors are inputs of the program, so each call
carries its batch's plan.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import zipfile
from typing import Callable, Mapping, Optional, Sequence, Union

import torch

# The programs call K1/K2 through these operators: importing the module
# registers them before any program is loaded.
import hydragnn_tpu_torch.ops.edge_pipeline  # noqa: F401
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.models.spec import ModelConfig

ARTIFACT_FORMAT = "hydragnn_tpu_torch.export/1"


def make_forward(model, cfg: ModelConfig, *, with_forces: bool = False) -> Callable:
    """``fn(batch) -> outputs`` in eval mode: the tuple of head outputs
    under ``torch.no_grad()``, or with ``with_forces`` the pair ``(graph
    energies [G], forces [N, 3])`` from
    ``train/mlip.energy_and_forces(create_graph=False)`` under
    ``torch.enable_grad()`` (the force pass needs a graph over the
    positions, whatever the caller's grad mode)."""
    model.eval()
    if with_forces:
        from hydragnn_tpu_torch.train.mlip import energy_and_forces

        def forward(batch):
            with torch.enable_grad():
                ge, forces = energy_and_forces(model, batch, cfg, create_graph=False)
            return ge.detach(), forces

        return forward

    def forward(batch):
        with torch.no_grad():
            return tuple(model(batch))

    return forward


def _device_key(device: torch.device) -> str:
    """The name a program is stored under: ``cpu`` or ``cuda:<index>``."""
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        return f"cuda:{index}"
    return device.type


class _Program(torch.nn.Module):
    """What is exported: the batch's present arrays, in field order, in;
    the head outputs (or the graph energies of an MLIP) out."""

    def __init__(self, model, cfg, template, names: Sequence[str], with_forces: bool):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.template = template
        self.names = tuple(names)
        self.with_forces = with_forces

    def forward(self, *arrays):
        batch = dataclasses.replace(self.template, **dict(zip(self.names, arrays)))
        if self.with_forces:
            from hydragnn_tpu_torch.train.mlip import predict_graph_energy

            return predict_graph_energy(self.model, batch, self.cfg)
        return tuple(self.model(batch))


def _template(batch, names):
    """``batch`` with every array field set to None (the tile sizes of
    its plan kept): the program fills it from its inputs."""
    return dataclasses.replace(batch, **{n: None for n in names})


def export_inference(
    model,
    cfg: ModelConfig,
    state: Optional[Mapping[str, torch.Tensor]],
    example_batch,
    *,
    path: Optional[str] = None,
    with_forces: bool = False,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> bytes:
    """Serialize the trained multihead forward (weights baked in) and
    return the artifact's bytes; also write them to ``path`` when given.

    ``state`` is a ``state_dict`` to bake in (None: the model's own
    weights); the caller's model is not changed. With ``with_forces``
    the artifact serves ``(graph energies, forces)`` (module docstring).
    ``devices`` lists the programs the artifact holds, one exported per
    device on a copy of the model there (default: the model's device and
    ``"cpu"``); each must be available (``resolve_device``)."""
    home = next(model.parameters()).device
    if devices is None:
        devices = [home, "cpu"]
    devs, seen = [], set()
    for d in devices:
        dev = resolve_device(d)
        key = _device_key(dev)
        if key not in seen:
            seen.add(key)
            devs.append((key, dev))
    host = example_batch.to("cpu")
    arrays = host.arrays()
    names = list(arrays)
    meta = {
        "format": ARTIFACT_FORMAT,
        "with_forces": bool(with_forces),
        "fields": names,
        "shapes": {n: list(arrays[n].shape) for n in names},
        "dtypes": {n: str(arrays[n].dtype) for n in names},
        "devices": [k for k, _ in devs],
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("artifact.json", json.dumps(meta))
        for key, dev in devs:
            m = copy.deepcopy(model).to(dev)
            if state is not None:
                m.load_state_dict(state)
            m.eval()
            batch = host.to(dev)
            prog = _Program(m, cfg, _template(batch, names), names, with_forces)
            ep = torch.export.export(
                prog, tuple(getattr(batch, n) for n in names), strict=False
            )
            out = io.BytesIO()
            torch.export.save(ep, out)
            zf.writestr(f"program_{key.replace(':', '_')}.pt2", out.getvalue())
    blob = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def _read(source: Union[str, bytes, os.PathLike]) -> bytes:
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as fh:
            return fh.read()
    return bytes(source)


def load_exported(
    source: Union[str, bytes],
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """Deserialize an artifact into ``fn(batch) -> outputs`` on
    ``device`` (``None`` means ``"cuda"``, which needs a card).

    ``source`` is the bytes from ``export_inference`` or a file path.
    The callable takes a ``GraphBatch`` with the artifact's exact fields
    and shapes, moves it to the device when it is not there, and returns
    the tuple of head outputs, or ``(graph energies, forces)`` for a
    ``with_forces`` artifact. Raises when the artifact holds no program
    for ``device``."""
    blob = _read(source)
    dev = resolve_device(device)
    key = _device_key(dev)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        meta = json.loads(zf.read("artifact.json"))
        if meta.get("format") != ARTIFACT_FORMAT:
            raise ValueError(f"not an artifact of {ARTIFACT_FORMAT}: {meta.get('format')!r}")
        if key not in meta["devices"]:
            raise ValueError(
                f"the artifact holds no program for {key}: it was exported for "
                f"{meta['devices']}; export it again with devices=[..., {key!r}]"
            )
        program = zf.read(f"program_{key.replace(':', '_')}.pt2")
    module = torch.export.load(io.BytesIO(program)).module()
    names = tuple(meta["fields"])
    shapes = {n: tuple(s) for n, s in meta["shapes"].items()}
    with_forces = bool(meta["with_forces"])

    def fn(batch):
        arrays = batch.arrays()
        if tuple(arrays) != names:
            raise ValueError(
                f"batch fields {list(arrays)} do not match the artifact's {list(names)}"
            )
        args = []
        for n in names:
            t = torch.as_tensor(arrays[n])
            if tuple(t.shape) != shapes[n]:
                raise ValueError(
                    f"batch field {n} has shape {tuple(t.shape)}; the artifact was "
                    f"exported at {shapes[n]} (export one artifact per pack budget)"
                )
            args.append(t if t.device == dev else t.to(dev))
        if not with_forces:
            with torch.no_grad():
                return tuple(module(*args))
        i_pos = names.index("pos")
        pos = args[i_pos].detach().requires_grad_(True)
        args[i_pos] = pos
        with torch.enable_grad():
            graph_e = module(*args)
            (grad_pos,) = torch.autograd.grad(graph_e.sum(), pos)
        mask = args[names.index("node_mask")]
        forces = -grad_pos * mask.to(grad_pos.dtype)[:, None]
        return graph_e.detach(), forces

    fn.info = meta
    return fn


def main(argv=None):
    """CLI: export a serving artifact from a training run's checkpoint.

    python -m hydragnn_tpu_torch.export <config.json> <out> [--forces]
        [--batch_size N] [--device D]

    Loads the config's dataset (Dataset.path, as run_prediction would),
    builds the model on the device, restores the checkpoint written
    under logs/<run>/, and writes the artifact shaped by the first test
    batch (with triplets when the stack needs them, and with the block
    plan), holding programs for the device and the CPU.
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("config", help="training config JSON (with Dataset.path)")
    ap.add_argument("out", help="output artifact path")
    ap.add_argument(
        "--forces",
        action="store_true",
        help="serve energies and forces (the MLIP form)",
    )
    ap.add_argument(
        "--batch_size",
        type=int,
        default=None,
        help="override Training.batch_size for the artifact's shapes",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="device to build the model on and export for, besides the CPU "
        "(default cuda)",
    )
    args = ap.parse_args(argv)

    from hydragnn_tpu_torch.config import load_config, update_config
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.create import needs_triplets
    from hydragnn_tpu_torch.runner import (
        _check_num_nodes_bound,
        _ingest_datasets,
        _prediction_model,
        restore_checkpoint_state,
    )

    config = load_config(args.config)
    trainset, valset, testset = _ingest_datasets(config)
    config = update_config(config, trainset, valset, testset)
    # as run_training/run_prediction: an artifact whose dense scatter
    # drops out-of-bound nodes would serve wrong predictions
    _check_num_nodes_bound(config, trainset, valset, testset)
    training = config["NeuralNetwork"]["Training"]
    bs = args.batch_size or int(training.get("batch_size", 32))
    trips = needs_triplets(
        config["NeuralNetwork"]["Architecture"].get("mpnn_type", "SchNet")
    )
    seg_plan = training.get("use_segment_plan", True)
    loader = GraphLoader(
        testset or valset or trainset, bs, with_triplets=trips,
        with_segment_plan=True if seg_plan == "auto" else bool(seg_plan),
    )
    batch = next(iter(loader))

    model, cfg = _prediction_model(config, training, None, None, args.device)
    restore_checkpoint_state(config, model)
    with_forces = bool(args.forces or cfg.enable_interatomic_potential)
    dev = next(model.parameters()).device
    blob = export_inference(
        model, cfg, None, batch, path=args.out, with_forces=with_forces,
        devices=[dev, "cpu"],
    )
    print(
        json.dumps(
            {
                "artifact": args.out,
                "bytes": len(blob),
                "with_forces": with_forces,
                "batch_shapes": {
                    "nodes": int(batch.x.shape[0]),
                    "edges": int(batch.senders.shape[0]),
                    "graphs": int(batch.graph_mask.shape[0]),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
