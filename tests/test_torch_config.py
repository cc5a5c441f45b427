"""``update_config`` against the JAX package on every example config the
port runs.

Each config goes through the port's ``update_config`` and the JAX
package's with the same small train/val/test split (the same numpy
arrays in both packages' GraphSamples), made by chip_smoke.py's jax-free
copies of the example scripts' generators: md17.json (the MD17 stand-in)
as written and with ``mpnn_type: "PNAEq"`` (examples/md17/md17.py
--mpnn_type PNAEq), zinc.json and zinc_bf16.json (zinc.py's molecules),
polymers.json (the example's chains), oc20.json (oc20.py's slabs),
mptrj_forces.json (the crystals of examples/mptrj/train.py) and
qm7x.json (examples/qm7x/train.py's molecules). The derived configs must
be equal as dicts: input and output dimensions, ``num_nodes``, PNA's
``pna_deg`` and ``max_neighbours``, MACE's ``avg_num_neighbors``, and
every default. Nothing is compiled.
"""

import copy
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

import tests._cpu  # noqa: F401

from hydragnn_tpu.config import update_config as jupdate_config
from hydragnn_tpu.data import graph as jgraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    import torch

    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(*parts):
    with open(os.path.join(ROOT, "examples", *parts)) as f:
        return json.load(f)


def _case(smoke, name):
    """(config, samples) of one example config."""
    if name.startswith("md17"):
        config = _example("md17", "md17.json")
        if name == "md17_pnaeq":
            config["NeuralNetwork"]["Architecture"]["mpnn_type"] = "PNAEq"
        return config, smoke.md17_frames(24)
    if name.startswith("zinc"):
        return _example("zinc", name + ".json"), smoke.synthetic_zinc(24)
    if name == "polymers":
        rng = np.random.default_rng(26)
        return (_example("open_polymers_2026", "polymers.json"),
                [smoke.polymer_chain(rng) for _ in range(24)])
    if name == "oc20":
        return _example("open_catalyst_2020", "oc20.json"), smoke.synthetic_oc20(12)
    if name == "mptrj_forces":
        return (_example("mptrj", "mptrj_forces.json"),
                smoke.random_crystals(12, species=(28, 41, 13, 22), seed=3))
    return _example("qm7x", "qm7x.json"), smoke.qm7x_frames(30)


CASES = ["md17", "md17_pnaeq", "zinc", "zinc_bf16", "polymers", "oc20", "mptrj_forces",
         "qm7x"]


@pytest.mark.parametrize("name", CASES)
def test_update_config_matches_jax(smoke, name):
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.loader import split_dataset

    config, samples = _case(smoke, name)
    splits = split_dataset(samples, 0.8)
    fields = [f.name for f in dataclasses.fields(jgraph.GraphSample)]
    jsplits = [[jgraph.GraphSample(**{f: getattr(s, f) for f in fields}) for s in split]
               for split in splits]
    want = jupdate_config(copy.deepcopy(config), *jsplits)
    got = update_config(copy.deepcopy(config), *splits)
    assert got == want
    arch = got["NeuralNetwork"]["Architecture"]
    if arch["mpnn_type"] in ("PNA", "PNAPlus", "PNAEq"):
        assert arch["pna_deg"] and arch["max_neighbours"] == len(arch["pna_deg"]) - 1
