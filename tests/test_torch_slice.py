"""The slice end to end against the JAX package: SchNet served.

A small SchNet (2 conv layers, width 16, 16 Gaussians) is initialized by
the JAX package, carried over with ``params_from_jax``, and compared:

- ``make_forward`` and the encoder's node representations on a batch
  without a plan (JAX: XLA scatter; port: ``index_add_``) and on a
  planned batch (JAX: the Pallas kernel, interpreted, forced with
  HYDRAGNN_TPU_SEGMENT_IMPL=pallas_fused; port: K1's plain version at the
  Hopper tiles);
- every request served by the port's ``ServingEngine(device="cpu")``
  against JAX ``make_forward`` on that request collated alone.

Tolerance: f32 rtol 1e-5 / atol 1e-4 (tests/test_pallas_segment.py:341),
with the atol scaled by the reference's largest magnitude where that is
below 1. A random-weight SchNet's graph outputs are ~1e-4 to 1e-3, so a
bare atol of 1e-4 would pass a port that returned zeros.
"""

import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax

from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.export import make_forward as jax_make_forward
from hydragnn_tpu.models.create import create_model as jax_create_model
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.serve import loadgen as jloadgen

F32_TOL = dict(rtol=1e-5, atol=1e-4)


def _assert_matches(got, want):
    """``got`` equals ``want`` at f32 rtol 1e-5 and an atol of 1e-4 times
    ``want``'s largest magnitude (1e-4 once that reaches 1)."""
    scale = float(np.abs(want).max())
    assert scale > 1e-6, f"reference too small to compare against ({scale:g})"
    np.testing.assert_allclose(
        got, want, rtol=F32_TOL["rtol"], atol=F32_TOL["atol"] * min(scale, 1.0)
    )


def _cfg(spec):
    return spec.ModelConfig(
        mpnn_type="SchNet",
        input_dim=1,
        hidden_dim=16,
        num_conv_layers=2,
        heads=(spec.HeadSpec(name="energy", type="graph", dim=1),),
        graph_branches=(
            spec.BranchSpec(
                name="branch-0", num_sharedlayers=2, dim_sharedlayers=16,
                num_headlayers=2, dim_headlayers=(16, 16),
            ),
        ),
        radius=4.0,
        max_neighbours=32,
        num_gaussians=16,
        num_filters=16,
    )


@pytest.fixture(scope="module")
def port():
    """torch and the port's modules, imported when this file runs rather
    than at collection (test workers that never run it do not load
    torch)."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import export
    from hydragnn_tpu_torch.data import graph, padschedule
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.ops import edge_pipeline
    from hydragnn_tpu_torch.serve import admission, batcher, engine

    return types.SimpleNamespace(
        torch=torch, export=export, graph=graph, padschedule=padschedule,
        convert=convert, create=create, spec=spec, ep=edge_pipeline,
        admission=admission, batcher=batcher, engine=engine,
    )


@pytest.fixture(scope="module")
def models(port):
    """The JAX model and params, and the port's model carrying the same
    weights."""
    samples = jloadgen.synthetic_request_samples("qm9", 12, seed=0)
    jcfg = _cfg(jspec)
    jmodel = jax_create_model(jcfg)
    # init_params under jit: one compile instead of op-by-op dispatch
    variables = jax.jit(
        lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False)
    )(jgraph.collate(samples[:4]))
    params = variables["params"]
    variables = {"params": params, "batch_stats": variables.get("batch_stats", {})}
    tcfg = _cfg(port.spec)
    tmodel = port.create.create_model(tcfg, "cpu")
    tmodel.load_state_dict(port.convert.params_from_jax(jax.device_get(params)))
    return samples, jcfg, jmodel, variables, tcfg, tmodel


def _tpad(port, pad):
    return port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs)


@pytest.mark.parametrize("planned", [False, True])
def test_schnet_forward_matches_jax(port, models, monkeypatch, planned):
    """Head outputs and node representations (the encoder's output) of
    the port's SchNet equal JAX's on the same batch."""
    samples, jcfg, jmodel, variables, tcfg, tmodel = models
    pad = jgraph.PadSpec.for_samples(samples)
    if planned:
        monkeypatch.setenv("HYDRAGNN_TPU_SEGMENT_IMPL", "pallas_fused")
    jb = jgraph.collate(samples, pad, with_segment_plan=planned)
    forward = jax_make_forward(jmodel, jcfg, variables)
    want_h, want = jax.jit(
        lambda b: (jmodel.apply(variables, b, method=jmodel.encode)[0], forward(b))
    )(jb)
    tb = port.graph.collate(samples, _tpad(port, pad), with_segment_plan=planned)
    assert (tb.seg_window is not None) == planned
    got = port.export.make_forward(tmodel, tcfg)(tb)
    with port.torch.no_grad():
        got_h = tmodel.encode(tb)[0]
    assert len(got) == len(want) == 1
    real_nodes = np.asarray(jb.node_mask)
    _assert_matches(got_h.numpy()[real_nodes], np.asarray(want_h)[real_nodes])
    real = np.asarray(jb.graph_mask)
    _assert_matches(got[0].numpy()[real], np.asarray(want[0])[real])


def test_served_requests_match_jax(port, models):
    """Every request's served output equals JAX make_forward on the
    request collated alone; the engine's bins carry the plan."""
    samples, jcfg, jmodel, variables, tcfg, tmodel = models
    ns, es = port.padschedule.dataset_size_arrays(samples)
    st = port.engine.ServingSettings(enabled=True, batch_size=4)
    budgets = port.engine.fit_serving_budgets(ns, es, st)
    engine = port.engine.ServingEngine(
        tmodel, tcfg, tmodel.state_dict(), budgets,
        example=samples[0], settings=st, device="cpu",
    )
    assert engine.collate_bin(samples[:1], budgets[-1]).seg_window is not None
    bat = port.batcher.DynamicBatcher(budgets, deadline_ms=1e3, max_open_bins=2)
    reqs = [bat.submit(s) for s in samples]
    bat.close()
    launches = port.ep.edge_pipeline_planned.launches
    records = engine.process(bat)
    # CPU tensors run K1's plain version: no kernel launch
    assert port.ep.edge_pipeline_planned.launches == launches
    assert sum(len(r["reqs"]) for r in records) == len(samples)
    assert engine.rollup()["requests"] == len(samples)
    alone = jgraph.PadSpec(num_nodes=40, num_edges=80, num_graphs=2)
    fwd = jax.jit(jax_make_forward(jmodel, jcfg, variables))
    want = np.stack(
        [np.asarray(fwd(jgraph.collate([s], alone))[0])[0] for s in samples]
    )
    assert all(req.result[0].shape == (1,) for req in reqs)
    _assert_matches(np.stack([req.result[0] for req in reqs]), want)
    engine.close()


def test_entry_points_need_a_device_or_cpu(port, models):
    """Without a card, create_model and ServingEngine raise unless the
    caller asks for the CPU; a non-finite snapshot is refused."""
    samples, _, _, _, tcfg, tmodel = models
    budgets = [port.graph.PackSpec(64, 128, 5)]
    if not port.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.create.create_model(tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.engine.ServingEngine(tmodel, tcfg, None, budgets, example=samples[0])
    bad = {k: v.clone() for k, v in tmodel.state_dict().items()}
    bad["stack.conv_0.lin2.kernel"][0, 0] = float("nan")
    with pytest.raises(port.admission.AdmissionError, match="stack.conv_0.lin2.kernel"):
        port.engine.ServingEngine(
            tmodel, tcfg, bad, budgets, example=samples[0], device="cpu"
        )


def test_params_from_jax_layout(port, models):
    """Dense kernels are transposed into Linear weights, lin2 keeps its
    [in, out] kernel, and an unknown leaf raises."""
    _, _, _, variables, _, tmodel = models
    params = jax.device_get(variables["params"])
    sd = port.convert.params_from_jax(params)
    k1 = params["stack"]["conv_0"]["filter_mlp"]["dense_1"]["kernel"]
    np.testing.assert_array_equal(
        sd["stack.conv_0.filter_mlp.dense_1.weight"].numpy(), np.asarray(k1).T
    )
    np.testing.assert_array_equal(
        sd["stack.conv_0.lin2.kernel"].numpy(),
        np.asarray(params["stack"]["conv_0"]["lin2"]["kernel"]),
    )
    assert set(sd) == set(tmodel.state_dict())
    with pytest.raises(ValueError, match="no mapping"):
        port.convert.params_from_jax(
            {"stack": {"conv_0": {"lin1": {"embedding": np.ones(3)}}}}
        )
