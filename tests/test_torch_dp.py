"""Data parallelism, ZeRO/FSDP and multibranch training against the JAX
package, on the CPU.

The port's D "devices" are the ranks of a process group; the JAX
package's are the devices of one process's mesh (tests/conftest.py's 8
virtual CPU devices, ``{data: 2}`` here). One module-scoped spawn of two
gloo ranks (``tests/_torch_dp_worker.py``, torch and the port only) runs
every two-rank case while this process computes the JAX side:

- (a) ``plan_from_config`` field by field: scheme, ``data``/``fsdp``/
  ``zero``, ``HYDRAGNN_TPU_MESH``, ``HYDRAGNN_TPU_USE_FSDP``;
- (b) ``pack_epoch_ffd_dp``, ``dp_step_plan``, ``dp_spec_schedule``
  (one and two processes), ``slot_spec_schedule`` and
  ``dp_packing_beats_schedule``, bit for bit at D = 2 and 4;
- (c) a world-1 dp step (a gloo group of one, in this process) equal
  to the single scheme's step bit for bit, and ``run_prediction`` at
  world 1 taking the dp test pass with the single pass's samples;
- (d) the two-rank dp eval step and two train steps against
  ``make_dp_eval_step``/``make_dp_train_step`` on PNA (a
  ``MaskedBatchNorm`` stack) with sub-batches of 3 and 2 real graphs,
  then with the second slot fully masked (``_masked_out``): loss, per-
  task losses, every gradient, every updated parameter and running
  statistic;
- (e) the same under ``zero`` (FSDP2 over both ranks) against the dp
  step and against JAX, and HSDP (``{data: 1, fsdp: 2}``: both ranks on
  the one slot) against the single step on its batch;
- (f) one multibranch step with the dual optimizer at devices per
  branch [1, 1] against ``make_multibranch_train_step``;
- (g) ``run_training`` under ``{"scheme": "dp", "data": 2}`` on ci.json's
  SchNet (2 epochs, packing on) against the JAX package's, from the
  same initial parameters: per-epoch losses; then ``run_prediction``'s
  lockstep pass against the JAX package's prediction, sample by sample.

- (h) the multibranch guard on the two ranks: guarded steps equal the
  unguarded ones bit for bit, and NaN labels on branch 1's slot leave
  branch 1's decoder and the encoder as they were and branch 0's
  decoder as a clean step leaves it, bit for bit (the JAX package's
  containment contract, tests/test_guard.py); a multibranch
  ``run_training`` with the guard and resume containers, stopped after
  6 steps and continued, equals the uninterrupted run bit for bit;
- (i) the sharded checkpoint format under ZeRO: each rank's file holds
  its shard alone, the state restores bit for bit at world 2 (each rank
  from its file) and at world 1 here (from both files), and a ZeRO run
  writing it equals the same run writing ``.pt`` bit for bit;
- (j) the dp feed through the collation workers and the prefetch thread,
  its buffers recycled after ``DPLoader.required_hold``, equal to the
  serial feed on both ranks (packed supersteps, a resumed epoch, a
  cached eval loader).

Also: a dataset format other than the raw LSMS text still raises with
its ROADMAP item (10c); a config with ``pipeline.workers`` no longer
does.

Tolerances: f32 forward rtol 1e-5 / atol 1e-4, f32 gradients and
updated parameters rtol 1e-4 / atol 1e-3, each atol scaled by the
reference's largest magnitude where that is below 1.
"""

import copy
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp

import hydragnn_tpu
from hydragnn_tpu import runner as jrunner
from hydragnn_tpu.config import update_config as jupdate_config
from hydragnn_tpu.config.config import gather_deg
from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data import loader as jloader
from hydragnn_tpu.data import padschedule as jpads
from hydragnn_tpu.data import raw as jraw
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jdgd
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.models.create import create_model as jcreate_model
from hydragnn_tpu.models.create import create_model_config as jcreate_config
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.parallel import dp as jdp
from hydragnn_tpu.parallel import multibranch as jmb
from hydragnn_tpu.parallel import runtime as jruntime
from hydragnn_tpu.parallel.mesh import make_mesh, shard_stacked_batch, stack_batches
from hydragnn_tpu.train.loop import make_loss_fn
from hydragnn_tpu.train.optimizer import select_optimizer as jselect_optimizer
from hydragnn_tpu.train.state import create_train_state

from tests import _torch_dp_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
N_CONFIGS = 40


def _plain(tree):
    """A parameter tree as nested plain dicts of numpy arrays (what the
    ranks unpickle without flax)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_close(got, want, tol, name="", scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * min(max(scale, 1e-30), 1.0), err_msg=name)


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data import graph, loader, padschedule, raw, synthetic
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.parallel import dp, mesh, runtime
    from hydragnn_tpu_torch.train import loop, optimizer, state

    return types.SimpleNamespace(
        torch=torch, runner=runner, graph=graph, loader=loader, padschedule=padschedule,
        raw=raw, synthetic=synthetic, convert=convert, create=create, spec=spec, dp=dp,
        mesh=mesh, runtime=runtime, loop=loop, optimizer=optimizer, state=state)


# ----------------------------------------------------------------------
# (a) plan_from_config
# ----------------------------------------------------------------------

PLAN_CASES = {
    "auto-1": (1, {}, {}),
    "auto-8": (8, {}, {}),
    "single": (8, {"scheme": "single"}, {}),
    "dp-fill": (8, {"scheme": "dp"}, {}),
    "dp-2": (8, {"scheme": "dp", "data": 2}, {}),
    "dp-fsdp": (8, {"scheme": "dp", "data": 2, "fsdp": 2}, {}),
    "zero": (4, {"scheme": "dp", "zero": True}, {}),
    "mesh-env": (8, {}, {"HYDRAGNN_TPU_MESH": "data=2,fsdp=4"}),
    "use-fsdp-env": (2, {"scheme": "dp"}, {"HYDRAGNN_TPU_USE_FSDP": "1"}),
    "multibranch": (4, {"scheme": "multibranch"}, {}),
    "packing-superstep": (2, {"scheme": "dp", "packing": {"enabled": True, "max_budgets": 3},
                              "superstep": {"steps": 4}}, {}),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_from_config_matches_jax(port, monkeypatch, case):
    n, par, env = PLAN_CASES[case]
    for k in ("HYDRAGNN_TPU_MESH", "HYDRAGNN_TPU_USE_FSDP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config = {"NeuralNetwork": {"Training": {"Parallelism": par}}}
    want = jruntime.plan_from_config(copy.deepcopy(config), devices=jax.devices()[:n])
    got = port.runtime.plan_from_config(copy.deepcopy(config), n_devices=n)
    for field in ("scheme", "fsdp", "fsdp_axis", "packing", "packing_max_budgets",
                  "packing_slack", "packing_max_graphs", "superstep_steps",
                  "superstep_max_host_bytes", "data_parallel_size"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.mesh is None) == (want.mesh is None)
    if want.mesh is not None:
        assert got.mesh.shape == {"data": want.mesh.shape["data"],
                                  "fsdp": want.mesh.shape.get("fsdp", 1)}


def test_plan_from_config_refuses_too_many_devices(port):
    config = {"NeuralNetwork": {"Training": {"Parallelism": {"scheme": "dp", "data": 4}}}}
    with pytest.raises(ValueError, match="only 2 visible"):
        jruntime.plan_from_config(copy.deepcopy(config), devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="only 2 visible"):
        port.runtime.plan_from_config(copy.deepcopy(config), n_devices=2)


# ----------------------------------------------------------------------
# (b) the dp half of padschedule, bit for bit
# ----------------------------------------------------------------------


def _sizes(n, seed):
    rng = np.random.default_rng(seed)
    nodes = rng.integers(4, 40, n).astype(np.int64)
    edges = (nodes * rng.uniform(1.5, 6.0, n)).astype(np.int64)
    return nodes, edges


def _key(spec):
    return (spec.num_nodes, spec.num_edges, spec.num_graphs)


@pytest.mark.parametrize("d", [2, 4])
def test_dp_packer_and_step_plan_match_jax(port, d):
    nodes, edges = _sizes(300, seed=d)
    budgets = jpads.fit_pack_budgets(nodes, edges, 16, seed=0)
    t_budgets = port.padschedule.fit_pack_budgets(nodes, edges, 16, seed=0)
    assert [_key(b) for b in budgets] == [_key(b) for b in t_budgets]
    for epoch in range(2):
        order = np.concatenate(list(jpads.epoch_batch_indices(
            len(nodes), 16, shuffle=True, seed=0, epoch=epoch)))
        want = jpads.pack_epoch_ffd_dp(order, nodes, edges, budgets, d)
        got = port.padschedule.pack_epoch_ffd_dp(order, nodes, edges, t_budgets, d)
        assert len(got) == len(want) and len(got) % d == 0
        for (gi, gs), (wi, ws) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert _key(gs) == _key(ws)
        plan = [(i, s.pad_spec()) for i, s in want]
        t_plan = [(i, s.pad_spec()) for i, s in got]
        w_steps, w_tail = jpads.dp_step_plan(plan[:-1], d)
        g_steps, g_tail = port.padschedule.dp_step_plan(t_plan[:-1], d)
        assert [(t, None if s is None else _key(s)) for t, s in g_steps] == \
            [(t, None if s is None else _key(s)) for t, s in w_steps]
        assert len(g_tail) == len(w_tail) == d - 1
    for baseline in ("auto", "ladder", "worst"):
        w = jpads.dp_packing_beats_schedule(nodes, edges, 16, d, seed=0, baseline=baseline)
        g = port.padschedule.dp_packing_beats_schedule(nodes, edges, 16, d, seed=0,
                                                       baseline=baseline)
        assert (w is None) == (g is None), baseline
        if w is not None:
            assert [_key(b) for b in w[0]] == [_key(b) for b in g[0]] and w[1] == g[1]
    with pytest.raises(ValueError):
        port.padschedule.pack_epoch_ffd_dp(np.arange(d - 1), nodes, edges, t_budgets, d)


@pytest.mark.parametrize("d", [2, 4])
def test_dp_spec_schedules_match_jax(port, d):
    nodes, edges = _sizes(203, seed=10 + d)
    for n_procs, group in ((1, d), (2, d // 2)):
        for shuffle in (True, False):
            kw = dict(batch_size=8, n_procs=n_procs, steps_group=group, seed=3,
                      shuffle=shuffle)
            want = jpads.dp_spec_schedule(nodes, edges, bucket_limit=6, **kw)
            got = port.padschedule.dp_spec_schedule(nodes, edges, bucket_limit=6, **kw)
            assert got.ladder_is_small() == want.ladder_is_small()
            assert got.fingerprint() == want.fingerprint()
            for epoch in range(3):
                for j in range(30):
                    assert _key(got.spec(epoch, j)) == _key(want.spec(epoch, j))
    # slot schedules over per-slot loaders of both packages
    js = _molecules(60, seed=d)
    ts = _to_port(port, js)
    loaders = [jloader.GraphLoader(js[i::d], 4, shuffle=True, seed=i) for i in range(d)]
    t_loaders = [port.loader.GraphLoader(ts[i::d], 4, shuffle=True, seed=i) for i in range(d)]
    want = jpads.slot_spec_schedule(loaders, bucket_limit=6)
    got = port.padschedule.slot_spec_schedule(t_loaders, bucket_limit=6)
    assert got.fingerprint() == want.fingerprint()
    for epoch in range(3):
        for j in range(8):
            assert _key(got.spec(epoch, j)) == _key(want.spec(epoch, j))


# ----------------------------------------------------------------------
# Samples and models of the step cases
# ----------------------------------------------------------------------


def _molecules(n, seed, dataset_id=0):
    """Small random molecules: positions in a box, edges within radius
    2.0 (both directions), one node feature, a graph target."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(4, 9))
        pos = rng.uniform(0, 2.2, (k, 3)).astype(np.float32)
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        snd, rcv = np.nonzero((d < 2.0) & ~np.eye(k, dtype=bool))
        x = rng.integers(1, 4, (k, 1)).astype(np.float32)
        out.append(jgraph.GraphSample(
            x=x, pos=pos, edge_index=np.stack([snd, rcv]).astype(np.int64),
            y_graph=np.array([float(x.mean()) * 0.3 + 0.1 * len(snd) / k], np.float32),
            dataset_id=dataset_id))
    return out


def _to_port(port, samples):
    fields = ("x", "pos", "edge_index", "y_graph", "dataset_id")
    return [port.graph.GraphSample(**{f: getattr(s, f) for f in fields}) for s in samples]


def _shared_pad(groups):
    pads = [jgraph.PadSpec.for_samples(g) for g in groups]
    return jgraph.PadSpec(max(p.num_nodes for p in pads), max(p.num_edges for p in pads),
                          max(p.num_graphs for p in pads))


def _batches(port, groups):
    """The groups collated by both packages at one shared pad (the port's
    with the block plan)."""
    pad = _shared_pad(groups)
    tpad = port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs)
    jbs = [jgraph.collate(g, pad) for g in groups]
    tbs = [port.graph.collate(_to_port(port, g), tpad, with_segment_plan=True)
           for g in groups]
    return jbs, tbs


def _stacked(mesh, jbs):
    return shard_stacked_batch(stack_batches(jbs), mesh)


def _dp_reference(dp_inputs):
    """JAX's dp eval step, then two dp train steps (their losses,
    gradients, parameters and statistics) on the {data: 2} mesh."""
    deg, params, stats, jbs = dp_inputs
    cfg = worker.pna_cfg(jspec, deg)
    model = jcreate_model(cfg)
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    tx = jselect_optimizer(worker.DP_TRAINING)
    state = jdp.replicate_state(create_train_state(params, tx, stats), mesh)
    loss_over = jdp._weighted_loss_over_devices(make_loss_fn(model, cfg))
    grad_fn = jax.jit(jax.grad(lambda p, s, b: loss_over(p, s, b)[0]))
    step = jdp.make_dp_train_step(model, tx, cfg, mesh)
    a, b = jbs
    out = {"eval": jax.device_get(jdp.make_dp_eval_step(model, cfg, mesh)(
        state, _stacked(mesh, [a, b])))}
    for name, pair in (("step1", [a, b]), ("step2", [a, jdp._masked_out(b)])):
        stacked = _stacked(mesh, pair)
        grads = jax.device_get(grad_fn(state.params, state.batch_stats, stacked))
        state, tot, tasks = step(state, stacked)
        out[name] = jax.device_get((tot, tasks, grads, state.params, state.batch_stats))
    return out


def _mb_reference(mb_inputs):
    """JAX's multibranch step with the dual optimizer at [1, 1], and its
    gradients (the mean over slots, then the D / D_b rescale)."""
    params, jbs = mb_inputs
    cfg = worker.schnet_mb_cfg(jspec)
    model = jcreate_model(cfg)
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    tx = jmb.dual_optimizer(worker.MB_TRAINING)
    state = jdp.replicate_state(create_train_state(params, tx), mesh)
    stacked = _stacked(mesh, jbs)
    loss_fn = make_loss_fn(model, cfg)

    @jax.jit
    def grads_of(p, b):
        g = jax.grad(lambda q: jnp.mean(jax.vmap(lambda x: loss_fn(q, {}, x)[0])(b)))(p)
        return jmb.rescale_decoder_grads(g, cfg, 2, (1, 1))

    grads = jax.device_get(grads_of(state.params, stacked))
    step = jmb.make_multibranch_train_step(model, tx, cfg, mesh, (1, 1))
    state, tot, tasks = step(state, stacked)
    return jax.device_get((tot, tasks, grads, state.params))


def _ci_config(path):
    import json

    with open(os.path.join(HERE, "inputs", "ci.json")) as f:
        config = json.load(f)
    config["Dataset"]["path"] = {"total": path}
    training = config["NeuralNetwork"]["Training"]
    training["num_epoch"] = 2
    training["Parallelism"] = {
        "scheme": "dp", "data": 2, "packing": {"enabled": True},
        "superstep": {"steps": 1}, "pipeline": {"workers": 0},
    }
    return config


def _run_inputs(port, tmp_path):
    """ci.json's BCC set processed by both packages and split alike, and
    the JAX model's initial parameters."""
    paths = {k: str(tmp_path / k) for k in ("jax", "port")}
    jdgd(paths["jax"], number_configurations=N_CONFIGS, seed=7)
    port.synthetic.deterministic_graph_data(paths["port"], number_configurations=N_CONFIGS,
                                            seed=7)
    config = _ci_config(paths["port"])
    ds = config["Dataset"]
    os.environ["HYDRAGNN_TPU_NO_NATIVE"] = "1"
    try:
        js = jraw.process_raw_samples(jraw.read_lsms_directory(paths["jax"], ds), config)
    finally:
        del os.environ["HYDRAGNN_TPU_NO_NATIVE"]
    ts = port.raw.process_raw_samples(port.raw.read_lsms_directory(paths["port"], ds), config)
    jsplits = jloader.split_dataset(js, 0.7, stratified=True)
    tsplits = port.loader.split_dataset(ts, 0.7, stratified=True)
    full = jupdate_config(copy.deepcopy(config), *jsplits)
    model, _ = jcreate_config(full)
    params = jax.device_get(jax.jit(lambda b: init_params(model, b, seed=0)[0])(
        jgraph.collate(jsplits[0][:4])))
    return config, jsplits, tsplits, params


def _jax_run(config, jsplits, params, monkeypatch):
    """The JAX package's run_training from ``params``, then its
    run_prediction."""
    monkeypatch.setattr(jrunner, "init_params", lambda model, example, seed=0: (params, {}))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    state, model, cfg, hist, full = hydragnn_tpu.run_training(
        copy.deepcopy(config), datasets=jsplits)
    pred = jrunner.run_prediction(full, datasets=jsplits, state=state, model=model, cfg=cfg)
    return hist, pred


@pytest.fixture(scope="module")
def two_ranks(port, tmp_path_factory):
    """The two ranks' outputs (spawned first) and the JAX references
    (computed meanwhile)."""
    torch = port.torch
    work = tmp_path_factory.mktemp("dp_ranks")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        js = _molecules(12, seed=1)
        deg = gather_deg(js)
        pna = jcreate_model(worker.pna_cfg(jspec, deg))
        jbs, tbs = _batches(port, [js[:3], js[3:5]])
        p_params, p_stats = jax.device_get(jax.jit(lambda b: init_params(pna, b, seed=0))(
            jbs[0]))
        mb_groups = [_molecules(3, seed=2, dataset_id=0), _molecules(2, seed=3, dataset_id=1)]
        mb_jbs, mb_tbs = _batches(port, mb_groups)
        schnet = jcreate_model(worker.schnet_mb_cfg(jspec))
        mb_params = jax.device_get(jax.jit(lambda b: init_params(schnet, b, seed=0)[0])(
            mb_jbs[0]))
        config, jsplits, tsplits, run_params = _run_inputs(port, work)
        mb_sets = [tuple(_to_port(port, part) for part in (ms[:32], ms[32:40], ms[40:]))
                   for ms in (_molecules(48, seed=10 + b) for b in range(2))]
        torch.save({"deg": deg, "pna_params": _plain(p_params), "mb_sets": mb_sets,
                    "pna_stats": _plain(p_stats), "dp_batches": tbs,
                    "mb_params": _plain(mb_params), "mb_batches": mb_tbs,
                    "run_params": _plain(run_params), "run_config": config, "run_splits": tsplits},
                   str(work / "inputs.pt"))
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_dp_worker.py"), str(r), "2",
             str(work)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)]
        try:
            want = {"dp": _dp_reference((deg, p_params, p_stats, jbs)),
                    "mb": _mb_reference((mb_params, mb_jbs)),
                    "run": _jax_run(config, jsplits, run_params, mp),
                    "run_test_y": np.stack([s.y_graph for s in tsplits[2]]),
                    "mb_params": mb_params, "deg": deg}
            logs = [p.communicate(timeout=240)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        got = [torch.load(str(work / f"out{r}.pt"), weights_only=False) for r in range(2)]
    finally:
        mp.undo()
    return got, want


def _check_step(port, got_step, want_step, name):
    loss, tasks, snap = got_step
    tot, j_tasks, j_grads, j_params, j_stats = want_step
    _assert_close(loss, tot, F32_TOL, f"{name} loss")
    _assert_close(tasks, j_tasks, F32_TOL, f"{name} tasks")
    want_g = {k: v.numpy() for k, v in port.convert.params_from_jax(j_grads).items()}
    want_p = {k: v.numpy() for k, v in port.convert.params_from_jax(j_params, j_stats).items()}
    assert set(snap["grads"]) == set(want_g)
    # Gradients and parameters are held at the atol scaled by the largest
    # over every parameter: biases in front of a batch norm have a true
    # gradient of zero, and both packages return rounding noise there.
    g_scale = max(float(np.abs(g).max()) for g in want_g.values())
    for k, g in snap["grads"].items():
        _assert_close(g, want_g[k], GRAD_TOL, f"{name} grad {k}", g_scale)
    p_scale = max(float(np.abs(want_p[k]).max()) for k in snap["params"])
    for k, v in snap["params"].items():
        _assert_close(v, want_p[k], GRAD_TOL, f"{name} {k}", p_scale)
    for k, v in snap["stats"].items():
        _assert_close(v, want_p[k], GRAD_TOL, f"{name} {k}")


@pytest.mark.parametrize("scheme", ["dp", "zero"])
def test_two_rank_dp_steps_match_jax(port, two_ranks, scheme):
    """(d), (e): the eval step and two train steps (3 and 2 real graphs;
    then the second slot fully masked) on both ranks against JAX's dp
    steps; both ranks hold the same results."""
    got, want = two_ranks
    for r in range(2):
        g = got[r][scheme]
        _assert_close(g["eval"][0], want["dp"]["eval"][0], F32_TOL, "eval loss")
        _assert_close(g["eval"][1], want["dp"]["eval"][1], F32_TOL, "eval tasks")
        _check_step(port, g["step1"], want["dp"]["step1"], f"rank {r} step 1")
        _check_step(port, g["step2"], want["dp"]["step2"], f"rank {r} step 2")
    assert got[0][scheme]["step2"][0] == got[1][scheme]["step2"][0]
    assert got[0]["zero"]["sharded"] == ["DTensor"] and got[0]["dp"]["sharded"] == ["Parameter"]


def test_two_rank_zero_step_equals_dp(two_ranks):
    """(e): ZeRO's step against the dp step in the port."""
    got, _ = two_ranks
    for step in ("step1", "step2"):
        a, b = got[0]["dp"][step], got[0]["zero"][step]
        _assert_close(b[0], a[0], F32_TOL, f"{step} loss")
        g_scale = max(float(np.abs(g).max()) for g in a[2]["grads"].values())
        for part in ("grads", "params", "stats"):
            for k, v in a[2][part].items():
                _assert_close(b[2][part][k], v, GRAD_TOL, f"{step} {part} {k}",
                              g_scale if part == "grads" else None)


def test_two_rank_hsdp_step_equals_single(two_ranks):
    """HSDP (``{data: 1, fsdp: 2}``): both ranks take the one slot (the
    JAX package shards the batch over ``data`` only) and shard the
    parameters; the step equals the single scheme's on that batch
    (loss, gradients, parameters, statistics), on both ranks."""
    got, _ = two_ranks
    for r in range(2):
        h = got[r]["hsdp"]
        assert h["slot"] == 0
        (l1, a), (l2, b) = h["hsdp"], h["single"]
        _assert_close(l1, l2, F32_TOL, "loss")
        g_scale = max(float(np.abs(g).max()) for g in b["grads"].values())
        for part in ("grads", "params", "stats"):
            for k, v in b[part].items():
                _assert_close(a[part][k], v, GRAD_TOL, f"{part} {k}",
                              g_scale if part == "grads" else None)


def test_two_rank_multibranch_step_matches_jax(port, two_ranks):
    """(f): the multibranch step with the dual optimizer: loss, every
    gradient (mean over slots, decoders rescaled by D / D_b), and every
    AdamW-updated parameter (entries with a gradient within the
    tolerance of zero held to a move of at most lr), equal on both
    ranks."""
    got, want = two_ranks
    tot, tasks, j_grads, j_params = want["mb"]
    want_g = {k: v.numpy() for k, v in port.convert.params_from_jax(j_grads).items()}
    want_p = {k: v.numpy() for k, v in port.convert.params_from_jax(j_params).items()}
    lr = worker.MB_TRAINING["Optimizer"]["learning_rate"]
    g_scale = max(float(np.abs(g).max()) for g in want_g.values())
    for r in range(2):
        g = got[r]["mb"]
        assert g["groups"][0] > 0 and g["groups"][1] > 0
        _assert_close(g["loss"], tot, F32_TOL, "loss")
        for k, grad in g["snap"]["grads"].items():
            _assert_close(grad, want_g[k], GRAD_TOL, f"grad {k}", g_scale)
            noise = np.abs(want_g[k]) <= GRAD_TOL["atol"] * min(g_scale, 1.0)
            p, ref = g["snap"]["params"][k], want_p[k]
            same = np.isclose(p, ref, rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"])
            assert (same | (noise & (np.abs(p - ref) <= 2.001 * lr))).all(), k
    for k, v in got[0]["mb"]["snap"]["params"].items():
        np.testing.assert_array_equal(v, got[1]["mb"]["snap"]["params"][k])


def test_branch_split_and_decoder_rescale_match_jax(port, two_ranks):
    """``proportional_branch_split``, ``branch_of_device`` and
    ``rescale_decoder_grads`` (found by module name, longest branch name
    first) against the JAX package's, bit for bit."""
    torch = port.torch
    from hydragnn_tpu_torch.parallel import multibranch as tmb

    for sizes, n in (([300, 120, 80], 3), ([300, 120, 80], 8), ([5, 1], 4), ([7, 7, 7], 4)):
        assert tmb.proportional_branch_split(sizes, n) == jmb.proportional_branch_split(sizes, n)
        dpb = jmb.proportional_branch_split(sizes, n)
        np.testing.assert_array_equal(tmb.branch_of_device(dpb), jmb.branch_of_device(dpb))
    params = two_ranks[1]["mb_params"]
    want = port.convert.params_from_jax(
        jmb.rescale_decoder_grads(params, worker.schnet_mb_cfg(jspec), 3, (2, 1)))
    got = tmb.rescale_decoder_grads(port.convert.params_from_jax(params),
                                    worker.schnet_mb_cfg(port.spec), 3, (2, 1))
    assert set(got) == set(want)
    scaled = [k for k in got if not torch.equal(got[k], port.convert.params_from_jax(params)[k])]
    assert scaled and all(".decoder." in f".{k}" or k.startswith("decoder") for k in scaled)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_two_rank_run_training_matches_jax(two_ranks):
    """(g): two packed dp epochs of ci.json's SchNet: per-epoch losses on
    both ranks against the JAX package's; run_prediction's lockstep pass
    returns every test sample in the JAX package's order on both ranks,
    its error the last test loss; rank 0 wrote the checkpoint."""
    got, want = two_ranks
    j_hist, (j_err, _, j_trues, j_preds) = want["run"]
    for r in range(2):
        g = got[r]["run"]
        for name in ("train_loss", "val_loss", "test_loss"):
            _assert_close(g[name], getattr(j_hist, name), GRAD_TOL, name)
        _assert_close(g["error"], j_err, GRAD_TOL, "error")
        np.testing.assert_allclose(g["error"], g["test_loss"][-1], rtol=1e-6)
        np.testing.assert_array_equal(g["trues"][0], j_trues[0])
        _assert_close(g["preds"][0], j_preds[0], GRAD_TOL, "preds")
        assert g["ckpt"]
    assert got[0]["run"]["train_loss"] == got[1]["run"]["train_loss"]


def test_two_rank_dp_feed_through_the_pipeline(two_ranks):
    """The dp feed through two collation workers and the prefetch thread,
    buffers recycled after ``DPLoader.required_hold(2)`` = 4 deliveries,
    equals the serial feed on both ranks: this rank's slot of two packed
    epochs (supersteps of 2; the second resumed at step 1) and three
    epochs of a cached eval loader."""
    got, _ = two_ranks
    for r in range(2):
        g = got[r]["pipeline"]
        assert g["chain"] == ["PrefetchLoader", "DPLoader", "ParallelPipelineLoader",
                              "GraphLoader"], g["chain"]
        assert g["hold"] == 4
        assert g["same"] == [True] * 5, g
        assert all(n > 0 for n in g["deliveries"]) and g["macros"] > 0


def test_two_rank_run_as_two_nodes(two_ranks):
    """The multi-node form (each rank a node of its own): both ranks train
    on their equal shards to the same history, and run_prediction returns
    every test sample on both ranks in the JAX package's multi-host order
    (node 0's shard, node 1's shard, then what the equal shards leave
    out: ``testset[equal * nodes:]``)."""
    got, want = two_ranks
    a, b = got[0]["nodes"], got[1]["nodes"]
    assert a["train_loss"] == b["train_loss"] and np.isfinite(a["train_loss"]).all()
    test = want["run_test_y"]
    n, p = len(test), 2
    equal = n // p
    blocks = [list(range(r * (n // p) + min(r, n % p),
                         r * (n // p) + min(r, n % p) + n // p + (r < n % p)))[:equal]
              for r in range(p)]
    order = blocks[0] + blocks[1] + list(range(equal * p, n))
    for g in (a, b):
        np.testing.assert_array_equal(g["trues"][0], test[order])
        assert np.isfinite(g["preds"][0]).all() and g["preds"][0].shape == (n, 1)
    np.testing.assert_array_equal(a["preds"][0], b["preds"][0])


# ----------------------------------------------------------------------
# (c) world 1, in this process
# ----------------------------------------------------------------------


def test_world_one_dp_step_equals_single_bit_for_bit(port, tmp_path):
    """(c): under a gloo group of one, the dp train step (its count and
    gradient all-reduces, the weight n/n = 1) and the single scheme's
    step from the same parameters give the same loss, gradients,
    parameters and running statistics bit for bit."""
    import torch.distributed as dist

    torch = port.torch
    js = _molecules(6, seed=5)
    deg = gather_deg(js)
    _, tbs = _batches(port, [js])
    cfg = worker.pna_cfg(port.spec, deg)
    base = port.create.create_model(cfg, "cpu")
    results = {}
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        plan = port.runtime.plan_from_config(
            {"NeuralNetwork": {"Training": {"Parallelism": {"scheme": "dp"}}}})
        assert plan.scheme == "dp" and plan.mesh.size == 1
        assert port.runtime.plan_from_config({}).scheme == "single"
        for scheme in ("single", "dp"):
            model = copy.deepcopy(base)
            opt = port.optimizer.select_optimizer(model.parameters(), worker.MB_TRAINING)
            if scheme == "dp":
                step = port.dp.make_dp_train_step(model, opt, cfg, plan)
            else:
                step = port.loop.make_train_step(model, opt, cfg)
            _, loss, tasks = step(port.state.TrainState(model, opt), tbs[0])
            results[scheme] = [loss, tasks] + [p.grad for p in model.parameters()] + [
                t for t in model.state_dict().values()]
    finally:
        dist.destroy_process_group()
    for a, b in zip(results["single"], results["dp"]):
        assert torch.equal(a, b)


def test_world_one_dp_prediction_takes_the_dp_pass(port, tmp_path):
    """Under a gloo group of one, ``run_prediction`` of a dp config takes
    the dp test pass (its ``("dp", "test")`` steps over ``DPLoader``'s
    slot and the slots' gather), as training does, and returns the
    single pass's samples: the same targets in the same order, the
    predictions and the error within the f32 forward tolerance."""
    import torch.distributed as dist

    path = str(tmp_path / "data")
    port.synthetic.deterministic_graph_data(path, number_configurations=N_CONFIGS, seed=7)
    config = _ci_config(path)
    config["NeuralNetwork"]["Training"]["Parallelism"]["data"] = 1
    samples = port.raw.process_raw_samples(
        port.raw.read_lsms_directory(path, config["Dataset"]), config)
    splits = port.loader.split_dataset(samples, 0.7, stratified=True)
    from hydragnn_tpu_torch.config import update_config

    model, cfg = port.create.create_model_config(
        update_config(copy.deepcopy(config), *splits), "cpu")
    state = port.state.TrainState(model, None)
    keys = []
    plain_dispatch = port.loop._dispatch

    def recorded(run, graphs, key, batches, device):
        keys.append(key[:2])
        return plain_dispatch(run, graphs, key, batches, device)

    port.loop._dispatch = recorded
    try:
        single = port.runner.run_prediction(config, splits, state=state, model=model, cfg=cfg)
        assert keys and set(keys) == {("test", port.torch.float32)}
        keys.clear()
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1)
        try:
            dp = port.runner.run_prediction(config, splits, state=state, model=model, cfg=cfg)
        finally:
            dist.destroy_process_group()
    finally:
        port.loop._dispatch = plain_dispatch
    assert keys and set(keys) == {("dp", "test")}
    np.testing.assert_array_equal(dp[2][0], single[2][0])
    _assert_close(dp[3][0], single[3][0], F32_TOL, "preds")
    _assert_close(dp[0], single[0], F32_TOL, "error")


def test_accumulate_matches_optax_multisteps(port):
    """``accumulate`` (optax.MultiSteps: gradients averaged over 3 calls,
    AdamW stepped on every third) over six calls of fixed gradients
    against the JAX package's ``accumulate``: parameters after every call
    (rtol 1e-5, atol 1e-5 x max|ref|), unchanged between updates."""
    import optax

    torch = port.torch
    from hydragnn_tpu_torch.parallel.multibranch import accumulate

    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in p0] for _ in range(6)]
    training = {"Optimizer": {"type": "AdamW", "learning_rate": 0.05}}
    tx = jmb.accumulate(jselect_optimizer(training), 3)
    params = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(params)
    t_params = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    t_opt = accumulate(port.optimizer.select_optimizer(t_params, training), 3)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, params)
        params = optax.apply_updates(params, updates)
        before = [p.detach().clone() for p in t_params]
        for p, x in zip(t_params, g):
            p.grad = torch.tensor(x)
        t_opt.step()
        for p, want, old in zip(t_params, params, before):
            want = np.asarray(want)
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(want).max()))
            if i % 3 != 2:
                assert torch.equal(p.detach(), old)


def test_unported_features_still_raise(port):
    """Every dataset format of the JAX package is ported (item 10c,
    tests/test_torch_formats.py): only a format neither package reads
    raises, a ValueError as in the JAX package; the parallel input
    pipeline's config resolves on the single and dp schemes, and the
    single scheme's loaders are fed by the collation workers (it runs
    through ``run_training`` in tests/test_torch_pipeline.py and, with a
    ``continue``, in tests/test_torch_checkpoint.py)."""
    config = {"Dataset": {"format": "netcdf", "path": {"total": "nowhere"}},
              "NeuralNetwork": {"Training": {"Parallelism": {"pipeline": {"workers": 2}}}}}
    with pytest.raises(ValueError, match="Unknown Dataset.format: netcdf"):
        port.runner.run_training(copy.deepcopy(config), device="cpu")
    for scheme, n in (("single", 1), ("dp", 2), ("multibranch", 2)):
        config["NeuralNetwork"]["Training"]["Parallelism"]["scheme"] = scheme
        plan = port.runtime.plan_from_config(config, n_devices=n)
        assert (plan.scheme, plan.pipeline_workers, plan.prefetch) == (scheme, 2, 2)
    plan = port.runtime.plan_from_config(
        {"NeuralNetwork": {"Training": {"Parallelism": {"pipeline": {"workers": 2}}}}})
    samples = [port.graph.GraphSample(x=np.ones((3, 1), np.float32),
                                      edge_index=np.array([[0, 1], [1, 2]]),
                                      y_graph=np.ones(1, np.float32)) for _ in range(6)]
    feed = port.runtime.wrap_loader(plan, port.loader.GraphLoader(samples, 2), device="cpu")
    assert type(feed).__name__ == "ParallelPipelineLoader" and len(list(feed)) == 3


def _same_history(a, b, what):
    for name in ("train_loss", "val_loss", "test_loss"):
        assert a[name] == b[name], f"{what}: {name} {a[name]} != {b[name]}"
    assert set(a["params"]) == set(b["params"])
    for k, v in a["params"].items():
        assert torch_equal(v, b["params"][k]), f"{what}: {k}"


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def test_two_rank_guard_identity_and_resume(two_ranks):
    """The dp durability cases on both ranks: the guarded run with resume
    containers equals the plain run bit for bit (losses and every tensor
    of the model), and the run stopped mid-epoch after 6 of its steps
    then continued equals the uninterrupted one bit for bit."""
    got, _ = two_ranks
    for r in range(2):
        d = got[r]["durability"]
        assert d["stopped_at"] == 6 and d["guard"]["steps"] > 8
        _same_history(d["guard"], d["plain"], f"rank {r} guard on vs off")
        _same_history(d["resumed"], d["guard"], f"rank {r} stopped + continued")


@pytest.mark.parametrize("scheme", ["dp", "zero"])
def test_two_rank_guarded_steps_equal_unguarded(two_ranks, scheme):
    """The two dp (and ZeRO: the guard saves and selects each rank's
    shards, and the gradient norm is whole over the ranks) train steps
    with the guard on: the same losses and parameters bit for bit, every
    step's predicate true."""
    got, _ = two_ranks
    for r in range(2):
        g = got[r][scheme]
        for (loss, ok, params), want in zip(g["guarded"], (g["step1"], g["step2"])):
            assert ok and loss == want[0]
            assert set(params) == set(want[2]["params"])
            for k, v in params.items():
                np.testing.assert_array_equal(v, want[2]["params"][k], err_msg=k)


def test_two_rank_guard_skips_injected_nan(two_ranks):
    """``nan:loss@2`` under dp: every rank's guard skips global step 2
    alone (the predicate reads the reduced loss, so the ranks agree) and
    both keep the same finite history and parameters; unguarded, the
    first epoch's loss goes non-finite."""
    got, _ = two_ranks
    a, b = (got[r]["durability"] for r in range(2))
    assert a["nan"]["bad"] == b["nan"]["bad"] == [(0, 2)]
    assert np.isfinite(a["nan"]["train_loss"]).all()
    _same_history(a["nan"], b["nan"], "ranks 0 and 1")
    assert a["nan"]["train_loss"] != a["guard"]["train_loss"]
    assert not np.isfinite(a["nan_off"]["train_loss"][0])


# ----------------------------------------------------------------------
# (h) the multibranch guard and mid-epoch resume
# ----------------------------------------------------------------------


def test_two_rank_multibranch_guarded_steps_equal_unguarded(two_ranks):
    """Two multibranch steps with the guard on (per-slot predicates and
    selects) and off, from the same parameters: the same losses and
    every tensor of the state (parameters, AdamW moments, both groups'
    step counts and rates) bit for bit on both ranks, every slot true."""
    got, _ = two_ranks
    for r in range(2):
        g = got[r]["mb_guard"]
        assert g["labels"] == ["branch-0", "branch-1", "encoder"]
        for (l0, _, s0), (l1, ok, s1) in zip(g["plain"], g["guarded"]):
            assert l0 == l1 and ok == [True, True, True]
            assert set(s0) == set(s1)
            for k, v in s0.items():
                assert torch_equal(v, s1[k]), f"rank {r}: {k}"


def _slot_of(key, slots):
    """A state tensor's guard slot: its decoder branch, else 2 (the
    encoder: encoder parameters, buffers and the groups' tensors)."""
    if key.startswith("model/"):
        name = key[len("model/"):]
    elif key.startswith("opt/"):
        name = key[len("opt/"):].rsplit("/", 1)[0]
    else:
        return 2
    b = slots.get(f"model/{name}")
    return 2 if b is None else b


def test_two_rank_multibranch_guard_contains_a_branch_poison(two_ranks):
    """NaN labels on branch 1's slot for one guarded step (the dual
    optimizer, no clip; tests/test_guard.py's containment drill): the
    predicate is [branch-0 ok, branch-1 bad, encoder bad] on both ranks,
    the step adds nothing to the epoch's sums, branch 1's decoder and
    the encoder (every group's step count included) stay as they were
    and branch 0's decoder takes the clean step's update, bit for bit."""
    got, _ = two_ranks
    for r in range(2):
        g = got[r]["mb_guard"]
        clean, bad = g["clean"], g["poisoned"]
        assert clean["ok"] == [True, True, True]
        assert bad["ok"] == [True, False, False]
        assert bad["loss"] == 0.0 and bad["graphs"] == 0.0
        moved = 0
        for k, before in bad["before"].items():
            slot = _slot_of(k, g["slots"])
            after = bad["after"][k]
            if slot == 0:
                assert torch_equal(after, clean["after"][k]), f"rank {r}: {k}"
                moved += not torch_equal(after, before)
            else:
                assert torch_equal(after, before), f"rank {r}: {k} (slot {slot})"
        assert moved > 0


def test_two_rank_multibranch_stopped_and_continued(two_ranks):
    """run_training under the multibranch scheme with the guard on and
    resume containers every 2 steps (8 steps an epoch), stopped after its
    6th step: the newest container's cursor is step 4 of epoch 0 with
    per-branch cursors [4, 4]; continued, the run equals the
    uninterrupted one bit for bit (losses and every model tensor), on
    both ranks (tests/test_durability.py's multibranch resume)."""
    got, _ = two_ranks
    for r in range(2):
        d = got[r]["mb_resume"]
        assert d["stopped_at"] == 6 and d["whole"]["steps"] == 16
        m = d["manifest"]
        assert (m["epoch"], m["step"], m["branch_steps"]) == (0, 4, [4, 4])
        _same_history(d["resumed"], d["whole"], f"rank {r} stopped + continued")
        assert d["resumed"]["steps"] == 16


# ----------------------------------------------------------------------
# (i) the sharded checkpoint format under ZeRO
# ----------------------------------------------------------------------


def test_two_rank_zero_sharded_checkpoint(port, two_ranks):
    """A ZeRO state (PNA, AdamW, one step) saved in the sharded format:
    each rank's file holds exactly its own shard of every FSDP2 tensor
    (rank 1's at the offset ceil(n / 2)), rank 0's also the replicated
    tensors (the batch norms' statistics, the 0-d step counts and
    rates); restored into a fresh ZeRO model each
    rank's shards equal the live ones bit for bit; and here, at world 1,
    an unsharded model restored from both files equals the gathered
    state bit for bit."""
    from hydragnn_tpu_torch.utils import checkpoint as ck

    got, want = two_ranks
    for r in range(2):
        sh = got[r]["sharded"]
        assert sh["local_equal"] and sh["steps"] == (1, 1)
        plain = set(sh["plain"])
        assert {k for k in sh["local"] if k.startswith("optimizer/param_groups")} <= plain
        assert any(k.startswith("optimizer/state") for k in set(sh["local"]) - plain)
        held = set(sh["file"])
        assert held == (set(sh["local"]) if r == 0 else set(sh["local"]) - plain)
        for k, (shape, offsets) in sh["file"].items():
            assert shape == sh["local"][k], k
            full = sh["full"][k]
            if k not in plain and full.ndim:
                assert offsets[0] == (0 if r == 0 else -(-full.shape[0] // 2)), k
    torch = port.torch
    model = port.create.create_model(worker.pna_cfg(port.spec, want["deg"]), "cpu")
    state = port.state.TrainState(
        model, port.optimizer.select_optimizer(model.parameters(), worker.MB_TRAINING))
    ck._restore_sharded_dir(state, got[0]["sharded"]["path"])
    back = dict(ck._tensor_leaves(ck._state_tree(state)))
    assert set(back) == set(got[0]["sharded"]["full"]) and state.step == 1
    for k, v in got[0]["sharded"]["full"].items():
        assert torch.equal(back[k], torch.as_tensor(v)), k


def test_two_rank_zero_run_sharded_equals_pt(two_ranks):
    """ci.json's SchNet under ZeRO for one epoch with ``checkpoint_format``
    "orbax" and with ".pt": the same losses and every full tensor bit for
    bit (tests/test_model_loadpred.py's format cases); the orbax run wrote
    ``orbax/final`` and its pointers, and ``run_prediction(config)`` from
    it gives the same finite error on both ranks."""
    got, _ = two_ranks
    for r in range(2):
        runs = got[r]["sharded"]["runs"]
        _same_history(runs["orbax"], runs["pt"], f"rank {r} orbax vs pt")
        assert {"LATEST", "RESUME", "final"} <= set(runs["orbax_dir"])
        assert np.isfinite(runs["orbax_pred"][0])
    assert got[0]["sharded"]["runs"]["orbax_pred"][0] == got[1]["sharded"]["runs"]["orbax_pred"][0]
