"""One rank of tests/test_torch_dp.py's process group, and the model
configurations both sides build.

Run as a script (the test starts one process per rank):

    python tests/_torch_dp_worker.py RANK WORLD DIR

Each rank joins a gloo group through a FileStore in DIR, reads the
inputs the test wrote there (``inputs.pt``: numpy parameters from the
JAX package, port GraphSamples and batches), runs the port's dp, ZeRO
and multibranch steps and the dp ``run_training``/``run_prediction``
(on one node, then as two nodes), then the dp durability cases (the
guard on a healthy run and on an injected NaN, and a run stopped
mid-epoch then continued), the multibranch guard (guarded steps, a
label poison on one branch) and a multibranch run stopped mid-epoch
then continued, the sharded checkpoint format under ZeRO (a state
saved and restored, and a ZeRO run in both formats), and the dp feed
through the collation workers against the serial feed, and writes what
it saw to ``out<RANK>.pt``.
It imports torch and the port only (never jax, the JAX package or the
tests' conftest).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# The small models of the dp cases: PNA with its MaskedBatchNorm stack,
# and SchNet with two graph branches for the multibranch step.
DP_TRAINING = {"Optimizer": {"type": "SGD", "learning_rate": 0.1}}
MB_TRAINING = {"Optimizer": {"type": "AdamW", "learning_rate": 2e-3}}


def pna_cfg(spec, deg):
    """PNA, 2 layers at hidden 8, one graph head."""
    return spec.ModelConfig(
        mpnn_type="PNA", input_dim=1, hidden_dim=8, num_conv_layers=2,
        heads=(spec.HeadSpec("y", "graph", 1),),
        graph_branches=(spec.BranchSpec(num_sharedlayers=1, dim_sharedlayers=8,
                                        num_headlayers=1, dim_headlayers=(8,)),),
        task_weights=(1.0,), radius=2.0, pna_deg=tuple(int(d) for d in deg),
        max_neighbours=len(deg) - 1,
    )


def schnet_mb_cfg(spec, n_branches=2):
    """SchNet, 2 layers at hidden 8, one graph head on ``n_branches``
    decoder branches."""
    return spec.ModelConfig(
        mpnn_type="SchNet", input_dim=1, hidden_dim=8, num_conv_layers=2,
        heads=(spec.HeadSpec("y", "graph", 1),),
        graph_branches=tuple(spec.BranchSpec(name=f"branch-{i}", dim_sharedlayers=8,
                                             dim_headlayers=(8,))
                             for i in range(n_branches)),
        task_weights=(1.0,), radius=2.0, num_gaussians=8, num_filters=8,
    )


def _full(t):
    from hydragnn_tpu_torch.parallel.runtime import gather_to_host

    return gather_to_host(t).numpy().copy()


def _snapshot(model) -> dict:
    """Every parameter, gradient and running statistic, whole."""
    out = {"params": {}, "grads": {}, "stats": {}}
    for name, p in model.named_parameters():
        out["params"][name] = _full(p)
        out["grads"][name] = None if p.grad is None else _full(p.grad)
    for name, b in model.named_buffers():
        if name.endswith((".mean", ".var")):
            out["stats"][name] = _full(b)
    return out


def case_dp(inp, rank, zero):
    """(d)/(e): the eval step, then two train steps (unequal real graph
    counts, then slot 1 fully masked) on this rank's slot; and the same
    two steps with the divergence guard on (``guarded``: losses and
    parameters after each)."""
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.parallel import dp
    from hydragnn_tpu_torch.parallel.mesh import DataMesh
    from hydragnn_tpu_torch.parallel.runtime import ParallelPlan
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    cfg = pna_cfg(spec, inp["deg"])
    plan = ParallelPlan(scheme="dp", mesh=DataMesh(data=2), fsdp=zero, fsdp_axis="data")

    def build():
        model = create.create_model(cfg, "cpu")
        model.load_state_dict(convert.params_from_jax(inp["pna_params"], inp["pna_stats"]))
        model = dp.replicate_state(model, plan, "cpu")
        opt = select_optimizer(model.parameters(), DP_TRAINING)
        return model, opt, TrainState(model, opt)

    model, opt, state = build()
    a, b = inp["dp_batches"]
    own = a if rank == 0 else b
    second = a if rank == 0 else dp._masked_out(b)
    ev = dp.make_dp_eval_step(model, cfg, plan)(state, own)
    step = dp.make_dp_train_step(model, opt, cfg, plan)
    _, loss1, tasks1 = step(state, own)
    snap1 = _snapshot(model)
    _, loss2, tasks2 = step(state, second)
    snap2 = _snapshot(model)
    g_model, g_opt, g_state = build()
    g_step = make_train_step(g_model, g_opt, cfg, red=dp.Reduction(g_model, plan), guard=True)
    guarded = []
    for batch in (own, second):
        _, loss, _, _, ok, _ = g_step(g_state, batch)
        guarded.append((float(loss), bool(ok), _snapshot(g_model)["params"]))
    return {"eval": (float(ev[0]), ev[1].numpy().copy()),
            "step1": (float(loss1), tasks1.numpy().copy(), snap1),
            "step2": (float(loss2), tasks2.numpy().copy(), snap2),
            "guarded": guarded,
            "sharded": [type(p).__name__ for p in model.parameters()][:1]}


def case_hsdp(inp, rank):
    """HSDP (``{data: 1, fsdp: 2}``): both ranks hold the one slot and
    shard the parameters; one train step on batch a, and the single
    scheme's step on the same batch without collectives."""
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.parallel import dp
    from hydragnn_tpu_torch.parallel.runtime import plan_from_config
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    cfg = pna_cfg(spec, inp["deg"])
    plan = plan_from_config({"NeuralNetwork": {"Training": {"Parallelism": {
        "scheme": "dp", "data": 1, "fsdp": 2}}}})
    out = {"slot": plan.mesh.slot()}
    for name in ("hsdp", "single"):
        model = create.create_model(cfg, "cpu")
        model.load_state_dict(convert.params_from_jax(inp["pna_params"], inp["pna_stats"]))
        if name == "hsdp":
            model = dp.replicate_state(model, plan, "cpu")
            opt = select_optimizer(model.parameters(), DP_TRAINING)
            step = dp.make_dp_train_step(model, opt, cfg, plan)
        else:
            opt = select_optimizer(model.parameters(), DP_TRAINING)
            step = make_train_step(model, opt, cfg)
        _, loss, _ = step(TrainState(model, opt), inp["dp_batches"][0])
        out[name] = (float(loss), _snapshot(model))
    return out


def case_multibranch(inp, rank):
    """(f): one multibranch step with the dual optimizer at devices per
    branch [1, 1]: slot r holds branch r's batch."""
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.parallel.mesh import DataMesh
    from hydragnn_tpu_torch.parallel.multibranch import dual_optimizer, make_multibranch_train_step
    from hydragnn_tpu_torch.parallel.runtime import ParallelPlan
    from hydragnn_tpu_torch.train.state import TrainState

    cfg = schnet_mb_cfg(spec)
    model = create.create_model(cfg, "cpu")
    model.load_state_dict(convert.params_from_jax(inp["mb_params"]))
    plan = ParallelPlan(scheme="multibranch", mesh=DataMesh(data=2), devices_per_branch=(1, 1))
    opt = dual_optimizer(model, MB_TRAINING)
    step = make_multibranch_train_step(model, opt, cfg, plan, (1, 1))
    _, loss, tasks = step(TrainState(model, opt), inp["mb_batches"][rank])
    return {"loss": float(loss), "tasks": tasks.numpy().copy(), "snap": _snapshot(model),
            "groups": [len(g["params"]) for g in opt.param_groups]}


def _poison_labels(batch):
    """``batch`` with its real graphs' targets NaN (a host-side label
    poison: only this slot's branch reads them)."""
    import dataclasses

    import numpy as np
    import torch

    y, real = batch.y_graph, np.asarray(batch.graph_mask)
    if isinstance(y, torch.Tensor):
        y = y.clone()
        y[torch.as_tensor(real)] = float("nan")
    else:
        y = np.array(y, copy=True)
        y[real] = np.nan
    return dataclasses.replace(batch, y_graph=y)


def case_mb_guard(inp, rank):
    """The multibranch guard on the step of case_multibranch (the dual
    optimizer, no clip): two unguarded and two guarded steps from the
    same parameters (losses, predicates, parameters after each); then,
    from those parameters again, a clean guarded step and one whose
    rank-1 sub-batch (branch 1's) has NaN labels: the predicates, and
    every tensor of the state before and after each."""
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.parallel import multibranch as mb
    from hydragnn_tpu_torch.parallel.mesh import DataMesh
    from hydragnn_tpu_torch.parallel.runtime import ParallelPlan
    from hydragnn_tpu_torch.train.state import TrainState

    cfg = schnet_mb_cfg(spec)
    plan = ParallelPlan(scheme="multibranch", mesh=DataMesh(data=2), devices_per_branch=(1, 1))

    def build(guard):
        model = create.create_model(cfg, "cpu")
        model.load_state_dict(convert.params_from_jax(inp["mb_params"]))
        opt = mb.dual_optimizer(model, MB_TRAINING)
        return model, opt, mb.make_multibranch_train_step(model, opt, cfg, plan, (1, 1),
                                                          guard=guard)

    def state_of(model, opt):
        """Every tensor of the state by name: the model's, each
        parameter's optimizer state, each group's step count and rate."""
        name = {id(p): n for n, p in model.named_parameters()}
        out = {f"model/{k}": v.detach().clone() for k, v in model.state_dict().items()}
        out.update({f"opt/{name[id(p)]}/{k}": v.clone() for p, st in opt.state.items()
                    for k, v in st.items()})
        out.update({f"group/{i}/{k}": v.clone() for i, g in enumerate(opt.param_groups)
                    for k, v in g.items() if k != "params" and hasattr(v, "clone")})
        return out

    batch = inp["mb_batches"][rank]
    out = {"plain": [], "guarded": []}
    for name in ("plain", "guarded"):
        model, opt, step = build(name == "guarded")
        st = TrainState(model, opt)
        for _ in range(2):
            res = step(st, batch)
            ok = res[4].tolist() if name == "guarded" else None
            out[name].append((float(res[1]), ok, state_of(model, opt)))
    for name, b in (("clean", batch), ("poisoned", _poison_labels(batch) if rank == 1 else batch)):
        model, opt, step = build(True)
        before = state_of(model, opt)
        res = step(TrainState(model, opt), b)
        out[name] = {"before": before, "after": state_of(model, opt), "ok": res[4].tolist(),
                     "loss": float(res[1]), "graphs": float(res[3])}
    out["slots"] = {f"model/{n}": mb.decoder_branch_of_name(n, cfg)
                    for n, _ in model.named_parameters()}
    out["labels"] = mb.branch_guard_labels(2)
    return out


def mb_run_config(name, **training):
    """A multibranch run_training config: SchNet at hidden 8, one graph
    head on two branches, batch 4, AdamW (the dual optimizer)."""
    branch = {"num_sharedlayers": 1, "dim_sharedlayers": 8, "num_headlayers": 1,
              "dim_headlayers": [8]}
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": name},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "SchNet", "hidden_dim": 8, "num_conv_layers": 2, "radius": 2.0,
                "max_neighbours": 16, "num_gaussians": 8, "num_filters": 8,
                "output_heads": {"graph": [{"type": f"branch-{i}", "architecture": branch}
                                           for i in range(2)]},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {"input_node_features": [0], "output_names": ["y"],
                                      "output_index": [0], "type": ["graph"],
                                      "output_dim": [1]},
            "Training": dict({"num_epoch": 2, "batch_size": 4, "precision": "fp32",
                              "Optimizer": {"type": "AdamW", "learning_rate": 2e-3},
                              "Parallelism": {"scheme": "multibranch"}}, **training),
        },
    }


def case_mb_resume(inp, rank):
    """run_training under the multibranch scheme with Guard on and resume
    containers every 2 steps (8 steps an epoch): uninterrupted, stopped
    after its 6th step (``resumed`` continues it), and the stopped run's
    newest container manifest."""
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.utils import faults

    durable = {"Guard": {"enabled": True},
               "Checkpoint": {"enabled": True, "interval_steps": 2}}
    sets = inp["mb_sets"]
    out = {}
    state, model, _, hist, _ = runner.run_training(mb_run_config("mb_whole", **durable),
                                                   datasets=sets, device="cpu")
    out["whole"] = dict(_history(hist, model), steps=state.step)
    tick = faults.tick
    seen = []

    def stop_at_6(site):
        seen.append(site)
        if len(seen) == 6:
            raise _Stop()

    faults.tick = stop_at_6
    try:
        runner.run_training(mb_run_config("mb_stopped", **durable), datasets=sets,
                            device="cpu")
    except _Stop:
        out["stopped_at"] = len(seen)
    finally:
        faults.tick = tick
    out["manifest"] = torch_load(os.path.join(
        "logs", _only_run("mb_stopped"), "resume.pt"))["manifest"]
    state, model, _, hist, _ = runner.run_training(
        mb_run_config("mb_stopped", **durable, **{"continue": 1}), datasets=sets,
        device="cpu")
    out["resumed"] = dict(_history(hist, model), steps=state.step)
    return out


def _only_run(prefix):
    """The one run directory under logs/ named from ``prefix``."""
    runs = [d for d in os.listdir("logs") if d.startswith(prefix)]
    assert len(runs) == 1, runs
    return runs[0]


def torch_load(path):
    import torch

    return torch.load(path, weights_only=True)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def case_sharded(inp, rank):
    """The sharded format under ZeRO (FSDP2 over both ranks): PNA with
    AdamW after one step, saved with ``save_checkpoint_sharded``; what
    each rank's file holds; the state restored into a fresh ZeRO model
    (each rank from its own file) against the live one bit for bit, and
    the full tensors for the test's world-1 restore. Then the ZeRO dp
    run of case_run (one epoch) with ``checkpoint_format`` "orbax" and
    with ".pt", and run_prediction(config) from the orbax run's
    directory."""
    import copy

    import torch

    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.parallel import dp
    from hydragnn_tpu_torch.parallel.mesh import DataMesh
    from hydragnn_tpu_torch.parallel.runtime import ParallelPlan
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState
    from hydragnn_tpu_torch.utils import checkpoint as ck

    cfg = pna_cfg(spec, inp["deg"])
    plan = ParallelPlan(scheme="dp", mesh=DataMesh(data=2), fsdp=True, fsdp_axis="data")

    def build():
        model = create.create_model(cfg, "cpu")
        model.load_state_dict(convert.params_from_jax(inp["pna_params"], inp["pna_stats"]))
        model = dp.replicate_state(model, plan, "cpu")
        opt = select_optimizer(model.parameters(), MB_TRAINING)
        return TrainState(model, opt)

    def leaves(st):
        return dict(ck._tensor_leaves(ck._state_tree(st)))

    live = build()
    dp.make_dp_train_step(live.model, live.optimizer, cfg, plan)(live, inp["dp_batches"][rank])
    ck.save_checkpoint_sharded("zero_ckpt", live, epoch=3)
    path = os.path.join("logs", "zero_ckpt", "orbax", "epoch_3")
    mine = torch.load(os.path.join(path, f"rank{rank}.pt"), weights_only=True)
    fresh = build()
    ck.load_checkpoint_sharded("zero_ckpt", fresh)
    got, want = leaves(fresh), leaves(live)
    out = {"local_equal": set(got) == set(want) and all(
        torch.equal(_local(got[k]), _local(want[k])) for k in want),
        "steps": (fresh.step, live.step),
        "file": {k: (list(v.shape), mine["offsets"][k]) for k, v in mine["pieces"].items()},
        "local": {k: list(_local(v).shape) for k, v in want.items()},
        "plain": sorted(k for k, v in want.items() if not hasattr(v, "to_local")),
        "full": {k: _full(v) for k, v in want.items()}, "path": os.path.abspath(path)}

    runs = {}
    for fmt in ("orbax", "pt"):
        config = copy.deepcopy(inp["run_config"])
        config["Dataset"]["name"] = f"zero_{fmt}"
        training = config["NeuralNetwork"]["Training"]
        training.update(num_epoch=1, checkpoint_format=fmt)
        training["Parallelism"]["zero"] = True
        state, model, _, hist, full = _train_from_jax(inp, config)
        runs[fmt] = dict(_history(hist, model), params={
            k: torch.as_tensor(_full(v)) for k, v in model.state_dict().items()})
        if fmt == "orbax":
            err, _, _, preds = runner.run_prediction(full, datasets=inp["run_splits"],
                                                     device="cpu")
            runs["orbax_pred"] = (float(err), preds)
            runs["orbax_dir"] = sorted(os.listdir(os.path.join("logs", full["_log_name"],
                                                               "orbax")))
    out["runs"] = runs
    return out


def _train_from_jax(inp, config):
    """run_training of ``config`` on the run's splits from the JAX run's
    initial parameters."""
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.models import convert

    sd = convert.params_from_jax(inp["run_params"])
    make = runner.create_model_config

    def with_jax_params(config, device=None, *, seed=0):
        model, cfg = make(config, device, seed=seed)
        model.load_state_dict(sd)
        return model, cfg

    runner.create_model_config = with_jax_params
    try:
        return runner.run_training(config, datasets=inp["run_splits"], device="cpu")
    finally:
        runner.create_model_config = make


def _history(hist, model) -> dict:
    return {"train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "test_loss": hist.test_loss,
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def case_run(inp, rank):
    """(g): run_training under {"scheme": "dp", "data": 2} from the JAX
    run's initial parameters, then run_prediction."""
    from hydragnn_tpu_torch import runner

    state, model, cfg, hist, full = _train_from_jax(inp, inp["run_config"])
    err, _, trues, preds = runner.run_prediction(
        full, datasets=inp["run_splits"], state=state, model=model, cfg=cfg)
    return dict(_history(hist, model), error=float(err), trues=trues, preds=preds,
                ckpt=os.path.exists(os.path.join("logs", full["_log_name"], "checkpoint.pt")))


class _Stop(BaseException):
    """Ends a run at a train step, on every rank alike (the in-process
    stand-in for a preemption: the ranks leave between steps)."""


def case_durability(inp, rank):
    """The dp run of case_run at batch 4 (more steps an epoch): with
    ``Training.Guard`` on and resume containers every 2 steps
    (``guard``) and with neither (``plain``); the guarded run stopped
    after its 6th step then continued (``resumed``); and with
    ``nan:loss@2`` armed, guarded (``nan``, with the bad steps its
    monitor saw) and not (``nan_off``)."""
    import copy

    from hydragnn_tpu_torch.train import guard
    from hydragnn_tpu_torch.utils import faults

    def config(name, **training):
        c = copy.deepcopy(inp["run_config"])
        c["Dataset"]["name"] = name
        c["NeuralNetwork"]["Training"].update(batch_size=4, **training)
        return c

    durable = {"Guard": {"enabled": True},
               "Checkpoint": {"enabled": True, "interval_steps": 2}}
    out = {}
    state, model, _, hist, _ = _train_from_jax(inp, config("guarded", **durable))
    out["guard"] = dict(_history(hist, model), steps=state.step)
    _, model, _, hist, _ = _train_from_jax(inp, config("plain"))
    out["plain"] = _history(hist, model)

    tick = faults.tick
    seen = []

    def stop_at_6(site):
        seen.append(site)
        if len(seen) == 6:
            raise _Stop()

    faults.tick = stop_at_6
    try:
        _train_from_jax(inp, config("stopped", **durable))
    except _Stop:
        out["stopped_at"] = len(seen)
    finally:
        faults.tick = tick
    _, model, _, hist, _ = _train_from_jax(inp, config("stopped", **durable, **{"continue": 1}))
    out["resumed"] = _history(hist, model)

    monitors = []
    plain = guard.GuardMonitor

    class Recorded(plain):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            monitors.append(self)

    guard.GuardMonitor = Recorded
    faults.install("nan:loss@2")
    try:
        _, model, _, hist, _ = _train_from_jax(inp, config("nan", Guard={"enabled": True}))
        out["nan"] = dict(_history(hist, model), bad=monitors[0].bad_steps_all)
        _, _, _, hist, _ = _train_from_jax(inp, config("nan_off"))
        out["nan_off"] = {"train_loss": hist.train_loss}
    finally:
        faults.reset()
        guard.GuardMonitor = plain
    return out


def case_nodes(inp, rank):
    """The multi-node form: with ``LOCAL_WORLD_SIZE=1`` each rank counts
    as a node of its own, so each trains on its equal shard of every
    split (unpacked: packing across nodes is refused) and
    run_prediction runs the lockstep pass over the shards, then the
    samples the equal shards leave out."""
    from hydragnn_tpu_torch import runner

    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        state, model, cfg, hist, full = runner.run_training(
            inp["run_config"], datasets=inp["run_splits"], device="cpu")
        err, _, trues, preds = runner.run_prediction(
            full, datasets=inp["run_splits"], state=state, model=model, cfg=cfg)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return {"train_loss": hist.train_loss, "test_loss": hist.test_loss, "error": float(err),
            "trues": trues, "preds": preds}


def case_pipeline(inp, rank):
    """The dp feed through two collation workers and the prefetch thread
    (``wrap_loader`` of a plan with ``pipeline.workers`` 2, ``prefetch``
    2, supersteps of 2), its packed buffers recycled as on a card after
    ``DPLoader.required_hold(2)`` deliveries, against the serial feed
    (workers 0, prefetch 0): this rank's slot of two device-coordinated
    packed epochs, the second resumed at step 1, and three epochs of a
    cached eval loader. Each delivery is cloned as it arrives (the
    loop's copy to the card at the step's start), then a 20 ms stand-in
    for the step lets the workers and the prefetch queue run ahead; the
    clones are compared. Returns the comparison."""
    import time

    import torch

    from hydragnn_tpu_torch.data.loader import GraphLoader, MacroBatch
    from hydragnn_tpu_torch.data.pipeline import owned_copy
    from hydragnn_tpu_torch.parallel import runtime

    def plan(workers, prefetch):
        return runtime.plan_from_config({"NeuralNetwork": {"Training": {"Parallelism": {
            "scheme": "dp", "pipeline": {"workers": workers, "depth": 2, "chunk": 1},
            "prefetch": prefetch, "superstep": {"steps": 2}}}}})

    def batches(item):
        return item.batches if isinstance(item, MacroBatch) else [item]

    def taken(feed):
        out = []
        for item in feed:
            out.append(owned_copy(item))
            time.sleep(0.02)
        return out

    train, val = list(inp["run_splits"][0]), list(inp["run_splits"][1])
    feeds = {}
    for name, (workers, prefetch, device) in {"pipeline": (2, 2, "cuda"),
                                               "serial": (0, 0, None)}.items():
        p = plan(workers, prefetch)
        tr = runtime.wrap_loader(p, GraphLoader(train, 2, shuffle=True, seed=3, packing=True,
                                                pack_max_budgets=1, pack_dp_shards=2),
                                 device=device)
        ev = runtime.wrap_loader(p, GraphLoader(val, 2, cache_batches=True), device=device)
        got = []
        for epoch, cursor in ((0, 0), (1, 1)):
            tr.set_epoch(epoch)
            if cursor:
                tr.skip_to(cursor)
            got.append(taken(tr))
        for epoch in range(3):
            ev.set_epoch(epoch)
            got.append(taken(ev))
        chain, ld = [], tr
        while ld is not None:
            chain.append(type(ld).__name__)
            ld = getattr(ld, "loader", None)
        feeds[name] = (got, chain)
    a, b = feeds["pipeline"][0], feeds["serial"][0]
    same = [len(x) == len(y) and all(
        len(batches(u)) == len(batches(v)) and all(
            u1.arrays().keys() == v1.arrays().keys()
            and all(torch.equal(t, v1.arrays()[k]) for k, t in u1.arrays().items())
            for u1, v1 in zip(batches(u), batches(v)))
        for u, v in zip(x, y)) for x, y in zip(a, b)]
    return {"same": same, "deliveries": [len(x) for x in a],
            "macros": sum(isinstance(u, MacroBatch) for x in a for u in x),
            "chain": feeds["pipeline"][1], "hold": runtime.wrap_loader(
                plan(2, 2), GraphLoader(val, 4), device="cuda").loader.loader.hold}


def main(rank: int, world: int, work: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    os.chdir(work)
    out = {"dp": case_dp(inp, rank, zero=False), "zero": case_dp(inp, rank, zero=True),
           "mb": case_multibranch(inp, rank), "run": case_run(inp, rank),
           "nodes": case_nodes(inp, rank), "hsdp": case_hsdp(inp, rank),
           "durability": case_durability(inp, rank), "mb_guard": case_mb_guard(inp, rank),
           "mb_resume": case_mb_resume(inp, rank), "sharded": case_sharded(inp, rank),
           "pipeline": case_pipeline(inp, rank)}
    torch.save(out, os.path.join(work, f"out{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
