"""Where a train step's device time goes, kernel by kernel, on the card.

    python tools/profile_train_steps.py

Builds three of chip_smoke.py's models at full width with random
weights (seed 0): examples/md17/md17.json's PaiNN potential on
bench.py's molecules, examples/zinc/zinc.json's PNAPlus + GPS on
zinc.py's molecules and examples/open_polymers_2026/polymers.json's SAGE
with its conv node head on the example's chains. Then it times one f32
train step (a fresh AdamW on a copy of the model each time) on:

- md17.json: the first batch of the unpacked bucket ladder (``packing``
  off) and the first packed bin that run_training trains on, in turns
  (ladder, packed, packed, ladder);
- zinc.json and polymers.json: the first packed bin.

For each step it prints the batch's size, the eager time (CUDA events
around 20 back-to-back steps), the device time and kernel count
(``torch.profiler`` over 5 steps, user-annotation ranges left out as
chip_smoke.py leaves them out), and the kernels that take the most
device time, grouped by name.

Then it attributes the step's device time by module: one more profiled
eager step with a ``record_function`` range around every module's
forward (``fwd:<module path>``, opened and closed by forward hooks).
Each kernel counts under the innermost range of the op that launched
it; a backward kernel under the range of the forward op whose autograd
node it runs (matched by the profiler's sequence numbers) as
``bwd:<module path>``; the optimizer's under ``optimizer``. It prints
the modules that take the most device time and, for the row reductions
(kernels named ``reduce_kernel``), which modules launch them. The replay
runs the same kernels. Needs one CUDA device; exits 2 without one.
"""

import copy
import os
import sys
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOP = 8
# reduction kernels (torch's ``at::native::reduce_kernel`` and its kin)
REDUCE = "reduce_kernel"


def module_ranges(model):
    """Forward hooks opening ``fwd:<name>`` profiler ranges around every
    module's forward; returns the hook handles."""
    handles = []
    for name, mod in model.named_modules():
        label = f"fwd:{name or type(mod).__name__}"

        def pre(m, args, _label=label):
            m._profile_range = torch.profiler.record_function(_label)
            m._profile_range.__enter__()

        def post(m, args, out):
            rng = getattr(m, "_profile_range", None)
            if rng is not None:
                m._profile_range = None
                rng.__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return handles


def _scope_of(evt):
    """The innermost ``fwd:`` range above a profiler event, or the
    optimizer's annotation; None when neither encloses it."""
    while evt is not None:
        if evt.name.startswith("fwd:"):
            return evt.name[4:]
        if evt.name.startswith("Optimizer."):
            return "optimizer"
        evt = evt.cpu_parent
    return None


def attribute_by_module(step, model, n_prof=1):
    """Device ms per module scope of ``n_prof`` profiled eager steps
    (module docstring): ``{scope: [ms, kernels, reduce ms, reduce
    kernels]}`` per step."""
    from torch.profiler import ProfilerActivity, profile

    handles = module_ranges(model)
    try:
        step()  # warm: the ranges' first use
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                step()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    events = prof.events()
    fwd_scope = {}
    for e in events:
        if getattr(e, "sequence_nr", -1) >= 0 and not e.name.startswith("autograd::"):
            scope = _scope_of(e)
            if scope is not None:
                fwd_scope.setdefault(e.sequence_nr, scope)
    out = defaultdict(lambda: [0.0, 0, 0.0, 0])
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue  # a range's own span on the device is not a kernel
        for k in getattr(e, "kernels", ()):
            scope, up = _scope_of(e), e
            while up is not None and scope is None:
                if up.name.startswith("autograd::engine::evaluate_function"):
                    fwd = fwd_scope.get(getattr(up, "sequence_nr", -1))
                    scope = None if fwd is None else f"bwd:{fwd}"
                    break
                up = up.cpu_parent
            ms = k.duration / 1e3 / n_prof
            row = out[scope or "(no module range)"]
            row[0] += ms
            row[1] += 1
            if REDUCE in k.name:
                row[2] += ms
                row[3] += 1
    for row in out.values():
        row[1] //= n_prof
        row[3] //= n_prof
    return dict(out)


def report_modules(what, scopes):
    total = sum(v[0] for v in scopes.values())
    red = sum(v[2] for v in scopes.values())
    n_red = sum(v[3] for v in scopes.values())
    print(f"{what} by module: {total:.3f} ms of device time; row reductions ({REDUCE}) "
          f"{n_red} kernels, {red:.3f} ms ({100 * red / max(total, 1e-9):.1f}%)", flush=True)
    for scope, (ms, n, rms, rn) in sorted(scopes.items(), key=lambda kv: -kv[1][0])[:2 * TOP]:
        print(f"    {ms:8.4f} ms {100 * ms / total:5.1f}%  x{n:<4d} reductions x{rn:<3d} "
              f"{rms:7.4f} ms  {scope[:90]}", flush=True)
    print(f"  {what} row reductions by module:", flush=True)
    for scope, (_, _, rms, rn) in sorted(scopes.items(), key=lambda kv: -kv[1][2]):
        if rn:
            print(f"    x{rn:<3d} {rms:7.4f} ms  {scope[:100]}", flush=True)


def step_profile(model0, cfg, training, batch, mlip, n_prof=5):
    """Eager ms, device ms, kernels per step and the top kernels by name
    of one f32 train step on ``batch`` (a CUDA batch)."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    model = copy.deepcopy(model0)
    opt = select_optimizer(model.parameters(), training)
    step = make_train_step(model, opt, cfg, compute_grad_energy=mlip)
    state = TrainState(model, opt)
    eager = cs.eager_ms(lambda: step(state, batch), iters=20, warmup=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step(state, batch)
        torch.cuda.synchronize()
    kernels = cs.device_kernels(prof)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / n_prof
        by_name[e.name][1] += 1
    device = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    scopes = attribute_by_module(lambda: step(state, batch), model)
    return eager, device, len(kernels) // n_prof, top, scopes


def report(what, batch, result):
    eager, device, n, top, scopes = result
    idle = 100 * (1 - device / eager) if device else float("nan")
    print(f"{what}: {batch.num_nodes} nodes, {int(batch.edge_mask.sum())} valid of "
          f"{batch.num_edges} edge slots, {batch.num_graphs} graph slots; {eager:.3f} ms "
          f"eager, {device:.3f} ms device, {n} kernels, idle {idle:.0f}%", flush=True)
    for name, (ms, count) in top:
        print(f"    {ms:8.4f} ms {100 * ms / device:5.1f}%  x{count // 5:<4d} {name[:110]}",
              flush=True)
    report_modules(what, scopes)


def main():
    import chip_smoke as cs

    cs.phase_device()
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.create import create_model_config

    print(cs.card_line(), flush=True)
    config, splits, _ = cs.mlip_data()
    ladder_config = copy.deepcopy(config)
    ladder_config["NeuralNetwork"]["Training"].setdefault("Parallelism", {})["packing"] = {
        "enabled": False}
    ladder = next(iter(cs.train_loader(ladder_config, splits[0])[0])).to("cuda")
    loader, _ = cs.train_loader(config, splits[0])
    cs.check(loader.packing, "md17.json's packing 'auto' did not pack bench's molecules")
    packed = next(iter(loader)).to("cuda")
    full = update_config(config, *splits)
    model0, cfg = create_model_config(full, "cuda", seed=0)
    training = full["NeuralNetwork"]["Training"]
    for what, batch in (("md17 ladder", ladder), ("md17 packed", packed),
                        ("md17 packed", packed), ("md17 ladder", ladder)):
        report(what, batch, step_profile(model0, cfg, training, batch, mlip=True))

    configs, zsplits = cs.zinc_data()
    zloader, _ = cs.train_loader(configs["fp32"], zsplits[0])
    zbin = next(iter(zloader)).to("cuda")
    zfull = update_config(configs["fp32"], *zsplits)
    zmodel0, zcfg = create_model_config(zfull, "cuda", seed=0)
    report("zinc packed", zbin, step_profile(zmodel0, zcfg, zfull["NeuralNetwork"]["Training"],
                                             zbin, mlip=False))

    pconfig, psplits = cs.polymer_data()
    ploader, _ = cs.train_loader(pconfig, psplits[0])
    pbin = next(iter(ploader)).to("cuda")
    pfull = update_config(pconfig, *psplits)
    pmodel0, pcfg = create_model_config(pfull, "cuda", seed=0)
    report("polymers packed", pbin, step_profile(pmodel0, pcfg,
                                                 pfull["NeuralNetwork"]["Training"], pbin,
                                                 mlip=False))


if __name__ == "__main__":
    main()
