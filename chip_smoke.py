"""Drive the PyTorch/CUDA port on one GPU and hold its kernel to account.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. device   torch/CUDA versions and the card's name and power limit;
            exits 2 without a CUDA device.
2. build    K1's library, built from csrc/edge_pipeline.cu with nvcc for
            sm_90a on every run; the ptxas register and shared-memory
            report.
3. kernel   K1 (the fused edge pipeline) against its plain PyTorch
            version on the card, at the shapes of the served bins
            (F_in = F_out = 128), every flavour (a; a,b; a,b,W) in f32
            and bf16, plus a plan with an empty window and static
            padding, and E = 0; two runs must give the same bits. Times
            with CUDA events: the kernel, the plain version, the bound
            from bytes and operations, and index_add_ for the
            reduce-only flavour.
4. slice    bench.py's headline SchNet at full width (4 CFConv layers,
            128 filters, 50 Gaussians, hidden 128, graph head 2x128
            shared + [128, 128]) with random weights from a seeded
            generator, serving 256 synthetic qm9 requests through
            DynamicBatcher -> ServingEngine(device="cuda"). Checks: every
            request has a finite result; K1's launch count rises by
            exactly 4 x dispatched bins during process(); each bin's
            served outputs equal a direct make_forward call on the same
            collated batch bit for bit; one bin matches the same model
            on the CPU's plain path.
5. report   the kernels JSON line, the card line, and the final
            {"ok": true, "device": ...} line.
"""

import copy
import json
import os
import subprocess
import sys
import time

import torch

F32_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_pallas_segment.py:341
BF16_TOL = dict(rtol=4e-2, atol=2.5e-1)  # tests/test_pallas_segment.py:342
CPU_TOL = dict(rtol=1e-4, atol=1e-4)
# H100 SXM published peaks (dense): HBM bytes/s, f32 (no tensor cores)
# and bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
N_REQUESTS = 256


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, replays=20, per_graph=10):
    """Device time of one call of ``fn``: ``per_graph`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's issue rate never shows (inputs stay L2-resident)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def eager_ms(fn, iters=50, warmup=5):
    """Stream time of ``fn`` issued eagerly from Python, back to back:
    the device waits on the host whenever issuing is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(e_valid, n, f_in, f_out, slots, blocks, has_b, has_w, dtype):
    """Least time for the work: inputs read once (valid edge rows of a
    and b, W, the plan), the output written once; operations: the
    multiply, the reduce adds and one [N, F_in] @ [F_in, F_out]."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (
        e_valid * f_in * size * (2 if has_b else 1)
        + (f_in * f_out * size if has_w else 0)
        + slots * (4 + 4 + 1) + blocks * 4
        + n * f_out * size
    )
    ops = e_valid * f_in * (2 if has_b else 1) + (2 * n * f_in * f_out if has_w else 0)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    if not torch.cuda.is_available():
        print(
            "chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
            "this script needs one GPU",
            file=sys.stderr,
        )
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; {card}")
    return card


def phase_build():
    from hydragnn_tpu_torch.ops import cuda_build

    cuda_build.build(force=True)  # from the source, every run
    r = cuda_build.build_report
    log(f"[build] edge_pipeline: {r['seconds']:.2f} s -> {os.path.relpath(r['path'])}")
    for line in r["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   ptxas: {line.strip()}")


def served_bins(samples, budgets):
    """One bin per budget shape, filled with requests in arrival order
    until the next one would not fit (the serving engine warms and
    serves exactly these shapes)."""
    bins = {}
    for spec in budgets:
        members, n, e = [], 0, 0
        for s in samples:
            if not spec.fits(n + s.num_nodes, e + s.num_edges, len(members) + 1):
                break
            members.append(s)
            n, e = n + s.num_nodes, e + s.num_edges
        bins[spec] = members
    return bins


def phase_kernel(samples, budgets):
    import numpy as np

    from hydragnn_tpu_torch.data.graph import collate
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_plain,
        edge_pipeline_planned,
        plan_blocks_static,
        static_block_bound,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    f = 128
    cases = {}
    for spec, members in served_bins(samples, budgets).items():
        batch = collate(members, spec.pad_spec(), with_segment_plan=True).to(dev)
        cases[f"n{spec.num_nodes}_e{spec.num_edges}"] = (batch, spec)
    # an extra plan: an empty node window and two static padding blocks
    rng = np.random.default_rng(3)
    n_x, e_x = 200, 400
    seg = np.sort(np.concatenate([rng.integers(0, 60, 200), rng.integers(120, 200, 200)]))
    plan_x = plan_blocks_static(seg, n_x, static_block_bound(e_x, n_x) + 2,
                                edge_valid=rng.random(e_x) > 0.1)
    rows = []
    main = None
    for key, (batch, spec) in list(cases.items()) + [("empty_window", (None, None))]:
        if batch is not None:
            plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
            n, e = batch.num_nodes, batch.num_edges
            e_valid = int(batch.edge_mask.sum())
            rcv_valid = batch.receivers[batch.edge_mask].long()
        else:
            plan = tuple(torch.from_numpy(p).to(dev) for p in plan_x)
            n, e = n_x, e_x
            e_valid = int(plan[2].sum())
            rcv_valid = None
        slots, blocks = plan[0].numel(), plan[3].numel()
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(e, f, generator=gen).to(dev, dtype)
            b = torch.randn(e, f, generator=gen).to(dev, dtype)
            w = (torch.randn(f, f, generator=gen) / f ** 0.5).to(dev, dtype)
            for stages in ("a", "ab", "abw"):
                args = (a, b if "b" in stages else None, w if "w" in stages else None,
                        *plan, n)
                with torch.no_grad():
                    got = edge_pipeline_planned(*args)
                    again = edge_pipeline_planned(*args)
                    ref = edge_pipeline_plain(*args)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"{key} {stages} {dtype}: two runs differ")
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                torch.testing.assert_close(got.float(), ref.float(), **tol)
                err = float((got.float() - ref.float()).abs().max())
                row = {"shape": key, "flavour": stages, "dtype": str(dtype).split(".")[-1],
                       "n": n, "e_valid": e_valid, "max_abs_err": err}
                if batch is not None:
                    with torch.no_grad():
                        row["ms"] = time_ms(lambda: edge_pipeline_planned(*args))
                        row["plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
                    row["bound_ms"], row["bound_by"] = bound(
                        e_valid, n, f, f, slots, blocks, "b" in stages, "w" in stages, dtype)
                    row["library_ms"] = None
                    if stages == "a":
                        a_valid = a[batch.edge_mask]
                        out = torch.zeros(n, f, dtype=dtype, device=dev)
                        row["library_ms"] = time_ms(
                            lambda: out.index_add_(0, rcv_valid, a_valid))
                    if stages == "abw" and dtype == torch.float32 and (
                            main is None or n > main["n"]):
                        main = row
                rows.append(row)
                log(f"[kernel] {key} {stages} {row['dtype']}: max|err| {err:.3g}"
                    + (f", kernel {row['ms'] * 1e3:.1f} us, plain {row['plain_ms'] * 1e3:.1f} us,"
                       f" bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})"
                       + (f", index_add_ {row['library_ms'] * 1e3:.1f} us"
                          if row["library_ms"] is not None else "")
                       if "ms" in row else ""))
    # E = 0: zeros without a launch
    before = edge_pipeline_planned.launches
    with torch.no_grad():
        z = edge_pipeline_planned(a[:0], b[:0], w, *plan, n)
    check(edge_pipeline_planned.launches == before and z.shape == (n, f)
          and not bool(z.any()), "E=0 must return zeros without a launch")
    log(f"[kernel] E=0: zeros {tuple(z.shape)} {z.dtype}, no launch")
    log(f"[kernel] {len(rows)} comparisons passed (f32 rtol 1e-5 atol 1e-4, "
        f"bf16 rtol 4e-2 atol 2.5e-1; identical bits on two runs)")
    return main, rows


def full_width_config():
    from hydragnn_tpu_torch.models.spec import model_config_from_dict

    head = {"num_sharedlayers": 2, "dim_sharedlayers": 128,
            "num_headlayers": 2, "dim_headlayers": [128, 128]}
    return model_config_from_dict({
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "SchNet", "input_dim": 1, "radius": 4.0,
                "max_neighbours": 32, "num_gaussians": 50, "num_filters": 128,
                "hidden_dim": 128, "num_conv_layers": 4,
                "output_heads": {"graph": [{"type": "branch-0", "architecture": head}]},
                "output_type": ["graph"], "output_dim": [1], "task_weights": [1.0],
            },
            "Variables_of_interest": {"output_names": ["energy"]},
        }
    })


def phase_slice(samples, budgets, settings):
    import numpy as np

    from hydragnn_tpu_torch.export import make_forward
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.edge_pipeline import edge_pipeline_planned
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher
    from hydragnn_tpu_torch.serve.engine import ServingEngine

    cfg = full_width_config()
    model = create_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    engine = ServingEngine(model, cfg, None, budgets, example=samples[0],
                           settings=settings, device="cuda")
    log(f"[slice] SchNet {cfg.num_conv_layers}x{cfg.num_filters} filters, "
        f"{n_params} parameters; budgets "
        f"{[(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]}; "
        f"warm-up {time.perf_counter() - t0:.2f} s {engine.warmup_ms}")
    batcher = DynamicBatcher(budgets, deadline_ms=settings.deadline_ms,
                             max_open_bins=settings.max_open_bins)
    reqs = [batcher.submit(s) for s in samples]
    batcher.close()
    edge_pipeline_planned.launches = 0
    t0 = time.perf_counter()
    records = engine.process(batcher)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = edge_pipeline_planned.launches
    check(launches == cfg.num_conv_layers * len(records),
          f"K1 launched {launches} times for {len(records)} bins "
          f"(want {cfg.num_conv_layers} per bin)")
    log(f"[slice] served {len(reqs)} requests in {len(records)} bins, "
        f"K1 launches {launches} = {cfg.num_conv_layers} x {len(records)}")
    for r in reqs:
        check(r.result is not None and r.result[0].shape == (1,)
              and bool(np.isfinite(r.result[0]).all()), f"request {r.req_id}: bad result")
    forward = make_forward(model, cfg)
    for rec in records:
        batch = engine.collate_bin([q.sample for q in rec["reqs"]], rec["spec"])
        out = forward(batch.to("cuda"))[0].cpu().numpy()
        for gi, q in enumerate(rec["reqs"]):
            check(np.array_equal(out[gi], q.result[0]),
                  f"bin {rec['key']}: served output differs from a direct forward")
    log(f"[slice] every bin's served outputs equal a direct make_forward bit for bit")
    rec = records[0]
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_batch = engine.collate_bin([q.sample for q in rec["reqs"]], rec["spec"]).to("cpu")
    cpu_out = make_forward(cpu_model, cfg)(cpu_batch)[0].numpy()
    served = np.stack([q.result[0] for q in rec["reqs"]])
    with torch.no_grad():
        h_gpu = model.encode(cpu_batch.to("cuda"))[0].cpu().numpy()
        h_cpu = cpu_model.encode(cpu_batch)[0].numpy()
    # The random-weight model's activations are small (~1e-4), so besides
    # rtol/atol 1e-4 the check also holds each error to 1e-4 of the
    # reference's largest magnitude (stricter here, never looser).
    for name, got, ref in (("outputs", served, cpu_out[: len(rec["reqs"])]),
                           ("node representations", h_gpu, h_cpu)):
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        np.testing.assert_allclose(got, ref, **CPU_TOL)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
        log(f"[slice] bin {rec['key']} {name}, card vs CPU plain path: max|err| "
            f"{err:.3g}, max|ref| {scale:.3g} (rtol 1e-4; atol 1e-4 and 1e-4 x max|ref|)")
    roll = engine.rollup()
    collate_ms = [1e3 * (r["t_dispatch"] - r["t_collate"]) for r in records]
    log(f"[slice] {len(reqs) / wall:.1f} requests/s over the burst ({wall * 1e3:.1f} ms); "
        f"latency p50 {roll['p50_ms']:.2f} ms p99 {roll['p99_ms']:.2f} ms "
        f"(all {len(reqs)} enqueued at once); host collate+launch per bin "
        f"{np.mean(collate_ms):.2f} ms mean; node fill {roll['node_fill']:.3f}")
    for spec in budgets:
        dev_batch = engine.collate_bin(samples[:4], spec).to("cuda")
        eager = eager_ms(lambda: forward(dev_batch))
        replay = time_ms(lambda: forward(dev_batch), replays=10, per_graph=2)
        log(f"[slice] one forward at n{spec.num_nodes}_e{spec.num_edges}: "
            f"{eager:.3f} ms issued eagerly from Python, {replay:.3f} ms of "
            f"device time (CUDA graph replay); the device idles "
            f"{100 * (1 - replay / eager):.0f}% of the eager forward")
    engine.close()
    return launches, len(records)


def main():
    card = phase_device()
    # The port lives next to this script; a copy of the script alone
    # fails here with ModuleNotFoundError.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.serve.engine import ServingSettings, fit_serving_budgets
    from hydragnn_tpu_torch.serve.loadgen import synthetic_request_samples

    phase_build()
    samples = synthetic_request_samples("qm9", N_REQUESTS, seed=0)
    settings = ServingSettings(enabled=True)
    budgets = fit_serving_budgets(*dataset_size_arrays(samples), settings)
    main_row, rows = phase_kernel(samples, budgets)
    launches, bins = phase_slice(samples, budgets, settings)

    kernels = [{
        "name": "edge_pipeline",
        "route": "cuda",
        "source": "hydragnn_tpu_torch/csrc/edge_pipeline.cu",
        "replaces": "hydragnn_tpu/ops/pallas_segment.py:337",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
        "bins": bins,
        "flavours": [r for r in rows if "ms" in r],
    }]
    log(f"[report] card: {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
