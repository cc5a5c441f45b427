"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases (each prints lines tagged with its name; any failure raises and
exits non-zero):

1. device      torch/CUDA versions and the card's name and power limit;
               exits 2 without a CUDA device.
2. build       the kernels' library, built from csrc/edge_pipeline.cu (K1)
               and csrc/edge_pipeline_bwd.cu (K2) for sm_90a on every run
               (one nvcc per source, in parallel, then one link); the
               ptxas register and spill report.
3. kernel      K1 (the fused edge pipeline) against its plain PyTorch
               version on the card, at the shapes of the served bins and
               of the headline train step (F_in = F_out = 128; the
               headline's windows hold more valid slots than one staging
               pass), every flavour (a; a,b; a,W; a,b,W)
               in f32 and bf16 and with bf16 a/b and an f32 W, plus a
               plan with an empty window and static padding, and E = 0;
               two runs must give the same bits. Times with CUDA events:
               the kernel, the plain version, the bound from bytes and
               operations, and index_add_ for the reduce-only flavour.
4. kernel-bwd  K2 (the pullback) against its plain version at the train
               bins' shapes and the headline train step's in every flavour
               and dtype mix, the empty-window plan and E = 0, same bits on
               two runs; timed like K1.
5. slice       bench.py's headline SchNet at full width (4 CFConv layers,
               128 filters, 50 Gaussians, hidden 128, graph head 2x128
               shared + [128, 128]) with random weights from a seeded
               generator, serving 256 synthetic qm9 requests through
               DynamicBatcher -> ServingEngine(device="cuda"). Checks:
               every request has a finite result; K1's launch count rises
               by exactly 4 x dispatched bins during process(); each bin's
               served outputs equal a direct make_forward call on the same
               collated batch bit for bit; one bin matches the same model
               on the CPU's plain path.
6. train       the same SchNet trained by run_training on the card (f32,
               batch 32, 2 epochs) on the BCC set of tests/test_graphs.py
               (300 configurations, seed 7), then run_prediction. Checks:
               finite losses, every step's loss finite and the last
               epoch's mean below the first step's loss, K1 launches = 4 x model
               forwards and K2 launches = 4 x train steps; the first train
               step on the card equals the same step on the CPU's plain
               path (loss, gradients, AdamW-updated parameters) in f32 and,
               at the bf16 tolerance, in bf16; whether two identical runs
               of that step give the same bits is reported. Then one train
               step at bench.py's headline shape (128 molecules of 9-30
               atoms, radius 4.0, 32 neighbours): card against the CPU's
               plain path (loss, gradients, updated parameters), then
               eager and device time and K1's and K2's share of it.
7. report      the kernels JSON line, the card line, and the final
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
VJP_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_pallas_segment.py:808
CPU_TOL = dict(rtol=1e-4, atol=1e-4)
# H100 SXM published peaks (dense): HBM bytes/s, f32 (no tensor cores)
# and bf16 tensor-core FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
N_REQUESTS = 256
K_CHUNK = 256  # plan slots the kernels stage per pass (kChunk in csrc/*.cu)


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


def _size(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def bound(nbytes, ops, dtype):
    """Least time for the work: ``nbytes`` over the HBM rate or ``ops``
    over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(e_valid, n, f_in, f_out, slots, blocks, a_dt, w_dt, has_b, has_w):
    """K1's bytes (valid edge rows of a and b, W, the plan read once; the
    output written once) and operations (the multiply, the reduce adds,
    one [N, F_in] @ [F_in, F_out])."""
    out_dt = torch.promote_types(a_dt, w_dt) if has_w else a_dt
    nbytes = (
        e_valid * f_in * _size(a_dt) * (2 if has_b else 1)
        + (f_in * f_out * _size(w_dt) if has_w else 0)
        + slots * (4 + 4 + 1) + blocks * 4
        + n * f_out * _size(out_dt)
    )
    ops = e_valid * f_in * (2 if has_b else 1) + (2 * n * f_in * f_out if has_w else 0)
    return nbytes, ops, out_dt


def k2_work(e, e_valid, n, f_in, f_out, slots, blocks, a_dt, w_dt, has_b, has_w):
    """K2's bytes (g, the plan, W and the valid edge rows of whichever of
    a and b the outputs need, read once; d_a, d_b and d_W written once)
    and operations (g @ W^T and msg_sum^T @ g per node, the per-edge
    products and message sums)."""
    g_dt = torch.promote_types(a_dt, w_dt) if has_w else a_dt
    reads_a = has_b or has_w
    nbytes = (
        n * f_out * _size(g_dt) + slots * (4 + 4 + 1) + blocks * 4
        + e_valid * f_in * _size(a_dt) * (int(reads_a) + int(has_b))
        + (2 * f_in * f_out * _size(w_dt) if has_w else 0)
        + e * f_in * _size(a_dt) * (2 if has_b else 1)
    )
    ops = e_valid * f_in * ((2 if has_b else 0) + (2 if has_w else 0))
    if has_w:
        ops += 4 * n * f_in * f_out
    return nbytes, ops, g_dt


# dtype mixes (a/b, W) and the flavours each takes: bf16 a/b with an f32
# master W needs W.
MIXES = {
    (torch.float32, torch.float32): ("a", "ab", "aw", "abw"),
    (torch.bfloat16, torch.bfloat16): ("a", "ab", "aw", "abw"),
    (torch.bfloat16, torch.float32): ("aw", "abw"),
}


def mix_name(a_dt, w_dt):
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    return names[a_dt] if a_dt == w_dt else f"{names[a_dt]}+{names[w_dt]}W"


def empty_window_plan(dev):
    """A plan with an empty node window and two static padding blocks."""
    import numpy as np

    from hydragnn_tpu_torch.ops.edge_pipeline import plan_blocks_static, static_block_bound

    rng = np.random.default_rng(3)
    n, e = 200, 400
    seg = np.sort(np.concatenate([rng.integers(0, 60, 200), rng.integers(120, 200, 200)]))
    plan = plan_blocks_static(seg, n, static_block_bound(e, n) + 2,
                              edge_valid=rng.random(e) > 0.1)
    return tuple(torch.from_numpy(p).to(dev) for p in plan), n, e


def window_fill(plan):
    """The most valid plan slots of any one node window."""
    perm, _, valid, window = plan
    be = perm.numel() // window.numel()
    return int(torch.bincount(window.long().repeat_interleave(be)[valid]).max())


def check_spans_passes(rows, tag):
    fill = max(r["window_fill"] for r in rows)
    check(fill > K_CHUNK, f"{tag}: no case puts more than {K_CHUNK} valid slots in a window")
    log(f"[{tag}] the fullest window holds {fill} valid slots (> {K_CHUNK} staged per "
        f"pass: row sums carry across staging passes)")


def batch_cases(batches, dev):
    """(key, plan, n, e, e_valid, batch) for each device batch, then the
    empty-window plan (batch None, not timed)."""
    out = []
    for key, batch in batches:
        plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window)
        out.append((key, plan, batch.num_nodes, batch.num_edges,
                    int(batch.edge_mask.sum()), batch))
    plan, n, e = empty_window_plan(dev)
    out.append(("empty_window", plan, n, e, int(plan[2].sum()), None))
    return out


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
    log(f"[build] K1 + K2 (one nvcc per source, started together, then the link): "
        f"{r['seconds']:.2f} s -> {os.path.relpath(r['path'])}")
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


def phase_kernel(samples, budgets, headline):
    from hydragnn_tpu_torch.data.graph import collate
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    f = 128
    batches = [
        (f"n{spec.num_nodes}_e{spec.num_edges}",
         collate(members, spec.pad_spec(), with_segment_plan=True).to(dev))
        for spec, members in served_bins(samples, budgets).items()
    ] + [headline]
    rows = []
    main = None
    for key, plan, n, e, e_valid, batch in batch_cases(batches, dev):
        slots, blocks = plan[0].numel(), plan[3].numel()
        fill = window_fill(plan)
        for (a_dt, w_dt), flavours in MIXES.items():
            a = torch.randn(e, f, generator=gen).to(dev, a_dt)
            b = torch.randn(e, f, generator=gen).to(dev, a_dt)
            w = (torch.randn(f, f, generator=gen) / f ** 0.5).to(dev, w_dt)
            for stages in flavours:
                args = (a, b if "b" in stages else None, w if "w" in stages else None,
                        *plan, n)
                with torch.no_grad():
                    got = edge_pipeline_planned(*args)
                    again = edge_pipeline_planned(*args)
                    ref = edge_pipeline_plain(*args)
                torch.cuda.synchronize()
                name = mix_name(a_dt, w_dt)
                check(torch.equal(got, again), f"{key} {stages} {name}: two runs differ")
                check(got.dtype == ref.dtype, f"{key} {stages} {name}: output dtype")
                tol = F32_TOL if a_dt == torch.float32 else BF16_TOL
                torch.testing.assert_close(got.float(), ref.float(), **tol)
                err = float((got.float() - ref.float()).abs().max())
                row = {"shape": key, "flavour": stages, "dtype": name, "n": n,
                       "e_valid": e_valid, "window_fill": fill, "max_abs_err": err}
                if batch is not None:
                    with torch.no_grad():
                        row["ms"] = time_ms(lambda: edge_pipeline_planned(*args))
                        row["plain_ms"] = time_ms(lambda: edge_pipeline_plain(*args))
                    nbytes, ops, out_dt = k1_work(e_valid, n, f, f, slots, blocks, a_dt,
                                                  w_dt, "b" in stages, "w" in stages)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, out_dt)
                    row["library_ms"] = None
                    if stages == "a":
                        a_valid = a[batch.edge_mask]
                        rcv_valid = batch.receivers[batch.edge_mask].long()
                        out = torch.zeros(n, f, dtype=a_dt, device=dev)
                        row["library_ms"] = time_ms(
                            lambda: out.index_add_(0, rcv_valid, a_valid))
                    if stages == "abw" and name == "f32" and (main is None or n > main["n"]):
                        main = row
                rows.append(row)
                log(f"[kernel] {key} {stages} {name}: max|err| {err:.3g}" + timing_note(row))
    # E = 0: zeros without a launch
    before = edge_pipeline_planned.launches
    with torch.no_grad():
        z = edge_pipeline_planned(a[:0], b[:0], w, *plan, n)
    check(edge_pipeline_planned.launches == before and z.shape == (n, f)
          and not bool(z.any()), "E=0 must return zeros without a launch")
    log(f"[kernel] E=0: zeros {tuple(z.shape)} {z.dtype}, no launch")
    check_spans_passes(rows, "kernel")
    log(f"[kernel] {len(rows)} comparisons passed (f32 rtol 1e-5 atol 1e-4, "
        f"bf16 rtol 4e-2 atol 2.5e-1; identical bits on two runs)")
    return main, rows


def timing_note(row):
    if "ms" not in row:
        return ""
    return (f", kernel {row['ms'] * 1e3:.1f} us, plain {row['plain_ms'] * 1e3:.1f} us,"
            f" bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})"
            + (f", index_add_ {row['library_ms'] * 1e3:.1f} us"
               if row.get("library_ms") is not None else ""))


def phase_kernel_bwd(batches):
    """K2 against its plain version on the train bins' and the headline
    step's plans (and the empty-window plan), every flavour and dtype
    mix."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    f = 128
    rows = []
    main = None
    for key, plan, n, e, e_valid, batch in batch_cases(batches, dev):
        slots, blocks = plan[0].numel(), plan[3].numel()
        fill = window_fill(plan)
        covered = torch.zeros(e, dtype=torch.bool, device=dev)
        covered[plan[0][plan[2]].long()] = True
        for (a_dt, w_dt), flavours in MIXES.items():
            a = torch.randn(e, f, generator=gen).to(dev, a_dt)
            b = torch.randn(e, f, generator=gen).to(dev, a_dt)
            w = (torch.randn(f, f, generator=gen) / f ** 0.5).to(dev, w_dt)
            for stages in flavours:
                g_dt = torch.promote_types(a_dt, w_dt) if "w" in stages else a_dt
                g = torch.randn(n, f, generator=gen).to(dev, g_dt)
                args = (g, a, b if "b" in stages else None,
                        w if "w" in stages else None, *plan, n)
                got = edge_pipeline_bwd_planned(*args)
                again = edge_pipeline_bwd_planned(*args)
                ref = edge_pipeline_bwd_plain(*args)
                torch.cuda.synchronize()
                name = mix_name(a_dt, w_dt)
                tol = VJP_TOL if a_dt == torch.float32 else BF16_TOL
                err = 0.0
                for which, x, y, z in zip("abw", got, again, ref):
                    check((x is None) == (z is None), f"{key} {stages} {name}: d{which}")
                    if z is None:
                        continue
                    check(x.dtype == z.dtype and torch.equal(x, y),
                          f"{key} {stages} {name}: d{which} dtype or two runs differ")
                    torch.testing.assert_close(x.float(), z.float(), **tol)
                    if which != "w":
                        check(not bool(x[~covered].any()),
                              f"{key} {stages} {name}: d{which} nonzero off the plan")
                    err = max(err, float((x.float() - z.float()).abs().max()))
                row = {"shape": key, "flavour": stages, "dtype": name, "n": n,
                       "e_valid": e_valid, "window_fill": fill, "max_abs_err": err}
                if batch is not None:
                    row["ms"] = time_ms(lambda: edge_pipeline_bwd_planned(*args))
                    row["plain_ms"] = time_ms(lambda: edge_pipeline_bwd_plain(*args))
                    nbytes, ops, _ = k2_work(e, e_valid, n, f, f, slots, blocks, a_dt,
                                             w_dt, "b" in stages, "w" in stages)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, g_dt)
                    row["library_ms"] = None
                    if stages == "abw" and name == "f32" and (main is None or n > main["n"]):
                        main = row
                rows.append(row)
                log(f"[kernel-bwd] {key} {stages} {name}: max|err| {err:.3g}"
                    + timing_note(row))
    before = edge_pipeline_bwd_planned.launches
    z = edge_pipeline_bwd_planned(g, a[:0], b[:0], w, *plan, n)
    check(edge_pipeline_bwd_planned.launches == before and z[0].shape == (0, f)
          and z[2].shape == (f, f) and not bool(z[2].any()),
          "E=0 must return empty d_a and zero d_W without a launch")
    log("[kernel-bwd] E=0: empty d_a/d_b, zero d_W, no launch")
    check_spans_passes(rows, "kernel-bwd")
    log(f"[kernel-bwd] {len(rows)} comparisons passed (f32 rtol 1e-4 atol 1e-3, "
        f"bf16 rtol 4e-2 atol 2.5e-1; identical bits on two runs; zero rows off the plan)")
    return main, rows


FULL_WIDTH_ARCH = {
    "mpnn_type": "SchNet", "radius": 4.0, "max_neighbours": 32, "num_gaussians": 50,
    "num_filters": 128, "hidden_dim": 128, "num_conv_layers": 4,
    "output_heads": {"graph": {"num_sharedlayers": 2, "dim_sharedlayers": 128,
                               "num_headlayers": 2, "dim_headlayers": [128, 128]}},
    "task_weights": [1.0],
}


def full_width_config():
    """The served/trained model's spec, from ``FULL_WIDTH_ARCH``."""
    from hydragnn_tpu_torch.config import normalize_output_heads
    from hydragnn_tpu_torch.models.spec import model_config_from_dict

    arch = dict(FULL_WIDTH_ARCH, input_dim=1, output_type=["graph"], output_dim=[1],
                output_heads=normalize_output_heads(FULL_WIDTH_ARCH["output_heads"]))
    return model_config_from_dict({
        "NeuralNetwork": {
            "Architecture": arch,
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


def bcc_config(path, precision="fp32"):
    """tests/inputs/ci.json's data, targets and training settings (batch 32,
    AdamW at 0.01) with bench.py's full-width SchNet, for two epochs."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "chip_smoke_bcc", "format": "unit_test",
            "compositional_stratified_splitting": True, "path": {"total": path},
            "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1],
                              "column_index": [0, 6, 7]},
            "graph_features": {"name": ["sum_x_x2_x3"], "dim": [1], "column_index": [0]},
        },
        "NeuralNetwork": {
            "Architecture": dict(FULL_WIDTH_ARCH),
            "Variables_of_interest": {
                "input_node_features": [0], "output_names": ["sum_x_x2_x3"],
                "output_index": [0], "type": ["graph"], "denormalize_output": False,
            },
            "Training": {
                "num_epoch": 2, "perc_train": 0.7, "loss_function_type": "mse",
                "batch_size": 32, "precision": precision,
                "Optimizer": {"type": "AdamW", "learning_rate": 0.01},
            },
        },
    }


def assert_close_scaled(got, ref, tol, what):
    """``got`` equals ``ref`` at ``tol``'s rtol and its atol times
    ``ref``'s largest magnitude (never more than the atol itself)."""
    import numpy as np

    scale = float(np.abs(ref).max())
    check(scale > 0, f"{what}: reference is all zeros")
    np.testing.assert_allclose(got, ref, rtol=tol["rtol"],
                               atol=tol["atol"] * min(scale, 1.0), err_msg=what)
    return float(np.abs(got - ref).max()), scale


def one_step(model, cfg, training, batch, compute_dtype):
    """One AdamW step of ``model`` on ``batch``: (loss, {name: grad},
    {name: updated parameter}) on the host."""
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    opt = select_optimizer(model.parameters(), training)
    step = make_train_step(model, opt, cfg, compute_dtype)
    _, loss, _ = step(TrainState(model, opt), batch)
    grads = {k: p.grad.detach().float().cpu().numpy() for k, p in model.named_parameters()}
    params = {k: p.detach().float().cpu().numpy() for k, p in model.named_parameters()}
    return float(loss), grads, params


def phase_train(config, splits):
    import numpy as np

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.base import MultiHeadGraphModel
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train import loop

    # The run: counts of K1/K2 launches and of model forwards, from 0, and
    # every train step's loss (kept on the card, read after the run).
    forwards = [0]
    step_losses = []
    plain_forward = MultiHeadGraphModel.forward
    plain_make_train_step = loop.make_train_step

    def counted_forward(self, batch):
        forwards[0] += 1
        return plain_forward(self, batch)

    def recorded_make_train_step(*args, **kwargs):
        step = plain_make_train_step(*args, **kwargs)

        def recorded(state, batch):
            state, loss, tasks = step(state, batch)
            step_losses.append(loss)
            return state, loss, tasks

        return recorded

    MultiHeadGraphModel.forward = counted_forward
    loop.make_train_step = recorded_make_train_step
    try:
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        t0 = time.perf_counter()
        state, model, cfg, hist, full = port.run_training(config, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k1, k2, n_fwd = (edge_pipeline_planned.launches,
                         edge_pipeline_bwd_planned.launches, forwards[0])
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        forwards[0] = 0
        err, _, trues, preds = port.run_prediction(full, state=state, model=model, cfg=cfg)
        torch.cuda.synchronize()
        k1_pred, k2_pred, n_fwd_pred = (edge_pipeline_planned.launches,
                                        edge_pipeline_bwd_planned.launches, forwards[0])
    finally:
        MultiHeadGraphModel.forward = plain_forward
        loop.make_train_step = plain_make_train_step
    layers = cfg.num_conv_layers
    steps = torch.stack(step_losses).double().cpu().numpy()
    losses = hist.train_loss + hist.val_loss + hist.test_loss + [err]
    check(all(np.isfinite(losses)) and np.isfinite(steps).all(),
          f"non-finite loss in {losses} or in the steps {steps.tolist()}")
    check(len(steps) == state.step, f"{len(steps)} step losses for {state.step} steps")
    check(hist.train_loss[-1] < hist.train_loss[0] and hist.train_loss[-1] < steps[0],
          f"train loss did not fall: epoch means {hist.train_loss}, first step {steps[0]}")
    check(k2 == layers * state.step and state.step > 0,
          f"K2 launched {k2} times in {state.step} train steps (want {layers} per step)")
    check(k1 == layers * n_fwd, f"K1 launched {k1} times in {n_fwd} forwards")
    check(k1_pred == layers * n_fwd_pred and k2_pred == 0 and n_fwd_pred > 0,
          f"run_prediction: K1 {k1_pred}, K2 {k2_pred}, {n_fwd_pred} forwards")
    check(np.isfinite(preds[0]).all() and preds[0].shape == trues[0].shape,
          "run_prediction: bad predictions")
    log(f"[train] run_training on the card ({train_s:.2f} s, {state.step} train steps, "
        f"{n_fwd} forwards): train loss {hist.train_loss}, val {hist.val_loss}, "
        f"test {hist.test_loss}; the last epoch's mean train loss is below the first "
        f"epoch's and below the first step's loss {steps[0]:.6g}")
    log(f"[train] per-step train loss: {[float(f'{x:.4g}') for x in steps]} "
        f"(largest {steps.max():.4g} at step {int(steps.argmax())})")
    log(f"[train] K2 launches {k2} = {layers} x {state.step} train steps; K1 launches "
        f"{k1} = {layers} x {n_fwd} forwards")
    log(f"[train] run_prediction: error {err:.6g} over {trues[0].shape[0]} graphs, "
        f"K1 launches {k1_pred} = {layers} x {n_fwd_pred} forwards, K2 0")

    # The first train step on the card against the CPU's plain path.
    full = update_config(config, *splits)
    training = full["NeuralNetwork"]["Training"]
    batch = next(iter(GraphLoader(splits[0], 32, shuffle=True, seed=0, fixed_pad="auto")))
    model0, cfg = create_model_config(full, "cuda", seed=0)
    parity = {}
    for precision, dtype, tol in (("fp32", torch.float32, VJP_TOL),
                                  ("bf16", torch.bfloat16, BF16_TOL)):
        card = one_step(copy.deepcopy(model0), cfg, training, batch.to("cuda"), dtype)
        cpu = one_step(copy.deepcopy(model0).to("cpu"), cfg, training, batch, dtype)
        worst = {"loss": assert_close_scaled(np.asarray(card[0]), np.asarray(cpu[0]),
                                             F32_TOL if dtype == torch.float32 else tol,
                                             f"{precision} loss")}
        for what, i in (("grad", 1), ("param", 2)):
            errs = [assert_close_scaled(card[i][k], cpu[i][k], tol, f"{precision} {what} {k}")
                    for k in cpu[i]]
            worst[what] = max(errs)
        worst["loss_value"] = card[0]
        parity[precision] = worst
        log(f"[train] first step, card vs CPU plain path, {precision}: loss {card[0]:.6g} vs "
            f"{cpu[0]:.6g}; worst |err| (|ref|) grads {worst['grad'][0]:.3g} "
            f"({worst['grad'][1]:.3g}), updated params {worst['param'][0]:.3g} "
            f"({worst['param'][1]:.3g}); rtol {tol['rtol']}, atol {tol['atol']} x "
            f"min(max|ref|, 1)")
        if precision == "fp32":
            again = one_step(copy.deepcopy(model0), cfg, training, batch.to("cuda"), dtype)
            same = again[0] == card[0] and all(
                np.array_equal(again[2][k], card[2][k]) for k in card[2])
            log(f"[train] two identical f32 steps on the card give "
                f"{'the same bits' if same else 'different bits'} (loss and parameters; "
                f"the h[snd] gather's backward adds with atomics)")
    log(f"[train] run_training's first step loss {steps[0]:.6g}; the f32 parity step "
        f"above (same model seed, same first batch) {parity['fp32']['loss_value']:.6g}")
    return {"k1": k1, "k2": k2, "steps": state.step, "forwards": n_fwd,
            "step_losses": steps.tolist(),
            "train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "test_loss": hist.test_loss, "prediction_error": err, "seconds": train_s,
            "parity": parity}


def molecules(n_configs, n_lo, n_hi, radius, max_neighbours, seed=0):
    """bench.py's random molecules (``_molecules``), from the same seeded
    generator, with the port's radius graph."""
    import numpy as np

    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_configs):
        n = int(rng.integers(n_lo, n_hi))
        pos = rng.uniform(0, 2.2 * n ** (1 / 3), size=(n, 3))
        x = rng.integers(0, 5, size=(n, 1)).astype(np.float32)
        ei = radius_graph(pos, radius, max_neighbours=max_neighbours)
        out.append(GraphSample(x=x, pos=pos.astype(np.float32), edge_index=ei,
                               y_graph=np.array([rng.normal()], dtype=np.float32)))
    return out


def headline_batch():
    """bench.py's headline train batch: 128 molecules, collated with the
    block plan, on the host."""
    from hydragnn_tpu_torch.data.graph import PadSpec, collate

    samples = molecules(128, 9, 30, 4.0, 32, seed=0)
    return collate(samples, PadSpec.for_samples(samples), with_segment_plan=True)


def phase_train_timing(cpu_batch):
    """One train step at bench.py's headline shape: the card's step
    against the CPU's plain path, then eager time, device time from the
    profiler, and K1's and K2's share of it."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    batch = cpu_batch.to("cuda")
    cfg = full_width_config()
    model = create_model(cfg, device="cuda", seed=0)
    training = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}
    card = one_step(copy.deepcopy(model), cfg, training, batch, torch.float32)
    cpu = one_step(copy.deepcopy(model).to("cpu"), cfg, training, cpu_batch, torch.float32)
    loss_err = assert_close_scaled(np.asarray(card[0]), np.asarray(cpu[0]), F32_TOL,
                                   "headline loss")
    worst = {what: max(assert_close_scaled(card[i][k], cpu[i][k], VJP_TOL,
                                           f"headline {what} {k}") for k in cpu[i])
             for what, i in (("grad", 1), ("param", 2))}
    log(f"[train] headline step, card vs CPU plain path, fp32: loss {card[0]:.6g} vs "
        f"{cpu[0]:.6g} (|err| {loss_err[0]:.3g}); worst |err| (|ref|) grads "
        f"{worst['grad'][0]:.3g} ({worst['grad'][1]:.3g}), updated params "
        f"{worst['param'][0]:.3g} ({worst['param'][1]:.3g}); rtol 1e-4, atol 1e-3 x "
        f"min(max|ref|, 1)")
    opt = select_optimizer(model.parameters(), training)
    step = make_train_step(model, opt, cfg)
    state = TrainState(model, opt)
    e_valid = int(batch.edge_mask.sum())
    eager = eager_ms(lambda: step(state, batch), iters=20, warmup=3)
    n_prof = 5
    edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step(state, batch)
        torch.cuda.synchronize()
    check(edge_pipeline_planned.launches == 4 * n_prof
          and edge_pipeline_bwd_planned.launches == 4 * n_prof,
          "headline step: want 4 K1 and 4 K2 launches per step")
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_prof
    k1 = sum(e.time_range.elapsed_us() for e in kernels
             if "edge_pipeline_kernel<" in e.name) / 1e3 / n_prof
    k2 = sum(e.time_range.elapsed_us() for e in kernels
             if "edge_pipeline_bwd_kernel<" in e.name or "dw_reduce_kernel<" in e.name
             ) / 1e3 / n_prof
    out = {"graphs": int(batch.graph_mask.sum()), "nodes": batch.num_nodes,
           "edges": batch.num_edges, "e_valid": e_valid, "eager_ms": eager,
           "cpu_parity": {"loss": loss_err[0], "grad": worst["grad"][0],
                          "param": worst["param"][0]}}
    if busy > 0:
        out.update(device_ms=busy, k1_ms=k1, k2_ms=k2)
        log(f"[train] one f32 train step at the headline shape (128 molecules, "
            f"{batch.num_nodes} nodes, {e_valid} edges; padded {batch.num_edges}): "
            f"{eager:.3f} ms issued eagerly, {busy:.3f} ms of device time (profiler, "
            f"{len(kernels) // n_prof} kernels per step); K1 {k1:.3f} ms "
            f"({100 * k1 / busy:.1f}%), K2 {k2:.3f} ms ({100 * k2 / busy:.1f}%) of it; "
            f"the device idles {100 * (1 - busy / eager):.0f}% of the eager step")
    else:
        log(f"[train] one f32 train step at the headline shape: {eager:.3f} ms issued "
            f"eagerly; device time not measured (the profiler recorded no kernels)")
    return out


def bcc_data():
    """The BCC set of tests/test_graphs.py (300 configurations, seed 7)
    written under dataset/ (gitignored), its config, and its stratified
    train/val/test split as the runner makes it."""
    from hydragnn_tpu_torch.data.loader import split_dataset
    from hydragnn_tpu_torch.data.raw import process_raw_samples, read_lsms_directory
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    path = os.path.join("dataset", "chip_smoke_bcc")
    t0 = time.perf_counter()
    deterministic_graph_data(path, number_configurations=300, seed=7)
    config = bcc_config(path)
    samples = process_raw_samples(read_lsms_directory(path, config["Dataset"]), config)
    splits = split_dataset(samples, 0.7, stratified=True)
    log(f"[train] BCC set: 300 configurations (seed 7), splits "
        f"{[len(x) for x in splits]}, in {time.perf_counter() - t0:.2f} s")
    return config, splits


def train_bins(trainset):
    """The first two batches of the BCC run's train loader (batch 32) on
    the card: the shapes K2 meets in phase train."""
    from hydragnn_tpu_torch.data.loader import GraphLoader

    loader = GraphLoader(trainset, 32, shuffle=True, seed=0, fixed_pad="auto")
    out = []
    for batch in loader:
        out.append((f"train_n{batch.num_nodes}_e{batch.num_edges}", batch.to("cuda")))
        if len(out) == 2:
            break
    return out


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
    head_cpu = headline_batch()
    head = (f"headline_n{head_cpu.num_nodes}_e{head_cpu.num_edges}", head_cpu.to("cuda"))
    main_row, rows = phase_kernel(samples, budgets, head)
    config, splits = bcc_data()
    bwd_row, bwd_rows = phase_kernel_bwd(train_bins(splits[0]) + [head])
    launches, bins = phase_slice(samples, budgets, settings)
    train = phase_train(config, splits)
    headline = phase_train_timing(head_cpu)

    kernels = [{
        "name": "edge_pipeline",
        "route": "cuda",
        "source": "hydragnn_tpu_torch/csrc/edge_pipeline.cu",
        "replaces": "hydragnn_tpu/ops/pallas_segment.py:337",
        "launches": train["k1"],
        "launches_by_path": {"serve": launches, "train": train["k1"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "f32"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
        "bins": bins,
        "flavours": [r for r in rows if "ms" in r],
    }, {
        "name": "edge_pipeline_bwd",
        "route": "cuda",
        "source": "hydragnn_tpu_torch/csrc/edge_pipeline_bwd.cu",
        "replaces": "hydragnn_tpu/ops/pallas_segment.py:490",
        "launches": train["k2"],
        "launches_by_path": {"serve": 0, "train": train["k2"]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["dtype"] == "f32"),
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": None,
        "shape": bwd_row["shape"],
        "flavours": [r for r in bwd_rows if "ms" in r],
    }]
    log(f"[report] train: {json.dumps({k: v for k, v in train.items() if k != 'parity'})}")
    log(f"[report] headline train step: {json.dumps(headline)}")
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
