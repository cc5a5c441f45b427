"""Where a CTA of K1 and K2 spends its time, phase by phase, on the card.

    python tools/trace_edge_kernels.py [SRC_DIR ...]

Each SRC_DIR holds a version of the kernels' three sources (edge_tile.cuh,
edge_pipeline.cu, edge_pipeline_bwd.cu); the default is the checkout's
hydragnn_tpu_torch/csrc. For each version the script copies the sources,
adds a %globaltimer stamp (thread 0 of every CTA) at each phase boundary,
builds them with the port's nvcc flags under hydragnn_tpu_torch/csrc/build/
(gitignored), and, with a,b,W f32 at F = 128 on chip_smoke.py's three
main-path shapes (the largest served bin, the first BCC train bin, the
headline batch):

- times K1 and K2 as chip_smoke.py does (CUDA-graph replay; the stamps
  cost a few global stores a CTA), every version in turns, twice;
- checks that every version gives the first version's results (f32
  tolerances);
- prints, at the train bin and the headline, the median and the largest
  time from the first CTA's start to each phase mark: the window search,
  the chunk list, the first issues, chunk 0 landing, the end of the walk,
  the products and (K1) the cluster reduction; and for the walk's chunks
  the median time from issue to landing and from landing to the next
  issue (the chunk's own work).

Needs one CUDA device; exits 2 without one.
"""

import ctypes
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARK = ('static __device__ unsigned long long hg_trace[8192 * 48];\n'
        '#define MARK(i) do { if (threadIdx.x == 0) { unsigned long long t_; '
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
        'hg_trace[blockIdx.x * 48 + (i)] = t_; } } while (0)\n')
# (anchor, mark, where: after the anchor, before its last line, or inside
# its closing brace); mark ids: 0 start, 1 window range,
# 40 list, 41 begin, 8+q chunk q landed, 24+q chunk q issued (before the
# wait), then per kernel: K1 3 walk done, 4 W landed, 5 product done,
# 6 cluster synced, 7 reduced; K2 3 d_h product done, 4 walk done,
# 5 g re-staged, 6 d_W partial written.
HEADER_MARKS = [
    ("      __syncthreads();\n      compute(q % kStages, row0,", "8 + min(q, 15)", "before"),
    ("      if (q + 1 < nq) load_plan(q + 1);\n", "24 + min(q, 15)", "after"),
    ("    first = 0;\n    list();\n", "40", "after"),
    ("    begin(pre);\n  }", "41", "inside"),
]
K1_MARKS = [
    ("  const int rows = min(bn, n_nodes - node_base);\n", "0", "after"),
    ("  window_range(window_id, n_blocks, win, wk.lo, hi);\n", "1", "after"),
    ("    });\n    if constexpr (HAS_W) {  // the ring is idle", "3", "before"),
    ("    __syncthreads();\n\n    if constexpr (!HAS_W) {", "4", "before"),
    ("    __syncthreads();  // msg_s and w_s are free for the next slab\n", "5", "after"),
    ("    cluster.sync();\n    const float* src[kMaxCluster];", "6", "before"),
    ("    cluster.sync();  // no CTA leaves", "7", "before"),
]
K2_MARKS = [
    ("  const bool vec_ab = vec & 1;\n", "0", "after"),
    ("  window_range(window_id, n_blocks, win, wk.lo, hi);\n", "1", "after"),
    ("    __syncthreads();  // g and W leave the ring stages the walk fills next\n", "3", "after"),
    ("  });\n\n  if constexpr (HAS_W) {\n    // g's window again", "4", "before"),
    ("    __syncthreads();\n    // This window's d_W", "5", "before"),
]


def _insert(text, anchor, mark, where="after"):
    if anchor not in text:
        raise SystemExit(f"trace_edge_kernels: source has no anchor {anchor!r}")
    stamp = f"MARK({mark});\n"
    if where == "before":  # before the anchor's last line
        head, nl, tail = anchor.rpartition("\n")
        indent = " " * (len(tail) - len(tail.lstrip(" ")))
        return text.replace(anchor, f"{head}{nl}{indent}{stamp}{tail}", 1)
    if where == "inside":
        return text.replace(anchor, anchor.replace("  }", f"    {stamp}  }}"), 1)
    assert anchor.endswith("\n"), anchor
    indent = " " * (len(anchor) - len(anchor.lstrip(" ")))
    return text.replace(anchor, anchor + indent + stamp, 1)


def build(src_dir, tag):
    """The traced library of the sources in ``src_dir``."""
    from hydragnn_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "trace", tag)
    os.makedirs(out_dir, exist_ok=True)
    hdr = open(os.path.join(src_dir, "edge_tile.cuh")).read()
    hdr = hdr.replace("namespace hg {", MARK + "namespace hg {", 1)
    for anchor, mark, where in HEADER_MARKS:
        hdr = _insert(hdr, anchor, mark, where)
    k1 = open(os.path.join(src_dir, "edge_pipeline.cu")).read()
    for anchor, mark, where in K1_MARKS:
        k1 = _insert(k1, anchor, mark, where)
    k1 += ('\nextern "C" int hg_trace_read(void* dst, size_t n) '
           '{ return (int)cudaMemcpyFromSymbol(dst, hg_trace, n); }\n')
    k2 = open(os.path.join(src_dir, "edge_pipeline_bwd.cu")).read()
    for anchor, mark, where in K2_MARKS:
        k2 = _insert(k2, anchor, mark, where)
    end = k2.index("// Blocks [0, fold_blocks)")
    body = k2[:end].rstrip()
    assert body.endswith("}")
    k2 = body[:-1] + "  MARK(6);\n}\n\n" + k2[end:]
    k2 += ('\nextern "C" int hg_trace_read2(void* dst, size_t n) '
           '{ return (int)cudaMemcpyFromSymbol(dst, hg_trace, n); }\n')
    for name, text in (("edge_tile.cuh", hdr), ("edge_pipeline.cu", k1),
                       ("edge_pipeline_bwd.cu", k2)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    rep = cuda_build.compile_library(
        [os.path.join(out_dir, "edge_pipeline.cu"), os.path.join(out_dir, "edge_pipeline_bwd.cu")],
        os.path.join(out_dir, "libtrace.so"))
    lib = ctypes.CDLL(rep["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hg_edge_pipeline_fwd.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.hg_edge_pipeline_fwd.restype = i
    lib.hg_edge_pipeline_bwd.argtypes = [p] * 13 + [i] * 10 + [p]
    lib.hg_edge_pipeline_bwd.restype = i
    lib.hg_cuda_error_string.argtypes = [i]
    lib.hg_cuda_error_string.restype = ctypes.c_char_p
    for fn in ("hg_trace_read", "hg_trace_read2"):
        getattr(lib, fn).argtypes = [p, ctypes.c_size_t]
    print(f"[trace] built {tag} from {os.path.relpath(src_dir, ROOT)} in {rep['seconds']:.1f} s")
    return lib


def read(lib, fn, n_ctas):
    buf = np.zeros(8192 * 48, np.uint64)
    torch.cuda.synchronize()
    if getattr(lib, fn)(buf.ctypes.data, buf.nbytes) != 0:
        raise RuntimeError("reading the trace buffer failed")
    return buf.reshape(8192, 48)[:n_ctas].astype(np.int64)


def report(tag, t, names):
    rel = np.where(t > 0, t - t[:, 0].min(), -1)
    print(f"[trace] {tag}: {len(t)} CTAs, {rel.max() / 1e3:.2f} us from the first CTA's "
          f"start to the last mark")
    for j, name in names:
        col = rel[:, j][rel[:, j] >= 0]
        if len(col):
            print(f"[trace]   {name:>20}: median {np.median(col) / 1e3:6.2f} us, "
                  f"largest {col.max() / 1e3:6.2f} us")
    land, work = [], []
    for c in range(len(t)):
        for q in range(15):
            issued, landed, nxt = rel[c, 24 + q], rel[c, 8 + q], rel[c, 24 + q + 1]
            if issued >= 0 and landed >= 0:
                land.append(landed - issued)
            if landed >= 0 and nxt >= 0:
                work.append(nxt - landed)
    if work:
        print(f"[trace]   chunk: issue to landing median {np.median(land) / 1e3:.2f} us, "
              f"landing to the next issue (the chunk's work) median "
              f"{np.median(work) / 1e3:.2f} us")


def main():
    if not torch.cuda.is_available():
        print("trace_edge_kernels: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    from hydragnn_tpu_torch.data.graph import PadSpec, collate
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.ops import cuda_build
    from hydragnn_tpu_torch.ops import edge_pipeline as ep
    from hydragnn_tpu_torch.serve.engine import ServingSettings, fit_serving_budgets
    from hydragnn_tpu_torch.serve.loadgen import synthetic_request_samples

    print(f"[trace] {torch.cuda.get_device_name(0)}; {cs.card_line()}")
    dirs = sys.argv[1:] or [cuda_build.CSRC]
    libs = {f"v{k}": build(os.path.abspath(d), f"v{k}") for k, d in enumerate(dirs)}
    samples = synthetic_request_samples("qm9", cs.N_REQUESTS, seed=0)
    budgets = fit_serving_budgets(*dataset_size_arrays(samples), ServingSettings(enabled=True))
    served = max(cs.served_batches(samples, budgets), key=lambda kb: kb[1].num_nodes)[1]
    _, splits = cs.bcc_data()
    train = cs.train_bins(splits[0])[0][1]
    head_cpu = cs.headline_batch()
    head = head_cpu.to("cuda")
    shapes = (("served", served), ("train", train), ("headline", head))
    gen = torch.Generator().manual_seed(0)
    f = 128
    ops = {tag: [t.cuda() for t in (torch.randn(b.num_edges, f, generator=gen),
                                    torch.randn(b.num_edges, f, generator=gen),
                                    torch.randn(f, f, generator=gen) / f ** 0.5,
                                    torch.randn(b.num_nodes, f, generator=gen))]
           for tag, b in shapes}
    ref = {}
    names = list(libs)
    for name in names + names[::-1]:
        cuda_build._lib = libs[name]
        for tag, bt in shapes:
            plan = (bt.seg_perm, bt.seg_ids, bt.seg_valid, bt.seg_window)
            n = bt.num_nodes
            a, b, w, g = ops[tag]
            with torch.no_grad():
                out = ep.edge_pipeline_planned(a, b, w, *plan, n)
            grads = ep.edge_pipeline_bwd_planned(g, a, b, w, *plan, n)
            if tag in ref:
                torch.testing.assert_close(out, ref[tag][0], **cs.F32_TOL)
                for x, y in zip(grads, ref[tag][1]):
                    torch.testing.assert_close(x, y, **cs.VJP_TOL)
            else:
                ref[tag] = (out, grads)
            with torch.no_grad():
                t1 = cs.time_ms(lambda: ep.edge_pipeline_planned(a, b, w, *plan, n))
            t2 = cs.time_ms(lambda: ep.edge_pipeline_bwd_planned(g, a, b, w, *plan, n))
            print(f"[trace] time {name} {tag} (n {n}): K1 {t1 * 1e3:.1f} us, K2 {t2 * 1e3:.1f} us")
    for name in names:
        lib = cuda_build._lib = libs[name]
        for tag, bt in shapes[1:]:
            plan = (bt.seg_perm, bt.seg_ids, bt.seg_valid, bt.seg_window)
            n = bt.num_nodes
            a, b, w, g = ops[tag]
            ctas = ((n + 31) // 32) * 4
            with torch.no_grad():
                for _ in range(3):
                    ep.edge_pipeline_planned(a, b, w, *plan, n)
            report(f"K1 {name} {tag}", read(lib, "hg_trace_read", ctas),
                   [(1, "window range"), (40, "chunk list"), (41, "first issues"),
                    (8, "chunk 0 landed"), (3, "walk done"), (4, "W landed"),
                    (5, "product done"), (6, "cluster synced"), (7, "reduced")])
            for _ in range(3):
                ep.edge_pipeline_bwd_planned(g, a, b, w, *plan, n)
            report(f"K2 {name} {tag}", read(lib, "hg_trace_read2", ctas),
                   [(1, "window range"), (40, "chunk list"), (41, "first issues"),
                    (3, "d_h product done"), (8, "chunk 0 landed"), (4, "walk done"),
                    (5, "g re-staged"), (6, "d_W written")])


if __name__ == "__main__":
    main()
