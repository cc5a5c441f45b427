// K1: the fused edge pipeline, forward, hand-written for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/pallas_segment.py::_edge_pipeline_kernel
// (launched there by _pallas_edge_pipeline through pl.pallas_call).
//
// Computes, over a block plan of the receiver-sorted edge list
// (hydragnn_tpu_torch/ops/edge_pipeline.py::plan_sorted_blocks):
//
//     out[n] = sum_{slots s: valid[s], seg[s] == n} (a[perm[s]] * b[perm[s]]) @ W
//
// with b and W each optional, f32 or bf16 operands (bf16 a/b may come with
// an f32 master W, as the JAX kernel takes it), f32 accumulation and one
// cast of the output to promote(a, W).
//
// What bounds it on this card. Per call it must read the valid rows of a
// and b, W and the plan, and write [N, F_out]: at bench.py's headline
// train batch (24,656 edges, F = 128, f32) ~27 MB, 8 us at 3.35 TB/s,
// against 2 N F_in F_out ~ 0.09 GFLOP of product. So bytes bound it,
// and at a served bin (584 nodes, ~1,200 edges) latency does: the
// launch, the walk, and how many SMs have work.
//
// Design (the shared pieces are in edge_tile.cuh):
// - Grid: one CTA per (node window of bn rows, slab of F_in columns).
//   Each CTA sums its slab of the window's message into an f32
//   [bn, slab] tile (each node's run of receiver-sorted slots is summed
//   by the one warp that owns it: no per-warp tiles, no fold), streaming
//   the plan's contiguous edge tiles through the cp.async ring. Chunks
//   without a valid slot (padding edges, static padding blocks) are
//   never staged.
// - With W the output needs a sum over all of F_in, so the slab CTAs of
//   one window form a thread-block cluster (cudaLaunchKernelEx with the
//   cluster-dimension attribute; at most 8, the portable limit: slabs are
//   32 columns up to F_in = 256, then 64 up to 512, and so on). Each CTA
//   multiplies its sum by W[slab, :] (f32 FMAs; W's slab rows are
//   contiguous and staged with coalesced copies over the idle ring) into
//   an f32 [bn, F_out] partial in its shared memory; then
//   rank r adds the cluster's partials through distributed shared memory
//   (cluster.map_shared_rank), always in rank order, and writes output
//   columns [r F_out / cluster, (r + 1) F_out / cluster). No float
//   atomics: the same inputs give the same bits on every run.
// - Without W (the reduce-only and a,b flavours) the slabs are
//   independent: no cluster, each CTA writes its columns.
// - Every output row of the window is written exactly once, zeros for an
//   empty window included.
// wgmma (64-row tiles, so bn = 64), TMA multicast and a persistent grid
// are later work.

#include <cooperative_groups.h>

#include "edge_tile.cuh"

namespace {

using namespace hg;
namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;

// Columns per CTA (a multiple of kSlab) and CTAs per window: with W at
// most kMaxCluster CTAs, which share one window's product through a
// cluster; without W one 32-column slab each.
__host__ __device__ inline void slabs_of(int f_in, bool has_w, int& subs, int& n_slabs) {
  const int n32 = (f_in + kSlab - 1) / kSlab;
  subs = has_w ? (n32 + kMaxCluster - 1) / kMaxCluster : 1;
  n_slabs = (n32 + subs - 1) / subs;
}

// Shared memory, in bytes from 16-byte aligned offsets: the message sum
// [bn16, kMsgLd] f32, the ring [kStages][ops][kSub][kRingLd] (T) and the
// walk's shared ints; with W, W's slab rows [32, ldw] (TW) are staged
// over the ring once the walk is done, followed there by the f32
// partial [bn16, ldp] when the CTA has one 32-column slab (else the
// partial, which lives across slabs, follows the walk's ints). Keeping
// W out of the walk's way holds a CTA at ~69 KB at F = 128, so three
// fit on an SM.
struct FwdLayout {
  int bn16, ldw, ldp;
  size_t msg, ring, ints, w, part, total;
  __host__ __device__ FwdLayout(int bn, int f_out, int sz_t, int sz_w, bool has_b,
                                bool has_w, int subs) {
    bn16 = round_up(bn, 16);
    const int ops = has_b ? 2 : 1;
    ldw = round_up(f_out, 8) + 32 / sz_w;
    ldp = round_up(f_out, 8) + 8;
    const size_t w_bytes = has_w ? align16((size_t)kSlab * ldw * sz_w) : 0;
    const size_t part_bytes = has_w ? align16((size_t)bn16 * ldp * 4) : 0;
    size_t off = 0;
    msg = off;
    off = align16(off + (size_t)bn16 * kMsgLd * 4);
    ring = w = off;
    size_t ring_bytes = (size_t)kStages * ring_stage_bytes(ops, sz_t);
    const size_t over = w_bytes + (subs == 1 ? part_bytes : 0);
    ring_bytes = ring_bytes > over ? ring_bytes : over;
    off = align16(off + ring_bytes);
    ints = off;
    off = align16(off + kWalkBytes);
    part = ring + w_bytes;
    if (subs != 1) {
      part = off;
      off += part_bytes;
    }
    total = off;
  }
};

// Four consecutive outputs (16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// T: a and b; TW: W; TO: the output, promote(T, TW). vec bits: 1 = a and b
// rows take 16-byte copies; 4 = W rows do; 8 = output rows take 4-wide
// stores (F_out % 4 == 0, out 16-byte aligned).
template <typename T, typename TW, typename TO, bool HAS_B, bool HAS_W>
__global__ void __launch_bounds__(kThreads, 3)
edge_pipeline_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const TW* __restrict__ w, const int* __restrict__ perm,
                     const int* __restrict__ seg, const uint8_t* __restrict__ valid,
                     const int* __restrict__ window_id, TO* __restrict__ out, int n_edges,
                     int n_nodes, int f_in, int f_out, int be, int bn, int n_blocks,
                     int n_slabs, int subs, int vec) {
  constexpr int kOps = HAS_B ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L(bn, f_out, sizeof(T), sizeof(TW), HAS_B, HAS_W, subs);
  float* msg_s = reinterpret_cast<float*>(smem + L.msg);
  TW* w_s = reinterpret_cast<TW*>(smem + L.w);
  float* part = reinterpret_cast<float*>(smem + L.part);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int slab = blockIdx.x % n_slabs;
  const int win = blockIdx.x / n_slabs;
  const int node_base = win * bn;
  const int rows = min(bn, n_nodes - node_base);

  Walk<T, kOps> wk;
  wk.perm = perm;
  wk.seg = seg;
  wk.valid = valid;
  wk.a = a;
  wk.b = b;
  wk.ring = reinterpret_cast<T*>(smem + L.ring);
  wk.ints = reinterpret_cast<int*>(smem + L.ints);
  int hi;
  window_range(window_id, n_blocks, win, wk.lo, hi);
  wk.nsub = (be + kSub - 1) / kSub;
  wk.n_cand = (hi - wk.lo) * wk.nsub;
  wk.be = be;
  wk.node_base = node_base;
  wk.rows = rows;
  wk.n_edges = n_edges;
  wk.f_in = f_in;
  wk.vec = vec & 1;

  for (int sub = 0; sub < subs; ++sub) {
    const int c0 = (slab * subs + sub) * kSlab;
    if (c0 >= f_in) break;  // uniform: a ragged last CTA
    wk.c0 = c0;
    for (int i = tid; i < L.bn16 * kMsgLd; i += kThreads) msg_s[i] = 0.f;
    wk.start();
    wk.finish([&](int st, int, const int* codes) {
      chunk_slots<T, kOps, true>(msg_s, codes, wk.ring_at(st, 0), wk.ring_at(st, kOps - 1),
                                 [](int, int) { return 0.f; },
                                 [](int, int, float, float, float) {});
    });
    if constexpr (HAS_W) {  // the ring is idle: W's slab rows go there
      stage_tile<TW>(w_s, L.ldw, w, c0, kSlab, f_in, 0, round_up(f_out, 8), f_out, vec & 4);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();

    if constexpr (!HAS_W) {
      for (int i = tid; i < rows * kSlab; i += kThreads) {
        const int r = i / kSlab, c = i % kSlab;
        if (c0 + c < f_in)
          store(out + (size_t)(node_base + r) * f_out + c0 + c, msg_s[r * kMsgLd + c]);
      }
    } else {
      // part[n, j] (+)= sum_i msg[n, i] W[c0 + i, j]: each thread a 4 x 4
      // block, rows 4 warp.., columns 4 lane.. (f32 FMAs; edge_tile.cuh).
      for (int r0 = warp * 4; r0 < L.bn16; r0 += 4 * kWarps) {
        for (int j = lane * 4; j < f_out; j += 128) {
          float acc[4][4] = {};
#pragma unroll 4
          for (int i = 0; i < kSlab; ++i) {
            float wv[4];
            load4(w_s + i * L.ldw + j, wv);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float m = msg_s[(r0 + u) * kMsgLd + i];  // one address per warp
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(m, wv[v], acc[u][v]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float* p = part + (r0 + u) * L.ldp + j;
#pragma unroll
            for (int v = 0; v < 4; ++v) p[v] = sub == 0 ? acc[u][v] : p[v] + acc[u][v];
          }
        }
      }
    }
    __syncthreads();  // msg_s and w_s are free for the next slab
  }

  if constexpr (HAS_W) {
    // The window's output: rank r sums the cluster's partials, in rank
    // order, over its share of the F_out columns, four at a time where
    // the output rows allow 16-byte (f32) or 8-byte (bf16) stores.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float* src[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      src[q] = q < n_slabs ? cluster.map_shared_rank(part, q) : part;
    const int cw = round_up((f_out + n_slabs - 1) / n_slabs, 4);
    const int j0 = slab * cw;
    if (vec & 8) {
      for (int i = tid; i < rows * (cw / 4); i += kThreads) {
        const int r = i / (cw / 4), j = j0 + (i % (cw / 4)) * 4;
        if (j >= f_out) continue;
        float4 v[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < n_slabs) v[q] = *reinterpret_cast<const float4*>(src[q] + r * L.ldp + j);
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          if (q >= n_slabs) continue;
          sum[0] += v[q].x;
          sum[1] += v[q].y;
          sum[2] += v[q].z;
          sum[3] += v[q].w;
        }
        store4(out + (size_t)(node_base + r) * f_out + j, sum);
      }
    } else {
      for (int i = tid; i < rows * cw; i += kThreads) {
        const int r = i / cw, j = j0 + i % cw;
        if (j >= f_out) continue;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < n_slabs) sum += src[q][r * L.ldp + j];
        store(out + (size_t)(node_base + r) * f_out + j, sum);
      }
    }
    cluster.sync();  // no CTA leaves while another reads its partial
  }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

int max_smem_optin() {
  static int max_smem = -1;  // read once: a CUDA graph capture makes no query
  if (max_smem < 0) {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return 0;
    max_smem = bytes;
  }
  return max_smem;
}

template <typename T, typename TW, typename TO, bool HAS_B, bool HAS_W>
cudaError_t launch(const void* a, const void* b, const void* w, const void* perm,
                   const void* seg, const void* valid, const void* window_id, void* out,
                   int n_edges, int n_nodes, int f_in, int f_out, int be, int bn,
                   int n_blocks, cudaStream_t stream) {
  auto kernel = edge_pipeline_kernel<T, TW, TO, HAS_B, HAS_W>;
  int subs, n_slabs;
  slabs_of(f_in, HAS_W, subs, n_slabs);
  const FwdLayout L(bn, f_out, sizeof(T), sizeof(TW), HAS_B, HAS_W, subs);
  if (L.total > (size_t)max_smem_optin()) return cudaErrorInvalidValue;
  // Opt in above 48 KB once per instantiation and size (raised only), so
  // a steady stream of launches, or a CUDA graph capture, makes no
  // attribute calls.
  static size_t opted = 48 * 1024;
  if (L.total > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
    opted = L.total;
  }
  const int n_windows = (n_nodes + bn - 1) / bn;
  const int vec = ((f_in * (int)sizeof(T)) % 16 == 0 && aligned16(a) && aligned16(b) ? 1 : 0) |
                  ((f_out * (int)sizeof(TW)) % 16 == 0 && aligned16(w) ? 4 : 0) |
                  (f_out % 4 == 0 && aligned16(out) ? 8 : 0);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_windows * n_slabs);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = L.total;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = HAS_W ? n_slabs : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const TW*>(w), static_cast<const int*>(perm), static_cast<const int*>(seg),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(window_id),
      static_cast<TO*>(out), n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, n_slabs, subs,
      vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Flavours with W take TW; without W the weight type is moot and TO is T.
template <typename T, typename TW, typename TO>
cudaError_t launch_flavour(int has_b, int has_w, const void* a, const void* b,
                           const void* w, const void* perm, const void* seg,
                           const void* valid, const void* window_id, void* out,
                           int n_edges, int n_nodes, int f_in, int f_out, int be,
                           int bn, int n_blocks, cudaStream_t stream) {
#define HG_LAUNCH(TW_, TO_, HB, HW)                                               \
  return launch<T, TW_, TO_, HB, HW>(a, b, w, perm, seg, valid, window_id, out,  \
                                     n_edges, n_nodes, f_in, f_out, be, bn,      \
                                     n_blocks, stream)
  if (has_b && has_w) HG_LAUNCH(TW, TO, true, true);
  if (has_w) HG_LAUNCH(TW, TO, false, true);
  if (has_b) HG_LAUNCH(T, T, true, false);
  HG_LAUNCH(T, T, false, false);
#undef HG_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32; 1 = bfloat16; 2 = bfloat16 a/b with a float32 W
// (and a float32 output), which needs W. Returns the launch's CUDA error
// (0 on success), or cudaErrorInvalidValue when the sizes do not fit
// shared memory. The caller allocates `out` ([n_nodes, f_out]).
int hg_edge_pipeline_fwd(const void* a, const void* b, const void* w,
                         const void* perm, const void* seg, const void* valid,
                         const void* window_id, void* out, int n_edges, int n_nodes,
                         int f_in, int f_out, int be, int bn, int n_blocks, int dtype,
                         int has_b, int has_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (dtype == 0)
    return (int)launch_flavour<float, float, float>(has_b, has_w, a, b, w, perm, seg,
                                                    valid, window_id, out, n_edges,
                                                    n_nodes, f_in, f_out, be, bn,
                                                    n_blocks, s);
  if (dtype == 1)
    return (int)launch_flavour<bf16, bf16, bf16>(has_b, has_w, a, b, w, perm, seg, valid,
                                                 window_id, out, n_edges, n_nodes, f_in,
                                                 f_out, be, bn, n_blocks, s);
  if (dtype == 2 && has_w)
    return (int)launch_flavour<bf16, float, float>(has_b, has_w, a, b, w, perm, seg,
                                                   valid, window_id, out, n_edges,
                                                   n_nodes, f_in, f_out, be, bn,
                                                   n_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// K1's launch shape for these sizes: out[0] CTAs, out[1] CTAs per
// cluster, out[2] threads per CTA, out[3] dynamic shared memory per CTA
// in bytes, out[4] columns per CTA.
void hg_edge_pipeline_fwd_shape(int n_nodes, int f_in, int f_out, int bn, int dtype,
                                int has_b, int has_w, int* out) {
  int subs, n_slabs;
  slabs_of(f_in, has_w, subs, n_slabs);
  const FwdLayout L(bn, f_out, dtype == 0 ? 4 : 2, dtype == 1 ? 2 : 4, has_b, has_w, subs);
  out[0] = ((n_nodes + bn - 1) / bn) * n_slabs;
  out[1] = has_w ? n_slabs : 1;
  out[2] = kThreads;
  out[3] = (int)L.total;
  out[4] = subs * kSlab;
}

const char* hg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
