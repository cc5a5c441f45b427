// K2: the fused edge pipeline's pullback, hand-written for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/pallas_segment.py::_edge_pipeline_bwd_kernel
// (launched there by _pallas_edge_pipeline_bwd through pl.pallas_call).
//
// Given the cotangent g [N, F_out] of K1's output
//
//     out[n] = sum_{slots s: valid[s], seg[s] == n} (a[perm[s]] * b[perm[s]]) @ W
//
// it computes, with b and W each optional,
//
//     d_h[e] = g[seg[s]] @ W^T          for the one valid slot s of edge e
//     d_a[e] = d_h[e] * b[e],  d_b[e] = d_h[e] * a[e]   (0 for edges in no valid slot)
//     d_W    = sum_s (a * b)[perm[s]]^T g[seg[s]]
//
// in f32, cast once to each operand's type (bf16 a/b may come with an f32
// master W, and then g and d_W are f32).
//
// What bounds it on this card. Per call it must read g, W, the plan and
// the valid rows of a and b, and write d_a, d_b (every row) and d_W: at
// bench.py's headline train batch (24,656 edges, F = 128, f32) ~52 MB,
// 15.5 us at 3.35 TB/s, against ~0.19 GFLOP of products (~3 us at the
// 67 TFLOP/s f32 rate). So bytes bound it, and at the small train bins
// (288 nodes) latency does: the launch, the walk, and how many SMs have
// work.
//
// Design (the shared pieces are in edge_tile.cuh):
// - Grid: one CTA per (node window of bn rows, slab of 32 F_in columns),
//   ceil(F_in / 32) x windows CTAs; the last slab is masked. The slab
//   parts are independent: the CTA for slab c forms
//   d_h[:, c] = g_win @ W[c, :]^T (f32 FMAs, edge_tile.cuh), writes
//   columns c of d_a and d_b for its window's valid slots (a warp
//   writes 128 contiguous bytes a slot), sums the message (a*b)[:, c]
//   per node in the same pass over the staged chunk, and
//   writes the f32 d_W partial rows [c, :] = msg^T @ g_win. Every CTA
//   reads its window's g rows (from L2 after the first slab); TMA
//   multicast of that window across a cluster is not used.
// - Staging: g's window rows and W's slab rows (contiguous, so Wᵀ is
//   staged with coalesced reads) are one cp.async group; the plan's
//   contiguous edge tiles stream through the three-stage cp.async ring
//   of edge_tile.cuh (chunks without a valid slot are never staged), the
//   first chunk overlapping the d_h product and two chunks in flight
//   during each chunk's work. g's window is read again (from L2) for the
//   d_W product, so that the ring can hold it and a CTA stays small
//   enough for three per SM.
// - No memset of d_a or d_b: each row is written exactly once. A valid
//   slot writes its row's gradient, and the slab-0 CTA marks the row in
//   an E-byte coverage mask (zeroed by the caller, 1/(4 F_in) of the
//   bytes of a memset of d_a). A second kernel writes zeros to every
//   unmarked row (masked edges, padding edges) and folds the d_W
//   partials in window order. The mask is chosen over an owner rule
//   derived from the plan: a row of a tile that several windows visit,
//   invalid in all of them, has no owner the plan names without a walk
//   over those blocks (empty windows' and padding blocks point at tile 0
//   out of order), while the mask costs E bytes and rides on the launch
//   that folds d_W anyway.
// - perm is a permutation over valid slots, so no row is written twice
//   and no float atomics are needed anywhere: the same inputs give the
//   same bits on every run.
// wgmma (64-row tiles, so bn = 64), TMA multicast of g and a persistent
// grid are later work.

#include "edge_tile.cuh"

namespace {

using namespace hg;

constexpr int kDhLd = 36;  // [bn, 32] f32 d_h tile stride

// Shared memory, in bytes from 16-byte aligned offsets. With W: d_h
// [bn16, kDhLd] f32 and the message sum [bn16, kMsgLd] f32; without W
// the g slab [bn16, kRingLd] (TG), which is d_h. Then the ring
// [kStages][ops][kSub][kRingLd] (T) and the walk's shared ints. With W
// the g window [bn16, ldg] (TG) and W's slab rows [32, ldw] (TW) are
// staged over ring stages 1.. for the d_h product, while chunk 0 lands
// in stage 0, and g again over stage 0.. for the d_W product once the
// walk is done: so a CTA holds ~74 KB at F = 128 and three fit on an SM.
struct BwdLayout {
  int bn16, ldg, ldw;
  size_t g, g_end, w, dh, msg, ring, ints, total;
  __host__ __device__ BwdLayout(int bn, int f_out, int sz_t, int sz_w, int sz_g, bool has_b,
                                bool has_w) {
    bn16 = round_up(bn, 16);
    const int ops = (has_b || has_w ? 1 : 0) + (has_b ? 1 : 0);
    ldg = has_w ? round_up(f_out, 8) + 16 / sz_g : kRingLd;
    ldw = round_up(f_out, 8) + 16 / sz_w;
    const size_t g_bytes = align16((size_t)bn16 * ldg * sz_g);
    const size_t stage_bytes = ring_stage_bytes(ops, sz_t);
    size_t off = 0;
    g = dh = msg = off;
    if (has_w) {
      dh = off;
      off = align16(off + (size_t)bn16 * kDhLd * 4);
      msg = off;
      off = align16(off + (size_t)bn16 * kMsgLd * 4);
    } else {
      off = g_bytes;
    }
    ring = off;
    size_t ring_bytes = (size_t)kStages * stage_bytes;
    if (has_w) {
      g = ring + stage_bytes;
      w = g + g_bytes;
      g_end = ring;
      const size_t over = stage_bytes + g_bytes + align16((size_t)kSlab * ldw * sz_w);
      ring_bytes = ring_bytes > over ? ring_bytes : over;
    } else {
      w = g_end = g;
    }
    off = align16(off + ring_bytes);
    ints = off;
    total = off + kWalkBytes;
  }
};

// vec bits: 1 = a, b, d_a, d_b rows take 16-byte copies; 2 = g; 4 = W.
template <typename T, typename TW, typename TG, bool HAS_B, bool HAS_W>
__global__ void __launch_bounds__(kThreads, 3)
edge_pipeline_bwd_kernel(const TG* __restrict__ g, const T* __restrict__ a,
                         const T* __restrict__ b, const TW* __restrict__ w,
                         const int* __restrict__ perm, const int* __restrict__ seg,
                         const uint8_t* __restrict__ valid,
                         const int* __restrict__ window_id, T* __restrict__ d_a,
                         T* __restrict__ d_b, uint8_t* __restrict__ covered,
                         float* __restrict__ dw_part, int n_edges, int n_nodes, int f_in,
                         int f_out, int be, int bn, int n_blocks, int n_slabs, int vec) {
  constexpr int kOps = (HAS_B || HAS_W ? 1 : 0) + (HAS_B ? 1 : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L(bn, f_out, sizeof(T), sizeof(TW), sizeof(TG), HAS_B, HAS_W);
  TG* g_s = reinterpret_cast<TG*>(smem + L.g);
  TW* w_s = reinterpret_cast<TW*>(smem + L.w);
  float* dh_s = reinterpret_cast<float*>(smem + L.dh);
  float* msg_s = reinterpret_cast<float*>(smem + L.msg);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int slab = blockIdx.x % n_slabs;
  const int win = blockIdx.x / n_slabs;
  const int c0 = slab * kSlab;
  const int node_base = win * bn;
  const int rows = min(bn, n_nodes - node_base);
  const bool vec_ab = vec & 1;

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
  wk.c0 = c0;
  wk.vec = vec_ab;

  // The window's cotangent rows (zeros past N), and W's slab rows, as
  // one cp.async group; then chunk 0 of the walk (with W the other ring
  // stages hold g and W until the d_h product is done).
  if constexpr (HAS_W) {
    stage_tile<TG>(g_s, L.ldg, g, node_base, L.bn16, node_base + rows, 0,
                   round_up(f_out, 8), f_out, vec & 2);
    stage_tile<TW>(w_s, L.ldw, w, c0, kSlab, f_in, 0, round_up(f_out, 8), f_out, vec & 4);
  } else {
    stage_tile<TG>(g_s, L.ldg, g, node_base, L.bn16, node_base + rows, c0, kSlab, f_out,
                   vec & 2);
  }
  cp_async_commit();
  wk.start(HAS_W ? 1 : kStages - 1);

  if constexpr (HAS_W) {
    if (wk.nq > 0) cp_async_wait<1>();  // g and W; chunk 0 may still be in flight
    else cp_async_wait<0>();
    __syncthreads();
    // d_h[n, j] = sum_k g[n, k] W[c0 + j, k], rows 4 warp.., column lane
    // (f32 FMAs; edge_tile.cuh); and the message sum starts at 0.
    for (int r0 = warp * 4; r0 < L.bn16; r0 += 4 * kWarps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int k = 0; k < f_out; k += 4) {
        float gv[4][4], wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) load4(g_s + (r0 + u) * L.ldg + k, gv[u]);
        load4(w_s + lane * L.ldw + k, wv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[u] = fmaf(gv[u][q], wv[q], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) dh_s[(r0 + u) * kDhLd + lane] = acc[u];
    }
    for (int i = tid; i < L.bn16 * kMsgLd; i += kThreads) msg_s[i] = 0.f;
    __syncthreads();  // g and W leave the ring stages the walk fills next
  }

  wk.finish([&](int st, int row0, const int* codes) {
    // Each valid slot's row of d_a / d_b at the lane's column (a warp
    // writes a slot's 32 columns at once), and with W its message into
    // the node sums.
    const bool col_in = c0 + lane < f_in;
    chunk_slots<T, kOps, HAS_W>(
        msg_s, codes, wk.ring_at(st, 0), wk.ring_at(st, kOps > 1 ? 1 : 0),
        [&](int, int n) {
          return HAS_W ? dh_s[n * kDhLd + lane] : to_f32(g_s[n * kRingLd + lane]);
        },
        [&](int s, int, float va, float vb, float dh) {
          const size_t off = (size_t)(row0 + s) * f_in + c0 + lane;
          if (col_in) {
            store(d_a + off, dh * vb);
            if constexpr (HAS_B) store(d_b + off, dh * va);
          }
          if (slab == 0 && lane == 0) covered[row0 + s] = 1;
        });
  });

  if constexpr (HAS_W) {
    // g's window again, over the idle ring.
    g_s = reinterpret_cast<TG*>(smem + L.g_end);
    stage_tile<TG>(g_s, L.ldg, g, node_base, L.bn16, node_base + rows, 0,
                   round_up(f_out, 8), f_out, vec & 2);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // This window's d_W partial rows: part[c0 + i, j] = sum_n msg[n, i] g[n, j],
    // written whole (zeros for an empty window).
    float* part = dw_part + ((size_t)win * f_in + c0) * f_out;
    // Each thread a 4 x 4 block: rows c0 + 4 warp.., columns 4 lane..
    const int i0 = warp * 4;
    for (int j = lane * 4; j < f_out; j += 128) {
      float acc[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < L.bn16; ++n) {
        float m[4], gv[4];
        load4(msg_s + n * kMsgLd + i0, m);
        load4(g_s + n * L.ldg + j, gv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(m[u], gv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + i0 + u >= f_in) break;
        float* p = part + (size_t)(i0 + u) * f_out + j;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (j + v < f_out) p[v] = acc[u][v];
      }
    }
  }
}

// Blocks [0, fold_blocks): d_W[i] = the window partials summed in window
// order. The rest: each warp takes 32 edge rows and writes zeros to the
// d_a (and d_b) rows no valid slot covered.
template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
bwd_finish_kernel(const float* __restrict__ part, TW* __restrict__ d_w, int n_windows,
                  int size, int fold_blocks, const uint8_t* __restrict__ covered,
                  T* __restrict__ d_a, T* __restrict__ d_b, int n_edges, int f_in, int vec) {
  if ((int)blockIdx.x < fold_blocks) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= size) return;
    float s = 0.f;
#pragma unroll 8
    for (int q = 0; q < n_windows; ++q) s += part[(size_t)q * size + i];  // loads overlap; sums in order
    store(d_w + i, s);
    return;
  }
  const int lane = threadIdx.x % 32;
  const int base = (blockIdx.x - fold_blocks) * kThreads + (threadIdx.x / 32) * 32;
  const int r = base + lane;
  unsigned todo = __ballot_sync(0xffffffffu, r < n_edges && !covered[r]);
  while (todo) {
    const int row = base + __ffs(todo) - 1;
    todo &= todo - 1;
    T* ra = d_a + (size_t)row * f_in;
    T* rb = d_b ? d_b + (size_t)row * f_in : nullptr;
    if (vec & 1) {
      constexpr int kPer = 16 / sizeof(T);
      for (int c = lane * kPer; c < f_in; c += 32 * kPer) {
        *reinterpret_cast<uint4*>(ra + c) = make_uint4(0, 0, 0, 0);
        if (rb) *reinterpret_cast<uint4*>(rb + c) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int c = lane; c < f_in; c += 32) {
        ra[c] = zero_of<T>();
        if (rb) rb[c] = zero_of<T>();
      }
    }
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

template <typename T, typename TW, typename TG, bool HAS_B, bool HAS_W>
cudaError_t launch(const void* g, const void* a, const void* b, const void* w,
                   const void* perm, const void* seg, const void* valid,
                   const void* window_id, void* d_a, void* d_b, void* d_w, void* dw_part,
                   void* covered, int n_edges, int n_nodes, int f_in, int f_out, int be,
                   int bn, int n_blocks, cudaStream_t stream) {
  auto kernel = edge_pipeline_bwd_kernel<T, TW, TG, HAS_B, HAS_W>;
  const BwdLayout L(bn, f_out, sizeof(T), sizeof(TW), sizeof(TG), HAS_B, HAS_W);
  if (L.total > (size_t)max_smem_optin()) return cudaErrorInvalidValue;
  // Opt in above 48 KB once per instantiation and size (raised only).
  static size_t opted = 48 * 1024;
  if (L.total > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
    opted = L.total;
  }
  const int n_windows = (n_nodes + bn - 1) / bn;
  const int n_slabs = (f_in + kSlab - 1) / kSlab;
  const int vec = ((f_in * (int)sizeof(T)) % 16 == 0 && aligned16(a) && aligned16(b) &&
                   aligned16(d_a) && aligned16(d_b) ? 1 : 0) |
                  ((f_out * (int)sizeof(TG)) % 16 == 0 && aligned16(g) ? 2 : 0) |
                  ((f_out * (int)sizeof(TW)) % 16 == 0 && aligned16(w) ? 4 : 0);
  kernel<<<n_windows * n_slabs, kThreads, L.total, stream>>>(
      static_cast<const TG*>(g), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const TW*>(w), static_cast<const int*>(perm),
      static_cast<const int*>(seg), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(window_id), static_cast<T*>(d_a), static_cast<T*>(d_b),
      static_cast<uint8_t*>(covered), static_cast<float*>(dw_part), n_edges, n_nodes, f_in,
      f_out, be, bn, n_blocks, n_slabs, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = f_in * f_out;
  const int fold_blocks = HAS_W ? (size + kThreads - 1) / kThreads : 0;
  const int fill_blocks = (n_edges + kThreads - 1) / kThreads;
  bwd_finish_kernel<T, TW><<<fold_blocks + fill_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(dw_part), static_cast<TW*>(d_w), n_windows, size,
      fold_blocks, static_cast<const uint8_t*>(covered), static_cast<T*>(d_a),
      HAS_B ? static_cast<T*>(d_b) : nullptr, n_edges, f_in, vec);
  return cudaGetLastError();
}

// Flavours with W take TW and TG; without W, g has the operands' type T.
template <typename T, typename TW, typename TG>
cudaError_t launch_flavour(int has_b, int has_w, const void* g, const void* a,
                           const void* b, const void* w, const void* perm,
                           const void* seg, const void* valid, const void* window_id,
                           void* d_a, void* d_b, void* d_w, void* dw_part, void* covered,
                           int n_edges, int n_nodes, int f_in, int f_out, int be, int bn,
                           int n_blocks, cudaStream_t stream) {
#define HG_LAUNCH(TW_, TG_, HB, HW)                                                \
  return launch<T, TW_, TG_, HB, HW>(g, a, b, w, perm, seg, valid, window_id, d_a, \
                                     d_b, d_w, dw_part, covered, n_edges, n_nodes, \
                                     f_in, f_out, be, bn, n_blocks, stream)
  if (has_b && has_w) HG_LAUNCH(TW, TG, true, true);
  if (has_w) HG_LAUNCH(TW, TG, false, true);
  if (has_b) HG_LAUNCH(T, T, true, false);
  HG_LAUNCH(T, T, false, false);
#undef HG_LAUNCH
}

int type_size(int dtype, int which) {  // which: 0 = a/b, 1 = W, 2 = g
  if (dtype == 0) return 4;
  if (dtype == 1) return 2;
  return which == 0 ? 2 : 4;
}

}  // namespace

extern "C" {

// dtype: 0 = float32; 1 = bfloat16; 2 = bfloat16 a/b with a float32 W (and
// a float32 g and d_W), which needs W. The caller allocates d_a, d_b
// ([n_edges, f_in]), d_w ([f_in, f_out]), the f32 scratch dw_part
// ([ceil(n_nodes / bn), f_in, f_out]) and the coverage mask `covered`
// ([n_edges] bytes, zeroed); d_b/d_w/dw_part are unused (may be null)
// without b/W. Returns the first CUDA error of the two launches (0 on
// success), or cudaErrorInvalidValue when the sizes do not fit shared
// memory.
int hg_edge_pipeline_bwd(const void* g, const void* a, const void* b, const void* w,
                         const void* perm, const void* seg, const void* valid,
                         const void* window_id, void* d_a, void* d_b, void* d_w,
                         void* dw_part, void* covered, int n_edges, int n_nodes, int f_in,
                         int f_out, int be, int bn, int n_blocks, int dtype, int has_b,
                         int has_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (dtype == 0)
    return (int)launch_flavour<float, float, float>(
        has_b, has_w, g, a, b, w, perm, seg, valid, window_id, d_a, d_b, d_w, dw_part,
        covered, n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, s);
  if (dtype == 1)
    return (int)launch_flavour<bf16, bf16, bf16>(
        has_b, has_w, g, a, b, w, perm, seg, valid, window_id, d_a, d_b, d_w, dw_part,
        covered, n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, s);
  if (dtype == 2 && has_w)
    return (int)launch_flavour<bf16, float, float>(
        has_b, has_w, g, a, b, w, perm, seg, valid, window_id, d_a, d_b, d_w, dw_part,
        covered, n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// K2's launch shape for these sizes: out[0] CTAs of the main kernel,
// out[1] CTAs per cluster (1), out[2] threads per CTA, out[3] dynamic
// shared memory per CTA in bytes, out[4] CTAs of the finishing kernel.
void hg_edge_pipeline_bwd_shape(int n_edges, int n_nodes, int f_in, int f_out, int bn,
                                int dtype, int has_b, int has_w, int* out) {
  const BwdLayout L(bn, f_out, type_size(dtype, 0), type_size(dtype, 1),
                    type_size(dtype, has_w ? 2 : 0), has_b, has_w);
  out[0] = ((n_nodes + bn - 1) / bn) * ((f_in + kSlab - 1) / kSlab);
  out[1] = 1;
  out[2] = kThreads;
  out[3] = (int)L.total;
  out[4] = (has_w ? (f_in * f_out + kThreads - 1) / kThreads : 0) +
           (n_edges + kThreads - 1) / kThreads;
}

}  // extern "C"
