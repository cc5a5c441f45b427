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
// Design. Two identities move the work from edges to nodes: d_h depends
// on the edge only through its receiver, so g @ W^T is computed once per
// node row ([bn, F_in] per window, not [E, F_in]); and
// d_W = (segment_sum(a * b))^T @ g, so the message a * b is summed into a
// per-window [bn, F_in] tile exactly as K1 sums it, never written to
// device memory as [E, F]. One CTA owns one node window of bn rows (as in
// K1): it stages its g rows in shared memory (rows past N are zeros; g is
// never read there, nor at an invalid slot), forms g @ W^T with a
// register-tiled f32 product, then walks its plan slots. Each valid slot
// writes its edge row of d_a and d_b once: perm is a permutation over
// valid slots, so no row is written twice and no atomics are needed;
// d_a/d_b are zeroed first (cudaMemsetAsync), so edges of padding, masked
// or never-visited slots stay zero, and invalid slots write nothing. The
// TPU kernel carried d_W in one output tile across its sequential grid and
// re-opened boundary tiles of d_a/d_b across consecutive blocks; Hopper
// runs blocks in no order, so instead each CTA writes its window's f32
// partial of d_W to scratch and a second kernel sums the partials in
// window order. No float atomics anywhere: the same inputs give the same
// bits on every run.
//
// What bounds it on this card. Per call the kernel must read a and b
// (valid rows), g, W and the plan, and write d_a, d_b and d_W: at a train
// bin of ~1,200 edges and F = 128 that is ~2 MB, ~0.6 us at 3.35 TB/s;
// the products are 2*N*F_in*F_out (g @ W^T) plus 2*N*F_in*F_out (d_W)
// plus the per-edge multiplies, ~0.1 us at 67 TFLOP/s f32. So bytes bound
// it, and at these sizes the launch, the slot walk and the few CTAs per
// bin (bn = 32 gives ~20) matter more than either. The design keeps every
// operand row read once, the message and d_h in shared memory and
// registers, and the only extra traffic the d_W partials (F_in * F_out
// f32 per window, L2-resident). wgmma, TMA staging and a persistent grid
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // plan slots staged per pass
constexpr int kVec = 4;      // columns a lane carries per pass (stride 32)
constexpr int kUnroll = 8;   // slots whose operands are loaded before any is used
// Product tiling: a 16 x 16 thread grid, each thread kRT rows x kCT cols,
// over W^T rows staged kKC at a time.
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kRT = 2;
constexpr int kCT = 8;
constexpr int kKC = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// First i in [0, n) with arr[i] >= key; arr is non-decreasing.
__device__ __forceinline__ int lower_bound(const int* arr, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Shared memory, in floats: the g window, then (with W) g @ W^T, the
// warp tiles of the message sum and the W^T chunk; then the staged
// (row, edge) slot pairs.
__host__ __device__ __forceinline__ size_t smem_floats(int groups, int bn, int f_in,
                                                       int f_out, bool has_w) {
  size_t n = (size_t)bn * f_out + 2 * kChunk;
  if (has_w) n += (size_t)bn * f_in * (1 + groups) + (size_t)kKC * kTX * kCT;
  return n;
}

__device__ __forceinline__ void flush(float* acc_row, const float* r, int cb, int f_in) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = cb + 32 * j;
    if (c < f_in) acc_row[c] += r[j];
  }
}

// T: a, b, d_a, d_b; TW: W and d_W; TG: g, promote(T, TW).
template <typename T, typename TW, typename TG, bool HAS_B, bool HAS_W>
__global__ void __launch_bounds__(kThreads)
edge_pipeline_bwd_kernel(const TG* __restrict__ g, const T* __restrict__ a,
                         const T* __restrict__ b, const TW* __restrict__ w,
                         const int* __restrict__ perm, const int* __restrict__ seg,
                         const uint8_t* __restrict__ valid,
                         const int* __restrict__ window_id, T* __restrict__ d_a,
                         T* __restrict__ d_b, float* __restrict__ dw_part, int n_edges,
                         int n_nodes, int f_in, int f_out, int be, int bn, int n_blocks,
                         int groups) {
  extern __shared__ float smem[];
  float* g_s = smem;                        // [bn][f_out]
  float* next = g_s + (size_t)bn * f_out;
  float* gw_s = g_s;                        // [bn][f_in]: g @ W^T, or g itself
  float* tiles = nullptr;                   // [groups][bn][f_in]
  float* wchunk = nullptr;                  // [kKC][kTX * kCT]
  if constexpr (HAS_W) {
    gw_s = next;
    next += (size_t)bn * f_in;
    tiles = next;
    next += (size_t)groups * bn * f_in;
    wchunk = next;
    next += kKC * kTX * kCT;
  }
  int* s_row = reinterpret_cast<int*>(next);  // [kChunk]
  int* s_e = s_row + kChunk;                  // [kChunk]
  __shared__ int s_range[2];

  const int win = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int node_base = win * bn;
  const int rows = min(bn, n_nodes - node_base);
  const int tile = bn * f_in;
  if (tid == 0) {
    s_range[0] = lower_bound(window_id, n_blocks, win);
    s_range[1] = lower_bound(window_id, n_blocks, win + 1);
  }
  // The window's cotangent rows as f32; rows past n_nodes are zeros.
  const TG* g_w = g + (size_t)node_base * f_out;
  for (int i = tid; i < bn * f_out; i += kThreads)
    g_s[i] = (i / f_out < rows) ? to_f32(g_w[i]) : 0.f;
  if constexpr (HAS_W) {
    for (int i = tid; i < groups * tile; i += kThreads) tiles[i] = 0.f;
  }
  __syncthreads();

  const int tx = tid % kTX;
  const int ty = tid / kTX;
  if constexpr (HAS_W) {
    // gw[r, k] = sum_c g[r, c] * W[k, c]: the per-node d_h. Loops are
    // uniform across the CTA (every thread reaches every barrier).
    for (int rp = 0; rp < bn; rp += kTY * kRT) {
      for (int cp = 0; cp < f_in; cp += kTX * kCT) {
        float sum[kRT][kCT];
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int j = 0; j < kCT; ++j) sum[i][j] = 0.f;
        const int r0 = rp + ty * kRT;
        for (int k0 = 0; k0 < f_out; k0 += kKC) {
          __syncthreads();  // the previous chunk is consumed
          for (int i = tid; i < kKC * kTX * kCT; i += kThreads) {
            const int kk = i / (kTX * kCT), c = cp + i % (kTX * kCT);
            wchunk[i] = (k0 + kk < f_out && c < f_in)
                            ? to_f32(w[(size_t)c * f_out + k0 + kk]) : 0.f;
          }
          __syncthreads();
          const int kn = min(kKC, f_out - k0);
          for (int kk = 0; kk < kn; ++kk) {
            float av[kRT], wv[kCT];
#pragma unroll
            for (int i = 0; i < kRT; ++i)
              av[i] = (r0 + i < bn) ? g_s[(r0 + i) * f_out + k0 + kk] : 0.f;
#pragma unroll
            for (int j = 0; j < kCT; ++j) wv[j] = wchunk[kk * kTX * kCT + tx + j * kTX];
#pragma unroll
            for (int i = 0; i < kRT; ++i)
#pragma unroll
              for (int j = 0; j < kCT; ++j) sum[i][j] = fmaf(av[i], wv[j], sum[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          if (r0 + i >= bn) continue;
#pragma unroll
          for (int j = 0; j < kCT; ++j) {
            const int c = cp + tx + j * kTX;
            if (c < f_in) gw_s[(r0 + i) * f_in + c] = sum[i][j];
          }
        }
      }
    }
    __syncthreads();
  }

  // The slot walk: each valid slot writes its edge's d_a/d_b row once and
  // (with W) adds its message a*b into its warp's tile.
  const int slot_end = s_range[1] * be;
  for (int base = s_range[0] * be; base < slot_end; base += kChunk) {
    const int cnt = min(kChunk, slot_end - base);
    for (int i = tid; i < cnt; i += kThreads) {
      const int s = base + i;
      int row = -1, e = 0;
      if (valid[s]) {
        row = seg[s] - node_base;
        e = perm[s];
        // Outside the plan contract: contributes nothing and never reads
        // or writes out of range.
        if (row < 0 || row >= rows || e < 0 || e >= n_edges) {
          row = -1;
          e = 0;
        }
      }
      s_row[i] = row;
      s_e[i] = e;
    }
    __syncthreads();
    if (warp < groups) {
      float* acc = HAS_W ? tiles + (size_t)warp * tile : nullptr;
      const int per = (cnt + groups - 1) / groups;
      const int lo = warp * per;
      const int hi = min(lo + per, cnt);
      for (int cb = lane; cb < f_in; cb += 32 * kVec) {
        float r[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) r[j] = 0.f;
        int cur = -1;
        for (int i0 = lo; i0 < hi; i0 += kUnroll) {
          // Load kUnroll slots' operands first (invalid slots read row 0,
          // always in range, and are skipped below), so their loads are in
          // flight together; then use them in slot order.
          int rws[kUnroll];
          size_t offs[kUnroll];
          float va[kUnroll][kVec], vb[kUnroll][kVec];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = i0 + u;
            rws[u] = i < hi ? s_row[i] : -1;
            offs[u] = (size_t)(i < hi ? s_e[i] : 0) * f_in;
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const int c = cb + 32 * j;
              va[u][j] = (HAS_B || HAS_W) && c < f_in ? to_f32(a[offs[u] + c]) : 0.f;
              vb[u][j] = HAS_B && c < f_in ? to_f32(b[offs[u] + c]) : 1.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (rws[u] < 0) continue;  // invalid slots are skipped, never multiplied
            const float* dh = gw_s + rws[u] * f_in;
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const int c = cb + 32 * j;
              if (c >= f_in) continue;
              store(d_a + offs[u] + c, dh[c] * vb[u][j]);
              if constexpr (HAS_B) store(d_b + offs[u] + c, dh[c] * va[u][j]);
            }
            if constexpr (HAS_W) {
              if (rws[u] != cur) {
                if (cur >= 0) flush(acc + cur * f_in, r, cb, f_in);
#pragma unroll
                for (int j = 0; j < kVec; ++j) r[j] = 0.f;
                cur = rws[u];
              }
#pragma unroll
              for (int j = 0; j < kVec; ++j) r[j] += va[u][j] * vb[u][j];
            }
          }
        }
        if constexpr (HAS_W) {
          if (cur >= 0) flush(acc + cur * f_in, r, cb, f_in);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (HAS_W) {
    // Fold the warp tiles into tile 0, always in warp order.
    if (groups > 1) {
      for (int i = tid; i < tile; i += kThreads) {
        float v = tiles[i];
        for (int q = 1; q < groups; ++q) v += tiles[(size_t)q * tile + i];
        tiles[i] = v;
      }
    }
    __syncthreads();
    // This window's d_W partial: part[k, c] = sum_r msg_sum[r, k] * g[r, c],
    // written whole (zeros for an empty window).
    float* part = dw_part + (size_t)win * f_in * f_out;
    for (int kp = 0; kp < f_in; kp += kTY * kRT) {
      for (int cp = 0; cp < f_out; cp += kTX * kCT) {
        float sum[kRT][kCT];
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int j = 0; j < kCT; ++j) sum[i][j] = 0.f;
        const int k0 = kp + ty * kRT;
        for (int r = 0; r < rows; ++r) {
          float av[kRT], gv[kCT];
#pragma unroll
          for (int i = 0; i < kRT; ++i) av[i] = (k0 + i < f_in) ? tiles[r * f_in + k0 + i] : 0.f;
#pragma unroll
          for (int j = 0; j < kCT; ++j) {
            const int c = cp + tx + j * kTX;
            gv[j] = c < f_out ? g_s[r * f_out + c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kRT; ++i)
#pragma unroll
            for (int j = 0; j < kCT; ++j) sum[i][j] = fmaf(av[i], gv[j], sum[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          if (k0 + i >= f_in) continue;
#pragma unroll
          for (int j = 0; j < kCT; ++j) {
            const int c = cp + tx + j * kTX;
            if (c < f_out) part[(size_t)(k0 + i) * f_out + c] = sum[i][j];
          }
        }
      }
    }
  }
}

// d_W[i] = sum over windows, in window order, of the f32 partials.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ part, TW* __restrict__ d_w, int n_windows,
                 int size) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int q = 0; q < n_windows; ++q) s += part[(size_t)q * size + i];
  store(d_w + i, s);
}

// The most warp tiles (up to kWarps) that fit the card's opt-in shared
// memory per block beside the other staging; 0 when even one does not.
// Without W there are no tiles and every warp walks slots.
int slot_groups(int bn, int f_in, int f_out, bool has_w) {
  static int max_smem = -1;  // read once: a CUDA graph capture makes no query
  if (max_smem < 0) {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return 0;
    max_smem = bytes;
  }
  int groups = kWarps;
  while (groups > 0 &&
         smem_floats(groups, bn, f_in, f_out, has_w) * sizeof(float) > (size_t)max_smem)
    --groups;
  return groups;
}

template <typename T, typename TW, typename TG, bool HAS_B, bool HAS_W>
cudaError_t launch(const void* g, const void* a, const void* b, const void* w,
                   const void* perm, const void* seg, const void* valid,
                   const void* window_id, void* d_a, void* d_b, void* d_w, void* dw_part,
                   int n_edges, int n_nodes, int f_in, int f_out, int be, int bn,
                   int n_blocks, cudaStream_t stream) {
  auto kernel = edge_pipeline_bwd_kernel<T, TW, TG, HAS_B, HAS_W>;
  const int groups = slot_groups(bn, f_in, f_out, HAS_W);
  if (groups == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_floats(groups, bn, f_in, f_out, HAS_W) * sizeof(float);
  // Opt in above 48 KB once per instantiation and size (raised only).
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const size_t row_bytes = (size_t)n_edges * f_in * sizeof(T);
  cudaError_t err = cudaMemsetAsync(d_a, 0, row_bytes, stream);
  if (err != cudaSuccess) return err;
  if (HAS_B) {
    err = cudaMemsetAsync(d_b, 0, row_bytes, stream);
    if (err != cudaSuccess) return err;
  }
  const int n_windows = (n_nodes + bn - 1) / bn;
  kernel<<<n_windows, kThreads, smem, stream>>>(
      static_cast<const TG*>(g), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const TW*>(w), static_cast<const int*>(perm),
      static_cast<const int*>(seg), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(window_id), static_cast<T*>(d_a), static_cast<T*>(d_b),
      static_cast<float*>(dw_part), n_edges, n_nodes, f_in, f_out, be, bn, n_blocks,
      groups);
  err = cudaGetLastError();
  if (err != cudaSuccess || !HAS_W) return err;
  const int size = f_in * f_out;
  dw_reduce_kernel<TW><<<(size + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(dw_part), static_cast<TW*>(d_w), n_windows, size);
  return cudaGetLastError();
}

// Flavours with W take TW and TG; without W, g has the operands' type T.
template <typename T, typename TW, typename TG>
cudaError_t launch_flavour(int has_b, int has_w, const void* g, const void* a,
                           const void* b, const void* w, const void* perm,
                           const void* seg, const void* valid, const void* window_id,
                           void* d_a, void* d_b, void* d_w, void* dw_part, int n_edges,
                           int n_nodes, int f_in, int f_out, int be, int bn,
                           int n_blocks, cudaStream_t stream) {
#define HG_LAUNCH(TW_, TG_, HB, HW)                                                \
  return launch<T, TW_, TG_, HB, HW>(g, a, b, w, perm, seg, valid, window_id, d_a, \
                                     d_b, d_w, dw_part, n_edges, n_nodes, f_in,    \
                                     f_out, be, bn, n_blocks, stream)
  if (has_b && has_w) HG_LAUNCH(TW, TG, true, true);
  if (has_w) HG_LAUNCH(TW, TG, false, true);
  if (has_b) HG_LAUNCH(T, T, true, false);
  HG_LAUNCH(T, T, false, false);
#undef HG_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32; 1 = bfloat16; 2 = bfloat16 a/b with a float32 W (and
// a float32 g and d_W), which needs W. The caller allocates d_a, d_b
// ([n_edges, f_in]), d_w ([f_in, f_out]) and the f32 scratch dw_part
// ([ceil(n_nodes / bn), f_in, f_out]); d_b/d_w/dw_part are unused (may be
// null) without b/W. Returns the first CUDA error of the memsets and
// launches (0 on success), or cudaErrorInvalidValue when the sizes do not
// fit shared memory.
int hg_edge_pipeline_bwd(const void* g, const void* a, const void* b, const void* w,
                         const void* perm, const void* seg, const void* valid,
                         const void* window_id, void* d_a, void* d_b, void* d_w,
                         void* dw_part, int n_edges, int n_nodes, int f_in, int f_out,
                         int be, int bn, int n_blocks, int dtype, int has_b, int has_w,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (dtype == 0)
    return (int)launch_flavour<float, float, float>(
        has_b, has_w, g, a, b, w, perm, seg, valid, window_id, d_a, d_b, d_w, dw_part,
        n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, s);
  if (dtype == 1)
    return (int)launch_flavour<bf16, bf16, bf16>(
        has_b, has_w, g, a, b, w, perm, seg, valid, window_id, d_a, d_b, d_w, dw_part,
        n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, s);
  if (dtype == 2 && has_w)
    return (int)launch_flavour<bf16, float, float>(
        has_b, has_w, g, a, b, w, perm, seg, valid, window_id, d_a, d_b, d_w, dw_part,
        n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
