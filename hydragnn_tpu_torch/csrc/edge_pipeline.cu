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
// Design. One CTA owns one node window of bn rows and walks that
// window's plan blocks (found by binary search in window_id). The TPU
// kernel carried a window's partial sums across consecutive grid steps
// in its output tile; Hopper runs blocks in no order, so here nothing
// crosses CTAs and every output row is written exactly once, zeros
// included. The CTA stages kChunk slots at a time in shared memory as
// (row, edge) pairs, invalid slots marked -1, so the walk never waits on
// a chain of dependent index loads. Each warp then takes a contiguous
// share of the staged slots: a lane owns a column set, keeps the running
// sum of the current row in registers and adds it into the warp's own
// f32 [bn, F_in] tile in shared memory when the row changes. The warp
// tiles are folded in a fixed order and multiplied once by W
// (sum(msg) @ W == sum(msg @ W)) with a register-tiled f32 product whose
// W rows are staged kKC at a time in shared memory. There are no float
// atomics, so the same inputs give the same bits on every run.
//
// What bounds it on this card. Per plan slot the kernel reads 9 bytes of
// plan and, for a valid slot, F_in elements of a and of b; W is read once
// per CTA (from L2 after the first). At the serving shapes (a qm9 bin of
// ~600 nodes and ~1200 edges, F = 128) that is under 2 MB against
// ~2*N*F*F flops in the product, far below both the 3.35 TB/s memory rate
// and the 67 TFLOP/s f32 rate: the kernel is bound by latency (the
// launch, the slot walk, ~20 CTAs on 132 SMs), not by bytes or
// operations. The design answers that with small windows (bn = 32 gives
// ~20 CTAs per bin instead of 3 at the TPU's bn = 256), eight warps that
// walk a window's slots in parallel, each with kUnroll slots' loads in
// flight at once, W staged in a few large chunks, and one pass over the
// inputs with no [E, F] message in device memory. wgmma, TMA
// staging and a persistent grid are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // plan slots staged per pass
constexpr int kVec = 4;      // columns a lane carries per pass (stride 32)
constexpr int kUnroll = 8;   // slots whose operands are loaded before any is added
// Product tiling: a 16 x 16 thread grid, each thread kRT rows x kCT cols,
// over W rows staged kKC at a time.
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

// Shared memory, in floats: the warp tiles, then the W chunk, then the
// staged (row, edge) slot pairs.
__host__ __device__ __forceinline__ size_t smem_floats(int groups, int bn, int f_in) {
  return (size_t)groups * bn * f_in + (size_t)kKC * kTX * kCT + 2 * kChunk;
}

__device__ __forceinline__ void flush(float* acc_row, const float* r, int cb, int f_in) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = cb + 32 * j;
    if (c < f_in) acc_row[c] += r[j];
  }
}

// T: a and b; TW: W; TO: the output, promote(T, TW).
template <typename T, typename TW, typename TO, bool HAS_B, bool HAS_W>
__global__ void __launch_bounds__(kThreads)
edge_pipeline_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const TW* __restrict__ w, const int* __restrict__ perm,
                     const int* __restrict__ seg, const uint8_t* __restrict__ valid,
                     const int* __restrict__ window_id, TO* __restrict__ out,
                     int n_edges, int n_nodes, int f_in, int f_out, int be, int bn,
                     int n_blocks, int groups) {
  extern __shared__ float smem[];
  const int tile = bn * f_in;
  float* tiles = smem;                                    // [groups][bn][f_in]
  float* wchunk = smem + (size_t)groups * tile;           // [kKC][kTX * kCT]
  int* s_row = reinterpret_cast<int*>(wchunk + kKC * kTX * kCT);  // [kChunk]
  int* s_e = s_row + kChunk;                              // [kChunk]
  __shared__ int s_range[2];

  const int win = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  if (tid == 0) {
    s_range[0] = lower_bound(window_id, n_blocks, win);
    s_range[1] = lower_bound(window_id, n_blocks, win + 1);
  }
  for (int i = tid; i < groups * tile; i += kThreads) tiles[i] = 0.f;
  __syncthreads();

  const int node_base = win * bn;
  const int slot_end = s_range[1] * be;

  // Phase 1: reduce the window's valid slots into the warp tiles.
  for (int base = s_range[0] * be; base < slot_end; base += kChunk) {
    const int cnt = min(kChunk, slot_end - base);
    for (int i = tid; i < cnt; i += kThreads) {
      const int s = base + i;
      int row = -1, e = 0;
      if (valid[s]) {
        row = seg[s] - node_base;
        e = perm[s];
        // Outside the plan contract: contributes nothing (the TPU
        // kernel's one-hot compare drops such slots too) and never
        // reads or writes out of range.
        if (row < 0 || row >= bn || e < 0 || e >= n_edges) {
          row = -1;
          e = 0;
        }
      }
      s_row[i] = row;
      s_e[i] = e;
    }
    __syncthreads();
    if (warp < groups) {
      float* acc = tiles + (size_t)warp * tile;
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
          // always in range, and are skipped below), so their loads are
          // in flight together; then add them in slot order.
          int rows[kUnroll];
          float v[kUnroll][kVec];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = i0 + u;
            rows[u] = i < hi ? s_row[i] : -1;
            const size_t off = (size_t)(i < hi ? s_e[i] : 0) * f_in;
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const int c = cb + 32 * j;
              float x = 0.f;
              if (c < f_in) {
                x = to_f32(a[off + c]);
                if constexpr (HAS_B) x *= to_f32(b[off + c]);
              }
              v[u][j] = x;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (rows[u] < 0) continue;  // select, never multiply, invalid slots away
            if (rows[u] != cur) {
              if (cur >= 0) flush(acc + cur * f_in, r, cb, f_in);
#pragma unroll
              for (int j = 0; j < kVec; ++j) r[j] = 0.f;
              cur = rows[u];
            }
#pragma unroll
            for (int j = 0; j < kVec; ++j) r[j] += v[u][j];
          }
        }
        if (cur >= 0) flush(acc + cur * f_in, r, cb, f_in);
      }
    }
    __syncthreads();
  }

  // Fold the warp tiles into tile 0, always in warp order.
  if (groups > 1) {
    for (int i = tid; i < tile; i += kThreads) {
      float v = tiles[i];
      for (int g = 1; g < groups; ++g) v += tiles[(size_t)g * tile + i];
      tiles[i] = v;
    }
    __syncthreads();
  }

  const int rows = min(bn, n_nodes - node_base);
  TO* out_w = out + (size_t)node_base * f_out;
  if constexpr (!HAS_W) {
    for (int i = tid; i < rows * f_in; i += kThreads) store(out_w + i, tiles[i]);
    return;
  }

  // Phase 2: out[r, c] = sum_k tile[r, k] * W[k, c], f32 FMAs. Loops are
  // uniform across the CTA (every thread reaches every barrier).
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  for (int rp = 0; rp < rows; rp += kTY * kRT) {
    for (int cp = 0; cp < f_out; cp += kTX * kCT) {
      float sum[kRT][kCT];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) sum[i][j] = 0.f;
      const int r0 = rp + ty * kRT;
      for (int k0 = 0; k0 < f_in; k0 += kKC) {
        __syncthreads();  // the previous chunk is consumed
        for (int i = tid; i < kKC * kTX * kCT; i += kThreads) {
          const int kk = i / (kTX * kCT), c = cp + i % (kTX * kCT);
          wchunk[i] = (k0 + kk < f_in && c < f_out)
                          ? to_f32(w[(size_t)(k0 + kk) * f_out + c]) : 0.f;
        }
        __syncthreads();
        const int kn = min(kKC, f_in - k0);
        for (int kk = 0; kk < kn; ++kk) {
          float av[kRT], wv[kCT];
#pragma unroll
          for (int i = 0; i < kRT; ++i)
            av[i] = (r0 + i < bn) ? tiles[(r0 + i) * f_in + k0 + kk] : 0.f;
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
        if (r0 + i >= rows) continue;
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          const int c = cp + tx + j * kTX;
          if (c < f_out) store(out_w + (size_t)(r0 + i) * f_out + c, sum[i][j]);
        }
      }
    }
  }
}

// The most warps (up to kWarps) whose [bn, f_in] tiles, with the W chunk
// and the staged slots, fit the card's opt-in shared memory per block;
// 0 when even one does not.
int slot_groups(int bn, int f_in) {
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
  while (groups > 0 && smem_floats(groups, bn, f_in) * sizeof(float) > (size_t)max_smem)
    --groups;
  return groups;
}

template <typename T, typename TW, typename TO, bool HAS_B, bool HAS_W>
cudaError_t launch(const void* a, const void* b, const void* w, const void* perm,
                   const void* seg, const void* valid, const void* window_id, void* out,
                   int n_edges, int n_nodes, int f_in, int f_out, int be, int bn,
                   int n_blocks, cudaStream_t stream) {
  auto kernel = edge_pipeline_kernel<T, TW, TO, HAS_B, HAS_W>;
  const int groups = slot_groups(bn, f_in);
  if (groups == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_floats(groups, bn, f_in) * sizeof(float);
  // Opt in above 48 KB once per instantiation and size (raised only), so
  // a steady stream of launches, or a CUDA graph capture, makes no
  // attribute calls.
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const int n_windows = (n_nodes + bn - 1) / bn;
  kernel<<<n_windows, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const TW*>(w),
      static_cast<const int*>(perm), static_cast<const int*>(seg),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(window_id),
      static_cast<TO*>(out), n_edges, n_nodes, f_in, f_out, be, bn, n_blocks, groups);
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
// (and a float32 output), which needs W. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue when the sizes do
// not fit shared memory. The caller allocates `out` ([n_nodes, f_out]).
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

const char* hg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
