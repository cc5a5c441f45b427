// Device code shared by K1 (edge_pipeline.cu) and K2 (edge_pipeline_bwd.cu):
// the block-wide window search, asynchronous staging of the plan's
// contiguous edge tiles, and the per-chunk slot walk.
//
// The plan contract these kernels read (ops/edge_pipeline.py::
// plan_sorted_blocks, pinned by tests/test_torch_ops.py): block k of a
// plan covers one be-aligned tile t of the receiver-sorted edge array,
// perm[k*be + i] = min(t*be + i, E-1), so t = perm[k*be] / be and the
// block's rows are one contiguous [be, F] slab of a and of b, which
// streams as 16-byte cp.async copies where gathered rows would each be a
// dependent load (and a TMA box cannot gather). Every valid slot is checked
// against the contract (perm[s] == t*be + i, the row < E, the receiver
// inside the window) and a slot that breaks it contributes nothing.
//
// Columns are split into slabs of kSlab = 32, and one CTA owns one
// (node window, slab). A chunk is kSub = 64 slots of one block (a block
// of be = 512, the TPU's tile, is staged as 8 chunks). Chunks go through
// a three-stage ring in shared memory: while the CTA works on chunk q,
// the 16-byte cp.async copies of chunks q+1 and q+2's [64, 32] slabs are
// in flight, and chunk q+1's plan entries are loaded into registers.
//
// The window products (32 x 32 x F per CTA: g @ W^T, msg^T @ g, msg @ W)
// run on CUDA cores in f32, each thread a register block of up to 4 x 4
// outputs fed by 16-byte shared loads: at these sizes tensor cores with
// the 3xTF32 split that f32 accuracy needs measured slower on the card
// (PERF.md), and FMAs are exact f32 besides.
//
// A node window's message sum is summed on CUDA cores in f32
// (chunk_slots): the slots are receiver-sorted, so each node's run is
// summed in registers by the one warp that owns it and added once. No
// float atomics anywhere: the same inputs give the same bits. Invalid
// slots are skipped, never multiplied by 0, so a NaN in a padding row
// stays out.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hg {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 64;     // plan slots per staged chunk
constexpr int kSlab = 32;    // columns per slab (one CTA's share of F_in)
constexpr int kRingLd = 40;  // ring row stride in elements: 32 + 8 (16-byte aligned rows)
constexpr int kMsgLd = 40;   // [bn, 32] f32 message-sum tile stride
constexpr int kStages = 3;    // ring stages: two chunks in flight while one is worked on
constexpr int kActCap = 256;  // chunks a window's walk lists at once
// Shared ints of the walk: the active-chunk list and each listed chunk's
// tile [2][kActCap], per-warp counts [kWarps], and the current chunk's
// slot codes [kSub].
constexpr size_t kWalkBytes = (2 * kActCap + kWarps + kSub) * sizeof(int);

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [row0, row0 + nrows) x columns [c0, c0 + ncols) of the
// row-major [row_lim, f] array src into dst (row stride ld elements);
// entries at rows >= row_lim or columns >= f are zeros. With vec (f and
// src 16-byte aligned, c0 and ncols multiples of 16 / sizeof(T)) every
// thread issues 16-byte cp.async copies, zero-filled where out of range
// (src_bytes 0), that complete at the caller's cp_async_wait; otherwise
// plain loads and stores, which are done when the caller syncs.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* __restrict__ src,
                                           int row0, int nrows, int row_lim, int c0,
                                           int ncols, int f, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = ncols / kPer;
    for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * kPer;
      const bool in = row0 + r < row_lim && c0 + c < f;
      const T* s = in ? src + (size_t)(row0 + r) * f + c0 + c : src;
      cp_async16(dst + r * ld + c, s, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += kThreads) {
      const int r = i / ncols, c = i % ncols;
      const bool in = row0 + r < row_lim && c0 + c < f;
      dst[r * ld + c] = in ? src[(size_t)(row0 + r) * f + c0 + c] : zero_of<T>();
    }
  }
}

// ---------------------------------------------------------- window search

// [lo, hi): the blocks of window `key` in the non-decreasing ids[0, n).
// Block-wide lower bounds for key and key + 1 together: each round
// samples kThreads evenly spaced entries and counts those below the key
// (__syncthreads_count), so a plan of up to 256 blocks costs one round
// of loads and one of up to 65,536 two, where one thread's binary
// search would wait on ~log2(n) dependent loads. Every thread calls it.
__device__ __forceinline__ void window_range(const int* __restrict__ ids, int n, int key,
                                             int& lo, int& hi) {
  int base[2] = {0, 0}, len[2] = {n, n};
  while (len[0] > 0 || len[1] > 0) {
    int step[2];
    bool lt[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      step[q] = max(1, (len[q] + kThreads - 1) / kThreads);
      const int p = base[q] + ((int)threadIdx.x + 1) * step[q] - 1;
      lt[q] = len[q] > 0 && p < base[q] + len[q] && ids[p] < key + q;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int cnt = __syncthreads_count(lt[q]);
      if (len[q] > 0) {
        const int nb = base[q] + cnt * step[q];
        const int up = min(base[q] + (cnt + 1) * step[q] - 1, base[q] + len[q]);
        base[q] = nb;
        len[q] = up - nb;
      }
    }
  }
  lo = base[0];
  hi = base[1];
}

// ------------------------------------------------------------ the walk

// Bytes of one ring stage: the operands' [kSub, kSlab] slabs, row stride
// kRingLd.
__host__ __device__ __forceinline__ size_t ring_stage_bytes(int ops, int sz_t) {
  return align16((size_t)ops * kSub * kRingLd * sz_t);
}

// One CTA's walk over its window's plan chunks for one column slab
// [c0, c0 + 32): stages the a (and b) slabs of each chunk's contiguous
// tile through the ring and hands each chunk to `compute` as
// (stage, first edge row, codes), codes[s] being slot s's node row in the
// window or -1 for a slot that contributes nothing. N_OPS is the
// number of operands staged: 0 (none), 1 (a) or 2 (a and b).
// Only chunks that hold a valid slot are walked. The planner gives the
// last window every block of padding edges and every static padding
// block, all invalid (at a BCC train bin of 2,120 edges, 656 valid,
// some 35 chunks), so a walk over every chunk would leave one CTA on
// the critical path for tens of microseconds. list() reads the valid
// bytes of up to kActCap candidate chunks at once (16 bytes a load),
// with each one's tile index beside them, and compacts the active ones,
// in order, into a shared list.
// Usage: start(pre) lists the first candidates and issues the first
// `pre` active chunks (one cp.async group each); finish(compute) walks
// them all.
template <typename T, int N_OPS>
struct Walk {
  const int* __restrict__ perm;
  const int* __restrict__ seg;
  const uint8_t* __restrict__ valid;
  const T* __restrict__ a;
  const T* __restrict__ b;
  T* ring;    // [kStages][N_OPS][kSub][kRingLd]
  int* ints;  // kWalkBytes: the list, its tiles, warp counts, codes
  int lo, n_cand, nsub, be, node_base, rows, n_edges, f_in, c0;
  bool vec;
  // The current list (candidates [first, first + kActCap), nq active,
  // `issued` of them staged), and the plan entries of the next chunk's
  // slot threadIdx.x (threads < kSub), loaded a chunk ahead.
  int first = 0, nq = 0, issued = 0, pv = 0, ps = 0, pp = 0;

  // Candidate chunk c of the window: block lo + c / nsub, sub-tile c % nsub.
  __device__ __forceinline__ int cand(int q) const { return ints[q]; }
  __device__ __forceinline__ int tile_of(int q) const { return ints[kActCap + q]; }
  __device__ __forceinline__ int sub_of(int q) const { return cand(q) % nsub; }
  __device__ __forceinline__ int row_of(int q) const {
    return tile_of(q) * be + sub_of(q) * kSub;
  }
  __device__ __forceinline__ int* codes() const { return ints + 2 * kActCap + kWarps; }
  // List the active chunks among candidates [first, first + kActCap).
  __device__ __forceinline__ void list() {
    int* act = ints;
    int* act_tile = act + kActCap;
    int* wcnt = act_tile + kActCap;
    const int count = min(kActCap, n_cand - first);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    int total = 0;
    for (int base = 0; base < count; base += kThreads) {
      const int c = first + base + (int)threadIdx.x;
      bool any = false;
      int tile = 0;
      if (base + (int)threadIdx.x < count) {
        tile = perm[(size_t)(lo + c / nsub) * be] / be;
        const int j = c % nsub;
        const int cnt = min(kSub, be - j * kSub);
        const uint8_t* v = valid + (size_t)(lo + c / nsub) * be + (size_t)j * kSub;
        if (cnt == kSub && (reinterpret_cast<uintptr_t>(v) & 15) == 0) {
          const uint4* v4 = reinterpret_cast<const uint4*>(v);
          uint4 x = v4[0], y = v4[1], z = v4[2], w = v4[3];
          any = (x.x | x.y | x.z | x.w | y.x | y.y | y.z | y.w | z.x | z.y | z.z | z.w |
                 w.x | w.y | w.z | w.w) != 0;
        } else {
          for (int i = 0; i < cnt; ++i) any |= v[i] != 0;
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, any);
      if (lane == 0) wcnt[warp] = __popc(m);
      __syncthreads();
      int off = total, all = 0;
      for (int q = 0; q < kWarps; ++q) {
        if (q < warp) off += wcnt[q];
        all += wcnt[q];
      }
      if (any) {
        act[off + __popc(m & ((1u << lane) - 1))] = c;
        act_tile[off + __popc(m & ((1u << lane) - 1))] = tile;
      }
      total += all;
      __syncthreads();
    }
    nq = total;
  }
  __device__ __forceinline__ T* ring_at(int st, int op) const {
    return ring + (size_t)(st * N_OPS + op) * kSub * kRingLd;
  }
  // One operand's [kSub, kSlab] slab of edge rows r0.. into dst: the
  // shapes are compile-time, so each 16-byte copy costs a few
  // instructions (stage_tile's general form takes tens).
  __device__ __forceinline__ void stage_slab(T* dst, const T* __restrict__ src, int r0) {
    constexpr int kPer = 16 / sizeof(T), kRow = kSlab / kPer;
    if (!vec) {
      stage_tile<T>(dst, kRingLd, src, r0, kSub, n_edges, c0, kSlab, f_in, false);
      return;
    }
#pragma unroll
    for (int i = threadIdx.x; i < kSub * kRow; i += kThreads) {
      const int r = i / kRow, c = (i % kRow) * kPer;
      const bool in = r0 + r < n_edges && c0 + c < f_in;
      cp_async16(dst + r * kRingLd + c, in ? src + (size_t)(r0 + r) * f_in + c0 + c : src,
                 in ? 16 : 0);
    }
  }
  // Stage the next listed chunk into its ring stage: one cp.async group.
  __device__ __forceinline__ void issue() {
    const int k = issued++;
    const int st = k % kStages, r0 = row_of(k);
    if constexpr (N_OPS >= 1) stage_slab(ring_at(st, 0), a, r0);
    if constexpr (N_OPS >= 2) stage_slab(ring_at(st, 1), b, r0);
    cp_async_commit();
  }
  __device__ __forceinline__ void load_plan(int q) {
    const int c = cand(q), j = c % nsub;
    const int cnt = min(kSub, be - j * kSub);
    pv = 0;
    if ((int)threadIdx.x < cnt) {
      const size_t s = (size_t)(lo + c / nsub) * be + (size_t)j * kSub + threadIdx.x;
      pv = valid[s];
      ps = seg[s];
      pp = perm[s];
    }
  }
  // Issue the current list's first `pre` chunks (ring stages 0 .. pre-1;
  // the later stages stay free for the caller until run()).
  __device__ __forceinline__ void begin(int pre) {
    issued = 0;
    while (issued < min(pre, nq)) issue();
    if (nq > 0) load_plan(0);
  }
  __device__ __forceinline__ void start(int pre = kStages - 1) {
    first = 0;
    list();
    begin(pre);
  }
  template <typename F>
  __device__ __forceinline__ void finish(F&& compute) {
    while (true) {
      run(compute);
      first += kActCap;
      if (first >= n_cand) break;
      list();
      begin(kStages - 1);
    }
  }
  // Chunk q is worked on while chunks q+1 .. q+kStages-1 are in flight.
  // compute(stage, first edge row, codes) gets the chunk's slot codes.
  template <typename F>
  __device__ __forceinline__ void run(F&& compute) {
    const int tid = threadIdx.x;
    int* cd = codes();
    for (int q = 0; q < nq; ++q) {
      const int row0 = row_of(q);
      if (tid < kSub) {
        const int e = row0 + tid;
        const int n = ps - node_base;
        cd[tid] = (pv && n >= 0 && n < rows && pp == e && e < n_edges) ? n : -1;
      }
      // Stage (q + kStages - 1) % kStages was freed by the last iteration's
      // closing barrier.
      while (issued < min(nq, q + kStages)) issue();
      if (q + 1 < nq) load_plan(q + 1);
      // Wait for chunk q: the groups committed after it may stay in flight.
      const int newer = issued - 1 - q;
      static_assert(kStages == 3, "the wait below covers up to two newer groups");
      if (newer >= 2) cp_async_wait<2>();
      else if (newer == 1) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();
      compute(q % kStages, row0, static_cast<const int*>(cd));
      __syncthreads();
    }
  }
};

// ------------------------------------------------------------ products

// Four consecutive values of a shared-memory row as f32 (16-byte
// aligned for f32, 8 for bf16): one vector load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// One chunk's valid slots, lane c taking column c of the slab. Warp w
// owns the nodes whose first valid slot of the chunk lies in
// [8w, 8w + 8) (the slots are receiver-sorted, so those are the nodes in
// (prev, hi]: prev the node of the last valid slot before 8w, hi the
// largest in the share) and follows their runs past 8w + 8 as far as
// they go. So each node's slots are summed by one warp, in slot order,
// and added once: no fold, no float atomic, the same bits every run.
// The shared loads of 8 slots are issued together: a (and b; 1 without
// b) at the lane's column, and x = pre(s, n), a value of the slot's node
// row that the caller reads (n clamped to 0 for an invalid slot, whose x
// goes unused). For each owned slot s of node n, apply(s, n, va, vb, x)
// runs; invalid slots are skipped, never multiplied by 0. With SUM,
// msg[n, c] (f32, stride kMsgLd) += the messages va * vb.
static_assert(kSub == 64 && kSub / kWarps == 8,
              "chunk_slots reads a chunk's 64 codes with two ballots, 8 slots a warp");
template <typename T, int N_OPS, bool SUM, typename P, typename F>
__device__ __forceinline__ void chunk_slots(float* msg, const int* codes,
                                            const T* __restrict__ ra,
                                            const T* __restrict__ rb, P&& pre, F&& apply) {
  constexpr int kPer = kSub / kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int beg = warp * kPer;
  // One ballot over the chunk's 64 codes: the last valid slot before this
  // share (its node is prev), the largest node in the share (hi) and the
  // chunk's last valid slot (where this warp's runs must end).
  const int c_lo = codes[lane], c_hi = codes[32 + lane];
  const unsigned v_lo = __ballot_sync(0xffffffffu, c_lo >= 0);
  const unsigned v_hi = __ballot_sync(0xffffffffu, c_hi >= 0);
  const unsigned long long valid = (unsigned long long)v_hi << 32 | v_lo;
  const unsigned long long before = valid & ((1ull << beg) - 1);
  const int prev = before ? codes[63 - __clzll(before)] : -1;
  const unsigned long long share = valid & (0xffull << beg);
  const int hi = share ? codes[63 - __clzll(share)] : -1;
  if (hi <= prev) return;  // no node starts in this share
  const int end = 64 - __clzll(valid);  // one past the chunk's last valid slot
  float run = 0.f;
  int cur = -1;
  for (int t0 = beg; t0 < end; t0 += kPer) {
    int c[kPer];
    float va[kPer], vb[kPer], x[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      c[u] = codes[t0 + u];
      va[u] = N_OPS >= 1 ? to_f32(ra[(t0 + u) * kRingLd + lane]) : 0.f;
      vb[u] = N_OPS >= 2 ? to_f32(rb[(t0 + u) * kRingLd + lane]) : 1.f;
      x[u] = pre(t0 + u, max(c[u], 0));
    }
    bool past = false;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      past |= c[u] > hi;
      if (c[u] <= prev || c[u] > hi) continue;  // invalid (-1), or another warp's node
      apply(t0 + u, c[u], va[u], vb[u], x[u]);
      if constexpr (SUM) {
        if (c[u] != cur) {
          if (cur >= 0) msg[cur * kMsgLd + lane] += run;
          cur = c[u];
          run = 0.f;
        }
        run += va[u] * vb[u];
      }
    }
    if (past) break;  // sorted: no later slot is this warp's
  }
  if constexpr (SUM) {
    if (cur >= 0) msg[cur * kMsgLd + lane] += run;
  }
}

}  // namespace hg
