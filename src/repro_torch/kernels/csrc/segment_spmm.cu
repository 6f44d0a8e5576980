// Batched weighted segment SpMM, forward (and, with src and dst swapped,
// the backward's dh):
//
//     out[n, v, c] = sum_{e : dst[n, e] = v} w[n, e] * h[n, src[n, e], c]
//
// h (N, m, d) f32 or bf16, src/dst (N, e) int32, w (N, e) f32, out like h.
// The sum is taken in f32 and cast to h's type once, at the store.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py::_spmm_batched_kernel
// (and its transpose in _spmm_bwd).  That kernel builds (e_blk x m) one-hot
// gather and scatter matrices and runs two MXU matmuls per segment -- O(e*m*d)
// work that only pays on a systolic array.  Here the work is O(e*d), each
// output element is owned by one thread, and no float atomics are used, so
// two launches on the same inputs are bitwise equal.  Edges whose src or dst
// lies outside [0, m) are skipped.
//
// What bounds it: bytes, (2*N*m*d*itemsize + 3*N*e*4), and latency at the
// main path's sizes.  Measured on an H100 (PERF.md, section 6), the earlier
// design (a block per (segment, 32 columns), warp 0 sorting the edges alone,
// 32 at a time, then one edge in flight a warp, three dependent loads an
// edge) spent 74-87% of a block in the warp that owns node 0: every padding
// edge is (0, 0) with w = 0, so that warp summed the whole padding pile one
// edge after another.  This design:
//
//   * A block per (segment n, tile of destination rows, column tile).  The
//     wrapper (kernels/segment_spmm.py::plan) picks the tile so the grid
//     fills the card about once: at the serving bucket (8, 64, 512, 64) 4
//     tiles of 16 rows (32 blocks, one row per thread group), at the stress
//     shape (64, 1024, 8192, 128) 6 tiles of 171 rows.  A column tile is
//     all of d up to 32 vectors: 16-byte h loads at d 64 and 128, so the
//     sort is done once per row tile.
//   * A stable counting sort that all 8 warps share: each warp takes a
//     contiguous chunk of the edge list, counts its edges per destination
//     row (ranks among equal destinations by __match_any_sync, 32 edges at a
//     time, four such groups' loads in flight), one block-wide scan turns
//     the (chunk, row) counts into offsets, and each warp places its chunk
//     again in edge order.  Within a row the order stays edge order, so the
//     sum's order is fixed.  Serial depth e / (32 * 8), not e / 32.
//   * The padding pile goes: an edge with w == 0 whose (src, dst) and w == 0
//     repeat those of the edge just before it in edge order is dropped.  Its
//     term, +-0 * h[src, c], is +-0 where h is finite and NaN where it is not
//     -- the same as the kept copy's, which is still in the sum (so 0 * inf
//     still gives the reference's NaN).  A sum started from +0 by fmaf never
//     becomes -0, so adding a +-0 term again changes nothing.  The trailing
//     run of (0, 0) padding edges is one term.
//   * The sorted (src, w) are staged in shared memory as 8-byte records, so
//     the sum loads only the h rows from global memory, 8 edges' loads in
//     flight before their FMAs; the FMAs run in edge order, one fmaf chain
//     from +0 per output element, as before (the result equals the earlier
//     design's up to the sign of a zero).
//   * A thread group of TPR threads (a power of two <= 32) owns a row, V
//     elements a thread (one 16-, 8-, 4- or 2-byte load).  A row with many
//     in-edges (a hub) is summed by its one group: the measured shapes have
//     random destinations (in-degree ~6-8 of real edges, the padding now one
//     edge), where splitting a row would only add a join.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileRows = kThreads;  // the scan gives one row to a thread
constexpr int kGroups = 4;              // 32-edge groups a warp loads at once
constexpr int kUnroll = 8;              // h loads in flight a thread group
constexpr unsigned kFull = 0xffffffffu;

template <int kBytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ uint32_t word(const uint2& r, int i) { return i == 0 ? r.x : r.y; }
__device__ __forceinline__ uint32_t word(unsigned r, int) { return r; }
__device__ __forceinline__ uint32_t word(unsigned short r, int) { return r; }

__device__ __forceinline__ void put(uint4* p, const uint32_t* w) {
  *p = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void put(uint2* p, const uint32_t* w) { *p = make_uint2(w[0], w[1]); }
__device__ __forceinline__ void put(unsigned* p, const uint32_t* w) { *p = w[0]; }
__device__ __forceinline__ void put(unsigned short* p, const uint32_t* w) {
  *p = static_cast<unsigned short>(w[0]);
}

// V elements of T as one load: element j as f32, and V f32 stored as T.
template <typename T, int V>
struct Vec {
  using R = typename Raw<V * sizeof(T)>::type;
  static constexpr int kWords = (V * sizeof(T) + 3) / 4;

  static __device__ __forceinline__ R load(const T* p) {
    return __ldg(reinterpret_cast<const R*>(p));
  }
  static __device__ __forceinline__ float get(const R& r, int j) {
    if constexpr (sizeof(T) == 4) return __uint_as_float(word(r, j));
    const uint32_t x = word(r, j >> 1);   // bf16: element 2i low, 2i + 1 high
    return __uint_as_float((j & 1) ? (x & 0xFFFF0000u) : (x << 16));
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    uint32_t w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(f[2 * i]));
        const uint32_t hi = 2 * i + 1 < V
            ? __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])) : 0u;
        w[i] = lo | (hi << 16);
      }
    }
    put(reinterpret_cast<R*>(p), w);
  }
};

// One edge of a warp's chunk: its (src, w) and its key, the destination row
// within the tile, or -1 where it is past the chunk, out of range, outside
// the tile, or a weight-0 repeat of the edge before it.
struct Edge {
  int s, t, ps, pt;
  float w, pw;
};

__device__ __forceinline__ Edge load_edge(const int* __restrict__ src,
                                          const int* __restrict__ dst,
                                          const float* __restrict__ w, int i,
                                          int i_end) {
  Edge x{-1, -1, -1, -1, 0.f, 1.f};   // no edge before: pw = 1, never a repeat
  if (i < i_end) {
    x.s = __ldg(src + i);
    x.t = __ldg(dst + i);
    x.w = __ldg(w + i);
    if (i > 0) {
      x.ps = __ldg(src + i - 1);
      x.pt = __ldg(dst + i - 1);
      x.pw = __ldg(w + i - 1);
    }
  }
  return x;
}

__device__ __forceinline__ int edge_key(const Edge& x, int m, int r0, int rows) {
  const bool in_range = static_cast<unsigned>(x.s) < static_cast<unsigned>(m) &&
                        static_cast<unsigned>(x.t) < static_cast<unsigned>(m);
  const bool repeat = x.w == 0.f && x.pw == 0.f && x.s == x.ps && x.t == x.pt;
  const int r = x.t - r0;
  return in_range && !repeat && static_cast<unsigned>(r) < static_cast<unsigned>(rows)
             ? r : -1;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
segment_spmm_kernel(const T* __restrict__ h, const int* __restrict__ src,
                    const int* __restrict__ dst, const float* __restrict__ w,
                    T* __restrict__ out, int m, int e, int d, int tile_rows,
                    int tpr_log2) {
  extern __shared__ int2 rec[];                        // e: (src, w) by (row, edge)
  int* cnt = reinterpret_cast<int*>(rec + e);          // kWarps x tile_rows
  int* start = cnt + kWarps * tile_rows;               // tile_rows + 1
  __shared__ int warp_total[kWarps];

  const int n = blockIdx.x;
  const int r0 = blockIdx.y * tile_rows;
  const int rows = min(tile_rows, m - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* src_n = src + static_cast<size_t>(n) * e;
  const int* dst_n = dst + static_cast<size_t>(n) * e;
  const float* w_n = w + static_cast<size_t>(n) * e;

  for (int i = threadIdx.x; i < kWarps * tile_rows; i += kThreads) cnt[i] = 0;
  __syncthreads();

  // this warp's chunk of the edge list, and its counts (then cursors)
  const int chunk = (e + kWarps - 1) / kWarps;
  const int i0 = min(e, warp * chunk);
  const int i1 = min(e, i0 + chunk);
  int* mine = cnt + warp * tile_rows;

  // pass 1: counts per (chunk, row)
  for (int base = i0; base < i1; base += 32 * kGroups) {
    Edge x[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      x[g] = load_edge(src_n, dst_n, w_n, base + 32 * g + lane, i1);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int key = edge_key(x[g], m, r0, rows);
      const unsigned peers = __match_any_sync(kFull, key);
      if (key >= 0 && lane == __ffs(peers) - 1) mine[key] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // per row: exclusive over the chunks, then one block-wide exclusive scan
  // of the rows' totals gives each (chunk, row) its first slot
  const int r = threadIdx.x;
  int total = 0;
  if (r < rows) {
    for (int c = 0; c < kWarps; ++c) {
      const int x = cnt[c * tile_rows + r];
      cnt[c * tile_rows + r] = total;
      total += x;
    }
  }
  int incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int excl = incl - total;
  for (int c = 0; c < warp; ++c) excl += warp_total[c];
  if (r < rows) {
    start[r] = excl;
    for (int c = 0; c < kWarps; ++c) cnt[c * tile_rows + r] += excl;
    if (r == rows - 1) start[rows] = excl + total;
  }
  __syncthreads();

  // pass 2: place each kept edge's (src, w) at its slot, stable in edge order
  for (int base = i0; base < i1; base += 32 * kGroups) {
    Edge x[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      x[g] = load_edge(src_n, dst_n, w_n, base + 32 * g + lane, i1);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int key = edge_key(x[g], m, r0, rows);
      const unsigned peers = __match_any_sync(kFull, key);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (key >= 0) rec[mine[key] + rank] = make_int2(x[g].s, __float_as_int(x[g].w));
      __syncwarp();
      if (key >= 0 && rank == 0) mine[key] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // the sum: a group of TPR threads a row, V columns a thread
  using Ld = Vec<T, V>;
  const int tpr = 1 << tpr_log2;
  const int group = (warp << (5 - tpr_log2)) + (lane >> tpr_log2);
  const int n_groups = kWarps << (5 - tpr_log2);
  const int col = (blockIdx.z * tpr + (lane & (tpr - 1))) * V;
  if (col >= d) return;
  const T* h_n = h + static_cast<size_t>(n) * m * d + col;
  T* out_n = out + (static_cast<size_t>(n) * m + r0) * d + col;
  for (int row = group; row < rows; row += n_groups) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    const int k1 = start[row + 1];
    for (int k = start[row]; k < k1; k += kUnroll) {
      typename Ld::R hv[kUnroll];
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        hv[u] = typename Ld::R{};
        wv[u] = 0.f;
        if (k + u < k1) {
          const int2 ed = rec[k + u];
          wv[u] = __int_as_float(ed.y);
          hv[u] = Ld::load(h_n + static_cast<size_t>(ed.x) * d);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u < k1) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(wv[u], Ld::get(hv[u], j), acc[j]);
        }
      }
    }
    Ld::store(out_n + static_cast<size_t>(row) * d, acc);
  }
}

// kernels/segment_spmm.py::smem_bytes mirrors this layout for its checks
size_t smem_bytes(int e, int tile_rows) {
  return static_cast<size_t>(e) * sizeof(int2) +
         static_cast<size_t>(kWarps * tile_rows + tile_rows + 1) * sizeof(int);
}

template <typename T, int V>
cudaError_t launch(const void* h, const int* src, const int* dst, const float* w,
                   void* out, int N, int m, int e, int d, int tpr_log2,
                   int tile_rows, cudaStream_t stream) {
  const size_t smem = smem_bytes(e, tile_rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_spmm_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int cols = (1 << tpr_log2) * V;
  const dim3 grid(N, (m + tile_rows - 1) / tile_rows, (d + cols - 1) / cols);
  segment_spmm_kernel<T, V><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), src, dst, w, static_cast<T*>(out), m, e, d,
      tile_rows, tpr_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec: h elements a thread loads at once
// (1, 2, 4; 8 for bf16; V * itemsize must divide d * itemsize and h's
// address); tpr_log2: log2 of the threads a row (<= 5); tile_rows: the
// destination rows a block (1 .. 256).  Returns a cudaError_t (0 on success).
// Launches on ``stream`` and does not synchronise.
int segment_spmm_batched_fwd(const void* h, const int* src, const int* dst,
                             const float* w, void* out, int N, int m, int e,
                             int d, int dtype, int vec, int tpr_log2,
                             int tile_rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tpr_log2 < 0 || tpr_log2 > 5 || tile_rows < 1 || tile_rows > kMaxTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (vec == 1) return launch<float, 1>(h, src, dst, w, out, N, m, e, d, tpr_log2, tile_rows, st);
    if (vec == 2) return launch<float, 2>(h, src, dst, w, out, N, m, e, d, tpr_log2, tile_rows, st);
    if (vec == 4) return launch<float, 4>(h, src, dst, w, out, N, m, e, d, tpr_log2, tile_rows, st);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vec == 1) return launch<B, 1>(h, src, dst, w, out, N, m, e, d, tpr_log2, tile_rows, st);
    if (vec == 2) return launch<B, 2>(h, src, dst, w, out, N, m, e, d, tpr_log2, tile_rows, st);
    if (vec == 4) return launch<B, 4>(h, src, dst, w, out, N, m, e, d, tpr_log2, tile_rows, st);
    if (vec == 8) return launch<B, 8>(h, src, dst, w, out, N, m, e, d, tpr_log2, tile_rows, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory one block may use after opting in, in bytes (or -1).
int segment_spmm_smem_limit(int device) {
  int v = -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

const char* segment_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
