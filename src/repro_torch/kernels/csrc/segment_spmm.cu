// Batched weighted segment SpMM, forward:
//
//     out[n, v, c] = sum_{e : dst[n, e] = v} w[n, e] * h[n, src[n, e], c]
//
// h (N, m, d) f32 or bf16, src/dst (N, e) int32, w (N, e) f32, out like h.
// The sum is taken in f32 and cast to h's type once, at the store.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py::_spmm_batched_kernel
// (its forward; the backward lands with the training slice).  That kernel
// builds (e_blk x m) one-hot gather and scatter matrices and runs two MXU
// matmuls per segment -- O(e*m*d) work that only pays on a systolic array --
// and carries the edge-block reduction across sequential grid steps.  Here
// the work is O(e*d) and each output element is owned by exactly one thread:
//
//   * one block per (segment n, 32-column feature tile);
//   * the block stages the segment's dst in shared memory (one coalesced
//     pass) and counts in-degrees there (integer atomics: the count is
//     exact whatever the order); warp 0 scans them into CSR row starts and
//     places the edge ids in destination order, stable within a
//     destination (warp-wide __match_any_sync ranks, one 32-edge chunk at a
//     time, in edge order);
//   * each warp then owns destination nodes and each lane one feature
//     column: the lane sums w[e] * h[src[e], c] over the node's edges in
//     their original order, with a warp's 32 reads of one h row coalesced.
//
// No float atomics: every sum runs in a fixed order, so two launches on the
// same inputs are bitwise equal (ROADMAP B1 asks for run-to-run identical
// results).  Edges whose src or dst lies outside [0, m) are skipped, so the
// kernel never reads or writes out of bounds.
//
// What bounds it: bytes.  It does 2*e*d flops on (2*N*m*d + 3*N*e) * 4 bytes.
// At the serving bucket (N=8, m=64, e=512, d=64, f32) that is about 0.3 MB,
// about 0.1 us at 3.35 TB/s, so a launch (a few us) would dominate a kernel
// that reached the bound.  The design answer is the TPU one: one launch per
// message-passing layer for the whole bucket batch of segments, never one
// per segment.  Measured on an H100 (PERF.md), this kernel takes ~20 us
// there: latency inside the block, not bytes or the launch, sets its time.
//
// Later speed items: every padding edge is (0, 0) with w = 0, so the warp
// that owns node 0 sums every padding edge of its segment (0 * h must stay in
// the sum: an inf in h has to give the reference's NaN).  Each edge of the
// sum costs a chain of dependent loads (edge id, then src and w, then the h
// row).  The sort is redone by every feature tile of a segment and runs on
// one warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // feature columns per block, one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool edge_in_range(int s, int t, int m) {
  return static_cast<unsigned>(s) < static_cast<unsigned>(m) &&
         static_cast<unsigned>(t) < static_cast<unsigned>(m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_spmm_fwd_kernel(const T* __restrict__ h, const int* __restrict__ src,
                        const int* __restrict__ dst, const float* __restrict__ w,
                        T* __restrict__ out, int m, int e, int d) {
  extern __shared__ int smem[];
  int* start = smem;            // m + 1 CSR row starts
  int* cursor = smem + m + 1;   // m: in-degree, then next free slot per node
  int* dst_s = cursor + m;      // e: dst, or -1 for an edge out of range
  int* perm = dst_s + e;        // e: edge ids in (dst, edge order) order

  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * kTile + lane;
  const int* src_n = src + static_cast<size_t>(n) * e;
  const int* dst_n = dst + static_cast<size_t>(n) * e;
  const float* w_n = w + static_cast<size_t>(n) * e;

  for (int v = threadIdx.x; v < m; v += kThreads) cursor[v] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < e; i += kThreads) {
    const int s = src_n[i], t = dst_n[i];
    const bool ok = edge_in_range(s, t, m);
    dst_s[i] = ok ? t : -1;
    if (ok) atomicAdd(&cursor[t], 1);
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the in-degrees, 32 nodes at a time
    int carry = 0;
    for (int base = 0; base < m; base += 32) {
      const int v = base + lane;
      const int c = v < m ? cursor[v] : 0;
      int x = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (v < m) start[v] = carry + x - c;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) start[m] = carry;
    __syncwarp();
    for (int v = lane; v < m; v += 32) cursor[v] = start[v];
    __syncwarp();
    // stable placement: lane i of a chunk goes after every earlier edge of
    // its destination, earlier chunks first, then lower lanes of this chunk
    for (int base = 0; base < e; base += 32) {
      const int i = base + lane;
      const int t = i < e ? dst_s[i] : -1;
      const unsigned peers = __match_any_sync(kFull, t);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int pos = t >= 0 ? cursor[t] + rank : 0;
      __syncwarp();
      if (t >= 0) {
        perm[pos] = i;
        if (rank == 0) cursor[t] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  if (col >= d) return;
  const T* h_n = h + static_cast<size_t>(n) * m * d;
  T* out_n = out + static_cast<size_t>(n) * m * d;
  for (int v = warp; v < m; v += kWarps) {
    float acc = 0.f;
    const int k1 = start[v + 1];
    for (int k = start[v]; k < k1; ++k) {
      const int i = perm[k];
      const int s = __ldg(src_n + i);
      const float wt = __ldg(w_n + i);
      acc = fmaf(wt, to_f32(h_n[static_cast<size_t>(s) * d + col]), acc);
    }
    out_n[static_cast<size_t>(v) * d + col] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* h, const int* src, const int* dst, const float* w,
                   void* out, int N, int m, int e, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * m + 1 + 2 * e) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_spmm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(N, (d + kTile - 1) / kTile);
  segment_spmm_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), src, dst, w, static_cast<T*>(out), m, e, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
// Launches on ``stream`` and does not synchronise.
int segment_spmm_batched_fwd(const void* h, const int* src, const int* dst,
                             const float* w, void* out, int N, int m, int e,
                             int d, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(h, src, dst, w, out, N, m, e, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(h, src, dst, w, out, N, m, e, d, st);
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
