// Causal sliding-window attention (the prefill / full-sequence forward of a
// dense transformer), f32:
//
//     s_ij      = (q[b, i, h, :] . k[b, j, g, :]) * scale,   g = h / (H / KV)
//     out[b, i, h, :] = sum_j softmax_j(s_ij) * v[b, j, g, :]
//
// over the keys with  i - W < j <= i  (W >= S is full causal attention).
// q (B, S, H, D), k and v (B, S, KV, D) are read through their strides (the
// last dimension contiguous); out is a contiguous (B, S, H, D).
//
// Replaces the TPU kernel src/repro/kernels/swa_attention.py::_swa_kernel
// (:27, launched at :86).  That kernel walks a (B*H, S/blk, nkv) grid in
// order on one core, carries the online-softmax state in VMEM scratch from
// one grid step to the next, needs S and W in multiples of its 128-row
// block, copies q/k/v to (B*H, S, D) first, and masks clamped out-of-range
// key blocks with -1e30, relying on a later finite block to wash out what
// exp(-1e30 - -1e30) = 1 adds.  Here:
//   - one block owns one (b, h, 64-row query tile) and walks the key tiles
//     that the tile's rows can see, in order, carrying the running max m,
//     sum l and accumulator per row in registers: nothing is shared between
//     blocks, there are no atomics, two launches are bitwise equal;
//   - a key tile wholly outside [q0 - W + 1, q_last] is never visited, and a
//     masked score is -inf.  A row whose visible keys have not started yet
//     keeps m = -inf; its exponentials are taken against 0 instead of m, so
//     exp(-inf) = 0 and no exp(-inf - -inf) NaN appears;
//   - any S and any W >= 1 (rows and keys past S are zero-filled and never
//     stored), D in {64, 128} as template instances;
//   - GQA is native: head h reads KV head h / (H / KV) in place; no repeated
//     K/V is materialised, and the strided reads take the place of the
//     reference's moveaxis copies.
// The 256 threads of a block form a 16 x 16 grid (ty, tx).  Thread (ty, tx)
// owns query rows ty + 16r (r < 4): it computes the scores of those rows
// against keys tx + 16c (c < 4) of the tile, and accumulates the output
// columns c4 * 64 + 4tx + (0..3) of those rows.  A row's 64 scores live in
// the 16 threads of one half-warp, reduced by shuffles.  Q, K and V tiles
// and the tile's probabilities P sit in shared memory (115 KB at D = 128,
// dynamic, above the 48 KB default); Q and K rows are padded by 4 floats
// so that the float4 reads of a quarter-warp hit distinct banks.
//
// What bounds it: operations.  It reads q, k, v once and writes out once,
// 4 * (2 B S H D + 2 B S KV D) bytes, for 4 B H D P flops where P is the
// number of visible (i, j) pairs: at the internlm2-1.8b shapes (H 16, KV 8,
// D 128) and S = 2048 that is 0.05 ms of bytes against 0.26 ms of f32
// flops at 67 TFLOP/s.  The products run on the f32 FMA units (no TF32:
// the f32 reference holds it to 1e-5); the design answer here is only to
// skip the invisible tiles (half the pairs at full causal, all but ~W/S of
// them with a window).  wgmma, TMA and a lower precision are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = kBK + 4;

template <int D>
struct Layout {
  static constexpr int kQStride = D + 4;
  static constexpr int kKStride = D + 4;
  static constexpr int kVStride = D;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQStride;
  static constexpr int kV = kK + kBK * kKStride;
  static constexpr int kP = kV + kBK * kVStride;
  static constexpr size_t kBytes = sizeof(float) * (kP + kBQ * kPStride);
};

// Copy rows [row0, row0 + rows) of one head (row r at base + r * row_stride)
// into shared memory at the given stride, zero-filling rows at or past S.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int dst_stride,
                                          const float* __restrict__ base,
                                          long long row_stride, int row0, int rows,
                                          int S) {
  constexpr int kF4 = D / 4;
  for (int f = threadIdx.x; f < rows * kF4; f += kThreads) {
    const int r = f / kF4;
    const int c = (f - r * kF4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      val = __ldg(reinterpret_cast<const float4*>(
          base + static_cast<long long>(row0 + r) * row_stride + c));
    *reinterpret_cast<float4*>(dst + r * dst_stride + c) = val;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int S, int H,
                     int KV, long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, int W, float scale) {
  using L = Layout<D>;
  constexpr int kNC = D / 64;  // float4 output columns a thread, per row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::kQ;
  float* Ks = smem + L::kK;
  float* Vs = smem + L::kV;
  float* Ps = smem + L::kP;

  // the longest query tiles (most visible keys) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + g * k_sh;
  const float* vb = v + b * v_sb + g * v_sh;
  load_tile<D>(Qs, L::kQStride, qb, q_ss, q0, kBQ, S);

  float m[4], l[4], acc[4][kNC * 4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC * 4; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = max(0, q0 - W + 1);
  for (int t = k_first / kBK; t <= q_last / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D>(Ks, L::kKStride, kb, k_ss, k0, kBK, S);
    load_tile<D>(Vs, L::kVStride, vb, v_ss, k0, kBK, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * L::kQStride + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * L::kKStride + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = s[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          s[r][c] = a;
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float row_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool visible = j <= i && j > i - W && j < S;
        s[r][c] = visible ? s[r][c] * scale : -INFINITY;
        row_max = fmaxf(row_max, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(row_max));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_use);
        row_sum += s[r][c];
        Ps[(ty + 16 * r) * kPStride + tx + 16 * c] = s[r][c];
      }
      l[r] = l[r] * alpha + half_warp_sum(row_sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kNC * 4; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[r] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * r) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c4 = 0; c4 < kNC; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (j + jj) * L::kVStride + c4 * 64 + tx * 4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y : jj == 2 ? p[r].z : p[r].w;
            acc[r][c4 * 4 + 0] = fmaf(pr, vv.x, acc[r][c4 * 4 + 0]);
            acc[r][c4 * 4 + 1] = fmaf(pr, vv.y, acc[r][c4 * 4 + 1]);
            acc[r][c4 * 4 + 2] = fmaf(pr, vv.z, acc[r][c4 * 4 + 2]);
            acc[r][c4 * 4 + 3] = fmaf(pr, vv.w, acc[r][c4 * 4 + 3]);
          }
        }
      }
    }
  }

  // every stored row saw its own key (j = i), so l >= 1 there
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* o = out + ((static_cast<long long>(b) * S + i) * H + h) * D;
#pragma unroll
    for (int c4 = 0; c4 < kNC; ++c4) {
      float4 val;
      val.x = acc[r][c4 * 4 + 0] / denom;
      val.y = acc[r][c4 * 4 + 1] / denom;
      val.z = acc[r][c4 * 4 + 2] / denom;
      val.w = acc[r][c4 * 4 + 3] / denom;
      *reinterpret_cast<float4*>(o + c4 * 64 + tx * 4) = val;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int B,
                   int S, int H, int KV, const long long* strides, int W, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      swa_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  swa_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, KV, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], strides[8], W, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, D), k and v (B, S, KV, D), f32, last dimension contiguous,
// base pointers 16-byte aligned and ``strides`` (in elements: q's batch,
// sequence and head strides, then k's, then v's) multiples of 4; out a
// contiguous (B, S, H, D).  H % KV == 0, D in {64, 128}, 1 <= W.  ``scale``
// is the f32 1/sqrt(D).  Returns a cudaError_t (0 on success).  Launches on
// ``stream`` and does not synchronise; the wrapper checks every condition.
int swa_attention_fwd(const float* q, const float* k, const float* v, float* out, int B,
                      int S, int H, int KV, int D, const long long* strides, int W,
                      float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || W < 1 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return launch<64>(q, k, v, out, B, S, H, KV, strides, W, scale, st);
  if (D == 128) return launch<128>(q, k, v, out, B, S, H, KV, strides, W, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
