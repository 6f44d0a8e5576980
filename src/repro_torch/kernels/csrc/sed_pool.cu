// Fused Stale-Embedding-Dropout weighting + segment pooling (Eq. 1 and ⊕):
//
//     out[b, c] = sum_j eta[b, j] * h[b, j, c]          (agg = sum)
//     out[b, c] = that * (1 / max(J_b, 1))              (agg = mean)
//
// with eta built from the (B, J) masks in the order of kernels/ref.py::sed_eta
// as PyTorch runs it on the card (each step rounded on its own, no
// contraction into an FMA; the division by the scalar S a multiplication by
// its f32 reciprocal, as PyTorch divides by a scalar on CUDA):
//
//     J_b        = sum_j valid[b, j]
//     eta_fresh  = keep + ((1 - keep) * J_b) * (1 / S)
//     stale_term = (valid * (1 - fresh)) * (1 - drop)   [* exp(-decay * age)]
//     eta        = (fresh * eta_fresh + stale_term) * valid
//
// h (B, J, d) f32 or bf16, the masks (and ages) (B, J) f32, out (B, d) like h,
// the sum in f32 whatever h's type.
//
// Replaces the TPU kernels src/repro/kernels/sed_pool.py::_sed_pool_kernel
// (:27) and ::_sed_pool_aged_kernel (:40): one template here, the aged
// branch (a 5th operand, the per-segment age) switched on at compile time.
// Those take (b_blk, J, d_blk) blocks of h into VMEM and reduce J there.
//
// What bounds it on the H100.  Bytes: h is read once, the masks once, out
// written once, (B*J*d + k*B*J + B*d) * 4 with k = 3 mask planes (4 aged),
// for ~2*B*J*d flops.  At the training shape (8, 20, 64) that is ~45 KB,
// ~0.01 us at 3.35 TB/s, so what a launch costs beyond the launch itself is
// its latency: one round trip to memory and the chain of dependent
// instructions, shuffles and barriers after it.  At a
// large shape (1024, 64, 256) it is the rate at which the card streams h.
//
// The design:
//   * One block per (row b, tile of columns); blockIdx.x is the row.  A
//     thread owns one vector of V columns (16 bytes where d * itemsize and
//     h's base allow, else 8, 4 or 2: the vector width is a template
//     instance that the wrapper picks at launch, never a branch per element)
//     and one j-lane ty of TY: it sums j = ty, ty + TY, ty + 2 TY, ... in that
//     order.  TX (a power of two, at most 32) vectors lie across the block,
//     tx fastest, so a warp reads whole rows of h at once.
//   * One round trip: every thread issues the loads of its first kChunk j's
//     of h before anything waits on memory, and warp 0 issues the masks of
//     the row's first 32 * kMaskRegs j's at the same time.  Longer rows walk
//     j in chunks of kChunk, a chunk's loads all in flight together, while
//     the SM's other warps keep the memory busy.
//   * eta once per (b, j), not once per (b, j, c): warp 0 counts J_b (a
//     ballot and a popcount where the masks are 0/1, which is exact; else
//     each lane in j order and a shuffle tree in a fixed order), builds eta_j
//     for the row into shared memory with one exp and one ages load per
//     (b, j) and, when the wrapper asks (h needs a gradient), writes eta and
//     J_b out for the backward.  Rows longer than kEtaTile take it in turns.
//   * No branch per j: a j past the row's end multiplies a zero-filled h by
//     eta 0, which leaves the sum as it is.
//   * The TY partial sums of a column join by a fixed tree over adjacent
//     pairs, ((p0 + p1) + (p2 + p3)) + ...: the levels inside a warp by
//     shuffles, the rest after one barrier in the registers of j-lane 0.
//     No float atomics, so two launches on the same inputs are bitwise equal.
//   * The grid is as shallow as the shape allows: TY is the smallest power
//     of two that covers J in one chunk a thread (capped by 256 threads a
//     block), so a short row is one block of one round trip, and a large
//     batch is thousands of blocks that keep every SM streaming.
// The wrapper (kernels/sed_pool.py::plan) chooses V, TX, TY and the column
// tiles; tests/test_torch_sed_pool.py replays this summation order in torch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;        // j's of h a thread has in flight
constexpr int kMaskRegs = 2;     // j's a lane of warp 0 loads masks for up front
constexpr int kEtaTile = 2048;   // eta values a block holds at once
constexpr int kMaxVec = 8;       // columns a thread owns at most (bf16, 16 B)

template <int kBytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

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

// eta of one (b, j) in ref.sed_eta's order, each operation rounded alone.
template <bool kAged>
__device__ __forceinline__ float eta_of(float v, float f, float dr, float age,
                                        float eta_fresh, float neg_decay) {
  const float stale = __fmul_rn(v, __fsub_rn(1.f, f));
  float stale_term = __fmul_rn(stale, __fsub_rn(1.f, dr));
  if (kAged) stale_term = __fmul_rn(stale_term, expf(__fmul_rn(neg_decay, age)));
  return __fmul_rn(__fadd_rn(__fmul_rn(f, eta_fresh), stale_term), v);
}

// keep and one_minus_keep are the host's float(keep_prob) and
// float(1.0 - keep_prob) (the subtraction in double, as the reference's
// Python scalar arithmetic does it); inv_sampled is the f32 reciprocal of
// num_sampled; neg_decay is float(-decay).  eta_out (B, J) and jb_out (B,)
// are written where they are not null.
template <typename T, bool kAged, int kVecBytes>
__global__ void __launch_bounds__(kMaxThreads)
sed_pool_kernel(const T* __restrict__ h, const float* __restrict__ valid,
                const float* __restrict__ fresh, const float* __restrict__ drop,
                const float* __restrict__ ages, T* __restrict__ out,
                float* __restrict__ eta_out, float* __restrict__ jb_out, int J,
                int d, int TX, int TY, float keep, float one_minus_keep,
                float inv_sampled, float neg_decay, int mean) {
  constexpr int V = kVecBytes / static_cast<int>(sizeof(T));
  using Raw = typename RawOf<kVecBytes>::type;
  // a tile's eta, then zeros for the j's past it that a chunk reaches
  __shared__ float eta_s[kEtaTile + kChunk * kMaxThreads];
  // each warp's sum of a column: at most 8 warps x 32 vectors x kMaxVec
  __shared__ float part_s[kMaxThreads * kMaxVec];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int tx_bits = __ffs(TX) - 1;  // TX is a power of two
  const int tx = t & (TX - 1);
  const int ty = t >> tx_bits;
  const int c0 = (blockIdx.y * TX + tx) * V;
  const bool active = ty < TY && c0 < d;
  const size_t row = static_cast<size_t>(blockIdx.x) * J;
  const T* h_row = h + row * d + c0;   // dereferenced only where active
  const int stride = kChunk * TY;      // j's between a thread's chunks

  // the first chunk of h, in flight before anything waits on memory; a j
  // past the tile (or a thread past the row) holds zeros
  Raw cur[kChunk];
  const int end0 = min(J, kEtaTile);
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int j = ty + u * TY;
    cur[u] = active && j < end0
                 ? __ldg(reinterpret_cast<const Raw*>(h_row + static_cast<size_t>(j) * d))
                 : Raw{};
  }

  // warp 0: J_b, with the masks of j = lane + 32 q (q < kMaskRegs) loaded
  // in the same round trip
  float J_b = 0.f, eta_fresh = 0.f;
  float v[kMaskRegs], f[kMaskRegs], dr[kMaskRegs], a[kMaskRegs];
  if (t < 32) {
#pragma unroll
    for (int q = 0; q < kMaskRegs; ++q) {
      const int j = lane + 32 * q;
      v[q] = f[q] = dr[q] = a[q] = 0.f;
      if (j < J) {
        v[q] = __ldg(valid + row + j);
        f[q] = __ldg(fresh + row + j);
        dr[q] = __ldg(drop + row + j);
        if (kAged) a[q] = __ldg(ages + row + j);
      }
    }
    bool binary = J <= 32 * kMaskRegs;
#pragma unroll
    for (int q = 0; q < kMaskRegs; ++q) binary = binary && (v[q] == 0.f || v[q] == 1.f);
    if (__all_sync(0xffffffffu, binary)) {
      int n = 0;   // a count of ones: the f32 sum exactly
#pragma unroll
      for (int q = 0; q < kMaskRegs; ++q) n += __popc(__ballot_sync(0xffffffffu, v[q] != 0.f));
      J_b = static_cast<float>(n);
    } else {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaskRegs; ++q) s += v[q];
      for (int j = lane + 32 * kMaskRegs; j < J; j += 32) s += __ldg(valid + row + j);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      J_b = __shfl_sync(0xffffffffu, s, 0);
    }
    eta_fresh = __fadd_rn(keep, __fmul_rn(__fmul_rn(one_minus_keep, J_b), inv_sampled));
    if (jb_out != nullptr && lane == 0 && blockIdx.y == 0) jb_out[blockIdx.x] = J_b;
  }
  const bool write_eta = eta_out != nullptr && blockIdx.y == 0;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;

  for (int t0 = 0; t0 < J; t0 += kEtaTile) {
    const int t1 = min(J, t0 + kEtaTile);
    if (t0 > 0) {
      __syncthreads();                 // the previous tile's eta is consumed
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = t0 + ty + u * TY;
        cur[u] = active && j < t1
                     ? __ldg(reinterpret_cast<const Raw*>(h_row + static_cast<size_t>(j) * d))
                     : Raw{};
      }
    }
    if (t < 32) {
      int j = t0 + lane;
      if (t0 == 0) {
#pragma unroll
        for (int q = 0; q < kMaskRegs; ++q, j += 32) {
          if (j < t1) {
            const float e = eta_of<kAged>(v[q], f[q], dr[q], a[q], eta_fresh, neg_decay);
            eta_s[j] = e;
            if (write_eta) eta_out[row + j] = e;
          }
        }
      }
#pragma unroll 4
      for (; j < t1; j += 32) {
        const float age = kAged ? __ldg(ages + row + j) : 0.f;
        const float e = eta_of<kAged>(__ldg(valid + row + j), __ldg(fresh + row + j),
                                      __ldg(drop + row + j), age, eta_fresh, neg_decay);
        eta_s[j - t0] = e;
        if (write_eta) eta_out[row + j] = e;
      }
      for (int i = t1 - t0 + lane; i < t1 - t0 + stride; i += 32) eta_s[i] = 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = t0 + ty;;) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float e = eta_s[j0 - t0 + u * TY];
        T x[V];
        memcpy(x, &cur[u], sizeof(Raw));
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(e, to_f32(x[k]), acc[k]);
      }
      j0 += stride;
      if (j0 >= t1) break;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = j0 + u * TY;
        cur[u] = j < t1
                     ? __ldg(reinterpret_cast<const Raw*>(h_row + static_cast<size_t>(j) * d))
                     : Raw{};
      }
    }
  }

  // the TY partials of a column by adjacent pairs: inside a warp (32 / TX
  // j-lanes) by shuffles, every lane taking part (a lane past the row adds
  // zeros nobody reads)
  const int lanes_per_warp = 32 >> tx_bits;  // j-lanes a warp holds
  for (int s = 1; s < TY && s < lanes_per_warp; s <<= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], s * TX);
  }
  // then across the W = TY / lanes_per_warp warps (1, 2, 4 or 8): each
  // warp's first j-lane posts its sum, and j-lane 0 joins them by adjacent
  // pairs
  const int W = TY >> (5 - tx_bits);
  if (W > 1) {
    if (active && lane < TX) {
#pragma unroll
      for (int k = 0; k < V; ++k) part_s[((t >> 5) * TX + tx) * V + k] = acc[k];
    }
    __syncthreads();
    if (active && ty == 0) {
      const float* p = part_s + tx * V;   // warp i's sum at p[i * TX * V]
      const int ws = TX * V;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (W == 2) {
          acc[k] = acc[k] + p[ws + k];
        } else if (W == 4) {
          acc[k] = (acc[k] + p[ws + k]) + (p[2 * ws + k] + p[3 * ws + k]);
        } else {
          acc[k] = ((acc[k] + p[ws + k]) + (p[2 * ws + k] + p[3 * ws + k])) +
                   ((p[4 * ws + k] + p[5 * ws + k]) + (p[6 * ws + k] + p[7 * ws + k]));
        }
      }
    }
  }
  // the threads of j-lane 0 are in warp 0 (TX <= 32), which holds J_b
  if (!active || ty != 0) return;
  const float inv_jb = __frcp_rn(fmaxf(J_b, 1.f));
  T y[V];
#pragma unroll
  for (int k = 0; k < V; ++k) y[k] = from_f32<T>(mean ? __fmul_rn(acc[k], inv_jb) : acc[k]);
  Raw packed;
  memcpy(&packed, y, sizeof(Raw));
  *reinterpret_cast<Raw*>(out + static_cast<size_t>(blockIdx.x) * d + c0) = packed;
}

template <typename T, bool kAged, int kVecBytes>
cudaError_t launch(const void* h, const float* valid, const float* fresh,
                   const float* drop, const float* ages, void* out, float* eta_out,
                   float* jb_out, int B, int J, int d, int TX, int TY, int col_tiles,
                   float keep, float one_minus_keep, float inv_sampled,
                   float neg_decay, int mean, cudaStream_t stream) {
  const int threads = (TX * TY + 31) / 32 * 32;
  sed_pool_kernel<T, kAged, kVecBytes>
      <<<dim3(static_cast<unsigned>(B), static_cast<unsigned>(col_tiles)), threads, 0,
         stream>>>(static_cast<const T*>(h), valid, fresh, drop, ages,
                   static_cast<T*>(out), eta_out, jb_out, J, d, TX, TY, keep,
                   one_minus_keep, inv_sampled, neg_decay, mean);
  return cudaGetLastError();
}

template <typename T, bool kAged>
cudaError_t by_vec(int vec_bytes, const void* h, const float* valid,
                   const float* fresh, const float* drop, const float* ages, void* out,
                   float* eta_out, float* jb_out, int B, int J, int d, int TX, int TY,
                   int col_tiles, float keep, float one_minus_keep, float inv_sampled,
                   float neg_decay, int mean, cudaStream_t st) {
#define SED_POOL_LAUNCH(BYTES)                                                          \
  return launch<T, kAged, BYTES>(h, valid, fresh, drop, ages, out, eta_out, jb_out, B, \
                                 J, d, TX, TY, col_tiles, keep, one_minus_keep,         \
                                 inv_sampled, neg_decay, mean, st)
  switch (vec_bytes) {
    case 16: SED_POOL_LAUNCH(16);
    case 8: SED_POOL_LAUNCH(8);
    case 4: SED_POOL_LAUNCH(4);
    case 2:
      if constexpr (sizeof(T) == 2) SED_POOL_LAUNCH(2);
      break;
  }
#undef SED_POOL_LAUNCH
  return cudaErrorInvalidValue;
}

template <bool kAged>
int dispatch(const void* h, const float* valid, const float* fresh, const float* drop,
             const float* ages, void* out, float* eta_out, float* jb_out, int B, int J,
             int d, int vec_bytes, int TX, int TY, int col_tiles, float keep,
             float one_minus_keep, float inv_sampled, float neg_decay, int mean,
             int dtype, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  // what the kernel relies on: a vector inside one row and aligned, TY a
  // power of two, the block within kMaxThreads, the columns covered
  const bool ok =
      (dtype == 0 || dtype == 1) && B > 0 && J >= 0 && d >= 0 && TX >= 1 && TY >= 1 &&
      (TY & (TY - 1)) == 0 && (TX & (TX - 1)) == 0 && TX <= 32 && TX * TY <= kMaxThreads &&
      vec_bytes >= itemsize &&
      (d * itemsize) % vec_bytes == 0 &&
      reinterpret_cast<size_t>(h) % vec_bytes == 0 &&
      static_cast<long long>(col_tiles) * TX * (vec_bytes / itemsize) >= d &&
      col_tiles >= 1 && col_tiles <= 65535;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_vec<float, kAged>(vec_bytes, h, valid, fresh, drop, ages, out, eta_out,
                                jb_out, B, J, d, TX, TY, col_tiles, keep,
                                one_minus_keep, inv_sampled, neg_decay, mean, st);
  return by_vec<__nv_bfloat16, kAged>(vec_bytes, h, valid, fresh, drop, ages, out,
                                      eta_out, jb_out, B, J, d, TX, TY, col_tiles,
                                      keep, one_minus_keep, inv_sampled, neg_decay,
                                      mean, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; mean: 1 = times 1 / max(J_b, 1).
// vec_bytes, TX, TY, col_tiles: the launch geometry (kernels/sed_pool.py::
// plan): bytes a thread loads at once, vectors across a block (a power of
// two, at most 32), j-lanes (a power of two), column tiles.  inv_sampled:
// the f32 reciprocal of num_sampled.  eta_out (B, J) and jb_out (B,) may be
// null.  Returns a cudaError_t (0 on success; cudaErrorInvalidValue for a
// geometry the kernel does not take).  Launches on ``stream`` and does not
// synchronise.
int sed_pool_fwd(const void* h, const float* valid, const float* fresh,
                 const float* drop, void* out, float* eta_out, float* jb_out, int B,
                 int J, int d, int vec_bytes, int TX, int TY, int col_tiles, float keep,
                 float one_minus_keep, float inv_sampled, int mean, int dtype,
                 void* stream) {
  return dispatch<false>(h, valid, fresh, drop, nullptr, out, eta_out, jb_out, B, J, d,
                         vec_bytes, TX, TY, col_tiles, keep, one_minus_keep,
                         inv_sampled, 0.f, mean, dtype, stream);
}

// As sed_pool_fwd, with the stale branch weighted by exp(neg_decay * age).
int sed_pool_aged_fwd(const void* h, const float* valid, const float* fresh,
                      const float* drop, const float* ages, void* out, float* eta_out,
                      float* jb_out, int B, int J, int d, int vec_bytes, int TX, int TY,
                      int col_tiles, float keep, float one_minus_keep,
                      float inv_sampled, float neg_decay, int mean, int dtype,
                      void* stream) {
  return dispatch<true>(h, valid, fresh, drop, ages, out, eta_out, jb_out, B, J, d,
                        vec_bytes, TX, TY, col_tiles, keep, one_minus_keep,
                        inv_sampled, neg_decay, mean, dtype, stream);
}

const char* sed_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
