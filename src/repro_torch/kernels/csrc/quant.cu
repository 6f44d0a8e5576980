// Pack and unpack of the compressed exchange wire format over a (R, N)
// float32 source (kernels/ref.py::quantize_rows_ref and ::dequantize_rows_ref
// mirror every operation here, in its order):
//
//   bf16, stochastic   hi16((u + (bits & 0xFFFF)) & 0xFFFF0000), u = f32 bits
//   bf16, nearest      round to nearest even
//   int8               s = amax_row * f32(1/127); v = x / (s > 0 ? s : 1);
//                      q = stochastic ? floor(v) + ((bits >> 8) * 2^-24 < v - floor(v))
//                                     : rint(v)   (nearest even);
//                      clip to [-127, 127]; scale[row] = s
//   unpack bf16        (float)v;      unpack int8   (float)v * scale[row]
//
// NaN and inf carry the JAX package's bits (XLA's conversions on the CPU):
// a bf16 NaN is the quiet NaN 0x7FC0 with x's sign, from either pack; an
// int8 row holding a NaN has the scale 0x7FC00000 (amax propagates the NaN),
// is divided by 1 and packs 0 where x is NaN; a row holding +-inf has scale
// inf and packs 0 everywhere (x / inf = +-0, inf / inf = NaN).  A NaN reaches
// the int8 cast unclamped and the cast makes it 0, as XLA's does.
// Subnormals as XLA's arithmetic on the CPU treats them: the bf16 paths
// are bit operations and keep them; the int8 paths read a subnormal x or
// scale as a zero of its sign and flush a subnormal scale or quotient to
// one (explicit selects, flush_subnormal).
//
// Replaces the TPU kernels of src/repro/kernels/quant.py: _pack_bf16_kernel
// (:139), _pack_bf16_det_kernel (:143), _pack_int8_kernel (:147),
// _pack_int8_det_kernel (:153), _unpack_bf16_kernel (:159) and
// _unpack_int8_kernel (:163).  Those take (32, N padded to 128) row blocks
// into VMEM so the row's amax stays on chip.  Here:
//
// - nearest-even int8 pack: W warps a row, 8 / W rows a block (W and the
//   register array from kernels/quant.py::plan_pack_int8: many warps a row
//   where few rows arrive, 2 at 8192 x 1280).  x is read once, 16 bytes a
//   load with L2's 256-byte prefetch hint, and stays in registers from the
//   amax to the store (a row wider than REGISTER_N reads the rest twice);
//   the amax is a shuffle tree, one shared word a warp and one barrier
//   when W > 1; four results go out as one word.  A row's scale in
//   [2^-100, FLT_MAX] (or 0) divides by the reciprocal with one FMA
//   correction and rounds by adding 1.5 * 2^23, 4 full-rate operations an
//   element; any other row (NaN, inf, tiny) is read again and divided by
//   __fdiv_rn.  A test holds the two to the IEEE path for every x at a
//   sweep of scales (tests/test_torch_kernels_gpu.py).
// - int8 unpack: a flat pass, a warp 128 G contiguous elements (G words
//   a thread from plan_unpack_int8, 16 at 8192 x 1280): every load
//   instruction reads 128 contiguous bytes and every store writes 512.
// - nearest-even bf16 pack: a flat pass, a thread a chunk of 8 elements
//   (two 16-byte loads with the prefetch hint, one 16-byte store).
// - stochastic packs and the bf16 unpack: a block a row, a scalar loop;
//   the stochastic int8 pack reduces the amax with shuffles and one shared
//   word a warp.
//
// Each takes a scalar head up to its first aligned address and a scalar
// tail, so any 4-byte-aligned x and any v or out alignment are taken.
// The random bits are an input (a uint32 buffer drawn by the caller), so
// the kernels agree with the plain version bit for bit given the same bits.
//
// Bit-exact arithmetic: __fdiv_rn or the correction above (both give the
// correctly rounded quotient), __fmul_rn for the scale and the unpack,
// rintf or the 1.5 * 2^23 addition for round to nearest even,
// cvt.rn.bf16x2.f32 for the bf16 pack; built without --use_fast_math, so
// denormals are kept wherever no select flushes them.
//
// What bounds it: bytes.  Per element it reads 4 B (+4 B of bits on the
// write path) and writes 1-2 B (pack) or reads 1-2 B and writes 4 B
// (unpack), a handful of operations an element.  At the training shapes
// (a few rows of 64-1280 floats) that is a few KB and a launch (~5 us)
// dominates: one launch per exchanged buffer.  At 8192 x 1280 on an
// NVIDIA H100 80GB HBM3 at 700 W, the int8 pack and unpack take 72% of
// the bytes bound's speed; a bare 42 MB fill of f32 (the unpack's writes)
// reaches only 2.4 TB/s there (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kFlatThreads = 256;
constexpr uint32_t kBf16QNaN = 0x7FC0u;
constexpr uint32_t kF32QNaN = 0x7FC00000u;

// max and min that keep a NaN from either side (fmaxf and fminf drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A subnormal becomes a zero of its sign, by an explicit select: the
// reference's int8 arithmetic is XLA's on the CPU, which reads subnormal
// inputs as zero and flushes subnormal results (DAZ and FTZ).  The file is
// not built with -ftz=true, since its bf16 conversions keep subnormals.
__device__ __forceinline__ float flush_subnormal(float a) {
  return fabsf(a) < FLT_MIN ? copysignf(0.f, a) : a;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// two f32 -> bf16 to nearest even (a in the low half); a NaN becomes the
// quiet NaN with its sign, as XLA converts it
__device__ __forceinline__ uint32_t bf16x2_nearest(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  uint32_t r = *reinterpret_cast<const uint32_t*>(&p);
  if (a != a) r = (r & 0xFFFF0000u) | ((__float_as_uint(a) >> 16) & 0x8000u) | kBf16QNaN;
  if (b != b) r = (r & 0x0000FFFFu) | (__float_as_uint(b) & 0x80000000u) | (kBf16QNaN << 16);
  return r;
}

__device__ __forceinline__ uint16_t bf16_nearest(float a) {
  return static_cast<uint16_t>(bf16x2_nearest(a, 0.f));
}

// 16 bytes of x, asking L2 to fetch the surrounding 256 bytes and L1 to keep
// nothing: the pack reads each byte once
__device__ __forceinline__ float4 ld_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// a thread a chunk of 8 elements (32 bytes in, 16 out) from x + head on;
// the head (x's elements before its first 16-byte boundary) and the tail
// (after the last whole chunk) element by element
__global__ void __launch_bounds__(kFlatThreads)
pack_bf16_det_kernel(const float* __restrict__ x, uint16_t* __restrict__ out,
                     long long n, long long head) {
  const long long stride = static_cast<long long>(gridDim.x) * kFlatThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kFlatThreads + threadIdx.x;
  const long long chunks = (n - head) / 8;
  if (t < chunks) {
    const float4* xv = reinterpret_cast<const float4*>(x + head) + 2 * t;
    const float4 a = ld_once(xv), b = ld_once(xv + 1);
    reinterpret_cast<uint4*>(out + head)[t] =
        make_uint4(bf16x2_nearest(a.x, a.y), bf16x2_nearest(a.z, a.w),
                   bf16x2_nearest(b.x, b.y), bf16x2_nearest(b.z, b.w));
  }
  for (long long j = t; j < head; j += stride) out[j] = bf16_nearest(x[j]);
  for (long long j = head + chunks * 8 + t; j < n; j += stride) out[j] = bf16_nearest(x[j]);
}

__global__ void __launch_bounds__(kMaxThreads)
pack_bf16_stochastic_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
                            uint16_t* __restrict__ out, int N) {
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const uint32_t u = (__float_as_uint(x[base + i]) + (bits[base + i] & 0xFFFFu)) >> 16;
    // the reference converts the truncated f32 to bf16: a NaN turns quiet
    const bool nan = (u & 0x7F80u) == 0x7F80u && (u & 0x7Fu) != 0u;
    out[base + i] = static_cast<uint16_t>(nan ? (u & 0x8000u) | kBf16QNaN : u);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
pack_int8_stochastic_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
                            int8_t* __restrict__ out, float* __restrict__ scale, int N) {
  __shared__ float partial[kMaxThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  float m = 0.f;
  // a subnormal x counts as 0 in the amax too, but only a row of nothing
  // else could notice, and its scale is flushed below
  for (int i = threadIdx.x; i < N; i += blockDim.x) m = nan_max(m, fabsf(x[base + i]));
  m = warp_max(m);
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < n_warps ? partial[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) partial[0] = m;
  }
  __syncthreads();

  float s = flush_subnormal(__fmul_rn(partial[0], 1.0f / 127.0f));   // f32(1/127), folded
  if (s != s) s = __uint_as_float(kF32QNaN);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
  const float div = s > 0.f ? s : 1.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    // a subnormal quotient matters: at bits >> 8 == 0 it would round up to 1
    const float v = flush_subnormal(__fdiv_rn(flush_subnormal(x[base + i]), div));
    const float lo = floorf(v);
    const float u = __fmul_rn(static_cast<float>(bits[base + i] >> 8), 0x1p-24f);
    float q = lo + (u < v - lo ? 1.f : 0.f);
    // a NaN stays NaN to the cast, and cvt.rzi makes it 0 (PTX), as XLA's
    // cast does
    q = nan_min(nan_max(q, -127.f), 127.f);
    out[base + i] = static_cast<int8_t>(__float2int_rz(q));
  }
}

// |v|'s largest element joined to m, keeping a NaN
__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return nan_max(nan_max(m, nan_max(fabsf(v.x), fabsf(v.y))),
                 nan_max(fabsf(v.z), fabsf(v.w)));
}

// x / d to nearest even as an int8, in the low byte of a word, by d's
// reciprocal r = RN(1/d) and one FMA correction (q = q0 + (x - q0 d) r, the
// correctly rounded quotient, Markstein), then rint by adding 1.5 * 2^23,
// whose low byte is then the quotient's two's complement.  For a scale in
// [2^-100, FLT_MAX] or 0 only: x is then finite, the remainder x - q0 d is
// exact wherever |x / d| >= 1/8 (below, the result is 0 whatever its last
// bit), and |x / d| <= amax / RN(amax / 127) < 127.5, so no clamp is needed.
__device__ __forceinline__ uint32_t int8_nearest(float x, float d, float r) {
  const float q0 = __fmul_rn(x, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, d, x), r, q0);
  return __float_as_uint(__fadd_rn(q, 0x1.8p23f));
}

__device__ __forceinline__ uint32_t int8x4_nearest(float4 v, float d, float r) {
  return __byte_perm(__byte_perm(int8_nearest(v.x, d, r), int8_nearest(v.y, d, r), 0x0040),
                     __byte_perm(int8_nearest(v.z, d, r), int8_nearest(v.w, d, r), 0x0040),
                     0x5410);
}

// The same for any scale (NaN, inf, under 2^-100): IEEE division, rintf,
// the clamp to [-127, 127] that keeps a NaN, and cvt.rzi (NaN -> 0), as
// XLA's cast does.
__device__ __forceinline__ int8_t int8_nearest_ieee(float x, float d) {
  // a subnormal x reads as ±0: at a scale under 2^-100 its quotient can
  // reach 1 (a subnormal quotient rounds to 0 either way)
  const float q = nan_min(nan_max(rintf(__fdiv_rn(flush_subnormal(x), d)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rz(q));
}

// four int8 (the low byte first) to o, as one word where o is 4-byte aligned
__device__ __forceinline__ void store_int8x4(int8_t* o, uint32_t q, bool word) {
  if (word) {
    *reinterpret_cast<uint32_t*>(o) = q;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) o[b] = static_cast<int8_t>(q >> (8 * b));
  }
}

// The nearest-even int8 pack: W warps a row (W = 1, 2, 4 or 8), 8 / W rows
// a block of 8 warps.  A row's head (its elements before x's next 16-byte
// boundary, at most 3) and tail (after its last whole float4, at most 3) go
// to threads 0-2 of the row as scalars; float4 j of the body goes to thread
// j % (32 W), which keeps its first K float4 in registers from the amax to
// the store and reads any further ones (a row wider than 4 * 32 * W * K
// elements) twice.  The amax is a shuffle tree, then, for W > 1, one shared
// word a warp and one barrier.  ``x_mod`` is x's address / 4 mod 4;
// ``out_words``: out's byte of every 16-byte-aligned x element is 4-byte
// aligned, so four results go out as one word.
template <int K>
__global__ void __launch_bounds__(kFlatThreads)
pack_int8_det_kernel(const float* __restrict__ x, int8_t* __restrict__ out,
                     float* __restrict__ scale, int R, int N, int w_log2, int x_mod,
                     bool out_words) {
  __shared__ float partial[kFlatThreads / 32];
  const int W = 1 << w_log2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = 32 * W;                                   // threads a row
  const int t = ((warp & (W - 1)) << 5) | lane;
  const long long row =
      static_cast<long long>(blockIdx.x) * ((kFlatThreads / 32) >> w_log2) + (warp >> w_log2);
  const bool live = row < R;
  const long long base = row * N;
  const int head = min(N, static_cast<int>((4 - (x_mod + base) % 4) % 4));
  const int nvec = (N - head) / 4;
  const int tail = N - head - 4 * nvec;
  const float* xr = x + base;
  const float4* xv = reinterpret_cast<const float4*>(xr + head);

  float4 v[K];
  float m = 0.f, xh = 0.f, xt = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + k * T;
    if (live && j < nvec) {
      v[k] = ld_once(xv + j);
      m = abs_max4(m, v[k]);
    }
  }
  if (live && t < head) {
    xh = xr[t];
    m = nan_max(m, fabsf(xh));
  }
  if (live && t < tail) {
    xt = xr[head + 4 * nvec + t];
    m = nan_max(m, fabsf(xt));
  }
  for (int j = t + K * T; live && j < nvec; j += T) m = abs_max4(m, ld_once(xv + j));
  m = warp_max(m);
  if (W > 1) {
    if (lane == 0) partial[warp] = m;
    __syncthreads();
    const int first = warp & ~(W - 1);
    m = partial[first];
#pragma unroll
    for (int w = 1; w < kFlatThreads / 32; ++w)
      if (w < W) m = nan_max(m, partial[first + w]);
  }
  if (!live) return;

  // a subnormal scale is flushed to 0 (the row is then divided by 1); at a
  // scale in [2^-100, FLT_MAX], |x / s| < 2^-26 for a subnormal x, which
  // rounds to 0 whether x reads as 0 or not, so the fast path needs nothing
  float s = flush_subnormal(__fmul_rn(m, 1.0f / 127.0f));   // f32(1/127), folded
  if (s != s) s = __uint_as_float(kF32QNaN);
  if (t == 0) scale[row] = s;
  const float d = s > 0.f ? s : 1.f;
  int8_t* o = out + base;
  if (!(s == 0.f || (s >= 0x1p-100f && s <= FLT_MAX))) {
    // a row with a NaN or inf, or of magnitudes under ~1e-28: read again
    for (int i = t; i < N; i += T) o[i] = int8_nearest_ieee(xr[i], d);
    return;
  }
  const float r = __frcp_rn(d);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + k * T;
    if (j < nvec) store_int8x4(o + head + 4 * j, int8x4_nearest(v[k], d, r), out_words);
  }
  for (int j = t + K * T; j < nvec; j += T)
    store_int8x4(o + head + 4 * j, int8x4_nearest(ld_once(xv + j), d, r), out_words);
  if (t < head) o[t] = static_cast<int8_t>(int8_nearest(xh, d, r));
  if (t < tail) o[head + 4 * nvec + t] = static_cast<int8_t>(int8_nearest(xt, d, r));
}

__global__ void __launch_bounds__(kMaxThreads)
unpack_bf16_kernel(const uint16_t* __restrict__ v, float* __restrict__ out, int N) {
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    out[base + i] = __uint_as_float(static_cast<uint32_t>(v[base + i]) << 16);
}

__device__ __forceinline__ uint32_t ld_once_u32(const void* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float unpack_int8(int8_t q, float s) {
  return __fmul_rn(static_cast<float>(q), s);
}

// a row's scale, a subnormal one read as a zero of its sign (-3 x +0 = -0)
__device__ __forceinline__ float row_scale(const float* scale, long long row) {
  return flush_subnormal(scale[row]);
}

// A flat pass over the R*N buffer from v + head (v's first 4-byte boundary)
// on: a warp takes 128 G elements, lane l the G words at 4 l + 128 k
// (k < G), so each load instruction reads 128 contiguous bytes and each
// 16-byte store instruction writes 512 (four scalar stores unless out is
// then 16-byte aligned: ``out_vec``).  The row comes from one division a
// thread, then steps of 128 elements; a word that crosses a row's end
// takes each element's own scale.  The head and what is left after the
// last whole span, element by element.
template <int G>
__global__ void __launch_bounds__(kFlatThreads)
unpack_int8_kernel(const int8_t* __restrict__ v, const float* __restrict__ scale,
                   float* __restrict__ out, long long n, int N, long long head,
                   bool out_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kFlatThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kFlatThreads + threadIdx.x;
  const long long spans = (n - head) / (128 * G);
  if ((t >> 5) < spans) {
    const long long e0 = head + (t >> 5) * (128 * G) + 4 * (threadIdx.x & 31);
    uint32_t w[G];
#pragma unroll
    for (int k = 0; k < G; ++k) w[k] = ld_once_u32(v + e0 + 128 * k);
    long long row = n <= 0xFFFFFFFFll
        ? static_cast<long long>(static_cast<uint32_t>(e0) / static_cast<uint32_t>(N))
        : e0 / N;
    int col = static_cast<int>(e0 - row * N);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      float f[4];
      float s = row_scale(scale, row);
      if (col + 4 <= N) {
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = unpack_int8(static_cast<int8_t>(w[k] >> (8 * i)), s);
      } else {
        long long rr = row;
        int cc = col;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          f[i] = unpack_int8(static_cast<int8_t>(w[k] >> (8 * i)), s);
          if (++cc == N && i < 3) {
            cc = 0;
            s = row_scale(scale, ++rr);
          }
        }
      }
      float* o = out + e0 + 128 * k;
      if (out_vec) {
        *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = f[i];
      }
      for (col += 128; col >= N; col -= N) ++row;
    }
  }
  for (long long j = t; j < head; j += stride) out[j] = unpack_int8(v[j], row_scale(scale, j / N));
  for (long long j = head + spans * (128 * G) + t; j < n; j += stride)
    out[j] = unpack_int8(v[j], row_scale(scale, j / N));
}

// A warp per 32 elements of the row, at most kMaxThreads threads.
unsigned threads_for(int N) {
  const int t = ((N + 31) / 32) * 32;
  return static_cast<unsigned>(t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t));
}

}  // namespace

extern "C" {

// x (R, N) f32 -> out (R, N) bf16 bits; ``bits`` (R, N) uint32 or null for
// round to nearest even.  Each function launches one kernel on ``stream``
// (none when R or N is 0), does not synchronise, and returns a cudaError_t
// (0 on success).
int quant_pack_bf16(const float* x, const uint32_t* bits, uint16_t* out, int R, int N,
                    void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != nullptr) {
    pack_bf16_stochastic_kernel<<<R, threads_for(N), 0, st>>>(x, bits, out, N);
    return static_cast<int>(cudaGetLastError());
  }
  const long long n = static_cast<long long>(R) * N;
  // the chunks start at x's first 16-byte boundary; where out is not then
  // 16-byte aligned too, every element takes the element-wise path
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  long long head = static_cast<long long>(((16u - xa % 16u) % 16u) / 4u);
  if (xa % 4u != 0u || (reinterpret_cast<uintptr_t>(out) + 2u * head) % 16u != 0u) head = n;
  if (head > n) head = n;
  const long long chunks = (n - head) / 8;
  const long long work = chunks > 0 ? chunks : n;
  const long long blocks = (work + kFlatThreads - 1) / kFlatThreads;
  pack_bf16_det_kernel<<<static_cast<unsigned>(blocks), kFlatThreads, 0, st>>>(
      x, out, n, head);
  return static_cast<int>(cudaGetLastError());
}

// x (R, N) f32 -> out (R, N) int8 and scale (R,) f32; ``bits`` as above.
// The nearest-even pack takes ``warps_per_row`` (1, 2, 4 or 8) and
// ``vecs_per_lane`` (the float4 a thread keeps in registers: 2, 4, 8 or
// 16) from kernels/quant.py::plan_pack_int8; the stochastic pack ignores
// them.  x must be 4-byte aligned (a float32 tensor always is); out may
// have any alignment.
int quant_pack_int8(const float* x, const uint32_t* bits, int8_t* out, float* scale,
                    int R, int N, int warps_per_row, int vecs_per_lane, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != nullptr) {
    pack_int8_stochastic_kernel<<<R, threads_for(N), 0, st>>>(x, bits, out, scale, N);
    return static_cast<int>(cudaGetLastError());
  }
  const int W = warps_per_row;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if ((W != 1 && W != 2 && W != 4 && W != 8) || xa % 4u != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  const int x_mod = static_cast<int>((xa / 4u) % 4u);
  const bool out_words = (reinterpret_cast<uintptr_t>(out) + 4u - x_mod) % 4u == 0u;
  const int w_log2 = W == 1 ? 0 : W == 2 ? 1 : W == 4 ? 2 : 3;
  const int rows_per_block = kFlatThreads / (32 * W);
  const unsigned blocks = static_cast<unsigned>((R + rows_per_block - 1) / rows_per_block);
  const auto launch = [&](auto kernel) {
    kernel<<<blocks, kFlatThreads, 0, st>>>(x, out, scale, R, N, w_log2, x_mod, out_words);
    return static_cast<int>(cudaGetLastError());
  };
  switch (vecs_per_lane) {
    case 2: return launch(pack_int8_det_kernel<2>);
    case 4: return launch(pack_int8_det_kernel<4>);
    case 8: return launch(pack_int8_det_kernel<8>);
    case 16: return launch(pack_int8_det_kernel<16>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// v (R, N) bf16 bits -> out (R, N) f32.
int quant_unpack_bf16(const uint16_t* v, float* out, int R, int N, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  unpack_bf16_kernel<<<R, threads_for(N), 0, static_cast<cudaStream_t>(stream)>>>(
      v, out, N);
  return static_cast<int>(cudaGetLastError());
}

// v (R, N) int8, scale (R,) f32 -> out (R, N) f32; ``groups`` (1, 2, 4, 8
// or 16) words a thread, from kernels/quant.py::plan_unpack_int8.  v may
// have any alignment, out must be 4-byte aligned.
int quant_unpack_int8(const int8_t* v, const float* scale, float* out, int R, int N,
                      int groups, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const long long n = static_cast<long long>(R) * N;
  long long head = static_cast<long long>((4u - reinterpret_cast<uintptr_t>(v) % 4u) % 4u);
  if (head > n) head = n;
  const bool out_vec = (reinterpret_cast<uintptr_t>(out) + 4u * head) % 16u == 0u;
  const long long spans = (n - head) / (128 * groups);
  const long long work = spans > 0 ? spans * 32 : n;
  const unsigned blocks = static_cast<unsigned>((work + kFlatThreads - 1) / kFlatThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<blocks, kFlatThreads, 0, st>>>(v, scale, out, n, N, head, out_vec);
    return static_cast<int>(cudaGetLastError());
  };
  switch (groups) {
    case 1: return launch(unpack_int8_kernel<1>);
    case 2: return launch(unpack_int8_kernel<2>);
    case 4: return launch(unpack_int8_kernel<4>);
    case 8: return launch(unpack_int8_kernel<8>);
    case 16: return launch(unpack_int8_kernel<16>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
