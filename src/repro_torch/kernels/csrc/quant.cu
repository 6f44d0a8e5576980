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
//
// Replaces the TPU kernels of src/repro/kernels/quant.py: _pack_bf16_kernel
// (:139), _pack_bf16_det_kernel (:143), _pack_int8_kernel (:147),
// _pack_int8_det_kernel (:153), _unpack_bf16_kernel (:159) and
// _unpack_int8_kernel (:163).  Those take (32, N padded to 128) row blocks
// into VMEM so the row's amax stays on chip.  Here one block owns one row:
// the int8 pack reduces the row's amax with warp shuffles and one shared
// word per warp (max is exact in any order), then writes the values and the
// scale; the stochastic bf16 pack and the unpacks are plain passes over the
// row.  The nearest-even bf16 pack is elementwise, so it ignores the rows:
// one pass over the flat R*N buffer, a thread a chunk of 8 elements (two
// 16-byte loads with L2's 256-byte prefetch hint, one 16-byte store), a
// scalar head up to x's first 16-byte boundary and a scalar tail.  On the
// H100, one chunk a thread over as many blocks as it takes beat a grid
// sized to the card with a grid-stride loop, and the prefetch hint beat
// plain loads and streaming stores (PERF.md).  The random bits are an input
// (a uint32 buffer drawn by the caller), so the kernels agree with the
// plain version bit for bit given the same bits.
//
// Bit-exact arithmetic: __fdiv_rn (IEEE division, not a multiply by the
// reciprocal), __fmul_rn for the scale and the unpack, rintf for round to
// nearest even, cvt.rn.bf16x2.f32 for the bf16 pack; built without
// --use_fast_math, so denormals are kept.
//
// What bounds it: bytes.  Per element it reads 4 B (+4 B of bits on the
// write path) and writes 1-2 B (pack) or reads 1-2 B and writes 4 B
// (unpack), a handful of operations an element.  At the training shapes
// (a few rows of 64-1280 floats) that is a few KB: a launch (a few us)
// dominates, and the design answer is one launch per exchanged buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <bool kStochastic>
__global__ void __launch_bounds__(kMaxThreads)
pack_int8_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
                 int8_t* __restrict__ out, float* __restrict__ scale, int N) {
  __shared__ float partial[kMaxThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  float m = 0.f;
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

  float s = __fmul_rn(partial[0], 1.0f / 127.0f);   // f32(1/127), folded
  if (s != s) s = __uint_as_float(kF32QNaN);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
  const float div = s > 0.f ? s : 1.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = __fdiv_rn(x[base + i], div);
    float q;
    if (kStochastic) {
      const float lo = floorf(v);
      const float u = __fmul_rn(static_cast<float>(bits[base + i] >> 8), 0x1p-24f);
      q = lo + (u < v - lo ? 1.f : 0.f);
    } else {
      q = rintf(v);
    }
    // a NaN stays NaN to the cast, and cvt.rzi makes it 0 (PTX), as XLA's
    // cast does
    q = nan_min(nan_max(q, -127.f), 127.f);
    out[base + i] = static_cast<int8_t>(__float2int_rz(q));
  }
}

__global__ void __launch_bounds__(kMaxThreads)
unpack_bf16_kernel(const uint16_t* __restrict__ v, float* __restrict__ out, int N) {
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    out[base + i] = __uint_as_float(static_cast<uint32_t>(v[base + i]) << 16);
}

__global__ void __launch_bounds__(kMaxThreads)
unpack_int8_kernel(const int8_t* __restrict__ v, const float* __restrict__ scale,
                   float* __restrict__ out, int N) {
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  const float s = scale[blockIdx.x];
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    out[base + i] = __fmul_rn(static_cast<float>(v[base + i]), s);
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
int quant_pack_int8(const float* x, const uint32_t* bits, int8_t* out, float* scale,
                    int R, int N, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != nullptr)
    pack_int8_kernel<true><<<R, threads_for(N), 0, st>>>(x, bits, out, scale, N);
  else
    pack_int8_kernel<false><<<R, threads_for(N), 0, st>>>(x, nullptr, out, scale, N);
  return static_cast<int>(cudaGetLastError());
}

// v (R, N) bf16 bits -> out (R, N) f32.
int quant_unpack_bf16(const uint16_t* v, float* out, int R, int N, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  unpack_bf16_kernel<<<R, threads_for(N), 0, static_cast<cudaStream_t>(stream)>>>(
      v, out, N);
  return static_cast<int>(cudaGetLastError());
}

// v (R, N) int8, scale (R,) f32 -> out (R, N) f32.
int quant_unpack_int8(const int8_t* v, const float* scale, float* out, int R, int N,
                      void* stream) {
  if (R <= 0 || N <= 0) return 0;
  unpack_int8_kernel<<<R, threads_for(N), 0, static_cast<cudaStream_t>(stream)>>>(
      v, scale, out, N);
  return static_cast<int>(cudaGetLastError());
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
