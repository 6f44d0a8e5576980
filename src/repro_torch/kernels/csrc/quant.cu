// Pack and unpack of the compressed exchange wire format, row by row over a
// (R, N) float32 source (kernels/ref.py::quantize_rows_ref and
// ::dequantize_rows_ref mirror every operation here, in its order):
//
//   bf16, stochastic   hi16((u + (bits & 0xFFFF)) & 0xFFFF0000), u = f32 bits
//   bf16, nearest      __float2bfloat16_rn(x)
//   int8               s = amax_row * f32(1/127); v = x / (s > 0 ? s : 1);
//                      q = stochastic ? floor(v) + ((bits >> 8) * 2^-24 < v - floor(v))
//                                     : rint(v)   (nearest even);
//                      clip to [-127, 127]; scale[row] = s
//   unpack bf16        (float)v;      unpack int8   (float)v * scale[row]
//
// Replaces the TPU kernels of src/repro/kernels/quant.py: _pack_bf16_kernel
// (:139), _pack_bf16_det_kernel (:143), _pack_int8_kernel (:147),
// _pack_int8_det_kernel (:153), _unpack_bf16_kernel (:159) and
// _unpack_int8_kernel (:163).  Those take (32, N padded to 128) row blocks
// into VMEM so the row's amax stays on chip.  Here one block owns one row:
// the int8 pack reduces the row's amax with warp shuffles and one shared
// word per warp (max is exact in any order), then writes the values and the
// scale; the other kernels are plain passes over the row.  The random bits
// are an input (a uint32 buffer drawn by the caller), so the kernel agrees
// with the plain version bit for bit given the same bits.
//
// Bit-exact arithmetic: __fdiv_rn (IEEE division, not a multiply by the
// reciprocal), __fmul_rn for the scale and the unpack, rintf for round to
// nearest even; built without --use_fast_math, so denormals are kept.
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

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

template <bool kStochastic>
__global__ void __launch_bounds__(kMaxThreads)
pack_bf16_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
                 uint16_t* __restrict__ out, int N) {
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = x[base + i];
    if (kStochastic) {
      const uint32_t u = (__float_as_uint(v) + (bits[base + i] & 0xFFFFu)) & 0xFFFF0000u;
      out[base + i] = static_cast<uint16_t>(u >> 16);
    } else {
      out[base + i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
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
  for (int i = threadIdx.x; i < N; i += blockDim.x) m = fmaxf(m, fabsf(x[base + i]));
  m = warp_max(m);
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < n_warps ? partial[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) partial[0] = m;
  }
  __syncthreads();

  const float s = __fmul_rn(partial[0], 1.0f / 127.0f);   // f32(1/127), folded
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
    q = fminf(fmaxf(q, -127.f), 127.f);
    out[base + i] = static_cast<int8_t>(q);
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
  if (bits != nullptr)
    pack_bf16_kernel<true><<<R, threads_for(N), 0, st>>>(x, bits, out, N);
  else
    pack_bf16_kernel<false><<<R, threads_for(N), 0, st>>>(x, nullptr, out, N);
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
