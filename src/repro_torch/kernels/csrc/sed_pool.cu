// Fused Stale-Embedding-Dropout weighting + segment pooling (Eq. 1 and ⊕):
//
//     out[b, c] = sum_j eta[b, j] * h[b, j, c]          (agg = sum)
//     out[b, c] = that / max(J_b, 1)                    (agg = mean)
//
// with eta built from the (B, J) masks exactly as kernels/ref.py::sed_eta:
//
//     J_b        = sum_j valid[b, j]
//     eta_fresh  = keep + ((1 - keep) * J_b) / S
//     stale_term = valid * (1 - fresh) * (1 - drop)   [* exp(-decay * age)]
//     eta        = (fresh * eta_fresh + stale_term) * valid
//
// h (B, J, d) f32 or bf16, the masks (and ages) (B, J) f32, out (B, d) like h.
//
// Replaces the TPU kernels src/repro/kernels/sed_pool.py::_sed_pool_kernel
// (:27) and ::_sed_pool_aged_kernel (:40), one template here with the aged
// branch (a 5th operand, the per-segment age) switched on at compile time.
// Those kernels take (b_blk, J, d_blk) blocks of h into VMEM and reduce J
// there.  Here one thread owns one output element (b, c) and walks j in
// order, so nothing is shared between threads and no float atomics are
// needed: two launches on the same inputs are bitwise equal.  Output
// elements are numbered b * d + c, so the threads of a block cover
// consecutive columns of one row (their reads of h coalesce) and, where d is
// small (d = 1 for the segment_sum head), many rows.  Each thread builds
// eta_j itself from the row's masks (a row's masks are read by every thread
// of the row and come from L1); the sum over j is f32 whatever h's type, cast
// once at the store.
//
// What bounds it: bytes.  It reads h once and the masks once and writes out:
// (B*J*d + k*B*J + B*d) * itemsize with k = 3 mask planes, 4 with ages, for
// 2*B*J*d flops.  At the training shape (8, 20, 64) that is ~45 KB, ~0.01 us
// at 3.35 TB/s, so a launch (a few us) dominates.  The design answer: one
// launch per pooling for the whole batch, never one per graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// keep and one_minus_keep are the host's float(keep_prob) and
// float(1.0 - keep_prob) (the subtraction in double, as the reference's
// Python scalar arithmetic does it); neg_decay is float(-decay).
template <typename T, bool kAged>
__global__ void __launch_bounds__(kThreads)
sed_pool_fwd_kernel(const T* __restrict__ h, const float* __restrict__ valid,
                    const float* __restrict__ fresh, const float* __restrict__ drop,
                    const float* __restrict__ ages, T* __restrict__ out, int B, int J,
                    int d, float keep, float one_minus_keep, float num_sampled,
                    float neg_decay, int mean) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(B) * d) return;
  const int b = static_cast<int>(i / d);
  const int c = static_cast<int>(i - static_cast<long long>(b) * d);
  const size_t row = static_cast<size_t>(b) * J;

  float J_b = 0.f;
  for (int j = 0; j < J; ++j) J_b += __ldg(valid + row + j);
  const float eta_fresh = keep + (one_minus_keep * J_b) / num_sampled;

  const T* h_b = h + row * d + c;
  float acc = 0.f;
  for (int j = 0; j < J; ++j) {
    const float v = __ldg(valid + row + j);
    const float f = __ldg(fresh + row + j);
    const float stale = v * (1.f - f);
    float stale_term = stale * (1.f - __ldg(drop + row + j));
    if (kAged) stale_term = stale_term * expf(neg_decay * __ldg(ages + row + j));
    const float eta = (f * eta_fresh + stale_term) * v;
    acc = fmaf(eta, to_f32(h_b[static_cast<size_t>(j) * d]), acc);
  }
  if (mean) acc = acc / fmaxf(J_b, 1.f);
  out[i] = from_f32<T>(acc);
}

template <typename T, bool kAged>
cudaError_t launch(const void* h, const float* valid, const float* fresh,
                   const float* drop, const float* ages, void* out, int B, int J,
                   int d, float keep, float one_minus_keep, float num_sampled,
                   float neg_decay, int mean, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * d;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sed_pool_fwd_kernel<T, kAged><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(h), valid, fresh, drop, ages, static_cast<T*>(out), B, J,
      d, keep, one_minus_keep, num_sampled, neg_decay, mean);
  return cudaGetLastError();
}

template <bool kAged>
int dispatch(const void* h, const float* valid, const float* fresh, const float* drop,
             const float* ages, void* out, int B, int J, int d, float keep,
             float one_minus_keep, float num_sampled, float neg_decay, int mean,
             int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kAged>(h, valid, fresh, drop, ages, out, B, J, d, keep,
                                one_minus_keep, num_sampled, neg_decay, mean, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kAged>(h, valid, fresh, drop, ages, out, B, J, d,
                                        keep, one_minus_keep, num_sampled, neg_decay,
                                        mean, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; mean: 1 = divide by max(J_b, 1).
// Returns a cudaError_t (0 on success).  Launches on ``stream`` and does not
// synchronise.
int sed_pool_fwd(const void* h, const float* valid, const float* fresh,
                 const float* drop, void* out, int B, int J, int d, float keep,
                 float one_minus_keep, float num_sampled, int mean, int dtype,
                 void* stream) {
  return dispatch<false>(h, valid, fresh, drop, nullptr, out, B, J, d, keep,
                         one_minus_keep, num_sampled, 0.f, mean, dtype, stream);
}

// As sed_pool_fwd, with the stale branch weighted by exp(neg_decay * age).
int sed_pool_aged_fwd(const void* h, const float* valid, const float* fresh,
                      const float* drop, const float* ages, void* out, int B, int J,
                      int d, float keep, float one_minus_keep, float num_sampled,
                      float neg_decay, int mean, int dtype, void* stream) {
  return dispatch<true>(h, valid, fresh, drop, ages, out, B, J, d, keep,
                        one_minus_keep, num_sampled, neg_decay, mean, dtype, stream);
}

const char* sed_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
