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
// key blocks with -1e30.  Here one block walks, in order, the 64-key tiles
// that its query rows can see and keeps the online-softmax state (running
// max m, sum l, accumulator) in registers: nothing is shared between
// blocks, there are no atomics, two launches are bitwise equal.
//
// What bounds it: operations on the tensor cores.  It reads q, k, v once
// and writes out once, 4 * (2 B S H D + 2 B S KV D) bytes, for 4 B H D P
// flops (P visible (i, j) pairs); at f32 accuracy each product is three
// TF32 products.  At internlm2-1.8b's shapes (H 16, KV 8, D 128) and
// S = 2048 that is 0.05 ms of bytes against 0.10 ms of 3xTF32 operations at
// the H100's 495 TFLOP/s of dense TF32 (0.26 ms of f32 FMAs at 67).  The
// design:
//   - tensor cores at f32 accuracy (3xTF32).  Both products run on mma.sync
//     m16n8k8 TF32 with f32 accumulation.  Each operand x is split into
//     big = tf32(x) and small = tf32(x - big), both rounded as
//     cvt.rna.tf32.f32 rounds (to nearest, ties away), and a.b is taken as
//     a_small.b_big + a_big.b_small + a_big.b_big, small products first,
//     as CUTLASS's OpMultiplyAddFastF32; the dropped a_small.b_small is
//     ~2^-22 of a.b.  One TF32 product alone misses the f32 reference's
//     1e-5 (tests/test_torch_swa.py emulates both).  The rounding is done
//     by integer operations (see split): a conversion instruction issues at
//     16 a clock on an SM, and each K and V value is split by all 8 warps.
//     Each of the three passes runs over 8 independent accumulators before
//     the next, so no product waits on the one before it;
//   - P stays in registers.  A row of an m16n8 accumulator lives in the 4
//     threads of a quad (rows g = lane / 4 and g + 8), so a row's max and
//     sum take two quad shuffles; thread t holds keys 2t and 2t + 1 of each
//     8-key step, which P V's A fragment takes as its columns t and t + 4,
//     and V's B fragment is read from rows 2t and 2t + 1 to match (the sum
//     over keys does not care which column a key sits in).  Q K^T maps its
//     k-step's columns t and t + 4 to d 2t and 2t + 1 the same way, so Q's
//     and K's fragments are float2 reads;
//   - a tile's P V sums in a fresh accumulator and joins O by an f32 FMA,
//     O = O * alpha + P V: the tensor cores' accumulation rounds toward
//     zero, and accumulating O there across the 512 tiles of a 32k-token
//     row biased it past 1e-5;
//   - K and V through a two-stage cp.async ring: tile t + 1 loads while
//     tile t is computed.  Rows of Q and K sit D + 8 floats apart in shared
//     memory and rows of V D + 4, so every fragment read (float2 at row g,
//     column 2t; float at row 2t, column g) hits distinct banks;
//   - one block serves one (b, KV head, query tile) and HB query heads of
//     the group (HB = 2 where H / KV is even, else 1): 8 warps of 16 rows,
//     64 positions x 2 heads or 128 positions x 1 head.  Each K/V tile is
//     loaded once for the block's heads (internlm2-1.8b's 16 / 8: once a
//     group); a ratio of 6 runs 3 blocks a group;
//   - only a warp's diagonal tile and its window's first tile take the
//     per-element test i - W < j <= i; interior tiles skip it, and a tile
//     that none of a warp's rows can see skips the math.  Keys past S are
//     zero-filled and lie past the diagonal of every stored row.  A row
//     with no visible key yet keeps m = -inf and exponentiates against 0,
//     so no exp(-inf - -inf) NaN appears.  Exponentials are exp2f with
//     scale * log2(e) folded into the scores;
//   - the longest query tiles (most visible keys) start first: the head
//     group is the grid's fastest index, the query tile the next (S up to
//     65535 tiles).
// Shared memory: Q 128 rows and 2 stages of K and V 64 rows: 206,848 B at
// D 128 (one block an SM), 108,544 B at D 64.  -Xptxas -v (kept in
// build/kernels/swa_attention-*.log, printed by chip_smoke.py's build
// phase; nvcc 12.8, sm_90a): 255 registers at D 128 and 190 at D 64, for
// either HB, no spills.  On an H100 (80GB HBM3, 700 W) it reaches about a
// third of the 3xTF32 bound at 32k tokens (PERF.md): mma.sync's rate, the
// splits of K and V that every warp repeats, and a softmax that no product
// overlaps hold it there.
// wgmma with TF32 operands (both split operands in shared memory) is the
// later step toward the full tensor-core rate.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block, over its heads
constexpr int kBK = 64;             // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// floats a row in shared memory: Q and K rows are read as float2 at (row g,
// column 2t) and V rows as floats at (row 2t, column g); these strides put
// each half-warp's (Q, K) or warp's (V) reads on distinct banks
template <int D>
struct Layout {
  static constexpr int kQKStride = D + 8;
  static constexpr int kVStride = D + 4;
  static constexpr int kQ = 0;
  static constexpr int kStages = kRows * kQKStride;  // stage s: K, then V
  static constexpr int kV = kBK * kQKStride;         // V's offset in a stage
  static constexpr int kStage = kV + kBK * kVStride;
  static constexpr size_t kBytes = sizeof(float) * (kStages + 2 * kStage);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small, both TF32 rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero), by integer operations as CUTLASS's
// round_half_ulp_truncate: half a TF32 ulp is added to the bits, and the
// tensor core ignores an operand's low 13 bits.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  const uint32_t b = __float_as_uint(x) + 0x1000u;
  big = b;
  small = __float_as_uint(x - __uint_as_float(b & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a . b[n] for N independent n at f32 accuracy: the small products
// first, big x big last.  Each pass runs over the N accumulators before the
// next, so N products are in flight between two that depend on each other.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[N][2],
                                           const uint32_t (&b_small)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_small, b_big[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_big, b_small[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_big, b_big[n]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Start copying keys [k0, k0 + kBK) of one KV head into Ks and Vs.
template <int D>
__device__ __forceinline__ void load_kv(float* Ks, float* Vs, const float* __restrict__ kb,
                                        const float* __restrict__ vb, long long k_ss,
                                        long long v_ss, int k0, int S) {
  constexpr int kC = D / 4;  // 16-byte chunks a row
  for (int f = threadIdx.x; f < kBK * kC; f += kThreads) {
    const int r = f / kC;
    const int c = (f - r * kC) * 4;
    const bool ok = k0 + r < S;
    const long long row = ok ? k0 + r : 0;
    cp_async16(Ks + r * Layout<D>::kQKStride + c, kb + row * k_ss + c, ok);
    cp_async16(Vs + r * Layout<D>::kVStride + c, vb + row * v_ss + c, ok);
  }
}

template <int D, int HB>
__global__ void __launch_bounds__(kThreads, 1)
swa_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int S, int H,
                     int KV, long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, int W, float scale_log2) {
  using L = Layout<D>;
  constexpr int QB = kRows / HB;  // query positions a block
  constexpr int kKS = D / 8;      // k-steps of Q K^T
  constexpr int kON = D / 8;      // 8-column tiles of O
  constexpr int kSN = kBK / 8;    // 8-key tiles of S
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::kQ;

  // blocks start in the order of their linear index (x fastest): every head
  // group of the longest query tile first, then of the next
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QB;
  const int h0 = blockIdx.x * HB;
  const int b = blockIdx.z;
  const int g = h0 / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row (and row + 8)
  const int tq = lane % 4;  // thread in the quad
  const int h = h0 + warp * 16 / QB;   // this warp's head
  const int r0 = q0 + warp * 16 % QB;  // its first query position

  // Q: block row r is head h0 + r / QB, position q0 + r % QB
  {
    constexpr int kC = D / 4;
    const float* qb = q + b * q_sb + h0 * q_sh;
    for (int f = threadIdx.x; f < kRows * kC; f += kThreads) {
      const int r = f / kC;
      const int c = (f - r * kC) * 4;
      const int pos = q0 + r % QB;
      const bool ok = pos < S;
      cp_async16(Qs + r * L::kQKStride + c,
                 qb + (r / QB) * q_sh + (ok ? pos * q_ss : 0) + c, ok);
    }
  }
  const float* kb = k + b * k_sb + g * k_sh;
  const float* vb = v + b * v_sb + g * v_sh;
  const int q_last = min(q0 + QB, S) - 1;
  const int t_first = max(0, q0 - W + 1) / kBK;
  const int t_last = q_last / kBK;
  load_kv<D>(smem + L::kStages, smem + L::kStages + L::kV, kb, vb, k_ss, v_ss, t_first * kBK,
             S);
  cp_async_commit();

  float o[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows gr, gr + 8
  float l[2] = {0.f, 0.f};              // this thread's part of the running sum
  const int i0 = r0 + gr;
  const int i1 = i0 + 8;
  const int w_last = min(r0 + 15, S - 1);  // the warp's last visible key

  for (int t = t_first; t <= t_last; ++t) {
    const int stage = (t - t_first) & 1;
    if (t < t_last) {
      float* nk = smem + L::kStages + (stage ^ 1) * L::kStage;
      load_kv<D>(nk, nk + L::kV, kb, vb, k_ss, v_ss, (t + 1) * kBK, S);
    }
    cp_async_commit();  // empty at the last tile: the count stays uniform
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const int k0 = t * kBK;
    const float* Ks = smem + L::kStages + stage * L::kStage;
    const float* Vs = Ks + L::kV;

    if (r0 < S && k0 <= w_last && k0 + kBK - 1 > r0 - W) {
      float s[kSN][4];
#pragma unroll
      for (int n = 0; n < kSN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kKS; ++ks) {
        // the k-step's column t is d 2t and column t + 4 is d 2t + 1, in Q's
        // A and K's B fragments alike: one float2 read each
        const float2 q_lo = *reinterpret_cast<const float2*>(
            Qs + (warp * 16 + gr) * L::kQKStride + ks * 8 + 2 * tq);
        const float2 q_hi = *reinterpret_cast<const float2*>(
            Qs + (warp * 16 + gr + 8) * L::kQKStride + ks * 8 + 2 * tq);
        uint32_t ab[4], as[4];
        split(q_lo.x, ab[0], as[0]);  // (g, d 2t)
        split(q_hi.x, ab[1], as[1]);  // (g + 8, d 2t)
        split(q_lo.y, ab[2], as[2]);  // (g, d 2t + 1)
        split(q_hi.y, ab[3], as[3]);  // (g + 8, d 2t + 1)
        uint32_t bb[kSN][2], bs[kSN][2];
#pragma unroll
        for (int n = 0; n < kSN; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Ks + (n * 8 + gr) * L::kQKStride + ks * 8 + 2 * tq);
          split(kv.x, bb[n][0], bs[n][0]);  // K[key g][d 2t]
          split(kv.y, bb[n][1], bs[n][1]);  // K[key g][d 2t + 1]
        }
        mma_3xtf32<kSN>(s, ab, as, bb, bs);
      }

      // the diagonal tile and the window's first tile of this warp's rows
      const bool mask = k0 + kBK - 1 > r0 || k0 <= r0 + 15 - W;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (mask) {
            const int i = e < 2 ? i0 : i1;
            const int j = k0 + n * 8 + 2 * tq + (e & 1);
            if (j > i || j <= i - W) x = -INFINITY;
          }
          s[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      const float m_new0 = fmaxf(m[0], quad_max(mx0));
      const float m_new1 = fmaxf(m[1], quad_max(mx1));
      const float use0 = m_new0 == -INFINITY ? 0.f : m_new0;
      const float use1 = m_new1 == -INFINITY ? 0.f : m_new1;
      const float alpha0 = exp2f(m[0] - use0);
      const float alpha1 = exp2f(m[1] - use1);
      m[0] = m_new0;
      m[1] = m_new1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        s[n][0] = exp2f(s[n][0] - use0);
        s[n][1] = exp2f(s[n][1] - use0);
        s[n][2] = exp2f(s[n][2] - use1);
        s[n][3] = exp2f(s[n][3] - use1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l[0] = l[0] * alpha0 + sum0;
      l[1] = l[1] * alpha1 + sum1;

      // P's A fragments: column t is key 2t, column t + 4 key 2t + 1
      uint32_t pb[kSN][4], ps[kSN][4];
#pragma unroll
      for (int kk = 0; kk < kSN; ++kk) {
        split(s[kk][0], pb[kk][0], ps[kk][0]);  // (g, key 2t)
        split(s[kk][2], pb[kk][1], ps[kk][1]);  // (g + 8, key 2t)
        split(s[kk][1], pb[kk][2], ps[kk][2]);  // (g, key 2t + 1)
        split(s[kk][3], pb[kk][3], ps[kk][3]);  // (g + 8, key 2t + 1)
      }
      // O = O * alpha + P V, kON / kNB column groups of kNB 8-column tiles.
      // The tile's P V sums in a fresh accumulator and joins O by an f32
      // FMA: the tensor cores' accumulation rounds toward zero, which over
      // the hundreds of tiles of a long row would bias O.
      constexpr int kNB = 8 < kON ? 8 : kON;
#pragma unroll
      for (int n0 = 0; n0 < kON; n0 += kNB) {
        float pv[kNB][4];
#pragma unroll
        for (int n = 0; n < kNB; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kSN; ++kk) {
          const float* vp = Vs + (kk * 8 + 2 * tq) * L::kVStride + n0 * 8 + gr;
          uint32_t bb[kNB][2], bs[kNB][2];
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            split(vp[n * 8], bb[n][0], bs[n][0]);               // V[key 2t][col g]
            split(vp[L::kVStride + n * 8], bb[n][1], bs[n][1]);  // V[key 2t + 1][col g]
          }
          mma_3xtf32<kNB>(pv, pb[kk], ps[kk], bb, bs);
        }
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          o[n0 + n][0] = fmaf(o[n0 + n][0], alpha0, pv[n][0]);
          o[n0 + n][1] = fmaf(o[n0 + n][1], alpha0, pv[n][1]);
          o[n0 + n][2] = fmaf(o[n0 + n][2], alpha1, pv[n][2]);
          o[n0 + n][3] = fmaf(o[n0 + n][3], alpha1, pv[n][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  // every stored row saw its own key (j = i), so l >= 1 there
  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? i1 : i0;
    if (i >= S) continue;
    const float inv = 1.f / (half ? l1 : l0);
    float* row = out + ((static_cast<long long>(b) * S + i) * H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < kON; ++n)
      *reinterpret_cast<float2*>(row + n * 8) =
          make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

template <int D, int HB>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int B,
                   int S, int H, int KV, const long long* strides, int W, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(swa_attention_kernel<D, HB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int QB = kRows / HB;
  const dim3 grid(H / HB, (S + QB - 1) / QB, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  swa_attention_kernel<D, HB><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, KV, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], strides[8], W, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const float* q, const float* k, const float* v, float* out, int B,
                     int S, int H, int KV, const long long* strides, int W, float scale,
                     cudaStream_t stream) {
  if ((H / KV) % 2 == 0)
    return launch<D, 2>(q, k, v, out, B, S, H, KV, strides, W, scale, stream);
  return launch<D, 1>(q, k, v, out, B, S, H, KV, strides, W, scale, stream);
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
  if (D == 64) return launch_d<64>(q, k, v, out, B, S, H, KV, strides, W, scale, st);
  if (D == 128) return launch_d<128>(q, k, v, out, B, S, H, KV, strides, W, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a block takes at head dim D (0 for another D).
int swa_attention_smem_bytes(int D) {
  if (D == 64) return static_cast<int>(Layout<64>::kBytes);
  if (D == 128) return static_cast<int>(Layout<128>::kBytes);
  return 0;
}

const char* swa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
