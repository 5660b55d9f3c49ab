// K4: multi-head ViT self-attention softmax(q k^T * Dh^-1/2) v, one CTA per
// (batch element, head), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tracklab_tpu/ops/vit_attention_pallas.py
// (_kernel, launched by vit_attention). The TPU kernel runs one grid step per
// batch element with the heads unrolled, because a TPU grid runs in order on
// one core and per-step overhead dominates at these sizes. Here the (b, h)
// pairs are independent CTAs that the card runs side by side (B * H = 4608
// or 6144 on the KPR path, ViT-B at N = 193).
//
// Order of operations follows the JAX kernel and the plain version
// (tracklab_torch/kernels/vit_attention.py, vit_attention_plain): scores in
// f32, times Dh^-1/2, keys at or past n_valid get finfo(f32).min, row max,
// e = exp(s - m), p = e / sum(e), p rounded to the input type, then p . v
// accumulated in f32 and rounded to the input type once. It is not an
// online-softmax (flash) kernel that divides at the end.
//
// Layout: the CTA stages its head's K transposed (Dh x N) and V (N x Dh) in
// shared memory in the input type, read straight from the strided
// (B, N, H, Dh) views (the last axis contiguous), so the q, k and v views of
// one packed qkv tensor need no copies. One warp per query row: lane l owns
// keys l, l + 32, ... (N <= 256, so at most 8 per lane) and reads K^T at
// consecutive addresses; a warp-shuffle max and sum give the softmax; the
// row's p goes to a per-warp buffer in shared memory, and each lane then
// accumulates the output dims l, l + 32, ... (Dh <= 128) over the keys.
//
// What bounds it: at B = 384, N = 193, H = 12, Dh = 64 the work is
// 4 B H N^2 Dh = 43.9 GFLOP against 4 B N H Dh * 2 = 455 MB moved, 96 FLOP
// per byte: below the tensor-core ridge (~295 FLOP/B in bf16), so the card's
// bound is bytes. This simple kernel multiplies on CUDA cores with one
// shared-memory read per FMA, so it is bound by shared-memory issue, far from
// either bound; mma.sync / wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 256;
constexpr int kMaxDh = 128;
constexpr int kKeysPerLane = kMaxN / 32;
constexpr int kDimsPerLane = kMaxDh / 32;
constexpr int kWarps = 8;
constexpr size_t kMaxSmem = 232448;  // bytes one Hopper CTA may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int N, int Dh) {
  return 2 * align16((size_t)N * Dh * sizeof(T)) +
         align16((size_t)kWarps * Dh * sizeof(float)) +
         (size_t)kWarps * N * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    vit_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int N,
                         int H, int Dh, int n_valid, float scale, long long qsb,
                         long long qsn, long long qsh, long long ksb,
                         long long ksn, long long ksh, long long vsb,
                         long long vsn, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* kT = reinterpret_cast<T*>(smem);  // Dh x N
  T* vs = reinterpret_cast<T*>(smem + align16((size_t)N * Dh * sizeof(T)));
  float* qs = reinterpret_cast<float*>(
      smem + 2 * align16((size_t)N * Dh * sizeof(T)));  // kWarps x Dh
  float* ps = qs + align16((size_t)kWarps * Dh * sizeof(float)) /
                       sizeof(float);  // kWarps x N

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const T* qb = q + b * qsb + h * qsh;

  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i - j * Dh;
    kT[d * N + j] = kb[j * ksn + d];
    vs[i] = vb[j * vsn + d];
  }
  __syncthreads();

  float* qw = qs + warp * Dh;
  float* pw = ps + warp * N;
  const int n_keys = min(N, n_valid);
  int jc[kKeysPerLane];
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) jc[t] = min(lane + 32 * t, N - 1);

  for (int row = warp; row < N; row += kWarps) {
    for (int d = lane; d < Dh; d += 32) qw[d] = to_f(qb[row * qsn + d]);
    __syncwarp();

    float s[kKeysPerLane];
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) s[t] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float qd = qw[d];
      const T* kr = kT + d * N;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t)
        s[t] = fmaf(qd, to_f(kr[jc[t]]), s[t]);
    }

    float m = -FLT_MAX;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      float x = s[t] * scale;
      if (j >= n_valid) x = -FLT_MAX;  // finfo(f32).min, not -inf
      s[t] = x;
      if (j < N) m = fmaxf(m, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      const float e = j < N ? expf(s[t] - m) : 0.f;
      s[t] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < N) pw[j] = to_f(from_f<T>(s[t] / sum));  // p in the input type
    }
    __syncwarp();

    float acc[kDimsPerLane];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
    // keys past n_valid have p == 0 exactly and add nothing
    for (int j = 0; j < n_keys; ++j) {
      const float pj = pw[j];
      const T* vr = vs + j * Dh;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) acc[i] = fmaf(pj, to_f(vr[d]), acc[i]);
      }
    }
    T* o = out + (((long long)b * N + row) * H + h) * Dh;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) o[d] = from_f<T>(acc[i]);
    }
    __syncwarp();  // qw and pw are rewritten by the next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, int H, int Dh, const long long* st, int n_valid,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, Dh);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // more than 48 KB of dynamic shared memory must be asked for first
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)Dh);
  vit_attention_kernel<T><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N, H, Dh, n_valid, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tl_vit_attention_max_tokens() { return kMaxN; }
extern "C" int tl_vit_attention_max_head_dim() { return kMaxDh; }

// q, k, v: (B, N, H, Dh) views whose last axis is contiguous, with element
// strides (batch, token, head) given for each; out: contiguous (B, N, H, Dh).
// dtype 0 = f32, 1 = bf16. Keys at positions >= n_valid are masked. Launches
// on `stream` and returns cudaGetLastError() right after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int tl_vit_attention(const void* q, const void* k, const void* v,
                                void* out, int B, int N, int H, int Dh,
                                long long qsb, long long qsn, long long qsh,
                                long long ksb, long long ksn, long long ksh,
                                long long vsb, long long vsn, long long vsh,
                                int n_valid, int dtype, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || H < 1 || Dh < 1 || Dh > kMaxDh ||
      n_valid < 1)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(q, k, v, out, B, N, H, Dh, st, n_valid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, N, H, Dh, st, n_valid, s);
  return (int)cudaErrorInvalidValue;
}
