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
// What bounds it: at B = 384, N = 193, H = 12, Dh = 64 the work is
// 4 B H N^2 Dh = 43.9 GFLOP against 4 B N H Dh * 2 = 455 MB moved, 96 FLOP
// per byte: below the tensor-core ridge (~295 FLOP/B in bf16), so the card's
// bound is bytes.
//
// bf16 (every path): vit_attention_mma_kernel, on the tensor cores. The CTA
// stages its head's K and V once in shared memory with cp.async, straight
// from the strided (B, N, H, Dh) views of the packed qkv tensor (no copy of
// qkv), key rows padded to a multiple of 16 with the tail zero-filled (so a
// padded V row adds 0, never NaN * 0) and a row stride of Dh + 8 elements
// (ldmatrix's eight row addresses then fall in distinct banks). Each of the
// eight warps takes 16-row query tiles, its q fragments straight from global
// memory, and walks the keys in blocks of 16 three times: S = q k^T for the
// block runs as mma.sync m16n8k16 (bf16 in, f32 accumulate, k^T's fragments
// from ldmatrix) and stays in registers. Pass 1 takes the row max, pass 2
// sums e = exp(s - max), pass 3 forms p = e / sum, rounds it to bf16 as the
// A fragment of the block and accumulates O = P V (V's fragments from
// ldmatrix.trans); each output fragment is rounded once and stored. The
// products are recomputed rather than kept (a whole row of S would be 104
// registers a lane at N = 193 and a long, fully unrolled body, which ran
// slower on an H100): on the tensor cores they are cheap, and the
// passes are compact loops. The division is e * (1 / sum) with one residual
// correction, the correctly rounded quotient for this range. So q, k and v
// are read once and the output written once; what is left beside the bytes
// is the softmax's exp on CUDA cores.
//
// The same bf16 kernel has a second mode, the compute-dtype softmax
// (tl_vit_attention_bf16_mma_cd), for the JAX model's naive, einsum and
// einsumT lowerings, which take the softmax in bf16. Its plain version is
// vit_attention_compute_plain. It rounds to bf16 where those bf16 tensors
// round: the logits, the scaled logits, the masked keys at finfo(bf16).min,
// s - max, e = exp(s - max), the row sum (accumulated in f32) and
// p = e / sum. The passes recompute S as above, so no row of logits is kept.
//
// f32: vit_attention_kernel on CUDA cores (f32 on tensor cores would be
// TF32, three decimal digits). One warp per query row: lane l owns keys l,
// l + 32, ... and reads K^T (staged transposed) at consecutive addresses; a
// warp-shuffle max and sum give the softmax; the row's p goes to a per-warp
// buffer, and each lane accumulates the output dims l, l + 32, ... It is
// bound by shared-memory issue (one load per FMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 256;
constexpr int kMaxDh = 128;
constexpr int kKeysPerLane = kMaxN / 32;
constexpr int kDimsPerLane = kMaxDh / 32;
constexpr int kWarps = 8;
constexpr size_t kMaxSmem = 232448;  // bytes one Hopper CTA may use

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// ------------------------------------------------ bf16 on the tensor cores
typedef __nv_bfloat16 bf16;

constexpr int kMmaWarps = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// e / d given r = 1 / d (correctly rounded): the quotient e * r corrected
// by its residual, which is the correctly rounded e / d for the normal
// range of e (Markstein); one multiply and two FMAs instead of a division
__device__ __forceinline__ float div_by(float e, float d, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, d, e), r, q);
}

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline size_t mma_smem_bytes(int N, int Dh) {
  return 2 * (size_t)pad16(N) * (Dh + 8) * sizeof(bf16);
}

// x rounded to bf16 and back: the compute-dtype mode's rounding points
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// finfo(bf16).min, the compute-dtype mode's masked logit
constexpr float kBf16Lowest = -3.38953139e38f;

// S block jp of a 16-row query tile: keys 16 jp .. 16 jp + 15 as two n8
// tiles (sb[0]: keys 16 jp + 2t, +1; sb[1]: the same + 8; elements 0, 1 of
// row g, 2, 3 of row g + 8), scaled, and with MASK keys at or past n_valid
// at finfo(f32).min (CD: finfo(bf16).min) and padded keys (>= N) at -inf
// (they get e = 0). CD, the compute-dtype mode, rounds the logit to bf16
// and again after the scale, as bf16 tensors round them.
template <int DKT, bool MASK, bool CD>
__device__ __forceinline__ void s_block(float (&sb)[2][4], const uint32_t (&qf)[DKT][4],
                                        uint32_t krow, int jp, int LD, int dkt, float scale,
                                        int t, int N, int n_valid) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DKT; ++kk) {
    if (kk >= dkt) continue;
    uint32_t bf[4];
    ldsm_x4(krow + (uint32_t)(jp * 16 * LD + kk * 16) * 2, bf);
    mma_bf16(sb[0], qf[kk], bf[0], bf[1]);
    mma_bf16(sb[1], qf[kk], bf[2], bf[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = CD ? bf16r(__fmul_rn(bf16r(sb[i][e]), scale)) : sb[i][e] * scale;
      if (MASK) {
        const int col = jp * 16 + i * 8 + 2 * t + (e & 1);
        // finfo(dtype).min, not -inf
        if (col >= n_valid) x = CD ? kBf16Lowest : -FLT_MAX;
        if (col >= N) x = __int_as_float(0xff800000);  // -inf: padding, no key
      }
      sb[i][e] = x;
    }
}

// Runs body(jp, sb) over the key blocks of a query tile, the blocks that
// need no mask first.
template <int DKT, bool CD, typename F>
__device__ __forceinline__ void for_blocks(const uint32_t (&qf)[DKT][4], uint32_t krow,
                                           int nkt, int n_full, int LD, int dkt, float scale,
                                           int t, int N, int n_valid, F&& body) {
  float sb[2][4];
#pragma unroll 2
  for (int jp = 0; jp < n_full; ++jp) {
    s_block<DKT, false, CD>(sb, qf, krow, jp, LD, dkt, scale, t, N, n_valid);
    body(jp, sb);
  }
#pragma unroll 1
  for (int jp = n_full; jp < nkt; ++jp) {
    s_block<DKT, true, CD>(sb, qf, krow, jp, LD, dkt, scale, t, N, n_valid);
    body(jp, sb);
  }
}

// e = exp(s - max): CD rounds the difference and the exponential to bf16
template <bool CD>
__device__ __forceinline__ float exp_shift(float s, float m) {
  return CD ? bf16r(expf(bf16r(s - m))) : expf(s - m);
}

// DKT: the largest head-dim count (in 16s) the instantiation takes; the
// loops run to the launch's own count. CD: the compute-dtype softmax (the
// JAX naive/einsum/einsumT lowerings in bf16): logits, scaled logits,
// e = exp(s - max), the row sum and p = e / sum each rounded to bf16, with
// masked keys at finfo(bf16).min; otherwise the f32 softmax of the Pallas
// kernel. The products stay bf16 in, f32 accumulated in both.
template <int DKT, bool CD>
__global__ void __launch_bounds__(kMmaWarps * 32)
    vit_attention_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ out, int N, int H, int Dh,
                             int n_valid, float scale, long long qsb,
                             long long qsn, long long qsh, long long ksb,
                             long long ksn, long long ksh, long long vsb,
                             long long vsn, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = pad16(N);
  const int LD = Dh + 8;  // row stride in elements
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + NP * LD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  const bf16* qb = q + b * qsb + h * qsh;

  // stage K and V, key rows N..NP-1 zero-filled
  const int pieces = Dh / 8;
  for (int j = threadIdx.x / pieces; j < NP; j += blockDim.x / pieces) {
    const int c = (threadIdx.x % pieces) * 8;
    const int src = j < N ? j : 0;
    cp_async16(smem_u32(ks + j * LD + c), kb + src * ksn + c, j < N);
    cp_async16(smem_u32(vs + j * LD + c), vb + src * vsn + c, j < N);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int nkt = NP / 16, dkt = Dh / 16;
  const int n_full = min(N, n_valid) / 16;  // key blocks that need no mask
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row in it
  // this lane's ldmatrix row in K (block 0, dims 0..15) and in V (trans)
  const uint32_t krow =
      smem_u32(ks + ((mi >> 1) * 8 + mr) * LD + (mi & 1) * 8);
  const uint32_t vrow =
      smem_u32(vs + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);

  // q fragments of a 16-row tile (rows past N are zero), straight from
  // global memory
  uint32_t qf[DKT][4];
  auto load_q = [&](int tile) {
    const int r0 = tile * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < DKT; ++kk) {
      if (kk < dkt) {
        const int c = kk * 16 + 2 * t;
        qf[kk][0] = r0 < N ? load_u32(qb + r0 * qsn + c) : 0u;
        qf[kk][1] = r1 < N ? load_u32(qb + r1 * qsn + c) : 0u;
        qf[kk][2] = r0 < N ? load_u32(qb + r0 * qsn + c + 8) : 0u;
        qf[kk][3] = r1 < N ? load_u32(qb + r1 * qsn + c + 8) : 0u;
      }
    }
  };
  if (warp < nkt) load_q(warp);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int tile = warp; tile < nkt; tile += kMmaWarps) {
    if (tile != warp) load_q(tile);
    // pass 1: the row max of S (two partial maxima per row)
    float m[2][2] = {{-FLT_MAX, -FLT_MAX}, {-FLT_MAX, -FLT_MAX}};
    for_blocks<DKT, CD>(qf, krow, nkt, n_full, LD, dkt, scale, t, N, n_valid,
               [&](int, const float (&sb)[2][4]) {
#pragma unroll
                 for (int i = 0; i < 2; ++i)
#pragma unroll
                   for (int e = 0; e < 4; ++e)
                     m[i][e >> 1] = fmaxf(m[i][e >> 1], sb[i][e]);
               });
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(m[0][r], m[1][r]);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // pass 2: sum of e = exp(s - max), S recomputed
    float sm[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for_blocks<DKT, CD>(qf, krow, nkt, n_full, LD, dkt, scale, t, N, n_valid,
               [&](int, const float (&sb)[2][4]) {
#pragma unroll
                 for (int i = 0; i < 2; ++i)
#pragma unroll
                   for (int e = 0; e < 4; ++e)
                     sm[i][e >> 1] += exp_shift<CD>(sb[i][e], mx[e >> 1]);
               });
    float tot[2], rcp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tot[r] = sm[0][r] + sm[1][r];
      tot[r] += __shfl_xor_sync(0xffffffffu, tot[r], 1);
      tot[r] += __shfl_xor_sync(0xffffffffu, tot[r], 2);
      if (CD) tot[r] = bf16r(tot[r]);  // the bf16 row sum
      rcp[r] = 1.0f / tot[r];
    }
    // pass 3: p = e / sum rounded to bf16 as the A fragment of the key
    // block, and O += P V with V's fragments from ldmatrix.trans
    float o[2 * DKT][4];
#pragma unroll
    for (int j = 0; j < 2 * DKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for_blocks<DKT, CD>(qf, krow, nkt, n_full, LD, dkt, scale, t, N, n_valid,
               [&](int jp, const float (&sb)[2][4]) {
                 float p[2][4];
#pragma unroll
                 for (int i = 0; i < 2; ++i)
#pragma unroll
                   for (int e = 0; e < 4; ++e)
                     p[i][e] = div_by(exp_shift<CD>(sb[i][e], mx[e >> 1]),
                                      tot[e >> 1], rcp[e >> 1]);
                 const uint32_t pf[4] = {pack_bf16(p[0][0], p[0][1]),
                                         pack_bf16(p[0][2], p[0][3]),
                                         pack_bf16(p[1][0], p[1][1]),
                                         pack_bf16(p[1][2], p[1][3])};
#pragma unroll
                 for (int dp = 0; dp < DKT; ++dp) {
                   if (dp >= dkt) continue;
                   uint32_t bf[4];
                   ldsm_x4_t(vrow + (uint32_t)(jp * 16 * LD + dp * 16) * 2, bf);
                   mma_bf16(o[2 * dp], pf, bf[0], bf[1]);
                   mma_bf16(o[2 * dp + 1], pf, bf[2], bf[3]);
                 }
               });
    const int r0 = tile * 16 + g, r1 = r0 + 8;
    bf16* o0 = out + (((long long)b * N + r0) * H + h) * Dh + 2 * t;
    bf16* o1 = out + (((long long)b * N + r1) * H + h) * Dh + 2 * t;
#pragma unroll
    for (int j = 0; j < 2 * DKT; ++j) {
      if (j >= 2 * dkt) continue;
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16(o[j][0], o[j][1]);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(o1 + j * 8) = pack_bf16(o[j][2], o[j][3]);
    }
  }
}

template <int DKT, bool CD>
int launch_mma_t(const void* q, const void* k, const void* v, void* out,
                 int B, int N, int H, int Dh, const long long* st,
                 int n_valid, size_t smem, cudaStream_t stream) {
  auto kern = vit_attention_mma_kernel<DKT, CD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // CD: Dh ** -0.5 rounded once to f32, as a bf16 tensor times a Python
  // float takes it
  const float scale =
      CD ? (float)pow((double)Dh, -0.5) : 1.0f / sqrtf((float)Dh);
  kern<<<B * H, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N, H, Dh, n_valid,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

template <bool CD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int N, int H, int Dh, const long long* st, int n_valid,
               cudaStream_t stream) {
  if (Dh % 16) return (int)cudaErrorInvalidValue;
  // cp.async moves 16-byte pieces: K and V rows must start 16-byte aligned
  if (((uintptr_t)k | (uintptr_t)v) % 16 || (st[3] | st[4] | st[5]) % 8 ||
      (st[6] | st[7] | st[8]) % 8 || ((uintptr_t)q % 4) ||
      (st[0] | st[1] | st[2]) % 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(N, Dh);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (Dh <= 64)
    return launch_mma_t<4, CD>(q, k, v, out, B, N, H, Dh, st, n_valid, smem,
                               stream);
  return launch_mma_t<8, CD>(q, k, v, out, B, N, H, Dh, st, n_valid, smem,
                             stream);
}

}  // namespace

// q, k, v: (B, N, H, Dh) views whose last axis is contiguous, with element
// strides (batch, token, head) given for each; out: contiguous (B, N, H, Dh).
// Keys at positions >= n_valid are masked. N <= 256, Dh <= 128. Each entry
// launches on `stream` and returns cudaGetLastError() right after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take).
#define TL_K4_ARGS                                                          \
  const void *q, const void *k, const void *v, void *out, int B, int N,     \
      int H, int Dh, long long qsb, long long qsn, long long qsh,           \
      long long ksb, long long ksn, long long ksh, long long vsb,           \
      long long vsn, long long vsh, int n_valid, void *stream

static bool tl_k4_shape_ok(int B, int N, int H, int Dh, int n_valid) {
  return B >= 1 && N >= 1 && N <= kMaxN && H >= 1 && Dh >= 1 &&
         Dh <= kMaxDh && n_valid >= 1;
}

// f32 on CUDA cores
extern "C" int tl_vit_attention_f32(TL_K4_ARGS) {
  if (!tl_k4_shape_ok(B, N, H, Dh, n_valid)) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  return launch<float>(q, k, v, out, B, N, H, Dh, st, n_valid,
                       (cudaStream_t)stream);
}

// bf16 on the tensor cores; Dh % 16 == 0, K and V rows 16-byte aligned
extern "C" int tl_vit_attention_bf16_mma(TL_K4_ARGS) {
  if (!tl_k4_shape_ok(B, N, H, Dh, n_valid)) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  return launch_mma<false>(q, k, v, out, B, N, H, Dh, st, n_valid,
                           (cudaStream_t)stream);
}

// the same with the compute-dtype (bf16) softmax
extern "C" int tl_vit_attention_bf16_mma_cd(TL_K4_ARGS) {
  if (!tl_k4_shape_ok(B, N, H, Dh, n_valid)) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  return launch_mma<true>(q, k, v, out, B, N, H, Dh, st, n_valid,
                          (cudaStream_t)stream);
}
