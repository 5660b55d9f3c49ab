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
// In bf16 the order of operations follows the JAX kernel and the plain
// version (tracklab_torch/kernels/vit_attention.py, vit_attention_plain):
// scores in f32, times Dh^-1/2, keys at or past n_valid get finfo(f32).min,
// row max, e = exp(s - m), p = e / sum(e), p rounded to the input type, then
// p . v accumulated in f32 and rounded to the input type once; the bf16
// kernel is not an online-softmax (flash) kernel that divides at the end.
//
// What bounds it: at B = 384, N = 193, H = 12, Dh = 64 the work is
// 4 B H N^2 Dh = 43.9 GFLOP against 4 B N H Dh * 2 = 455 MB moved, 96 FLOP
// per byte: below the tensor-core ridge (~295 FLOP/B in bf16), so the card's
// bound is bytes.
//
// bf16: vit_attention_mma_kernel, on the tensor cores. The CTA
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
// f32 (KPR as the command line runs it; both softmax modes, which are one
// function in f32): vit_attention_tf32_kernel, on the tensor cores in
// 3xTF32. One TF32 product keeps 10 mantissa bits (~3 decimal digits), too
// few for f32; so each operand x is split with cvt.rna.tf32.f32 into
// hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact), and each product
// runs as three mma.sync m16n8k8 (lo hi, hi lo, then hi hi) into a fresh
// accumulator, added to the running sum with a rounded f32 add every k step
// or two (the tensor core truncates as it accumulates, a bias that grows
// with the length of the sum). The CTA stages K and V once with
// cp.async (rows of Dh + 4 floats where they fit: conflict-free ldmatrix
// for K's fragments, conflict-free 32-bit loads for V's), eight warps take
// 16-row query tiles and walk the keys in blocks of 32 with an online
// softmax: S for the block once, its row max and sum, O and the sum
// rescaled when the max grows, O += E V, and one division by the sum at
// the end. In f32 the plain version's "p rounded to the input type" is the
// identity, so dividing at the end differs from it by rounding only. Keys
// at or past n_valid, which the plain version sets to finfo(f32).min, get
// exp() = 0 exactly there: the kernel stages and walks only the first
// n_valid keys (with -inf past them in the last tile). The
// accumulator of S is used as P V's A fragment as it lies, with V's rows
// taken in the matching order (see tf32_block). What bounds it at (512,
// 193, 12, 64): 1.21 GB at 3.35 TB/s (0.362 ms) against 3 x 58.6 GFLOP at
// the TF32 peak of 494.7 TFLOP/s (0.355 ms), so bytes, barely.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 256;
constexpr int kMaxDh = 128;
constexpr size_t kMaxSmem = 232448;  // bytes one Hopper CTA may use

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

// ------------------------------------------ f32 on the tensor cores (3xTF32)
// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32: x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b, TF32 in, from a zero accumulator
__device__ __forceinline__ void mma_tf32_z(float (&c)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// 3xTF32: c (+)= a b with a = ah + al and b = bh + bl, the small products
// first, then ah bh (al bl, below f32's last bit, is left out). FRESH
// starts from zero: the tensor core truncates as it accumulates, so a long
// sum is taken as fresh k-step products added to an f32 accumulator with
// rounded adds (see csrc/csp.cu: mma_step).
template <bool FRESH>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (FRESH)
    mma_tf32_z(c, al, bh[0], bh[1]);
  else
    mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// a 16x8 A fragment (or an 8x8 B fragment) split into TF32 hi and lo
template <int R>
__device__ __forceinline__ void split_frag(const float (&x)[R], uint32_t (&hi)[R],
                                           uint32_t (&lo)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// 4-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

constexpr int kTfWarps = 8;
constexpr int kTfKeyTiles = 4;  // key n8 tiles per block of the online softmax

// Row stride (floats) of the staged K and V: pad8(Dh) + 4, whose rows start
// in distinct 4-bank groups (conflict-free ldmatrix for K, conflict-free
// 32-bit loads for V), else pad8(Dh), else pad4(Dh), the first that fits;
// 0 when none does.
__host__ __device__ inline int tf32_ld(int N, int Dh) {
  const int p8 = (Dh + 7) & ~7, p4 = (Dh + 3) & ~3;
  const int opts[3] = {p8 + 4, p8, p4};
  for (int i = 0; i < 3; ++i) {
    // K then V, N rows each; K's last key tile (up to 7 rows past N, 16
    // columns past a row) and V's last row (up to 4 columns past it) may
    // read past their rows: the allocation covers N + 8 rows and 16 floats
    const size_t rows = 2 * (size_t)N > (size_t)N + 8 ? 2 * (size_t)N : (size_t)N + 8;
    if ((rows * opts[i] + 16) * sizeof(float) <= kMaxSmem) return opts[i];
  }
  return 0;
}

__host__ __device__ inline size_t tf32_smem_bytes(int N, int Dh) {
  const size_t rows = 2 * (size_t)N > (size_t)N + 8 ? 2 * (size_t)N : (size_t)N + 8;
  return (rows * tf32_ld(N, Dh) + 16) * sizeof(float);
}

// One 16-row query tile's walk over a block of up to kTfKeyTiles n8 key
// tiles (keys n0 ..): S = q k^T (3xTF32), scaled, keys at or past n_keys
// at -inf (MASK: only the last block has any), the online softmax's max
// and sum, and O += E V (3xTF32) with E = exp(s - max) as the A fragment.
// The m16n8 accumulator of S gives lane (g, t) keys 2t and 2t + 1 of each
// n8 tile, and the m16n8k8 A fragment wants keys t and t + 4, so the P V
// product takes each tile's keys in the order 0, 2, 4, 6, 1, 3, 5, 7: the
// A fragment is the accumulator as it lies ({c0, c2, c1, c3}), and V's B
// fragment for lane (g, t) is rows 2t and 2t + 1 of the tile, dim g.
template <int DKT, bool MASK>
__device__ __forceinline__ void tf32_block(const float (&qf)[DKT][4], float (&o)[DKT][4],
                                           float (&m)[2], float (&l)[2], uint32_t krow,
                                           const float* vt, int n0, int nts, int LD, int dkt,
                                           int n_keys, float scale, int t) {
  float s[kTfKeyTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTfKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kp = 0; kp < DKT / 2; ++kp) {
    if (2 * kp >= dkt) break;
    uint32_t qh[2][4], ql[2][4];
    split_frag(qf[2 * kp], qh[0], ql[0]);
    split_frag(qf[2 * kp + 1], qh[1], ql[1]);
#pragma unroll
    for (int nt = 0; nt < kTfKeyTiles; ++nt) {
      if (MASK && nt >= nts) continue;
      // matrices: dims 16 kp + 0..3, 4..7 (b0, b1 of k step 2 kp), 8..11,
      // 12..15 (of k step 2 kp + 1), keys n0 + 8 nt + 0..7
      uint32_t b[4];
      ldsm_x4(krow + (uint32_t)((n0 + nt * 8) * LD + kp * 16) * 4, b);
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), bh[i >> 1][i & 1], bl[i >> 1][i & 1]);
      float c[4];
      mma_3xtf32<true>(c, qh[0], ql[0], bh[0], bl[0]);
      if (2 * kp + 1 < dkt) mma_3xtf32<false>(c, qh[1], ql[1], bh[1], bl[1]);
      add4(s[nt], c);
    }
  }
  // scale, mask, and the block's row maxima (rows g and g + 8)
  float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kTfKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale;
      if (MASK && n0 + nt * 8 + 2 * t + (e & 1) >= n_keys) x = -INFINITY;
      s[nt][e] = x;
      bm[e >> 1] = fmaxf(bm[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
    bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
    const float mn = fmaxf(m[r], bm[r]);
    alpha[r] = expf(m[r] - mn);  // 0 on the first block (m = -inf)
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int dn = 0; dn < DKT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];
#pragma unroll
  for (int nt = 0; nt < kTfKeyTiles; ++nt) {
    if (MASK && nt >= nts) continue;
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = expf(s[nt][i] - m[i >> 1]);
      l[i >> 1] += e[i];
    }
    const float pa[4] = {e[0], e[2], e[1], e[3]};
    uint32_t ah[4], al[4];
    split_frag(pa, ah, al);
    const int key = n0 + nt * 8 + 2 * t;
    const float* v0 = vt + (n0 + nt * 8) * LD;
    const bool ok0 = !MASK || key < n_keys, ok1 = !MASK || key + 1 < n_keys;
#pragma unroll
    for (int dn = 0; dn < DKT; ++dn) {
      if (dn >= dkt) continue;
      const float vv[2] = {ok0 ? v0[dn * 8] : 0.f, ok1 ? v0[LD + dn * 8] : 0.f};
      uint32_t vh[2], vl[2];
      split_frag(vv, vh, vl);
      float c[4];
      mma_3xtf32<true>(c, ah, al, vh, vl);
      add4(o[dn], c);
    }
  }
}

// f32 attention on the tensor cores in 3xTF32, one CTA per (b, h): K and V
// staged once with cp.async (rows of LD floats, the head-dim tail
// zero-filled; only the n_keys = min(N, n_valid) keys that carry weight),
// eight warps each taking 16-row query tiles with q's fragments straight
// from global memory, walking the keys in blocks of 32 with an online
// softmax (flash attention): O and the row sum are rescaled when the row
// max grows, and O is divided by the sum once at the end. DKT: the largest
// head-dim count (in 8s) of the instantiation. VEC4: K and V rows start on
// 16 bytes and Dh % 4 == 0 (16-byte copies), else 4-byte copies.
template <int DKT>
__global__ void __launch_bounds__(kTfWarps * 32, DKT <= 8 ? 2 : 1)
    vit_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out, int N,
                              int H, int Dh, int LD, int n_keys, int vec4, float scale,
                              long long qsb, long long qsn, long long qsh, long long ksb,
                              long long ksn, long long ksh, long long vsb, long long vsn,
                              long long vsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + (size_t)N * LD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  const float* qb = q + b * qsb + h * qsh;

  // stage the n_keys rows of K and V that carry weight, and one more (with
  // LD < pad8(Dh), K's last k step reads the start of the next row, against
  // zeros of q); columns Dh .. LD - 1 zero-filled
  const int rows = min(N, n_keys + 1);
  if (vec4) {
    const int pieces = LD / 4;
    for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
      const int j = i / pieces, c = (i - j * pieces) * 4;
      const bool ok = c < Dh;
      cp_async16(smem_u32(ks + j * LD + c), ok ? kb + j * ksn + c : kb, ok);
      cp_async16(smem_u32(vs + j * LD + c), ok ? vb + j * vsn + c : vb, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
      const int j = i / LD, c = i - j * LD;
      const bool ok = c < Dh;
      cp_async4(smem_u32(ks + j * LD + c), ok ? kb + j * ksn + c : kb, ok);
      cp_async4(smem_u32(vs + j * LD + c), ok ? vb + j * vsn + c : vb, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int nqt = (N + 15) / 16, dkt = (Dh + 7) / 8;
  const int n_full = n_keys / (8 * kTfKeyTiles);  // key blocks with no mask
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row in K: matrix lane / 8 (dims 4 (lane / 8) ..),
  // key row lane % 8
  const uint32_t krow = smem_u32(ks + (lane & 7) * LD + (lane >> 3) * 4);
  const float* vt = vs + 2 * t * LD + g;  // V row 2t, dim g of a key tile

  // q fragments of a 16-row tile (rows past N, dims past Dh are zero)
  float qf[DKT][4];
  auto load_q = [&](int tile) {
    const int r0 = tile * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < DKT; ++kk) {
      const int c0 = kk * 8 + t, c1 = c0 + 4;
      qf[kk][0] = r0 < N && c0 < Dh ? qb[r0 * qsn + c0] : 0.f;
      qf[kk][1] = r1 < N && c0 < Dh ? qb[r1 * qsn + c0] : 0.f;
      qf[kk][2] = r0 < N && c1 < Dh ? qb[r0 * qsn + c1] : 0.f;
      qf[kk][3] = r1 < N && c1 < Dh ? qb[r1 * qsn + c1] : 0.f;
    }
  };
  if (warp < nqt) load_q(warp);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int tile = warp; tile < nqt; tile += kTfWarps) {
    if (tile != warp) load_q(tile);
    float o[DKT][4];
#pragma unroll
    for (int dn = 0; dn < DKT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll 1
    for (int jb = 0; jb < n_full; ++jb)
      tf32_block<DKT, false>(qf, o, m, l, krow, vt, jb * 8 * kTfKeyTiles, kTfKeyTiles, LD,
                             dkt, n_keys, scale, t);
    const int n0 = n_full * 8 * kTfKeyTiles;
    if (n0 < n_keys)
      tf32_block<DKT, true>(qf, o, m, l, krow, vt, n0, (n_keys - n0 + 7) / 8, LD, dkt,
                            n_keys, scale, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int r0 = tile * 16 + g, r1 = r0 + 8;
    float* o0 = out + (((long long)b * N + r0) * H + h) * Dh;
    float* o1 = out + (((long long)b * N + r1) * H + h) * Dh;
#pragma unroll
    for (int dn = 0; dn < DKT; ++dn) {
      if (dn >= dkt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = dn * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        if (c < Dh && (r ? r1 : r0) < N)
          (r ? o1 : o0)[c] = o[dn][e] / l[r];
      }
    }
  }
}

template <int DKT>
int launch_tf32_t(const void* q, const void* k, const void* v, void* out, int B, int N,
                  int H, int Dh, int LD, int n_keys, int vec4, const long long* st,
                  cudaStream_t stream) {
  auto kern = vit_attention_tf32_kernel<DKT>;
  const size_t smem = tf32_smem_bytes(N, Dh);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, kTfWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N, H, Dh, LD, n_keys, vec4,
      1.0f / sqrtf((float)Dh), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return (int)cudaGetLastError();
}

int launch_tf32(const void* q, const void* k, const void* v, void* out, int B, int N, int H,
                int Dh, const long long* st, int n_valid, cudaStream_t stream) {
  const int LD = tf32_ld(N, Dh);
  if (LD == 0) return (int)cudaErrorInvalidValue;
  const int n_keys = n_valid < N ? n_valid : N;
  const int vec4 = ((uintptr_t)k | (uintptr_t)v) % 16 == 0 && Dh % 4 == 0 &&
                   (st[3] | st[4] | st[5] | st[6] | st[7] | st[8]) % 4 == 0;
  if (Dh <= 64)
    return launch_tf32_t<8>(q, k, v, out, B, N, H, Dh, LD, n_keys, vec4, st, stream);
  return launch_tf32_t<16>(q, k, v, out, B, N, H, Dh, LD, n_keys, vec4, st, stream);
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

// f32 on the tensor cores in 3xTF32 (both softmax modes: in f32 they are
// one function)
extern "C" int tl_vit_attention_f32(TL_K4_ARGS) {
  if (!tl_k4_shape_ok(B, N, H, Dh, n_valid)) return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  return launch_tf32(q, k, v, out, B, N, H, Dh, st, n_valid, (cudaStream_t)stream);
}

// The shared memory tl_vit_attention_f32 asks for at (N, Dh), 0 where it
// takes no such shape; kernels/vit_attention.py's route() plans the same.
extern "C" long long tl_vit_attention_f32_smem_bytes(int N, int Dh) {
  if (N < 1 || N > kMaxN || Dh < 1 || Dh > kMaxDh || tf32_ld(N, Dh) == 0) return 0;
  return (long long)tf32_smem_bytes(N, Dh);
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
