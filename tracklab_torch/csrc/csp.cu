// K3: one whole YOLOX CSPLayer per (frame, spatial tile), for Hopper (sm_90a),
// or, where no tile fits, stage by stage over the whole batch.
//
// Replaces the Pallas TPU kernel tracklab_tpu/ops/csp_pallas.py
// (_make_kernel, launched by fused_csplayer). It computes, with BN folded
// into the weights and SiLU after every conv:
//   a = silu(x Wm + bm)                       main 1x1 projection
//   s = silu(x Ws + bs)                       short 1x1 projection
//   n times: t = silu(a W1 + b1); a = silu(conv3x3(t; W3) + b3) (+ a)
//   out = silu([a, s] Wf + bf)
// rounding a, s and t to the storage type after each SiLU, and adding the
// residual in f32 before rounding, exactly where the TPU kernel does.
//
// The TPU kernel holds a whole 80x80 frame in VMEM; 227 KB of shared memory
// does not hold one 80x80x64 bf16 intermediate (800 KB). So this kernel tiles
// in space: one CTA per (frame, TH x TW output tile) loads its input with an
// n-pixel halo, computes both projections over the haloed region, and each
// 3x3 shrinks the valid region by one pixel. `a` and `t` stay in shared
// memory (`s` reuses `t`'s buffer once the bottlenecks are done); only the
// tile's output is written. Pixels of the region outside the image get
// t = 0, which is the 3x3 conv's zero padding.
//
// What bounds it: operations. The seven YOLOX-s CSPLayers at 640x640 do
// ~9.1 GFLOP per frame against ~3.3 MB of input+output at the largest
// (dark3), ~600 FLOP/B, above the H100's ~295 FLOP/B balance point; the
// halo's recomputation adds to the operations (the projections and the
// first bottlenecks run over the haloed region: ~1.4x the layer's own work
// for a 16x16 tile at n = 3), which kernels/csp.py's tile planner weighs
// against shared memory.
//
// bf16 (every path): csp_mma_kernel, on the tensor cores. Each stage is a
// GEMM on mma.sync m16n8k16 (bf16 in, f32 accumulate): M = the pixels of the
// stage's rectangle, N = output channels, K = input channels. A CTA tile is
// 256 x 64 (wide ring): sixteen warps of 32 x 32, four to a scheduler, since
// the region's buffers leave room for one CTA per SM. The A rows come from
// ldmatrix with one row address per lane, so a row is any pixel of the
// region: the 3x3 conv is nine shifted gathers of `t` and the shrinking
// valid rectangle costs nothing. `a` and `t` have a row stride of ch + 8
// elements (conflict-free ldmatrix; the 8 pad columns are zero, so a K tail
// of 8 reads zeros). The weights, packed [out, in] (K-contiguous, the
// col-major B operand), and for the projections the input x of the CTA
// tile's rows (zero-filled outside the image), stream through a cp.async
// ring in K chunks, one __syncthreads per chunk, the next chunks in flight
// while one is multiplied. The ring is the wide one (three slots, 76,800 B)
// unless the haloed buffers leave no room for it at any tile: then a compact
// one (two slots of 16- and 32-wide K chunks, a 64 x 64 CTA tile of four
// warps, 12,288 B), which lets the n = 9 layer of YOLOX-l and the ch = 640
// layers of YOLOX-x fuse. The epilogue works on each accumulator fragment:
// bias, SiLU in f32, the residual, rounding, zero outside the image, then
// the write to shared memory or to the NHWC output.
//
// Measured on the H100, the tensor pipe is not what limits this design:
// instruction issue and latency are. So the chunk stream advances cursors
// (no integer division), a whole chunk runs without guards (the next k
// step's ldmatrix can be hoisted), the bias is loaded before the K loop, a
// row's pixel is a multiply-high, and the SiLU uses the fast exp and
// division intrinsics (the result is rounded to bf16 right after).
//
// f32: csp_kernel on CUDA cores (f32 on tensor cores would be TF32): each
// thread a block of 8 pixels x 4 channels, weights [in, out] read from
// global memory as 4-wide vectors.
//
// The staged route, for a layer whose haloed buffers exceed shared memory at
// every tile (the region of a single output pixel, (2n + 1)^2 pixels of a and
// t, is already too large: YOLOX-l dark4, YOLOX-x dark3 and dark4 in bf16,
// more in f32): a, s and t live in device memory (scratch the caller passes;
// 6.1 MB for YOLOX-x dark4 at batch 2, within the 50 MB L2), and the
// layer's 2n + 3 stages run as GEMMs over all B*H*W pixels, one grid per
// stage in stream order, so there is no halo and nothing is recomputed. bf16
// stages (csp_staged_mma_kernel) use the same mma.sync fragments with the A
// rows gathered by cp.async (the 3x3's taps as pixel shifts, zero-filled
// outside the frame); f32 stages (csp_staged_f32_kernel) the CUDA-core work
// item above. Rounding and the residual are as in the tiled kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int PB = 8;  // pixels per work item
constexpr int CB = 4;  // output channels per work item

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <typename T>
struct CspArgs {
  const T* x;
  T* out;
  const T* wm;
  const float* bm;
  const T* ws;
  const float* bs;
  const T* w1;
  const float* b1;
  const T* w3;
  const float* b3;
  const T* wf;
  const float* bf;
  int H, W, cin, ch, cout, n, shortcut, th, tw, tiles_x;
};

// acc[i][cc] += sum_k src[i][k] * w[k * N + c + cc], k in [0, K), K % 4 == 0
template <typename T>
__device__ __forceinline__ void mac(float (&acc)[PB][CB], const T* const (&src)[PB],
                                    const T* __restrict__ w, int K, int N, int c) {
  for (int k = 0; k < K; k += 4) {
    float wv[4][CB];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load4(w + (size_t)(k + kk) * N + c, wv[kk]);
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      float av[4];
      load4(src[i] + k, av);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cc = 0; cc < CB; ++cc) acc[i][cc] = fmaf(av[kk], wv[kk][cc], acc[i][cc]);
    }
  }
}

enum Stage { kProjA, kBottle1x1, kBottle3x3, kProjS, kFinal };

// One stage over the region rectangle [r0, r1) x [c0, c1) and N output
// channels. Region pixel (r, q) is image pixel (gy0 + r, gx0 + q).
template <typename T, int STAGE>
__device__ void run_stage(const CspArgs<T>& A, const T* __restrict__ xb, T* sm_a, T* sm_t,
                          T* __restrict__ outb, int r0, int r1, int c0, int c1, int gy0,
                          int gx0, const T* __restrict__ w, const float* __restrict__ bias,
                          int N) {
  const int RW = A.tw + 2 * A.n;
  const int cols = c1 - c0;
  const int npix = (r1 - r0) * cols;
  const int ngroups = N / CB;
  const int nwork = ngroups * ((npix + PB - 1) / PB);
  for (int work = threadIdx.x; work < nwork; work += kThreads) {
    const int c = (work % ngroups) * CB;
    const int pb = work / ngroups;
    int pr[PB];
    int gpix[PB];
    bool inside[PB];
    float acc[PB][CB];
    float bv[CB];
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) bv[cc] = bias[c + cc];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int pix = pb * PB + i;
      const bool ok = pix < npix;
      const int r = r0 + (ok ? pix / cols : 0);
      const int q = c0 + (ok ? pix % cols : 0);
      const int gy = gy0 + r, gx = gx0 + q;
      pr[i] = ok ? r * RW + q : -1;
      inside[i] = ok && gy >= 0 && gy < A.H && gx >= 0 && gx < A.W;
      gpix[i] = inside[i] ? gy * A.W + gx : 0;
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) acc[i][cc] = bv[cc];
    }
    if (STAGE == kProjA || STAGE == kProjS) {
      const T* src[PB];
#pragma unroll
      for (int i = 0; i < PB; ++i) src[i] = xb + (size_t)gpix[i] * A.cin;
      mac(acc, src, w, A.cin, N, c);
    } else if (STAGE == kBottle1x1) {
      const T* src[PB];
#pragma unroll
      for (int i = 0; i < PB; ++i) src[i] = sm_a + (pr[i] < 0 ? 0 : pr[i]) * A.ch;
      mac(acc, src, w, A.ch, N, c);
    } else if (STAGE == kBottle3x3) {
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const int shift = (dy - 1) * RW + (dx - 1);
          const T* src[PB];
#pragma unroll
          for (int i = 0; i < PB; ++i)
            src[i] = sm_t + (pr[i] < 0 ? 0 : pr[i] + shift) * A.ch;
          mac(acc, src, w + (size_t)(dy * 3 + dx) * A.ch * N, A.ch, N, c);
        }
      }
    } else {  // kFinal: concat([a, s]) @ Wf
      const T* src[PB];
#pragma unroll
      for (int i = 0; i < PB; ++i) src[i] = sm_a + (pr[i] < 0 ? 0 : pr[i]) * A.ch;
      mac(acc, src, w, A.ch, N, c);
#pragma unroll
      for (int i = 0; i < PB; ++i) src[i] = sm_t + (pr[i] < 0 ? 0 : pr[i]) * A.ch;
      mac(acc, src, w + (size_t)A.ch * N, A.ch, N, c);
    }
    // epilogue
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      if (pr[i] < 0) continue;
      float v[CB];
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) v[cc] = silu(acc[i][cc]);
      if (STAGE == kFinal) {
        if (inside[i]) store4(outb + (size_t)gpix[i] * A.cout + c, v);
      } else if (STAGE == kBottle3x3) {
        T* dst = sm_a + pr[i] * A.ch + c;
        if (A.shortcut) {
          float old[CB];
          load4(dst, old);
#pragma unroll
          for (int cc = 0; cc < CB; ++cc) v[cc] += old[cc];
        }
        store4(dst, v);
      } else {
        T* dst = (STAGE == kProjA ? sm_a : sm_t) + pr[i] * A.ch + c;
        if (!inside[i]) {
#pragma unroll
          for (int cc = 0; cc < CB; ++cc) v[cc] = 0.f;
        }
        store4(dst, v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) csp_kernel(CspArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RH = A.th + 2 * A.n, RW = A.tw + 2 * A.n;
  T* sm_a = reinterpret_cast<T*>(smem_raw);
  T* sm_t = sm_a + (size_t)RH * RW * A.ch;
  const int b = blockIdx.y;
  const int ty = blockIdx.x / A.tiles_x, tx = blockIdx.x % A.tiles_x;
  const int gy0 = ty * A.th - A.n, gx0 = tx * A.tw - A.n;
  const T* xb = A.x + (size_t)b * A.H * A.W * A.cin;
  T* outb = A.out + (size_t)b * A.H * A.W * A.cout;
  const int ch = A.ch, n = A.n;

  run_stage<T, kProjA>(A, xb, sm_a, sm_t, outb, 0, RH, 0, RW, gy0, gx0, A.wm, A.bm, ch);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    run_stage<T, kBottle1x1>(A, xb, sm_a, sm_t, outb, i, RH - i, i, RW - i, gy0, gx0,
                             A.w1 + (size_t)i * ch * ch, A.b1 + (size_t)i * ch, ch);
    __syncthreads();
    run_stage<T, kBottle3x3>(A, xb, sm_a, sm_t, outb, i + 1, RH - i - 1, i + 1, RW - i - 1,
                             gy0, gx0, A.w3 + (size_t)i * 9 * ch * ch,
                             A.b3 + (size_t)i * ch, ch);
    __syncthreads();
  }
  run_stage<T, kProjS>(A, xb, sm_a, sm_t, outb, n, n + A.th, n, n + A.tw, gy0, gx0, A.ws,
                       A.bs, ch);
  __syncthreads();
  run_stage<T, kFinal>(A, xb, sm_a, sm_t, outb, n, n + A.th, n, n + A.tw, gy0, gx0, A.wf,
                       A.bf, A.cout);
}

// ------------------------------------------------ bf16 on the tensor cores
typedef __nv_bfloat16 bf16;

constexpr int kMT = 2;              // m16 tiles per warp (warp tile 16 kMT x 32)
constexpr int kBN = 64;             // CTA tile channels: 2 warps of 32
constexpr size_t kMaxSmem = 232448;  // bytes one Hopper CTA may use

// A cp.async ring: WARPS_M warps along M (CTA tile rows kBM), K chunks of KX
// for the x-fed projections and KW for the stages fed from a and t, SLOTS
// slots (SLOTS - 1 chunks in flight). A slot holds a kBM x KX chunk of x and
// a kBN x KX chunk of weights, or a kBN x KW chunk of weights, rows padded
// by 8 elements.
template <int WARPS_M, int KX, int KW, int SLOTS>
struct Ring {
  static constexpr int kWarpsM = WARPS_M, kKX = KX, kKW = KW, kSlots = SLOTS;
  static constexpr int kThreads = WARPS_M * 2 * 32;
  static constexpr int kBM = WARPS_M * 16 * kMT;
  static constexpr int kSlotBytes = (kBM + kBN) * (KX + 8) * 2 > kBN * (KW + 8) * 2
                                        ? (kBM + kBN) * (KX + 8) * 2
                                        : kBN * (KW + 8) * 2;
  static constexpr size_t kBytes = (size_t)SLOTS * kSlotBytes;
};
// the wide ring (76,800 B), and the compact one (12,288 B) for layers whose
// haloed buffers leave too little room for it (e.g. YOLOX-l dark3, n = 9)
using Wide = Ring<8, 32, 64, 3>;
using Compact = Ring<2, 16, 32, 2>;

__host__ __device__ inline size_t mma_smem_bytes(int th, int tw, int n, int ch, int ring) {
  return 2 * (size_t)(th + 2 * n) * (tw + 2 * n) * (ch + 8) * sizeof(bf16) +
         (ring ? Compact::kBytes : Wide::kBytes);
}

__host__ __device__ inline size_t f32_smem_bytes(int th, int tw, int n, int ch) {
  return 2 * (size_t)(th + 2 * n) * (tw + 2 * n) * ch * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// SiLU of the tensor-core kernel's epilogue, with the fast exp and division
// intrinsics (a few ulp of f32; the result is rounded to bf16 next)
__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// Position in a stage's stream of K chunks: CTA tile (mb, nb), K segment
// seg, chunk offset k0 within the segment. Advanced one chunk at a time, so
// the stream needs no integer division.
struct Cursor {
  int mb, nb, seg, k0;
  __device__ __forceinline__ bool tile_start() const { return seg == 0 && k0 == 0; }
  __device__ __forceinline__ void next(int KC, int K, int segs, int nnb) {
    k0 += KC;
    if (k0 < K) return;
    k0 = 0;
    if (++seg < segs) return;
    seg = 0;
    if (++nb == nnb) {
      nb = 0;
      ++mb;
    }
  }
};

// One stage over the region rectangle [r0, r1) x [c0, c1) (region pixel
// (r, q) is image pixel (gy0 + r, gx0 + q)) and N output channels, as a GEMM
// whose CTA tiles (C::kBM rows x 64 channels) and K chunks run as one stream
// through the cp.async ring C, C::kSlots - 1 chunks ahead. w is packed
// [out, in]; for the 3x3 the nine taps and for the final 1x1 the [a; s]
// halves are the K segments.
template <typename C, int STAGE>
__device__ void mma_stage(const CspArgs<bf16>& A, const bf16* __restrict__ xb, bf16* sm_a,
                          bf16* sm_t, unsigned char* ring, bf16* __restrict__ outb, int r0,
                          int r1, int c0, int c1, int gy0, int gx0,
                          const bf16* __restrict__ w, const float* __restrict__ bias, int N) {
  constexpr int kWarpsM = C::kWarpsM, kMmaThreads = C::kThreads, kBM = C::kBM;
  constexpr int kKX = C::kKX, kSlots = C::kSlots, kSlotBytes = C::kSlotBytes;
  constexpr bool kX = STAGE == kProjA || STAGE == kProjS;
  constexpr int KC = kX ? kKX : C::kKW;
  constexpr int kSegs = STAGE == kBottle3x3 ? 9 : (STAGE == kFinal ? 2 : 1);
  constexpr int kPieces = KC / 8;              // 16-byte pieces in a chunk row
  constexpr int kBPieces = kBN * kPieces, kXPieces = kBM * (kKX / 8);
  constexpr int kBPasses = (kBPieces + kMmaThreads - 1) / kMmaThreads;
  constexpr int kXPasses = (kXPieces + kMmaThreads - 1) / kMmaThreads;
  constexpr uint32_t kBOff = kX ? kBM * (kKX + 8) * 2 : 0;  // B within a slot
  const int RW = A.tw + 2 * A.n;
  const int LD = A.ch + 8;
  const int K = kX ? A.cin : A.ch;             // per segment
  const int ldw = STAGE == kFinal ? 2 * A.ch : K;
  const int seg_w = STAGE == kBottle3x3 ? A.ch * A.ch : A.ch;
  const int cols = c1 - c0;
  const int M = (r1 - r0) * cols;
  // m / cols as a multiply-high: exact for m, cols < 2^16 (m % cols >= 1
  // keeps the quotient's error below the next integer)
  const uint32_t cmagic = 0xffffffffu / cols + 1;
  auto divc = [&](int m) { return (int)__umulhi((uint32_t)m, cmagic); };
  const int nnb = (N + kBN - 1) / kBN;
  const int total = (M + kBM - 1) / kBM * nnb * kSegs * ((K + KC - 1) / KC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  constexpr int kWM = 16 * kMT;                // warp tile rows
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t ring_s = smem_u32(ring);

  // this thread's copies: pieces tid + j * kMmaThreads of the weight chunk
  // (row-major, kPieces a row) and of the x chunk (kKX / 8 a row)
  int xoff[kXPasses];  // x element offset of each A row, -1: zero-fill
  Cursor lc = {0, 0, 0, 0};
  int lslot = 0;
  auto load = [&]() {
    const uint32_t slot = ring_s + (uint32_t)lslot * kSlotBytes;
    const bf16* wseg = w + lc.seg * seg_w;
#pragma unroll
    for (int j = 0; j < kBPasses; ++j) {
      const int i = tid + j * kMmaThreads;
      if (kBPieces % kMmaThreads && i >= kBPieces) break;
      const int nl = i / kPieces, kp_b = (i % kPieces) * 8;
      const int nn = lc.nb * kBN + nl, k = lc.k0 + kp_b;
      const bool ok = nn < N && k < K;
      cp_async16(slot + kBOff + (uint32_t)(nl * (KC + 8) + kp_b) * 2,
                 ok ? wseg + nn * ldw + k : w, ok);
    }
    if (kX) {
      if (lc.tile_start()) {
#pragma unroll
        for (int j = 0; j < kXPasses; ++j) {
          const int m = lc.mb * kBM + (tid + j * kMmaThreads) / (kKX / 8);
          xoff[j] = -1;
          if (m < M) {
            const int qm = divc(m);
            const int gy = gy0 + r0 + qm, gx = gx0 + c0 + m - qm * cols;
            if (gy >= 0 && gy < A.H && gx >= 0 && gx < A.W) xoff[j] = (gy * A.W + gx) * A.cin;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kXPasses; ++j) {
        const int i = tid + j * kMmaThreads;
        if (kXPieces % kMmaThreads && i >= kXPieces) break;
        const int kp_a = (i % (kKX / 8)) * 8, k = lc.k0 + kp_a;
        const bool ok = xoff[j] >= 0 && k < K;
        cp_async16(slot + (uint32_t)(i / (kKX / 8) * (kKX + 8) + kp_a) * 2,
                   ok ? xb + xoff[j] + k : xb, ok);
      }
    }
    lc.next(KC, K, kSegs, nnb);
    lslot = lslot == kSlots - 1 ? 0 : lslot + 1;
  };

  float acc[kMT][4][4];
  float2 bv[4];  // bias of this lane's output channels in the CTA tile
  uint32_t arow[kMT];  // shared address of this lane's A row (smem-fed), per m16 tile
  Cursor cc = {0, 0, 0, 0};
  int cslot = 0;
  constexpr int kAhead = kSlots - 1;  // chunks in flight
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < total) load();
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int gi = 0; gi < total; ++gi) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    __syncthreads();  // chunk gi landed; the slot of chunk gi - 1 is free
    if (gi + kAhead < total) load();
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const int mw = cc.mb * kBM + wm * kWM;  // this warp's first row
    const int nw = cc.nb * kBN + wn * 32;  // this warp's first channel
    if (cc.tile_start()) {
#pragma unroll
      for (int a = 0; a < kMT; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
      if (!kX) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          int m = mw + mt * 16 + (lane & 15);
          if (m >= M) m = 0;  // a valid row; its result is not stored
          const int qm = divc(m);
          arow[mt] = smem_u32(sm_a + ((r0 + qm) * RW + c0 + m - qm * cols) * LD +
                              (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bv[nt] = nw + nt * 8 < N ? *reinterpret_cast<const float2*>(bias + nw + nt * 8 + 2 * t)
                                 : make_float2(0.f, 0.f);
    }
    const uint32_t slot = ring_s + (uint32_t)cslot * kSlotBytes;
    const int ksteps = (min(KC, K - cc.k0) + 15) / 16;
    uint32_t abase[kMT];
    if (!kX) {
      // the segment's source (t for the 3x3 and the s half of the final 1x1)
      // and the 3x3 tap's pixel shift, as a byte offset from the a row
      const bool from_t = STAGE == kBottle3x3 || (STAGE == kFinal && cc.seg == 1);
      const int shift = STAGE == kBottle3x3 ? (cc.seg / 3 - 1) * RW + (cc.seg % 3 - 1) : 0;
      const uint32_t off =
          (uint32_t)(((from_t ? (sm_t - sm_a) : 0) + shift * LD + cc.k0) * 2);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) abase[mt] = arow[mt] + off;
    }
    // a whole chunk of a whole warp tile runs without guards, so the next
    // step's ldmatrix can be hoisted above this step's mma
    auto chunk = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (!kWhole && kk >= ksteps) break;
        uint32_t af[kMT][4], bfr[2][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (!kWhole && mw + mt * 16 >= M) continue;
          const uint32_t addr =
              kX ? slot + (uint32_t)((wm * kWM + mt * 16 + (lane & 15)) * (kKX + 8) + kk * 16 +
                                     (lane >> 4) * 8) * 2
                 : abase[mt] + kk * 32;
          ldsm_x4(addr, af[mt]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (!kWhole && nw + np * 16 >= N) continue;
          ldsm_x4(slot + kBOff + (uint32_t)((wn * 32 + np * 16 + (mi >> 1) * 8 + mr) * (KC + 8) +
                                            kk * 16 + (mi & 1) * 8) * 2,
                  bfr[np]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (!kWhole && mw + mt * 16 >= M) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (!kWhole && nw + np * 16 >= N) continue;
            mma_bf16(acc[mt][2 * np], af[mt], bfr[np][0], bfr[np][1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np][2], bfr[np][3]);
          }
        }
      }
    };
    if (ksteps == KC / 16 && mw + kWM <= M && nw + 32 <= N)
      chunk(std::true_type{});
    else
      chunk(std::false_type{});

    const bool tile_end = cc.seg == kSegs - 1 && cc.k0 + KC >= K;
    cc.next(KC, K, kSegs, nnb);
    cslot = cslot == kSlots - 1 ? 0 : cslot + 1;
    if (tile_end) {  // epilogue of this CTA tile
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = mw + mt * 16 + g + half * 8;
          if (m >= M) continue;
          const int qm = divc(m);
          const int r = r0 + qm, q = c0 + m - qm * cols;
          const int gy = gy0 + r, gx = gx0 + q;
          const bool inside = gy >= 0 && gy < A.H && gx >= 0 && gx < A.W;
          bf16* dst = STAGE == kFinal ? outb + (gy * A.W + gx) * A.cout + nw + 2 * t
                                      : (STAGE == kProjA || STAGE == kBottle3x3 ? sm_a : sm_t) +
                                            (r * RW + q) * LD + nw + 2 * t;
          if (STAGE == kFinal && !inside) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nw + nt * 8 >= N) continue;
            float v0 = silu_fast(acc[mt][nt][2 * half] + bv[nt].x);
            float v1 = silu_fast(acc[mt][nt][2 * half + 1] + bv[nt].y);
            __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + nt * 8);
            if (STAGE == kBottle3x3 && A.shortcut) {
              const float2 old = __bfloat1622float2(*d);  // residual in f32
              v0 += old.x;
              v1 += old.y;
            }
            if ((STAGE == kProjA || STAGE == kBottle1x1 || STAGE == kProjS) && !inside)
              v0 = v1 = 0.f;  // t = 0 outside the image: the 3x3's zero padding
            *d = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename C>
__global__ void __launch_bounds__(C::kThreads) csp_mma_kernel(CspArgs<bf16> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RH = A.th + 2 * A.n, RW = A.tw + 2 * A.n;
  const int LD = A.ch + 8;
  bf16* sm_a = reinterpret_cast<bf16*>(smem_raw);
  bf16* sm_t = sm_a + (size_t)RH * RW * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sm_t + (size_t)RH * RW * LD);
  const int b = blockIdx.y;
  const int ty = blockIdx.x / A.tiles_x, tx = blockIdx.x % A.tiles_x;
  const int gy0 = ty * A.th - A.n, gx0 = tx * A.tw - A.n;
  const bf16* xb = A.x + (size_t)b * A.H * A.W * A.cin;
  bf16* outb = A.out + (size_t)b * A.H * A.W * A.cout;
  const int ch = A.ch, n = A.n;

  // the 8 pad columns of every row of a and t are zero (a K tail reads them)
  for (int i = threadIdx.x; i < 2 * RH * RW; i += blockDim.x)
    *reinterpret_cast<uint4*>(sm_a + (size_t)i * LD + ch) = make_uint4(0, 0, 0, 0);

  mma_stage<C, kProjA>(A, xb, sm_a, sm_t, ring, outb, 0, RH, 0, RW, gy0, gx0, A.wm, A.bm, ch);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    mma_stage<C, kBottle1x1>(A, xb, sm_a, sm_t, ring, outb, i, RH - i, i, RW - i, gy0, gx0,
                             A.w1 + (size_t)i * ch * ch, A.b1 + (size_t)i * ch, ch);
    __syncthreads();
    mma_stage<C, kBottle3x3>(A, xb, sm_a, sm_t, ring, outb, i + 1, RH - i - 1, i + 1,
                             RW - i - 1, gy0, gx0, A.w3 + (size_t)i * 9 * ch * ch,
                             A.b3 + (size_t)i * ch, ch);
    __syncthreads();
  }
  mma_stage<C, kProjS>(A, xb, sm_a, sm_t, ring, outb, n, n + A.th, n, n + A.tw, gy0, gx0, A.ws,
                       A.bs, ch);
  __syncthreads();
  mma_stage<C, kFinal>(A, xb, sm_a, sm_t, ring, outb, n, n + A.th, n, n + A.tw, gy0, gx0, A.wf,
                       A.bf, A.cout);
}

// ------------------------------------------------------ the staged route
// One stage of a layer no tile fits, over all B*H*W pixels at once:
//   dst[m, :N] = silu(sum over segments of src_seg[m] W_seg + bias) (+ dst[m])
// src and dst are (M, K) and (M, N) row-major. SEGS 1: a 1x1 conv; 9: the
// 3x3, segment dy * 3 + dx reading pixel (y + dy - 1, x + dx - 1) of src0,
// zero outside the frame; 2: the final 1x1, segment 0 from src0 (a),
// segment 1 from src1 (s).
template <typename T>
struct StagedArgs {
  const T* src0;
  const T* src1;
  const T* w;      // segment s at w + s * seg_w, rows of ldw (bf16) or N (f32)
  const float* bias;
  T* dst;
  int M, H, W, K, N, ldw, seg_w, res;
};

// The A row of src for output pixel m at tap (dy, dx) of a 3x3 (0, 0 for a
// 1x1), or -1 when that pixel lies outside the frame (the zero padding).
template <int SEGS>
__device__ __forceinline__ int staged_row(int m, int y, int x, int seg, int H, int W) {
  if (SEGS != 9) return m;
  const int dy = seg / 3 - 1, dx = seg % 3 - 1;
  const int yy = y + dy, xx = x + dx;
  return yy >= 0 && yy < H && xx >= 0 && xx < W ? m + dy * W + dx : -1;
}

// bf16 on the tensor cores: one CTA per 128 x 64 output tile, eight warps of
// 32 x 32, the A rows (gathered with the tap's shift) and the weights
// streaming through a four-slot cp.async ring in K chunks of 32. Rows past
// M, channels past N and K tails are zero-filled, so the chunk loop has no
// guards; the epilogue stores what lies inside.
constexpr int kSBM = 128, kSKC = 32, kSSlots = 4, kSThreads = 256;
constexpr int kSLd = kSKC + 8;  // padded slot row (conflict-free ldmatrix)
constexpr int kSSlotBytes = (kSBM + kBN) * kSLd * 2;
constexpr size_t kStagedSmem = (size_t)kSSlots * kSSlotBytes;

template <int SEGS>
__global__ void __launch_bounds__(kSThreads) csp_staged_mma_kernel(StagedArgs<bf16> S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring_s = smem_u32(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int mb = blockIdx.x * kSBM, nb = blockIdx.y * kBN;
  const int HW = S.H * S.W;
  const int K = S.K, kch = (K + kSKC - 1) / kSKC, total = SEGS * kch;

  // this thread's copies: A rows tid / 4 and tid / 4 + 64, B row tid / 4,
  // each the 16-byte piece tid % 4 of a 32-wide chunk row
  const int piece = (tid & 3) * 8;
  int am[2], ay[2], ax[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = mb + (tid >> 2) + 64 * j;
    am[j] = m < S.M ? m : -1;
    const int p = m - (m / HW) * HW;
    ay[j] = p / S.W;
    ax[j] = p - ay[j] * S.W;
  }
  const int bn_row = tid >> 2, bn = nb + bn_row;
  int lseg = 0, lk0 = 0, lslot = 0;
  auto load = [&]() {
    const uint32_t slot = ring_s + (uint32_t)lslot * kSSlotBytes;
    const bf16* src = SEGS == 2 && lseg == 1 ? S.src1 : S.src0;
    const int k = lk0 + piece;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = am[j] < 0 ? -1 : staged_row<SEGS>(am[j], ay[j], ax[j], lseg, S.H, S.W);
      const bool ok = r >= 0 && k < K;
      cp_async16(slot + (uint32_t)(((tid >> 2) + 64 * j) * kSLd + piece) * 2,
                 ok ? src + (size_t)r * K + k : src, ok);
    }
    const bool okb = bn < S.N && k < K;
    cp_async16(slot + (uint32_t)(kSBM * kSLd + bn_row * kSLd + piece) * 2,
               okb ? S.w + (size_t)lseg * S.seg_w + (size_t)bn * S.ldw + k : S.w, okb);
    lk0 += kSKC;
    if (lk0 >= K) {
      lk0 = 0;
      ++lseg;
    }
    lslot = lslot == kSSlots - 1 ? 0 : lslot + 1;
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
  const int nw = nb + wn * 32;  // this warp's first channel
  float2 bv[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    bv[nt] = nw + nt * 8 < S.N ? *reinterpret_cast<const float2*>(S.bias + nw + nt * 8 + 2 * t)
                               : make_float2(0.f, 0.f);

  constexpr int kAhead = kSSlots - 1;
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < total) load();
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int cslot = 0;
  for (int gi = 0; gi < total; ++gi) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    __syncthreads();  // chunk gi landed; the slot of chunk gi - 1 is free
    if (gi + kAhead < total) load();
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t slot = ring_s + (uint32_t)cslot * kSSlotBytes;
#pragma unroll
    for (int kk = 0; kk < kSKC / 16; ++kk) {
      uint32_t af[kMT][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldsm_x4(slot + (uint32_t)((wm * 32 + mt * 16 + (lane & 15)) * kSLd + kk * 16 +
                                  (lane >> 4) * 8) * 2,
                af[mt]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(slot + (uint32_t)((kSBM + wn * 32 + np * 16 + (mi >> 1) * 8 + mr) * kSLd +
                                  kk * 16 + (mi & 1) * 8) * 2,
                bfr[np]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[np][0], bfr[np][1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np][2], bfr[np][3]);
        }
    }
    cslot = cslot == kSSlots - 1 ? 0 : cslot + 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // epilogue: bias, SiLU in f32, the residual in f32, rounding
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mb + wm * 32 + mt * 16 + g + half * 8;
      if (m >= S.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nw + nt * 8 >= S.N) continue;
        __nv_bfloat162* d =
            reinterpret_cast<__nv_bfloat162*>(S.dst + (size_t)m * S.N + nw + nt * 8 + 2 * t);
        float v0 = silu_fast(acc[mt][nt][2 * half] + bv[nt].x);
        float v1 = silu_fast(acc[mt][nt][2 * half + 1] + bv[nt].y);
        if (S.res) {
          const float2 old = __bfloat1622float2(*d);
          v0 += old.x;
          v1 += old.y;
        }
        *d = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// f32 on CUDA cores: each thread 8 pixels x 4 channels, weights [in, out]
// (segment s at w + s * K * N) read as 4-wide vectors, as csp_kernel does.
template <int SEGS>
__global__ void __launch_bounds__(kThreads) csp_staged_f32_kernel(StagedArgs<float> S) {
  const int ngroups = S.N / CB;
  const int work = blockIdx.x * kThreads + threadIdx.x;
  if (work >= ngroups * ((S.M + PB - 1) / PB)) return;
  const int c = (work % ngroups) * CB;
  const int m0 = work / ngroups * PB;
  const int HW = S.H * S.W;
  int py[PB], px[PB];
  float acc[PB][CB];
#pragma unroll
  for (int i = 0; i < PB; ++i) {
    const int m = m0 + i;
    const int p = m - (m / HW) * HW;
    py[i] = p / S.W;
    px[i] = p - py[i] * S.W;
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) acc[i][cc] = S.bias[c + cc];
  }
  for (int seg = 0; seg < SEGS; ++seg) {
    const float* src = SEGS == 2 && seg == 1 ? S.src1 : S.src0;
    const float* w = S.w + (size_t)seg * S.K * S.N;
    int r[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i)
      r[i] = m0 + i < S.M ? staged_row<SEGS>(m0 + i, py[i], px[i], seg, S.H, S.W) : -1;
    for (int k = 0; k < S.K; k += 4) {
      float wv[4][CB];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load4(w + (size_t)(k + kk) * S.N + c, wv[kk]);
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        if (r[i] < 0) continue;
        float av[4];
        load4(src + (size_t)r[i] * S.K + k, av);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int cc = 0; cc < CB; ++cc) acc[i][cc] = fmaf(av[kk], wv[kk][cc], acc[i][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PB; ++i) {
    if (m0 + i >= S.M) continue;
    float* d = S.dst + (size_t)(m0 + i) * S.N + c;
    float v[CB];
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) v[cc] = silu(acc[i][cc]);
    if (S.res) {
      float old[CB];
      load4(d, old);
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) v[cc] += old[cc];
    }
    store4(d, v);
  }
}

template <int SEGS, typename T>
cudaError_t staged_stage(const T* src0, const T* src1, const T* w, const float* bias, T* dst,
                         int M, int H, int W, int K, int N, int ldw, int seg_w, int res,
                         cudaStream_t stream) {
  StagedArgs<T> S{src0, src1, w, bias, dst, M, H, W, K, N, ldw, seg_w, res};
  if constexpr (sizeof(T) == 2) {
    const cudaError_t err = cudaFuncSetAttribute(
        csp_staged_mma_kernel<SEGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kStagedSmem);
    if (err != cudaSuccess) return err;
    dim3 grid((M + kSBM - 1) / kSBM, (N + kBN - 1) / kBN);
    csp_staged_mma_kernel<SEGS><<<grid, kSThreads, kStagedSmem, stream>>>(S);
  } else {
    const long long items = (long long)(N / CB) * ((M + PB - 1) / PB);
    csp_staged_f32_kernel<SEGS><<<(unsigned)((items + kThreads - 1) / kThreads), kThreads, 0,
                                  stream>>>(S);
  }
  return cudaGetLastError();
}

// The whole layer by the staged route: a, s and t (M x ch each) in
// `scratch` (3 M ch elements), 2n + 3 stage grids in stream order.
template <typename T>
int launch_staged(const void* x, void* out, const void* wm, const float* bm, const void* ws,
                  const float* bs, const void* w1, const float* b1, const void* w3,
                  const float* b3, const void* wf, const float* bf, void* scratch, int B, int H,
                  int W, int cin, int ch, int cout, int n, int shortcut, void* stream) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kMult = kMma ? 8 : 4;
  if (B < 1 || H < 1 || W < 1 || n < 1 || cin % kMult || ch % kMult || cout % kMult ||
      (long long)B * H * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int M = B * H * W;
  const cudaStream_t st = (cudaStream_t)stream;
  const T* xs = static_cast<const T*>(x);
  T* a = static_cast<T*>(scratch);
  T* s = a + (size_t)M * ch;
  T* t = s + (size_t)M * ch;
  // bf16 weights are [out, in] (rows of K, the final's of 2 ch with s at
  // column ch); f32 weights are [in, out] (segment s at s K N)
  const int ldf = kMma ? 2 * ch : cout, segf = kMma ? ch : ch * cout;
  cudaError_t err = staged_stage<1, T>(xs, xs, static_cast<const T*>(wm), bm, a, M, H, W, cin,
                                       ch, cin, 0, 0, st);
  if (err == cudaSuccess)
    err = staged_stage<1, T>(xs, xs, static_cast<const T*>(ws), bs, s, M, H, W, cin, ch, cin,
                             0, 0, st);
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    err = staged_stage<1, T>(a, a, static_cast<const T*>(w1) + (size_t)i * ch * ch,
                             b1 + (size_t)i * ch, t, M, H, W, ch, ch, ch, 0, 0, st);
    if (err == cudaSuccess)
      err = staged_stage<9, T>(t, t, static_cast<const T*>(w3) + (size_t)i * 9 * ch * ch,
                               b3 + (size_t)i * ch, a, M, H, W, ch, ch, ch, ch * ch, shortcut,
                               st);
  }
  if (err == cudaSuccess)
    err = staged_stage<2, T>(a, s, static_cast<const T*>(wf), bf, static_cast<T*>(out), M, H,
                             W, ch, cout, ldf, segf, 0, st);
  return (int)err;
}

template <typename T>
int launch(const void* x, void* out, const void* wm, const float* bm, const void* ws,
           const float* bs, const void* w1, const float* b1, const void* w3,
           const float* b3, const void* wf, const float* bf, int B, int H, int W, int cin,
           int ch, int cout, int n, int shortcut, int th, int tw, int ring, void* stream) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kMult = kMma ? 8 : 4;  // channel counts must be multiples
  if (B < 1 || H < 1 || W < 1 || n < 1 || th < 1 || tw < 1 || cin % kMult ||
      ch % kMult || cout % kMult || ring < 0 || ring > (kMma ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  CspArgs<T> A;
  A.x = static_cast<const T*>(x);
  A.out = static_cast<T*>(out);
  A.wm = static_cast<const T*>(wm);
  A.bm = bm;
  A.ws = static_cast<const T*>(ws);
  A.bs = bs;
  A.w1 = static_cast<const T*>(w1);
  A.b1 = b1;
  A.w3 = static_cast<const T*>(w3);
  A.b3 = b3;
  A.wf = static_cast<const T*>(wf);
  A.bf = bf;
  A.H = H;
  A.W = W;
  A.cin = cin;
  A.ch = ch;
  A.cout = cout;
  A.n = n;
  A.shortcut = shortcut;
  A.th = th;
  A.tw = tw;
  A.tiles_x = (W + tw - 1) / tw;
  const int tiles_y = (H + th - 1) / th;
  const size_t smem =
      kMma ? mma_smem_bytes(th, tw, n, ch, ring) : f32_smem_bytes(th, tw, n, ch);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kern)(CspArgs<T>);
  int threads = kThreads;
  if constexpr (kMma) {
    kern = ring ? csp_mma_kernel<Compact> : csp_mma_kernel<Wide>;
    threads = ring ? Compact::kThreads : Wide::kThreads;
  } else {
    kern = csp_kernel<T>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(A.tiles_x * tiles_y, B);
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, cin) and out (B, H, W, cout) NHWC, th x tw output tiles.
// Weights in the storage type, biases f32, all contiguous on the device:
//   f32 (CUDA cores): [in, out]: wm, ws (cin, ch); w1 (n, ch, ch); w3 (n, 9,
//     ch, ch) with tap = dy * 3 + dx; wf (2 ch, cout), rows [a; s];
//   bf16 (tensor cores): [out, in]: wm, ws (ch, cin); w1 (n, ch, ch); w3 (n,
//     9, ch, ch); wf (cout, 2 ch), columns [a; s].
// ring: for bf16, 0 the wide cp.async ring, 1 the compact one; 0 for f32.
// Channel counts must be multiples of 4 (f32) or 8 (bf16). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for shapes the
// kernel does not take or a plan over the shared-memory limit.
#define TL_CSP_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const void* x, void* out, const void* wm, const float* bm,     \
                      const void* ws, const float* bs, const void* w1, const float* b1, \
                      const void* w3, const float* b3, const void* wf, const float* bf, \
                      int B, int H, int W, int cin, int ch, int cout, int n,          \
                      int shortcut, int th, int tw, int ring, void* stream) {        \
    return launch<T>(x, out, wm, bm, ws, bs, w1, b1, w3, b3, wf, bf, B, H, W, cin, ch, \
                     cout, n, shortcut, th, tw, ring, stream);                       \
  }

TL_CSP_ENTRY(tl_csp_f32, float)
TL_CSP_ENTRY(tl_csp_bf16_mma, __nv_bfloat16)

// The staged route, for a layer no tile fits: the same layout and rules,
// and `scratch`, 3 B H W ch elements of the storage type on the device
// (a, s and t). Runs 2n + 3 stage grids on `stream`.
#define TL_CSP_STAGED_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* x, void* out, const void* wm, const float* bm,         \
                      const void* ws, const float* bs, const void* w1, const float* b1,  \
                      const void* w3, const float* b3, const void* wf, const float* bf,  \
                      void* scratch, int B, int H, int W, int cin, int ch, int cout, int n, \
                      int shortcut, void* stream) {                                      \
    return launch_staged<T>(x, out, wm, bm, ws, bs, w1, b1, w3, b3, wf, bf, scratch, B, H, \
                            W, cin, ch, cout, n, shortcut, stream);                      \
  }

TL_CSP_STAGED_ENTRY(tl_csp_f32_staged, float)
TL_CSP_STAGED_ENTRY(tl_csp_bf16_mma_staged, __nv_bfloat16)

// The shared memory a launch with th x tw tiles asks for: mma = 1 for the
// bf16 tensor-core kernel with the given ring, 0 for the f32 kernel.
// kernels/csp.py's smem_bytes plans the same sum.
extern "C" long long tl_csp_smem_bytes(int th, int tw, int n, int ch, int mma, int ring) {
  return (long long)(mma ? mma_smem_bytes(th, tw, n, ch, ring)
                         : f32_smem_bytes(th, tw, n, ch));
}
