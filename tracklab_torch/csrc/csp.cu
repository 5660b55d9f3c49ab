// K3: one whole YOLOX CSPLayer per (frame, spatial tile), for Hopper (sm_90a).
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
// memory (`s` reuses `t`'s buffer once the bottlenecks are done); weights
// stream from global memory through L1/L2; only the tile's output is
// written. Pixels of the region outside the image get t = 0, which is the
// 3x3 conv's zero padding.
//
// What bounds it: operations. The seven YOLOX-s CSPLayers at 640x640 do
// ~9.1 GFLOP per frame against ~3.3 MB of input+output at the largest
// (dark3), ~600 FLOP/B, above the H100's ~295 FLOP/B balance point. This
// first version does the products as f32 FMAs on CUDA cores (each thread a
// block of 8 pixels x 4 channels, weights read as 4-wide vectors) and pays
// the halo's recomputation; tensor-core MMA (mma.sync / wgmma) is later work.
//
// Template on the storage type: float (held tightly against the plain
// layer) and __nv_bfloat16 (the main path). Accumulation is always f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
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

template <typename T>
int launch(const void* x, void* out, const void* wm, const float* bm, const void* ws,
           const float* bs, const void* w1, const float* b1, const void* w3,
           const float* b3, const void* wf, const float* bf, int B, int H, int W, int cin,
           int ch, int cout, int n, int shortcut, int th, int tw, void* stream) {
  if (B < 1 || H < 1 || W < 1 || n < 1 || th < 1 || tw < 1 || cin % 4 || ch % 4 || cout % 4)
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
  const size_t smem = 2 * (size_t)(th + 2 * n) * (tw + 2 * n) * ch * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      csp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(A.tiles_x * tiles_y, B);
  csp_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, cin) and out (B, H, W, cout) NHWC; wm, ws (cin, ch); w1 (n, ch,
// ch); w3 (n, 9, ch, ch) with tap = dy * 3 + dx; wf (2 ch, cout), rows [a; s];
// biases f32. All contiguous on the device. Returns cudaGetLastError() after
// the launch.
#define TL_CSP_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const void* x, void* out, const void* wm, const float* bm,     \
                      const void* ws, const float* bs, const void* w1, const float* b1, \
                      const void* w3, const float* b3, const void* wf, const float* bf, \
                      int B, int H, int W, int cin, int ch, int cout, int n,          \
                      int shortcut, int th, int tw, void* stream) {                  \
    return launch<T>(x, out, wm, bm, ws, bs, w1, b1, w3, b3, wf, bf, B, H, W, cin, ch, \
                     cout, n, shortcut, th, tw, stream);                             \
  }

TL_CSP_ENTRY(tl_csp_f32, float)
TL_CSP_ENTRY(tl_csp_bf16, __nv_bfloat16)
