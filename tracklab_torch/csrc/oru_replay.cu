// The observation-centric re-update (ORU replay) over track slots, one thread
// per slot, for Hopper (sm_90a): OC-SORT's (oru_replay_kernel, 7-dim xysr
// state) and Deep-OC-SORT's "new KF" (oru_replay_nkf_kernel, 8-dim xywh).
//
// A port-only kernel: the JAX package has no Pallas kernel here. Its
// XYSRFilter.oru_replay_batch (tracklab_tpu/ops/kalman.py:242) runs a
// lax.while_loop on the device to the largest gap of the frame. The eager
// plain version (tracklab_torch/kernels/oru_replay.py, oru_replay_plain)
// must read that bound on the host, one sync per tracker step, and then
// launches a few dozen small kernels per trip for every slot. Here each slot
// replays its own gap in registers: the state x (7) and covariance P (7x7)
// never leave the thread, and the launch needs no bound from the host.
//
// Semantics follow oru_replay_plain exactly: the linear interpolation from
// z_prev to z_new in (x, y, w, h) with the same 1e-12 clamps, one virtual
// update per step i < gap, a predict after every step but the last, and the
// frozen state returned where need is false or gap is 0. The update is
// XYSRFilter.update (the Joseph form for H = [I4 | 0] with the closed-form
// 4x4 inverse of ops/kalman.py:_inv4) and the predict XYSRFilter.predict (the
// negative-area guard, F = I + E as slice-adds, + Q), in the same order of
// operations. Elementwise steps use __fadd_rn / __fmul_rn so that no
// multiply-add is contracted into an FMA where PyTorch rounds twice; the
// small matrix products accumulate in index order, where cuBLAS (the plain
// version on the card) and the CPU's BLAS pick their own orders, so the two
// agree to f32 rounding, not bit for bit.
//
// What bounds it: bytes, in principle: each slot reads x, P, z_prev, z_new,
// gap and need (257 bytes) and writes x and P (224 bytes), ~0.5 MB for the
// 1024 slots of eight videos, 0.15 us at 3.35 TB/s. In practice it is the
// latency of the longest slot's chain of gap dependent updates (~1000 f32
// operations each) plus one launch, a few microseconds against the dozens of
// eager launches per trip it replaces.

// Deep-OC-SORT's replay (tracklab_tpu/trackers/deepocsort.py:117-150, plain
// version oru_replay_nkf_plain) has the same shape: the xywh measurements are
// interpolated directly (dz = (z_new - z_prev) / gap), each update is the
// Joseph form with R = diag((w/20)^2, (h/20)^2, ...) from the prior state,
// and each predict between updates zeroes a size velocity that would turn its
// size non-positive, with Q from the size before the shift. x (8) and P
// (8x8) stay in registers; the update keeps A = P - K P[:4, :] in P's own
// registers (rows 0..3 of P are copied first, since every row of A reads
// them) and finishes each row of P from that row's first four entries, and
// the predict adds F P F^T in place, rows 0..3 before rows 4..7, so neither
// needs a second 8x8 array. Bytes: 325 read and 288 written per slot.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-12f;
// XYSRFilter.constants: diag(R) and diag(Q)
__constant__ float kR[4] = {1.f, 1.f, 10.f, 10.f};
__constant__ float kQ[7] = {1.f, 1.f, 1.f, 1.f, 0.01f, 0.01f, 1e-4f};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp(a, min=m): NaN stays NaN
__device__ __forceinline__ float clamp_min(float a, float m) {
  return isnan(a) ? a : fmaxf(a, m);
}

// ops/kalman.py:_inv4, term for term: 2x2 minors, det, adjugate * (1 / det)
__device__ __forceinline__ void inv4(const float (&a)[4][4], float (&o)[4][4]) {
  const float s0 = sub(mul(a[0][0], a[1][1]), mul(a[1][0], a[0][1]));
  const float s1 = sub(mul(a[0][0], a[1][2]), mul(a[1][0], a[0][2]));
  const float s2 = sub(mul(a[0][0], a[1][3]), mul(a[1][0], a[0][3]));
  const float s3 = sub(mul(a[0][1], a[1][2]), mul(a[1][1], a[0][2]));
  const float s4 = sub(mul(a[0][1], a[1][3]), mul(a[1][1], a[0][3]));
  const float s5 = sub(mul(a[0][2], a[1][3]), mul(a[1][2], a[0][3]));
  const float c5 = sub(mul(a[2][2], a[3][3]), mul(a[3][2], a[2][3]));
  const float c4 = sub(mul(a[2][1], a[3][3]), mul(a[3][1], a[2][3]));
  const float c3 = sub(mul(a[2][1], a[3][2]), mul(a[3][1], a[2][2]));
  const float c2 = sub(mul(a[2][0], a[3][3]), mul(a[3][0], a[2][3]));
  const float c1 = sub(mul(a[2][0], a[3][2]), mul(a[3][0], a[2][2]));
  const float c0 = sub(mul(a[2][0], a[3][1]), mul(a[3][0], a[2][1]));
  const float det =
      add(sub(add(add(sub(mul(s0, c5), mul(s1, c4)), mul(s2, c3)), mul(s3, c2)),
              mul(s4, c1)),
          mul(s5, c0));
  const float inv_det = dvd(1.f, det);
  // x - y + z and -x + y - z, left to right, each product rounded
  auto pmp = [](float p, float q, float r) { return add(sub(p, q), r); };
  auto mpm = [](float p, float q, float r) { return sub(add(-p, q), r); };
  const float b[4][4] = {
      {pmp(mul(a[1][1], c5), mul(a[1][2], c4), mul(a[1][3], c3)),
       mpm(mul(a[0][1], c5), mul(a[0][2], c4), mul(a[0][3], c3)),
       pmp(mul(a[3][1], s5), mul(a[3][2], s4), mul(a[3][3], s3)),
       mpm(mul(a[2][1], s5), mul(a[2][2], s4), mul(a[2][3], s3))},
      {mpm(mul(a[1][0], c5), mul(a[1][2], c2), mul(a[1][3], c1)),
       pmp(mul(a[0][0], c5), mul(a[0][2], c2), mul(a[0][3], c1)),
       mpm(mul(a[3][0], s5), mul(a[3][2], s2), mul(a[3][3], s1)),
       pmp(mul(a[2][0], s5), mul(a[2][2], s2), mul(a[2][3], s1))},
      {pmp(mul(a[1][0], c4), mul(a[1][1], c2), mul(a[1][3], c0)),
       mpm(mul(a[0][0], c4), mul(a[0][1], c2), mul(a[0][3], c0)),
       pmp(mul(a[3][0], s4), mul(a[3][1], s2), mul(a[3][3], s0)),
       mpm(mul(a[2][0], s4), mul(a[2][1], s2), mul(a[2][3], s0))},
      {mpm(mul(a[1][0], c3), mul(a[1][1], c1), mul(a[1][2], c0)),
       pmp(mul(a[0][0], c3), mul(a[0][1], c1), mul(a[0][2], c0)),
       mpm(mul(a[3][0], s3), mul(a[3][1], s1), mul(a[3][2], s0)),
       pmp(mul(a[2][0], s3), mul(a[2][1], s1), mul(a[2][2], s0))}};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = mul(b[i][j], inv_det);
}

// XYSRFilter.update: y = z - x[:4]; K = P[:, :4] (P[:4, :4] + R)^-1;
// x += K y; A = P - K P[:4, :]; P = A - A[:, :4] K^T + (K * r) K^T
__device__ __forceinline__ void update(float (&x)[7], float (&P)[7][7],
                                       const float (&z)[4]) {
  float S[4][4], Si[4][4], K[7][4], y[4], A[7][7];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[i] = sub(z[i], x[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = i == j ? add(P[i][j], kR[i]) : P[i][j];
  }
  inv4(S, Si);
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = fmaf(P[i][k], Si[k][j], acc);
      K[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = fmaf(K[i][j], y[j], acc);
    x[i] = add(x[i], acc);
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = fmaf(K[i][k], P[k][j], acc);
      A[i][j] = sub(P[i][j], acc);
    }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m1 = fmaf(A[i][k], K[j][k], m1);
        m2 = fmaf(mul(K[i][k], kR[k]), K[j][k], m2);
      }
      P[i][j] = add(sub(A[i][j], m1), m2);
    }
}

// XYSRFilter.predict: vs := 0 where x[6] + x[2] <= 0; x[:3] += x[4:7];
// P' = F P F^T (rows 4:7 into 0:3, then the columns) + Q
__device__ __forceinline__ void predict(float (&x)[7], float (&P)[7][7]) {
  if (add(x[6], x[2]) <= 0.f) x[6] = 0.f;
  x[0] = add(x[0], x[4]);
  x[1] = add(x[1], x[5]);
  x[2] = add(x[2], x[6]);
  float Pn[7][7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float v = i < 3 ? add(P[i][j], P[i + 4][j]) : P[i][j];
      if (j < 3)
        v = add(v, i < 3 ? add(P[i][j + 4], P[i + 4][j + 4]) : P[i][j + 4]);
      Pn[i][j] = i == j ? add(v, kQ[i]) : v;
    }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) P[i][j] = Pn[i][j];
}

__global__ void __launch_bounds__(kThreads)
    oru_replay_kernel(const float* __restrict__ x_frozen,
                      const float* __restrict__ P_frozen,
                      const float* __restrict__ z_prev,
                      const float* __restrict__ z_new,
                      const int* __restrict__ gap_in,
                      const uint8_t* __restrict__ need_in,
                      float* __restrict__ x_out, float* __restrict__ P_out,
                      int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float x[7], P[7][7];
#pragma unroll
  for (int i = 0; i < 7; ++i) x[i] = x_frozen[s * 7 + i];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) P[i][j] = P_frozen[s * 49 + i * 7 + j];
  const int gap = gap_in[s];
  if (need_in[s] && gap > 0) {
    const float* zp = z_prev + s * 4;
    const float* zn = z_new + s * 4;
    const float w1 = sqrtf(clamp_min(mul(zp[2], zp[3]), kTiny));
    const float h1 = sqrtf(clamp_min(dvd(zp[2], clamp_min(zp[3], kTiny)), kTiny));
    const float w2 = sqrtf(clamp_min(mul(zn[2], zn[3]), kTiny));
    const float h2 = sqrtf(clamp_min(dvd(zn[2], clamp_min(zn[3], kTiny)), kTiny));
    const float tg = (float)max(gap, 1);
    const float dx = dvd(sub(zn[0], zp[0]), tg);
    const float dy = dvd(sub(zn[1], zp[1]), tg);
    const float dw = dvd(sub(w2, w1), tg);
    const float dh = dvd(sub(h2, h1), tg);
    for (int i = 0; i < gap; ++i) {
      const float t = (float)(i + 1);
      const float vw = add(w1, mul(t, dw));
      const float vh = add(h1, mul(t, dh));
      const float vz[4] = {add(zp[0], mul(t, dx)), add(zp[1], mul(t, dy)),
                           mul(vw, vh), dvd(vw, clamp_min(vh, kTiny))};
      update(x, P, vz);
      if (i < gap - 1) predict(x, P);
    }
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) x_out[s * 7 + i] = x[i];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) P_out[s * 49 + i * 7 + j] = P[i][j];
}

// Deep-OC-SORT's "new KF" noise scales, rounded from the doubles 1/20 and
// 1/160 as PyTorch rounds a Python float into an f32 product
constexpr float kWP = (float)(1.0 / 20.0);
constexpr float kWV = (float)(1.0 / 160.0);

// _nkf_update: r = (wp w, wp h, wp w, wp h)^2 from the prior state; y = z -
// x[:4]; K = P[:, :4] (P[:4, :4] + diag r)^-1; x += K y;
// A = P - K P[:4, :]; P = A - A[:, :4] K^T + (K * r) K^T
__device__ __forceinline__ void nkf_update(float (&x)[8], float (&P)[8][8],
                                           const float (&z)[4]) {
  const float pw = mul(kWP, x[2]), ph = mul(kWP, x[3]);
  const float r[4] = {mul(pw, pw), mul(ph, ph), mul(pw, pw), mul(ph, ph)};
  float S[4][4], Si[4][4], K[8][4], y[4], top[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[i] = sub(z[i], x[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = i == j ? add(P[i][j], r[i]) : P[i][j];
  }
  inv4(S, Si);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = fmaf(P[i][k], Si[k][j], acc);
      K[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = fmaf(K[i][j], y[j], acc);
    x[i] = add(x[i], acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) top[i][j] = P[i][j];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = fmaf(K[i][k], top[k][j], acc);
      P[i][j] = sub(P[i][j], acc);  // A
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a[4] = {P[i][0], P[i][1], P[i][2], P[i][3]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m1 = fmaf(a[k], K[j][k], m1);
        m2 = fmaf(mul(K[i][k], r[k]), K[j][k], m2);
      }
      P[i][j] = add(sub(P[i][j], m1), m2);
    }
  }
}

// _nkf_predict with velocities not frozen: a size velocity whose size would
// turn non-positive is zeroed; q = (wp w, wp h, wp w, wp h, wv w, ...)^2 from
// the size before the shift; x[:4] += x[4:]; P = F P F^T + diag q
__device__ __forceinline__ void nkf_predict(float (&x)[8], float (&P)[8][8]) {
  if (add(x[2], x[6]) <= 0.f) x[6] = 0.f;
  if (add(x[3], x[7]) <= 0.f) x[7] = 0.f;
  const float pw = mul(kWP, x[2]), ph = mul(kWP, x[3]);
  const float vw = mul(kWV, x[2]), vh = mul(kWV, x[3]);
  const float q[8] = {mul(pw, pw), mul(ph, ph), mul(pw, pw), mul(ph, ph),
                      mul(vw, vw), mul(vh, vh), mul(vw, vw), mul(vh, vh)};
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = add(x[i], x[i + 4]);
  // rows 0..3 read the unshifted rows 4..7; each row's columns 0..3 read its
  // unshifted columns 4..7
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      P[i][j] = add(add(P[i][j], P[i + 4][j]), add(P[i][j + 4], P[i + 4][j + 4]));
#pragma unroll
    for (int j = 4; j < 8; ++j) P[i][j] = add(P[i][j], P[i + 4][j]);
  }
#pragma unroll
  for (int i = 4; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) P[i][j] = add(P[i][j], P[i][j + 4]);
#pragma unroll
  for (int i = 0; i < 8; ++i) P[i][i] = add(P[i][i], q[i]);
}

__global__ void __launch_bounds__(kThreads)
    oru_replay_nkf_kernel(const float* __restrict__ x_frozen,
                          const float* __restrict__ P_frozen,
                          const float* __restrict__ z_prev,
                          const float* __restrict__ z_new,
                          const int* __restrict__ gap_in,
                          const uint8_t* __restrict__ need_in,
                          float* __restrict__ x_out, float* __restrict__ P_out,
                          int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float x[8], P[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = x_frozen[s * 8 + i];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) P[i][j] = P_frozen[s * 64 + i * 8 + j];
  const int gap = gap_in[s];
  if (need_in[s] && gap > 0) {
    const float tg = (float)max(gap, 1);
    float zp[4], dz[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      zp[k] = z_prev[s * 4 + k];
      dz[k] = dvd(sub(z_new[s * 4 + k], zp[k]), tg);
    }
    for (int i = 0; i < gap; ++i) {
      const float t = (float)(i + 1);
      const float vz[4] = {add(zp[0], mul(t, dz[0])), add(zp[1], mul(t, dz[1])),
                           add(zp[2], mul(t, dz[2])), add(zp[3], mul(t, dz[3]))};
      nkf_update(x, P, vz);
      if (i < gap - 1) nkf_predict(x, P);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x_out[s * 8 + i] = x[i];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) P_out[s * 64 + i * 8 + j] = P[i][j];
}

}  // namespace

// n slots of contiguous f32 x (n, 7), P (n, 7, 7), z_prev and z_new (n, 4),
// int32 gap (n,) and bool need (n,); writes x_out (n, 7) and P_out (n, 7, 7).
// Launches on `stream` and returns cudaGetLastError() right after the launch.
extern "C" int tl_oru_replay(const void* x_frozen, const void* P_frozen,
                             const void* z_prev, const void* z_new,
                             const void* gap, const void* need, void* x_out,
                             void* P_out, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  oru_replay_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      static_cast<const float*>(x_frozen), static_cast<const float*>(P_frozen),
      static_cast<const float*>(z_prev), static_cast<const float*>(z_new),
      static_cast<const int*>(gap), static_cast<const uint8_t*>(need),
      static_cast<float*>(x_out), static_cast<float*>(P_out), n);
  return (int)cudaGetLastError();
}

// n slots of contiguous f32 x (n, 8), P (n, 8, 8), z_prev and z_new (n, 4)
// xywh, int32 gap (n,) and bool need (n,); writes x_out (n, 8) and P_out (n,
// 8, 8). Launches on `stream` and returns cudaGetLastError() right after it.
extern "C" int tl_oru_replay_nkf(const void* x_frozen, const void* P_frozen,
                                 const void* z_prev, const void* z_new,
                                 const void* gap, const void* need, void* x_out,
                                 void* P_out, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  oru_replay_nkf_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const float*>(x_frozen), static_cast<const float*>(P_frozen),
      static_cast<const float*>(z_prev), static_cast<const float*>(z_new),
      static_cast<const int*>(gap), static_cast<const uint8_t*>(need),
      static_cast<float*>(x_out), static_cast<float*>(P_out), n);
  return (int)cudaGetLastError();
}
