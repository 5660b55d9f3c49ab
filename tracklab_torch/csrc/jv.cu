// K1: exact min-cost perfect matching (Jonker-Volgenant shortest augmenting
// path), one warp per problem, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tracklab_tpu/ops/assignment_pallas.py
// (_jv_kernel, launched by solve_square_pallas). On the TPU every per-step
// update is a full-width vector op over lanes; here one warp solves one
// problem, and several problems share a CTA.
//
// Step order follows the plain solver (tracklab_torch/kernels/jv.py,
// _solve_square_plain, itself the torch form of assignment.py's
// _solve_square_lax): rows in order, incremental duals, argmin ties broken to
// the lowest column, and the same f32 subtractions in the same order. The
// loop has no multiply, so no FMA contraction can change a rounding: col2row
// is identical to the plain version's, ties included.
//
// What bounds it: not bytes (the cost block is K*K*4 = 16 KB at K = 64) and
// not operations (~6 per column per step), but the latency of one dependent
// path step, in ns per step: each step's argmin picks the row the next step
// reads. The design is K2's (csrc/jv_rect.cu), square:
//   - lane l owns the contiguous, ascending run of columns [l*W, l*W + W),
//     W = ceil(S/32) <= 4 for the launch, and keeps each column's minv, v,
//     way, row p and that row's dual u[p] in registers (the used flags are
//     a bitmask);
//   - the leading k_eff x k_eff block is staged once into the warp's shared
//     memory with cp.async, row by row (no per-element division), rows
//     padded so a lane's run is one vector load;
//   - the argmin: each lane's run minimum (lowest column on ties) becomes an
//     order-preserving 32-bit key with -0.0 made +0.0; redux.sync
//     (__reduce_min_sync) gives every lane the minimum key, __ballot_sync and
//     __ffs the lowest lane holding it (the lowest column, since runs
//     ascend); delta decodes exactly from the key, and the winner's column,
//     row and row dual come in three shuffles;
//   - dual updates stay in registers; p, u and way go to the warp's shared
//     memory only at the end of a row, for the augmenting walk on lane 0,
//     ordered by __syncwarp.
// No tensor cores, TMA or clusters: there is no matrix product here. The
// Hopper features that matter are redux.sync and warp-synchronous
// execution. The kernel has no __syncthreads at all.
//
// Batched entry (B, S, S): problem b solves the leading k_eff[b] x k_eff[b]
// block of cost[b], or writes -1 everywhere at once when active[b] is 0.
// This lets callers select among matching variants on the device with one
// launch and no host sync. Columns >= k_eff[b] report -1 (no row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 128;
constexpr int kMaxW = kMaxS / 32;    // columns per lane
constexpr int kWarps = 4;            // problems per CTA
constexpr size_t kMaxSmem = 232448;  // shared memory a CTA may take (sm_90)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoCol = 0xffffffffu;  // key of a used or absent column

// Order-preserving key of an f32, -0.0 first made +0.0: a < b iff
// key(a) < key(b), and a == b iff key(a) == key(b), for non-NaN a, b.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// The minimum key of a lane's run and its lowest position (a tree that
// keeps the left, lower, half on ties).
template <int W>
__device__ __forceinline__ unsigned run_min(const unsigned (&k)[W], int& t0) {
  unsigned kk[W];
  int ti[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    kk[t] = k[t];
    ti[t] = t;
  }
#pragma unroll
  for (int s = 1; s < W; s <<= 1) {
#pragma unroll
    for (int t = 0; t + s < W; t += 2 * s) {
      if (kk[t + s] < kk[t]) {
        kk[t] = kk[t + s];
        ti[t] = ti[t + s];
      }
    }
  }
  t0 = ti[0];
  return kk[0];
}

template <int U>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (U == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

// One warp copies a rows x cols f32 block (row strides src_ld, dst_ld) into
// shared memory in U-float pieces; a pass covers 32 / pieces rows when a row
// has fewer pieces than lanes. The caller waits and syncs the warp.
template <int U>
__device__ void stage_rows(float* dst, const float* src, int rows, int cols,
                           int src_ld, int dst_ld, int lane) {
  const int pieces = cols / U;
  if (pieces <= 32) {
    const int per_pass = 32 / pieces;
    const int dr = lane / pieces;
    const int q = (lane - dr * pieces) * U;
    if (dr >= per_pass) return;
    for (int r = dr; r < rows; r += per_pass)
      cp_async<U>(dst + r * dst_ld + q, src + (size_t)r * src_ld + q);
  } else {
    for (int r = 0; r < rows; ++r)
      for (int q = lane * U; q < cols; q += 32 * U)
        cp_async<U>(dst + r * dst_ld + q, src + (size_t)r * src_ld + q);
  }
}

// A lane's run of one row of the padded shared block, in vector loads
// where the run allows.
template <int W>
__device__ __forceinline__ void load_run(float (&c)[W], const float* run) {
  if constexpr (W % 4 == 0) {
    const float4 x = *reinterpret_cast<const float4*>(run);
    c[0] = x.x;
    c[1] = x.y;
    c[2] = x.z;
    c[3] = x.w;
  } else if constexpr (W % 2 == 0) {
    const float2 x = *reinterpret_cast<const float2*>(run);
    c[0] = x.x;
    c[1] = x.y;
  } else {
#pragma unroll
    for (int t = 0; t < W; ++t) c[t] = run[t];
  }
}

// One warp per problem, blockDim.x / 32 problems per CTA. The warp's slice
// of shared memory holds, in 4-byte words: the S x LD cost block, p
// (S + 1), u (S), way (S); slice_words is a multiple of 4.
template <int W>
__global__ void __launch_bounds__(32 * kWarps)
    jv_warp_kernel(const float* __restrict__ cost,
                   const int* __restrict__ k_eff,
                   const uint8_t* __restrict__ active,
                   int* __restrict__ col2row, int B, int S, int LD,
                   int slice_words) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  int* out = col2row + (size_t)b * S;
  const int K = active[b] ? min(k_eff[b], S) : 0;
  if (K <= 0) {
    for (int c = lane; c < S; c += 32) out[c] = -1;
    return;
  }
  float* c_sh = smem + (size_t)warp * slice_words;
  int* p_sh = reinterpret_cast<int*>(c_sh + S * LD);
  float* u_sh = reinterpret_cast<float*>(p_sh + S + 1);
  int* way_sh = reinterpret_cast<int*>(u_sh + S);
  const float* src = cost + (size_t)b * S * S;
  if (K % 4 == 0 && S % 4 == 0 && ((uintptr_t)src & 15) == 0)
    stage_rows<4>(c_sh, src, K, K, S, LD, lane);
  else
    stage_rows<1>(c_sh, src, K, K, S, LD, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int FREE = K;  // sentinel row: column unassigned
  for (int c = lane; c <= K; c += 32) p_sh[c] = FREE;
  for (int r = lane; r < K; r += 32) u_sh[r] = 0.f;
  __syncwarp();

  const float INF = __int_as_float(0x7f800000);
  // lane's run; a lane with no column reads lane 0's (and ignores it)
  const int j_first = lane * W < K ? lane * W : 0;
  unsigned valid = 0;
#pragma unroll
  for (int t = 0; t < W; ++t)
    if (lane * W + t < K) valid |= 1u << t;
  float v[W], uc[W];
  int p[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    v[t] = 0.f;
    uc[t] = 0.f;
    p[t] = FREE;
  }

  for (int i = 0; i < K; ++i) {
    float minv[W];
    int way[W];
#pragma unroll
    for (int t = 0; t < W; ++t) {
      minv[t] = INF;
      way[t] = K;
    }
    unsigned used = 0;
    int j0 = K;  // the virtual column K holds row i
    int i0 = i;
    float ui0 = u_sh[i];
    float uvirt = ui0;
    while (true) {
      float c[W];
      load_run<W>(c, c_sh + i0 * LD + j_first);
      const unsigned live = valid & ~used;
      unsigned k[W];
#pragma unroll
      for (int t = 0; t < W; ++t) {
        k[t] = kNoCol;
        if (live >> t & 1u) {
          const float cur = __fsub_rn(__fsub_rn(c[t], ui0), v[t]);
          if (cur < minv[t]) {
            minv[t] = cur;
            way[t] = j0;
          }
          k[t] = order_key(minv[t]);
        }
      }
      int tb;
      const unsigned kb = run_min<W>(k, tb);
      const unsigned kmin = __reduce_min_sync(kFull, kb);
      const int wl = __ffs(__ballot_sync(kFull, kb == kmin)) - 1;
      int pb = p[0];
      float ub = uc[0];
#pragma unroll
      for (int t = 1; t < W; ++t) {
        if (tb == t) {
          pb = p[t];
          ub = uc[t];
        }
      }
      const int j1 = __shfl_sync(kFull, lane * W + tb, wl);
      const int i1 = __shfl_sync(kFull, pb, wl);
      const float u1 = __shfl_sync(kFull, ub, wl);
      const float delta = key_value(kmin);
      // dual updates: used columns (the virtual one included) move their
      // rows' u up and their own v down; unused columns' minv go down
#pragma unroll
      for (int t = 0; t < W; ++t) {
        if (used >> t & 1u) {
          uc[t] = __fadd_rn(uc[t], delta);
          v[t] = __fsub_rn(v[t], delta);
        } else if (valid >> t & 1u) {
          minv[t] = __fsub_rn(minv[t], delta);
        }
      }
      uvirt = __fadd_rn(uvirt, delta);
      j0 = j1;
      if (i1 == FREE) break;  // uniform: every lane holds the same i1
      if (lane == wl) used |= 1u << tb;
      i0 = i1;
      ui0 = u1;
    }
    // write back this row's duals and predecessors, then augment along the
    // predecessor columns back to the virtual column on lane 0
#pragma unroll
    for (int t = 0; t < W; ++t) {
      if (used >> t & 1u) u_sh[p[t]] = uc[t];
      if (valid >> t & 1u) way_sh[lane * W + t] = way[t];
    }
    if (lane == 0) {
      u_sh[i] = uvirt;
      p_sh[K] = i;
    }
    __syncwarp();
    if (lane == 0) {
      int jj = j0;
      while (jj != K) {
        const int jp = way_sh[jj];
        p_sh[jj] = p_sh[jp];
        jj = jp;
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < W; ++t) {
      if (valid >> t & 1u) {
        p[t] = p_sh[lane * W + t];
        uc[t] = p[t] != FREE ? u_sh[p[t]] : 0.f;
      }
    }
  }
  for (int c = lane; c < S; c += 32) out[c] = c < K ? p_sh[c] : -1;
}

using Kernel = void (*)(const float*, const int*, const uint8_t*, int*, int,
                        int, int, int);

Kernel kernel_for(int W) {
  switch (W) {
    case 1: return jv_warp_kernel<1>;
    case 2: return jv_warp_kernel<2>;
    case 3: return jv_warp_kernel<3>;
    default: return jv_warp_kernel<4>;
  }
}

int lcm4(int w) { return w % 4 == 0 ? w : (w % 2 == 0 ? 2 * w : 4 * w); }

// cudaFuncSetAttribute once per kernel and device, to the whole budget
constexpr int kMaxDevices = 64;
bool opted_in[kMaxDevices][kMaxW];

}  // namespace

extern "C" int tl_jv_max_size() { return kMaxS; }

// cost (B, S, S) f32, k_eff (B,) int32, active (B,) uint8 -> col2row (B, S)
// int32, all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() right after the launch.
extern "C" int tl_jv_solve_batched(const float* cost, const int* k_eff,
                                   const uint8_t* active, int* col2row, int B,
                                   int S, void* stream) {
  if (S < 1 || S > kMaxS || B < 1) return (int)cudaErrorInvalidValue;
  const int W = (S + 31) / 32;
  const int step = lcm4(W);
  const int LD = (S + step - 1) / step * step;  // rows padded for the runs
  const size_t slice = ((size_t)S * LD + (S + 1) + 2 * S + 3) / 4 * 4;
  int warps = kWarps < B ? kWarps : B;
  while (warps > 1 && warps * slice * 4 > kMaxSmem) --warps;
  const size_t smem = warps * slice * 4;
  const Kernel fn = kernel_for(W);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted_in[dev][W - 1]) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      opted_in[dev][W - 1] = true;
    }
  }
  const int blocks = (B + warps - 1) / warps;
  fn<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      cost, k_eff, active, col2row, B, S, LD, (int)slice);
  return (int)cudaGetLastError();
}
