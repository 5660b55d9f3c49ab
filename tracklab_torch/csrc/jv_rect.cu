// K2: V independent exact rectangular assignments (Jonker-Volgenant shortest
// augmenting path over R rows and C >= R columns), one warp per problem, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tracklab_tpu/ops/assignment_pallas.py
// (_jv_rect_batched_kernel, launched by solve_rect_batched_pallas). The TPU
// kernel keeps all V problems on the sublanes of one tile and gathers rows
// and bumps duals through one-hot contractions, because Mosaic has no
// gather. Here each problem is one warp, and several problems share a CTA.
//
// Step order follows the plain solver (tracklab_torch/kernels/jv_rect.py,
// _solve_rect_plain, itself the torch form of assignment.py's
// _solve_rect_lax): rows in order, incremental duals, argmin ties broken to
// the lowest column, and the same f32 subtractions in the same order
// (__fsub_rn/__fadd_rn, and the loop has no multiply to contract). col2row
// is therefore identical to the plain version's, ties included. The TPU
// kernel's deferred-dual Dijkstra may pick another optimum on ties; this one
// does not follow it.
//
// What bounds it: not bytes (the cost block is R*C*4 = 32 KB at 64 x 128)
// and not operations (~6 per column per step), but the latency of one
// dependent path step, in ns per step: each step's argmin picks the row the
// next step reads. So a step keeps to one warp and never waits on a block
// barrier:
//   - lane l owns the contiguous, ascending run of columns [l*W, l*W + W),
//     W = ceil(C/32) <= 16 (a template parameter), and keeps each column's minv, v, way, row p and
//     that row's dual u[p] in registers (the used flags are a bitmask);
//   - the row of the cost block sits in shared memory (staged once with
//     cp.async; rows padded so a lane's run is one or two vector loads), or
//     is read from device memory when the block is above kMaxSmem;
//   - the argmin: each lane takes the minimum of its run (lowest column on
//     ties), maps it to an order-preserving 32-bit key with -0.0 made +0.0
//     (f32 comparison treats them as equal, so the tie rule must), and
//     redux.sync (__reduce_min_sync) gives every lane the minimum key;
//     __ballot_sync and __ffs give the lowest lane that holds it, which holds
//     the lowest column since runs ascend. delta decodes exactly from the
//     key; the winner's column, row and row dual come in three shuffles;
//   - dual updates stay in the lanes' registers; p, u and way go to the
//     warp's shared memory only at the end of a row, for the augmenting
//     walk on lane 0, ordered by __syncwarp.
// No tensor cores, TMA or clusters: there is no matrix product here. The
// Hopper features that matter are redux.sync and warp-synchronous
// execution. The kernel has no __syncthreads at all.
//
// Entry (V, R, C), R <= C <= 512: problem b writes col2row[b, c] = the row
// assigned to column c, or R when the column is unassigned. A problem whose
// active[b] is 0 writes R everywhere at once, so callers can discard a
// result on the device without a host sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 512;
constexpr int kMaxW = kMaxC / 32;    // columns per lane
constexpr int kWarps = 4;            // problems per CTA
// shared memory a CTA may take (sm_90); a problem whose slice with the cost
// block is larger reads the cost block from device memory
constexpr size_t kMaxSmem = 232448;
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

// A lane's run of one cost row: vector loads from the padded shared block,
// or clamped scalar loads from device memory.
template <int W, bool kSmem>
__device__ __forceinline__ void load_run(float (&c)[W], const float* row,
                                         int j_first, int C) {
  if constexpr (!kSmem) {
#pragma unroll
    for (int t = 0; t < W; ++t) c[t] = __ldg(row + min(j_first + t, C - 1));
  } else if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(row + j_first)[q];
      c[4 * q] = x.x;
      c[4 * q + 1] = x.y;
      c[4 * q + 2] = x.z;
      c[4 * q + 3] = x.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int q = 0; q < W / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(row + j_first)[q];
      c[2 * q] = x.x;
      c[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < W; ++t) c[t] = row[j_first + t];
  }
}

// One warp per problem, blockDim.x / 32 problems per CTA. The warp's slice
// of shared memory holds, in 4-byte words: the R x LD cost block (kSmem),
// p (C + 1), u (R), way (C); slice_words is a multiple of 4.
template <int W, bool kSmem>
__global__ void __launch_bounds__(32 * kWarps)
    jv_rect_warp_kernel(const float* __restrict__ cost,
                        const uint8_t* __restrict__ active,
                        int* __restrict__ col2row, int V, int R, int C, int LD,
                        int slice_words) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= V) return;
  const int FREE = R;  // sentinel row: column unassigned
  int* out = col2row + (size_t)b * C;
  if (!active[b]) {
    for (int c = lane; c < C; c += 32) out[c] = FREE;
    return;
  }
  float* slice = smem + (size_t)warp * slice_words;
  int* p_sh = reinterpret_cast<int*>(slice + (kSmem ? R * LD : 0));
  float* u_sh = reinterpret_cast<float*>(p_sh + C + 1);
  int* way_sh = reinterpret_cast<int*>(u_sh + R);
  const float* src = cost + (size_t)b * R * C;
  const float* cb = src;
  int ld = C;
  if constexpr (kSmem) {
    if (C % 4 == 0 && ((uintptr_t)src & 15) == 0)
      stage_rows<4>(slice, src, R, C, C, LD, lane);
    else
      stage_rows<1>(slice, src, R, C, C, LD, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    cb = slice;
    ld = LD;
  }
  for (int c = lane; c <= C; c += 32) p_sh[c] = FREE;
  for (int r = lane; r < R; r += 32) u_sh[r] = 0.f;
  __syncwarp();

  const float INF = __int_as_float(0x7f800000);
  // lane's run; a lane with no column reads lane 0's (and ignores it)
  const int j_first = lane * W < C ? lane * W : 0;
  unsigned valid = 0;
#pragma unroll
  for (int t = 0; t < W; ++t)
    if (lane * W + t < C) valid |= 1u << t;
  float v[W], uc[W];
  int p[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    v[t] = 0.f;
    uc[t] = 0.f;
    p[t] = FREE;
  }

  for (int i = 0; i < R; ++i) {
    float minv[W];
    int way[W];
#pragma unroll
    for (int t = 0; t < W; ++t) {
      minv[t] = INF;
      way[t] = C;
    }
    unsigned used = 0;
    int j0 = C;  // the virtual column C holds row i
    int i0 = i;
    float ui0 = u_sh[i];
    float uvirt = ui0;
    while (true) {
      float c[W];
      load_run<W, kSmem>(c, cb + (size_t)i0 * ld, j_first, C);
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
      p_sh[C] = i;
    }
    __syncwarp();
    if (lane == 0) {
      int jj = j0;
      while (jj != C) {
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
  for (int c = lane; c < C; c += 32) out[c] = p_sh[c];
}

using Kernel = void (*)(const float*, const uint8_t*, int*, int, int, int,
                        int, int);

template <int W>
Kernel pick(bool in_smem) {
  return in_smem ? jv_rect_warp_kernel<W, true> : jv_rect_warp_kernel<W, false>;
}

Kernel kernel_for(int W, bool in_smem) {
  switch (W) {
    case 1: return pick<1>(in_smem);
    case 2: return pick<2>(in_smem);
    case 3: return pick<3>(in_smem);
    case 4: return pick<4>(in_smem);
    case 5: return pick<5>(in_smem);
    case 6: return pick<6>(in_smem);
    case 7: return pick<7>(in_smem);
    case 8: return pick<8>(in_smem);
    case 9: return pick<9>(in_smem);
    case 10: return pick<10>(in_smem);
    case 11: return pick<11>(in_smem);
    case 12: return pick<12>(in_smem);
    case 13: return pick<13>(in_smem);
    case 14: return pick<14>(in_smem);
    case 15: return pick<15>(in_smem);
    default: return pick<16>(in_smem);
  }
}

int lcm4(int w) { return w % 4 == 0 ? w : (w % 2 == 0 ? 2 * w : 4 * w); }

// cudaFuncSetAttribute once per kernel and device, to the whole budget
constexpr int kMaxDevices = 64;
bool opted_in[kMaxDevices][kMaxW][2];

}  // namespace

extern "C" int tl_jv_rect_max_cols() { return kMaxC; }

// cost (V, R, C) f32, active (V,) uint8 -> col2row (V, C) int32, all
// contiguous on the device, 1 <= R <= C <= kMaxC. Launches on `stream` and
// returns cudaGetLastError() right after the launch.
extern "C" int tl_jv_rect_solve_batched(const float* cost,
                                        const uint8_t* active, int* col2row,
                                        int V, int R, int C, void* stream) {
  if (V < 1 || R < 1 || R > C || C > kMaxC) return (int)cudaErrorInvalidValue;
  const int W = (C + 31) / 32;
  const int step = lcm4(W);
  const int LD = (C + step - 1) / step * step;  // rows padded for the runs
  const size_t state = (size_t)(C + 1) + R + C;
  const size_t with_cost = ((size_t)R * LD + state + 3) / 4 * 4;
  const bool in_smem = with_cost * 4 <= kMaxSmem;
  const size_t slice = in_smem ? with_cost : (state + 3) / 4 * 4;
  int warps = kWarps < V ? kWarps : V;
  while (warps > 1 && warps * slice * 4 > kMaxSmem) --warps;
  const size_t smem = warps * slice * 4;
  const Kernel fn = kernel_for(W, in_smem);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted_in[dev][W - 1][in_smem]) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      opted_in[dev][W - 1][in_smem] = true;
    }
  }
  const int blocks = (V + warps - 1) / warps;
  fn<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      cost, active, col2row, V, R, C, LD, (int)slice);
  return (int)cudaGetLastError();
}
