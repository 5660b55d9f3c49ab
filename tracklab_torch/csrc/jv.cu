// K1: exact min-cost perfect matching (Jonker-Volgenant shortest augmenting
// path), one CTA per problem, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tracklab_tpu/ops/assignment_pallas.py
// (_jv_kernel, launched by solve_square_pallas). On the TPU every per-step
// update is a full-width vector op over lanes; here one thread owns one
// column, and the per-step argmin is a warp-shuffle reduction followed by a
// combine of the per-warp winners in shared memory.
//
// Step order follows the plain solver (tracklab_torch/kernels/jv.py,
// _solve_square_plain, itself the torch form of assignment.py's
// _solve_square_lax): rows in order, incremental duals, argmin ties broken to
// the lowest column, and the same f32 subtractions in the same order. The
// loop has no multiply, so no FMA contraction can change a rounding: col2row
// is identical to the plain version's, ties included.
//
// What bounds it: not bytes (the cost block is K*K*4 = 16 KB at K = 64) but
// latency. The K rows run one after another, each a chain of dependent
// block-wide argmins (two __syncthreads per step). The design keeps the cost
// block, duals and path state in shared memory and registers so a step
// touches no device memory, and batches independent problems one per CTA.
//
// Batched entry (B, S, S): problem b solves the leading k_eff[b] x k_eff[b]
// block of cost[b], or writes -1 everywhere at once when active[b] is 0.
// This lets callers select among matching variants on the device with one
// launch and no host sync. Columns >= k_eff[b] report -1 (no row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 128;
constexpr int kMaxThreads = 160;  // >= kMaxS + 1 (the virtual column), x32
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ void merge_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void jv_batched_kernel(const float* __restrict__ cost,
                                  const int* __restrict__ k_eff,
                                  const uint8_t* __restrict__ active,
                                  int* __restrict__ col2row, int S) {
  extern __shared__ float c_sh[];  // K x K, row stride K
  __shared__ float u[kMaxS + 1];
  __shared__ int p[kMaxS + 1];
  __shared__ int way[kMaxS];
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  int* out = col2row + (size_t)b * S;
  const int K = active[b] ? min(k_eff[b], S) : 0;
  if (K <= 0) {
    for (int c = j; c < S; c += blockDim.x) out[c] = -1;
    return;
  }
  const float INF = __int_as_float(0x7f800000);
  const float* src = cost + (size_t)b * S * S;
  for (int idx = j; idx < K * K; idx += blockDim.x) {
    c_sh[idx] = src[(idx / K) * S + (idx % K)];
  }
  const int FREE = K;  // sentinel row: column unassigned
  if (j <= K) {
    u[j] = 0.f;
    p[j] = FREE;
  }
  float vj = 0.f;  // this thread's column potential (j < K)
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    if (j == 0) p[K] = i;  // the virtual column K holds row i
    float minv = INF;
    bool used = false;
    int j0 = K;
    __syncthreads();
    while (true) {
      const int i0 = p[j0];
      if (i0 == FREE) break;  // uniform: every thread reads the same j0
      if (j == j0) used = true;
      float reach = INF;
      if (j < K && !used) {
        const float cur = __fsub_rn(__fsub_rn(c_sh[i0 * K + j], u[i0]), vj);
        if (cur < minv) {
          minv = cur;
          way[j] = j0;
        }
        reach = minv;
      }
      // block-wide argmin, lowest column index on ties
      float bv = reach;
      int bi = j < K ? j : kMaxThreads;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, bv, off);
        const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
        merge_min(bv, bi, v2, i2);
      }
      if ((j & 31) == 0) {
        red_v[j >> 5] = bv;
        red_i[j >> 5] = bi;
      }
      __syncthreads();
      float delta = red_v[0];
      int j1 = red_i[0];
      for (int w = 1; w < nwarps; ++w) merge_min(delta, j1, red_v[w], red_i[w]);
      // dual updates: used columns (the virtual one included) move their
      // rows' u up and their own v down; unused columns' minv go down
      if (j <= K && used) {
        const int r = p[j];
        u[r] = __fadd_rn(u[r], delta);
        vj = __fsub_rn(vj, delta);
      } else if (j < K) {
        minv = __fsub_rn(minv, delta);
      }
      j0 = j1;
      __syncthreads();
    }
    // augment along the predecessor columns back to the virtual column
    if (j == 0) {
      int jj = j0;
      while (jj != K) {
        const int jp = way[jj];
        p[jj] = p[jp];
        jj = jp;
      }
    }
    __syncthreads();
  }
  for (int c = j; c < S; c += blockDim.x) out[c] = c < K ? p[c] : -1;
}

}  // namespace

extern "C" int tl_jv_max_size() { return kMaxS; }

// cost (B, S, S) f32, k_eff (B,) int32, active (B,) uint8 -> col2row (B, S)
// int32, all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() right after the launch.
extern "C" int tl_jv_solve_batched(const float* cost, const int* k_eff,
                                   const uint8_t* active, int* col2row, int B,
                                   int S, void* stream) {
  if (S < 1 || S > kMaxS || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      jv_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((S + 1 + 31) / 32) * 32;
  jv_batched_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      cost, k_eff, active, col2row, S);
  return (int)cudaGetLastError();
}
