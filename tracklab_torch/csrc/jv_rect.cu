// K2: V independent exact rectangular assignments (Jonker-Volgenant shortest
// augmenting path over R rows and C >= R columns), one CTA per problem, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tracklab_tpu/ops/assignment_pallas.py
// (_jv_rect_batched_kernel, launched by solve_rect_batched_pallas). The TPU
// kernel keeps all V problems on the sublanes of one tile and gathers rows
// and bumps duals through one-hot contractions, because Mosaic has no
// gather. Here each problem is its own CTA with one thread per column: a row
// of the cost block is a plain shared-memory read, and the row dual bump is
// a scattered write by the thread that owns the used column.
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
// but latency. The R rows run one after another, each a chain of dependent
// block-wide argmins (two __syncthreads per step). The cost block (when it
// fits), duals and path state stay in shared memory and registers, so a
// step touches no device memory; independent problems run side by side, one
// per CTA.
//
// Entry (V, R, C), R <= C <= 256: problem b writes col2row[b, c] = the row
// assigned to column c, or R when the column is unassigned. A problem whose
// active[b] is 0 writes R everywhere at once, so callers can discard a
// result on the device without a host sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 256;
constexpr int kMaxThreads = 288;  // >= kMaxC + 1 (the virtual column), x32
constexpr int kMaxWarps = kMaxThreads / 32;
// cost blocks up to this size are staged in shared memory; larger ones are
// read from device memory (through L1/L2) at each step
constexpr size_t kMaxSmemCost = 160 * 1024;

__device__ __forceinline__ void merge_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void jv_rect_batched_kernel(const float* __restrict__ cost,
                                       const uint8_t* __restrict__ active,
                                       int* __restrict__ col2row, int R, int C,
                                       int cost_in_smem) {
  extern __shared__ float c_sh[];  // R x C, row stride C
  __shared__ float u[kMaxC + 1];
  __shared__ int p[kMaxC + 1];
  __shared__ int way[kMaxC];
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  const int FREE = R;  // sentinel row: column unassigned
  int* out = col2row + (size_t)b * C;
  if (!active[b]) {
    for (int c = j; c < C; c += blockDim.x) out[c] = FREE;
    return;
  }
  const float INF = __int_as_float(0x7f800000);
  const float* cb = cost + (size_t)b * R * C;
  if (cost_in_smem) {
    for (int idx = j; idx < R * C; idx += blockDim.x) c_sh[idx] = cb[idx];
    cb = c_sh;
  }
  if (j <= R) u[j] = 0.f;
  if (j <= C) p[j] = FREE;
  float vj = 0.f;  // this thread's column potential (j < C)
  __syncthreads();

  for (int i = 0; i < R; ++i) {
    if (j == 0) p[C] = i;  // the virtual column C holds row i
    float minv = INF;
    bool used = false;
    int j0 = C;
    __syncthreads();
    while (true) {
      const int i0 = p[j0];
      if (i0 == FREE) break;  // uniform: every thread reads the same j0
      if (j == j0) used = true;
      float reach = INF;
      if (j < C && !used) {
        const float cur = __fsub_rn(__fsub_rn(cb[i0 * C + j], u[i0]), vj);
        if (cur < minv) {
          minv = cur;
          way[j] = j0;
        }
        reach = minv;
      }
      // block-wide argmin, lowest column index on ties
      float bv = reach;
      int bi = j < C ? j : kMaxThreads;
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
      if (j <= C && used) {
        const int r = p[j];
        u[r] = __fadd_rn(u[r], delta);
        vj = __fsub_rn(vj, delta);
      } else if (j < C) {
        minv = __fsub_rn(minv, delta);
      }
      j0 = j1;
      __syncthreads();
    }
    // augment along the predecessor columns back to the virtual column
    if (j == 0) {
      int jj = j0;
      while (jj != C) {
        const int jp = way[jj];
        p[jj] = p[jp];
        jj = jp;
      }
    }
    __syncthreads();
  }
  for (int c = j; c < C; c += blockDim.x) out[c] = p[c];
}

}  // namespace

extern "C" int tl_jv_rect_max_cols() { return kMaxC; }

// cost (V, R, C) f32, active (V,) uint8 -> col2row (V, C) int32, all
// contiguous on the device, 1 <= R <= C <= kMaxC. Launches on `stream` and
// returns cudaGetLastError() right after the launch.
extern "C" int tl_jv_rect_solve_batched(const float* cost,
                                        const uint8_t* active, int* col2row,
                                        int V, int R, int C, void* stream) {
  if (V < 1 || R < 1 || R > C || C > kMaxC) return (int)cudaErrorInvalidValue;
  const size_t cost_bytes = (size_t)R * C * sizeof(float);
  const int in_smem = cost_bytes <= kMaxSmemCost;
  const size_t smem = in_smem ? cost_bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      jv_rect_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((C + 1 + 31) / 32) * 32;
  jv_rect_batched_kernel<<<V, threads, smem, (cudaStream_t)stream>>>(
      cost, active, col2row, R, C, in_smem);
  return (int)cudaGetLastError();
}
