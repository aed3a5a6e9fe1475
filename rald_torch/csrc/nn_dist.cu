// Both nearest-neighbour minima of the exact squared-distance matrix, f32.
//
// Replaces the TPU kernel rald_tpu/ops/nn_dist_kernel.py::nn_min_sq_both
// (Pallas body _nn_min_both_kernel). For a (B, N, 3) and b (B, M, 3) it
// returns row[bi, i] = min_j d(a_i, b_j) and col[bi, j] = min_i d(a_i, b_j)
// with d = dx*dx + dy*dy + dz*dz, from one sweep over the (N, M) pairs.
// Padded rows carry BIG = 1e9 coordinates (d ~ 1e18, still finite), as in
// the JAX wrapper; the caller masks the padded rows' own outputs.
//
// Exactness: every distance is formed with explicitly rounded operations
// (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), summed left to
// right exactly as the plain PyTorch version does with separate tensor ops,
// and min is exact, so both outputs are bitwise equal to the plain version and to
// two one-direction passes. No tensor cores, no TF32, no |a|^2+|b|^2-2ab.
//
// What bounds it on an H100: ~8 f32 operations per pair on the CUDA cores
// (5e9 pairs at N = 5e5, M = 1e4: 4e10 FLOP, 0.6 ms at 67 TFLOP/s); the
// bytes (a and b read once, both outputs written once: ~8 MB) are noise.
//
// Design: a block of 256 threads owns 2048 a-rows (8 per thread, held in
// registers) and sweeps every b point through 256-point shared-memory
// tiles. The row min stays in registers for the whole sweep. The column
// min is reduced inside each warp with one redux.sync on the float bit
// pattern (non-negative floats order like their unsigned bits), across the
// block's warps in shared memory, and across blocks -- which CUDA runs in
// no order -- with one atomicMin per (block, b point) on the unsigned bits
// of a buffer the launcher first fills with +inf. All of it is exact.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int RA = 8;        // a rows per thread
constexpr int TA = NT * RA;  // a rows per block
constexpr int TB = 256;      // b points per shared-memory tile
constexpr float FAR = 1e30f; // tail slots: distance overflows to +inf, never wins
constexpr unsigned INF_BITS = 0x7f800000u;

__device__ __forceinline__ float dist2(float ax, float ay, float az, float bx, float by,
                                       float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void fill_inf(unsigned* __restrict__ p, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = INF_BITS;
}

__global__ void __launch_bounds__(NT)
nn_min_both_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ row, unsigned* __restrict__ col, int n, int m) {
  __shared__ float sx[TB], sy[TB], sz[TB];
  __shared__ unsigned cpart[NT / 32][TB];
  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* ab = a + (long long)bi * n * 3;
  const float* bb = b + (long long)bi * m * 3;
  const int i0 = blockIdx.x * TA + threadIdx.x;

  float ax[RA], ay[RA], az[RA], rmin[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = i0 + r * NT;
    const bool ok = i < n;
    ax[r] = ok ? ab[3LL * i] : FAR;
    ay[r] = ok ? ab[3LL * i + 1] : FAR;
    az[r] = ok ? ab[3LL * i + 2] : FAR;
    rmin[r] = __int_as_float(INF_BITS);
  }

  for (int j0 = 0; j0 < m; j0 += TB) {
    __syncthreads();  // previous tile's sx/cpart fully consumed
    for (int t = threadIdx.x; t < TB; t += NT) {
      const int j = j0 + t;
      const bool ok = j < m;
      sx[t] = ok ? bb[3LL * j] : FAR;
      sy[t] = ok ? bb[3LL * j + 1] : FAR;
      sz[t] = ok ? bb[3LL * j + 2] : FAR;
    }
    __syncthreads();
    for (int t = 0; t < TB; ++t) {
      const float bx = sx[t], by = sy[t], bz = sz[t];
      float cm = __int_as_float(INF_BITS);
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const float d = dist2(ax[r], ay[r], az[r], bx, by, bz);
        rmin[r] = fminf(rmin[r], d);
        cm = fminf(cm, d);
      }
      const unsigned wmin = __reduce_min_sync(0xffffffffu, __float_as_uint(cm));
      if (lane == 0) cpart[warp][t] = wmin;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < TB; t += NT) {
      const int j = j0 + t;
      if (j < m) {
        unsigned v = cpart[0][t];
#pragma unroll
        for (int w = 1; w < NT / 32; ++w) v = min(v, cpart[w][t]);
        atomicMin(col + (long long)bi * m + j, v);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = i0 + r * NT;
    if (i < n) row[(long long)bi * n + i] = rmin[r];
  }
}

}  // namespace

extern "C" int rald_nn_min_sq_both_f32(const void* a, const void* b, void* row, void* col,
                                       int batch, int n, int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long ncol = (long long)batch * m;
  fill_inf<<<(unsigned)((ncol + 255) / 256), 256, 0, st>>>((unsigned*)col, ncol);
  dim3 grid((n + TA - 1) / TA, batch);
  nn_min_both_kernel<<<grid, NT, 0, st>>>((const float*)a, (const float*)b, (float*)row,
                                          (unsigned*)col, n, m);
  return (int)cudaGetLastError();
}
