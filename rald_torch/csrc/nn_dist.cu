// Both nearest-neighbour minima of the exact squared-distance matrix, f32.
//
// Replaces the TPU kernels rald_tpu/ops/nn_dist_kernel.py::nn_min_sq_both
// (Pallas body _nn_min_both_kernel) and ::nn_min_sq_batch (_nn_min_kernel).
// For a (B, N, 3) and b (B, M, 3) the two-way kernel returns
// row[bi, i] = min_j d(a_i, b_j) and col[bi, j] = min_i d(a_i, b_j) with
// d = dx*dx + dy*dy + dz*dz, from one sweep over the (N, M) pairs; the
// row-only kernel (rald_nn_min_sq_batch_f32) is the same sweep without the
// column minima, so its output is bitwise the two-way kernel's rows. Padded
// rows carry BIG = 1e9 coordinates (d ~ 1e18, still finite), as in the JAX
// wrapper; the caller masks the padded rows' own outputs.
//
// Exactness: every distance is formed with explicitly rounded operations
// (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), summed left to
// right exactly as the plain PyTorch version does with separate tensor ops,
// and min is exact and independent of order, so both outputs are bitwise
// equal to the plain version and to two one-direction passes, whatever the
// grid. No tensor cores, no TF32, no |a|^2+|b|^2-2ab.
//
// What bounds it on an H100: the FP32 issue rate, not the flop rate. Each
// pair costs 8 FP32 instructions (3 FSUB, 3 FMUL, 2 FADD; the exact form
// cannot contract into FMAs) plus its minima, and an FADD or FMUL takes a
// whole issue slot for one flop. Each SM sub-partition issues one warp
// instruction a clock, so the distances alone take 5e9 pairs * 8 / (132 SMs
// * 128 lanes * 1.98 GHz) ~ 1.2 ms a frame at N = 5e5, M = 1e4; the flop
// bound (8 flops at 67 TFLOP/s, 0.6 ms) assumes FMAs and is out of reach.
// The bytes (a and b read once, the outputs written once: ~8 MB) are noise.
//
// Design. A block of 256 threads owns 4096 a rows (16 per thread, in
// registers, at most 128 registers so two blocks share an SM) and sweeps one
// slice of the b points through 512-point shared-memory tiles held as float4
// (x, y, z, pad), so one broadcast LDS.128 brings a point to a warp.
// - The grid is (a tiles, S slices of M, B frames). The launcher is given S,
//   which the wrapper plans (nn_dist_kernel.py split_plan) so that the
//   blocks fill the card several times over even when N is small: a slice is
//   a run of whole 64-point chunks, none empty. With S = 1 the row minima are
//   stored; with S > 1 they combine by atomicMin on the unsigned bits
//   (non-negative floats order like their bits) into a buffer the launcher
//   first fills with +inf. Exact, and independent of the order blocks run in.
// - The inner loop takes two points at once and folds two new distances per
//   instruction into each minimum with Hopper's DPX three-input minimum on
//   the unsigned bits (__vimin3_u32): per pair 8 FP32 instructions, half a
//   minimum for the row and, in the two-way kernel, half for the column.
// - Column minima: per point, the thread's 16 rows fold into one value by a
//   tree of minima (3 deep, not a chain 8 deep, so the warp minimum waits
//   less) and one redux.sync takes the warp's minimum. Lane k keeps step k's
//   two minima in registers, and every 32 steps the warp writes its 64
//   minima to shared memory at once (no branch per step); after each tile
//   the block's 8 warps reduce in shared memory and one atomicMin per
//   (block, b point) on the unsigned bits combines blocks into a buffer
//   filled with +inf.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int RA = 16;         // a rows per thread
constexpr int TA = NT * RA;    // a rows per block
constexpr int TB = 512;        // b points per shared-memory tile
constexpr int CHUNK = 64;      // b points per split chunk: a slice is whole chunks
constexpr int MIN_BLOCKS = 2;  // blocks per SM the register budget is held to
constexpr float FAR = 1e30f;   // tail slots: distance overflows to +inf, never wins
constexpr unsigned INF_BITS = 0x7f800000u;

__device__ __forceinline__ unsigned dist2(float ax, float ay, float az, float4 p) {
  const float dx = __fsub_rn(ax, p.x);
  const float dy = __fsub_rn(ay, p.y);
  const float dz = __fsub_rn(az, p.z);
  return __float_as_uint(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

// minima of distances' bits (non-negative floats order like their bits)
__device__ __forceinline__ unsigned min2(unsigned a, unsigned b) { return min(a, b); }

__device__ __forceinline__ unsigned min3(unsigned a, unsigned b, unsigned c) {
  return __vimin3_u32(a, b, c);
}

// min of K values as a shallow tree: an odd count splits into three odd
// parts under one three-input minimum, an even count into two odd halves
// under one two-input minimum. ceil((K - 1) / 2) instructions, as a chain
// takes, but 3 deep for 16 values where the chain is 8 deep.
template <int K>
__device__ __forceinline__ unsigned tree_min(const unsigned* v) {
  if constexpr (K == 1) {
    return v[0];
  } else if constexpr (K == 2) {
    return min2(v[0], v[1]);
  } else if constexpr (K % 2 == 0) {
    constexpr int H = (K / 2) | 1;
    return min2(tree_min<H>(v), tree_min<K - H>(v + H));
  } else {
    constexpr int A = (K / 3) | 1, B = ((K - A) / 2) | 1;
    return min3(tree_min<A>(v), tree_min<B>(v + A), tree_min<K - A - B>(v + A + B));
  }
}

__global__ void fill_inf(unsigned* __restrict__ p, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = INF_BITS;
}

// COL: also the column minima (into col); else col is unused
template <bool COL>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
nn_min_kernel(const float* __restrict__ a, const float* __restrict__ b,
              unsigned* __restrict__ row, unsigned* __restrict__ col, int n, int m) {
  __shared__ float4 sb[TB];
  __shared__ uint2 cpart[COL ? NT / 32 : 1][TB / 2];  // per warp, two points a slot
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* ab = a + (long long)bi * n * 3;
  const float* bb = b + (long long)bi * m * 3;
  const int i0 = blockIdx.x * TA + threadIdx.x;
  // this block's slice of b: chunks [y * C / S, (y + 1) * C / S), none empty
  const long long chunks = (m + CHUNK - 1) / CHUNK;
  const int jb = (int)(blockIdx.y * chunks / gridDim.y) * CHUNK;
  const int je = min((int)((blockIdx.y + 1) * chunks / gridDim.y) * CHUNK, m);

  float ax[RA], ay[RA], az[RA];
  unsigned rmin[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = i0 + r * NT;
    const bool ok = i < n;
    ax[r] = ok ? ab[3LL * i] : FAR;
    ay[r] = ok ? ab[3LL * i + 1] : FAR;
    az[r] = ok ? ab[3LL * i + 2] : FAR;
    rmin[r] = INF_BITS;
  }

  for (int j0 = jb; j0 < je; j0 += TB) {
    const int cnt = min(TB, je - j0);
    __syncthreads();  // previous tile's sb/cpart fully consumed
    for (int t = threadIdx.x; t < TB; t += NT) {
      const long long j = j0 + t;
      sb[t] = t < cnt ? make_float4(bb[3 * j], bb[3 * j + 1], bb[3 * j + 2], 0.f)
                      : make_float4(FAR, FAR, FAR, 0.f);
    }
    __syncthreads();
    // two points a step; an odd count's extra slot is FAR and never flushed.
    // COL: lane k keeps step k's warp minima (of 32 steps), and the warp
    // stores the 32 pairs at once
    uint2 keep = make_uint2(INF_BITS, INF_BITS);
#pragma unroll 2
    for (int t = 0; t < cnt; t += 2) {
      const float4 p = sb[t], q = sb[t + 1];
      unsigned dp[RA], dq[RA];
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        dp[r] = dist2(ax[r], ay[r], az[r], p);
        dq[r] = dist2(ax[r], ay[r], az[r], q);
        rmin[r] = min3(rmin[r], dp[r], dq[r]);
      }
      if (COL) {
        const unsigned wp = __reduce_min_sync(0xffffffffu, tree_min<RA>(dp));
        const unsigned wq = __reduce_min_sync(0xffffffffu, tree_min<RA>(dq));
        const int k = (t >> 1) & 31;
        keep = lane == k ? make_uint2(wp, wq) : keep;
        // slots past the last step hold stale pairs: beyond cnt, never flushed
        if (k == 31 || t + 2 >= cnt) cpart[warp][(t >> 1) - k + lane] = keep;
      }
    }
    if (!COL) continue;
    __syncthreads();
    const unsigned* cw = reinterpret_cast<const unsigned*>(cpart);
    for (int t = threadIdx.x; t < cnt; t += NT) {
      unsigned v = cw[t];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) v = min(v, cw[w * TB + t]);
      atomicMin(col + (long long)bi * m + j0 + t, v);
    }
  }

#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = i0 + r * NT;
    if (i >= n) continue;
    unsigned* dst = row + (long long)bi * n + i;
    if (gridDim.y == 1) {
      *dst = rmin[r];
    } else {
      atomicMin(dst, rmin[r]);
    }
  }
}

bool valid(int batch, int n, int m, int nsplit) {
  return batch > 0 && batch <= 65535 && n > 0 && m > 0 && nsplit >= 1 &&
         nsplit <= (m + CHUNK - 1) / CHUNK && nsplit <= 65535;
}

void fill(void* p, long long cnt, cudaStream_t st) {
  fill_inf<<<(unsigned)((cnt + 255) / 256), 256, 0, st>>>((unsigned*)p, cnt);
}

}  // namespace

// nsplit: the number S of M slices (1 <= S <= ceil(m / 64)), planned by the
// wrapper's split_plan
extern "C" int rald_nn_min_sq_both_f32(const void* a, const void* b, void* row, void* col,
                                       int batch, int n, int m, int nsplit, void* stream) {
  if (!valid(batch, n, m, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  fill(col, (long long)batch * m, st);
  if (nsplit > 1) fill(row, (long long)batch * n, st);
  dim3 grid((n + TA - 1) / TA, nsplit, batch);
  nn_min_kernel<true><<<grid, NT, 0, st>>>((const float*)a, (const float*)b, (unsigned*)row,
                                           (unsigned*)col, n, m);
  return (int)cudaGetLastError();
}

extern "C" int rald_nn_min_sq_batch_f32(const void* a, const void* b, void* row, int batch, int n,
                                        int m, int nsplit, void* stream) {
  if (!valid(batch, n, m, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nsplit > 1) fill(row, (long long)batch * n, st);
  dim3 grid((n + TA - 1) / TA, nsplit, batch);
  nn_min_kernel<false><<<grid, NT, 0, st>>>((const float*)a, (const float*)b, (unsigned*)row,
                                            nullptr, n, m);
  return (int)cudaGetLastError();
}
