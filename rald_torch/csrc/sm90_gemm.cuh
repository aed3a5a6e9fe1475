// Warp-specialised GEMM for Hopper (sm_90a), shared by geglu.cu,
// geglu_int8.cu and attn.cu: C = A B^T with A (rows, K) and B (*, K) both
// K-major, read through TMA maps (sm90_common.cuh: 128-byte swizzle, 128
// bytes of K per box row), and computed by wgmma, bf16 x bf16 -> f32 or
// int8 x int8 -> s32, with the epilogues of the kernels that use it.
//
// One block owns a (WG*64)-row tile of A and an N-row tile of B. One producer
// warp keeps TMA loads of both in flight through a ring of STAGES
// shared-memory stages (one full and one empty mbarrier per stage); WG
// consumer warpgroups of 64 rows each run wgmma with their sums in registers,
// releasing a stage as soon as the products that read it are done. Rows past
// the end read as zeros (TMA) and are not stored. No sum uses atomics, so
// the output is the same from run to run. blockIdx.z picks one of up to
// three B maps (with its column scales and output): several projections of
// the same A in one launch, with no concatenated weight.
//
// Epilogues (register 4j + 2i + e of a thread holds row 16 (warp % 4) +
// lane / 4 + 8 i, column 8 j + 2 (lane % 4) + e of its warpgroup's tile).
// O is the output type (and the residual's) of the non-GEGLU epilogues,
// bf16 or f32; "round" below is a rounding to O (none for f32):
//   GEGLU      bf16: B's N = 128 rows are W1's value rows [n0, n0+64) and
//              their gate rows [inner+n0, inner+n0+64); out (rows, inner) =
//              bf16(val * gelu(gate)) at the plain version's rounding points
//   OUT        bf16: out (rows, ncols) = round(acc + bias), bias bf16
//   OUT_RESID  bf16: out = round(acc + bias + resid)
//   STORE      bf16: out[z] (rows, ncols) = round(acc)
//   Q8_STORE   int8: out[z] = round((acc * rowscale) * colscale[z])
//   Q8_RESID   int8: out = round(((acc * rowscale) * colscale[0] + bias) + resid),
//              bias f32
//   Q8_GEGLU   int8, B paired as in GEGLU: p = (acc * rowscale) * colscale[0]
//              + bias (f32, value and gate columns alike), g = val *
//              gelu_poly(gate) in f32; out[0] (rows, inner) f32 = g and
//              gpart (rows, inner / 64) = the tile's max |g| of each row
//              (rald::quant_rows_kernel reduces the partials)
//   Q8_GEGLU_S the same g, with static scales: out[0] (rows, inner) int8 =
//              round(clip(g * inv_g, +-127)), each thread's codes gathered
//              by a 4-lane shuffle into 16-byte stores
// A null rowscale is a row scale of 1 ((acc * 1) * c is bitwise acc * c).
// The int8 dequant keeps int8_common.cuh's order and _rn intrinsics (no FMA
// contraction): the s32 sums are exact, so these equal a plain version that
// rounds at the same points, whatever order the sums were taken in.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "int8_common.cuh"
#include "sm90_common.cuh"

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int BK_BYTES = 128;  // K bytes per stage: one 128-byte swizzled row
constexpr int BJ = 64;         // GEGLU: inner columns per block (64 value + 64 gate rows)

enum Epi {
  GEGLU = 0, OUT = 1, OUT_RESID = 2, STORE = 3, Q8_STORE = 4, Q8_RESID = 5,
  Q8_GEGLU = 6,    // dynamic scales: g f32 and row-max partials
  Q8_GEGLU_S = 7,  // static scales: g codes
};

// the A map and up to three B maps (blockIdx.z picks one), passed by value
// as one __grid_constant__ parameter so TMA reads them from parameter space
struct Maps {
  CUtensorMap a;
  CUtensorMap b[3];
};

struct GemmArgs {
  int rows, k_tiles;        // rows of A and C; K / 128 bytes
  int inner, ncols;         // (Q8_)GEGLU: W1's value rows; others: columns of C per z
  const void* bias;         // bf16 (GEGLU, OUT, OUT_RESID) or f32 (Q8_*)
  const void* resid;        // (rows, ncols), of the output's type
  const float* rowscale;    // (rows) or null, Q8_*
  const float* colscale[3]; // (ncols) per z, Q8_*
  void* out[3];             // per z
  float* gpart;             // Q8_GEGLU: (rows, inner / BJ) row maxima
  const float* inv_g;       // Q8_GEGLU_S: one f32 multiplier 127 / amax
};

// shared memory of a GEMM block: STAGES x (A tile of WG*64 rows, B tile of N
// rows), each 128 bytes of K, then the barriers; + 1 KB to align the tiles to
// the 1024-byte swizzle atom
template <int WG, int N, int STAGES>
struct Smem {
  static constexpr int A = WG * 64 * BK_BYTES;
  static constexpr int B = N * BK_BYTES;
  static constexpr int STAGE = A + B;
  static constexpr int BYTES = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// (value, gate) product sums -> the gated value, at the plain version's
// rounding points (rald_torch/ops/geglu_kernel.py); the caller rounds the result
__device__ __forceinline__ float geglu(float v, float g, float bv, float bg) {
  const float val = bf16_round(v + bv);
  const float gate = bf16_round(g + bg);
  const float gl = bf16_round(0.5f * gate * (1.f + erff(gate * 0.7071067811865476f)));
  return val * gl;
}

// a pair of O values at out + i, and back
__device__ __forceinline__ void store2(bf16* out, long long i, float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(y0, y1);
}
__device__ __forceinline__ void store2(float* out, long long i, float y0, float y1) {
  *reinterpret_cast<float2*>(out + i) = make_float2(y0, y1);
}
__device__ __forceinline__ float2 as_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 as_float2(float2 v) { return v; }

// one 32-byte-deep wgmma of the consumer's 64 rows against the B tile
__device__ __forceinline__ void wgmma_k(float (&d)[32], uint64_t a, uint64_t b) { wgmma_bf16(d, a, b); }
__device__ __forceinline__ void wgmma_k(float (&d)[64], uint64_t a, uint64_t b) { wgmma_bf16(d, a, b); }
__device__ __forceinline__ void wgmma_k(int (&d)[32], uint64_t a, uint64_t b) { wgmma_s8(d, a, b); }
__device__ __forceinline__ void wgmma_k(int (&d)[64], uint64_t a, uint64_t b) { wgmma_s8(d, a, b); }

// T: bf16 or int8_t operands; O: bf16 or float output. Compiled for two
// resident blocks per SM where the ring is short (STAGES <= 3, the K = 512
// GEMMs), so one block's epilogue overlaps the other's products.
template <typename T, int EPI, int WG, int N, int STAGES, typename O>
__global__ void __launch_bounds__(WG * 128 + 32, STAGES <= 3 ? 2 : 1)
gemm_kernel(const __grid_constant__ Maps maps, const GemmArgs p) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr bool PAIRED = EPI == GEGLU || EPI == Q8_GEGLU || EPI == Q8_GEGLU_S;
  constexpr int KCOLS = BK_BYTES / int(sizeof(T));  // K columns per stage
  typedef typename std::conditional<INT8, int, float>::type Acc;
  using S = Smem<WG, N, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * S::STAGE);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int z = blockIdx.z;
  const int n0 = blockIdx.x * (PAIRED ? BJ : N);
  const int m0 = blockIdx.y * WG * 64;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WG * 4) {
    // producer warp: one thread issues every TMA load of the block
    if (lane == 0) {
      const CUtensorMap* map_b = z == 0 ? &maps.b[0] : z == 1 ? &maps.b[1] : &maps.b[2];
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* a = smem + s * S::STAGE;
        uint8_t* bt = a + S::A;
        mbar_arrive_expect_tx(&full[s], S::STAGE);
        tma_load_2d(a, &maps.a, &full[s], kt * KCOLS, m0);
        if constexpr (PAIRED) {
          tma_load_2d(bt, map_b, &full[s], kt * KCOLS, n0);
          tma_load_2d(bt + BJ * BK_BYTES, map_b, &full[s], kt * KCOLS, p.inner + n0);
        } else {
          tma_load_2d(bt, map_b, &full[s], kt * KCOLS, n0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [m0 + 64 wg, m0 + 64 wg + 64) of the tile
  const int wg = warp >> 2;
  Acc acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < p.k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* a = smem + s * S::STAGE + wg * 64 * BK_BYTES;
    const uint64_t da = desc_sw128(a);
    const uint64_t db = desc_sw128(smem + s * S::STAGE + S::A);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK_BYTES / 32; ++k)
      wgmma_k(acc, desc_advance_k(da, k), desc_advance_k(db, k));
    wgmma_commit();
    fence_regs(acc);
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  if constexpr (EPI == GEGLU) {
    const bf16* bias = static_cast<const bf16*>(p.bias);
    bf16* out = static_cast<bf16*>(p.out[0]);
#pragma unroll
    for (int j = 0; j < BJ / 8; ++j) {
      const int c = n0 + 8 * j + cq;  // inner column; its gate is N/2 registers on
      const float bv0 = __bfloat162float(bias[c]), bv1 = __bfloat162float(bias[c + 1]);
      const float bg0 = __bfloat162float(bias[p.inner + c]);
      const float bg1 = __bfloat162float(bias[p.inner + c + 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r < p.rows) {
          const int q = 4 * j + 2 * i;
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * p.inner + c) =
              __floats2bfloat162_rn(geglu(acc[q], acc[N / 4 + q], bv0, bg0),
                                    geglu(acc[q + 1], acc[N / 4 + q + 1], bv1, bg1));
        }
      }
    }
  } else if constexpr (EPI == Q8_GEGLU || EPI == Q8_GEGLU_S) {
    constexpr bool STAT = EPI == Q8_GEGLU_S;
    const float* bias = static_cast<const float*>(p.bias);
    const float* cs = p.colscale[0];
    const float ig = STAT ? *p.inv_g : 0.f;
    float rs[2], mx[2] = {0.f, 0.f};
    // STAT: codes of rows r0 / r0 + 8, four column groups a word: word u
    // holds groups 2u, 2u + 1 (bytes: group 2u's two columns, then 2u+1's)
    uint32_t w[2][4] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rs[i] = p.rowscale != nullptr && r0 + 8 * i < p.rows ? p.rowscale[r0 + 8 * i] : 1.f;
#pragma unroll
    for (int j = 0; j < BJ / 8; ++j) {
      const int c = n0 + 8 * j + cq;  // inner column; its gate is N/2 registers on
      const float cv[2] = {cs[c], cs[c + 1]}, cg[2] = {cs[p.inner + c], cs[p.inner + c + 1]};
      const float bv[2] = {bias[c], bias[c + 1]};
      const float bg[2] = {bias[p.inner + c], bias[p.inner + c + 1]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = 4 * j + 2 * i;
        float g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float val = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[q + e]), rs[i]), cv[e]), bv[e]);
          const float gate = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[N / 4 + q + e]), rs[i]), cg[e]), bg[e]);
          g[e] = __fmul_rn(val, rald::gelu_poly(gate));
          if constexpr (STAT) {
            const uint32_t code = (uint8_t)rald::q8(fminf(fmaxf(__fmul_rn(g[e], ig), -127.f), 127.f));
            w[i][j >> 1] |= code << (8 * (2 * (j & 1) + e));
          } else {
            mx[i] = fmaxf(mx[i], fabsf(g[e]));
          }
        }
        const int r = r0 + 8 * i;
        if (!STAT && r < p.rows)
          store2(static_cast<float*>(p.out[0]), (long long)r * p.inner + c, g[0], g[1]);
      }
    }
    const int t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if constexpr (STAT) {
        // a 4 x 4 transpose of words among the row's four threads: thread t
        // gathers word t of each thread s (v[s]), i.e. columns 16 t .. 16 t +
        // 15 of the tile, and stores them as one 16-byte vector
        const uint32_t w0 = w[i][0], w1 = w[i][1], w2 = w[i][2], w3 = w[i][3];
        auto pick = [=](int u) { return u == 0 ? w0 : u == 1 ? w1 : u == 2 ? w2 : w3; };
        const uint32_t got1 = __shfl_xor_sync(0xffffffffu, pick(t ^ 1), 1);
        const uint32_t got2 = __shfl_xor_sync(0xffffffffu, pick(t ^ 2), 2);
        const uint32_t got3 = __shfl_xor_sync(0xffffffffu, pick(t ^ 3), 3);
        uint32_t v[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int k = s ^ t;
          v[s] = k == 0 ? pick(t) : k == 1 ? got1 : k == 2 ? got2 : got3;
        }
        if (r < p.rows)
          *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out[0]) + (long long)r * p.inner + n0 +
                                    16 * t) =
              make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                         __byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632));
      } else {
        // the tile's row maxima: the four threads of a row (lanes 4g .. 4g+3)
        // hold its 64 columns
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (t == 0 && r < p.rows) p.gpart[(long long)r * (p.inner / BJ) + blockIdx.x] = mx[i];
      }
    }
  } else {
    // z's output and column scales picked without indexing the parameter
    // arrays by a run-time value, which would copy the whole GemmArgs to
    // local memory
    O* out = static_cast<O*>(z == 0 ? p.out[0] : z == 1 ? p.out[1] : p.out[2]);
    typedef typename std::conditional<std::is_same<O, float>::value, float2, __nv_bfloat162>::type
        Pair;
    const O* resid = static_cast<const O*>(p.resid);
    const float* colscale = z == 0 ? p.colscale[0] : z == 1 ? p.colscale[1] : p.colscale[2];
    // the row scales and residual pairs this thread needs are read before
    // the stores they feed: the compiler cannot move a load above a store to
    // `out` (it may alias), so loads left among the stores would each wait
    // out a memory latency in turn. Residuals go in chunks of 8 registers
    // (4 column groups in bf16, 2 in f32), so the register cap of two
    // blocks per SM holds.
    constexpr bool RESID = EPI == OUT_RESID || EPI == Q8_RESID;
    constexpr int JC = std::is_same<O, float>::value ? 2 : 4;
    float rs[2] = {0.f, 0.f};
    if constexpr (EPI == Q8_STORE || EPI == Q8_RESID) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r0 + 8 * i < p.rows) rs[i] = p.rowscale != nullptr ? p.rowscale[r0 + 8 * i] : 1.f;
    }
#pragma unroll
    for (int j0 = 0; j0 < N / 8; j0 += JC) {
      Pair xr[RESID ? JC : 1][2];
      if constexpr (RESID) {
#pragma unroll
        for (int jj = 0; jj < JC; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = r0 + 8 * i, c = n0 + 8 * (j0 + jj) + cq;
            if (r < p.rows && c < p.ncols)
              xr[jj][i] = *reinterpret_cast<const Pair*>(resid + (long long)r * p.ncols + c);
          }
      }
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj;
        const int c = n0 + 8 * j + cq;
        if (c >= p.ncols) continue;  // ncols % 16 == 0: uniform over the 8-column group
        float bb0 = 0.f, bb1 = 0.f, cs0 = 0.f, cs1 = 0.f;
        if constexpr (EPI == OUT || EPI == OUT_RESID) {
          const bf16* bias = static_cast<const bf16*>(p.bias);
          bb0 = __bfloat162float(bias[c]);
          bb1 = __bfloat162float(bias[c + 1]);
        }
        if constexpr (EPI == Q8_STORE || EPI == Q8_RESID) {
          cs0 = colscale[c];
          cs1 = colscale[c + 1];
        }
        if constexpr (EPI == Q8_RESID) {
          const float* bias = static_cast<const float*>(p.bias);
          bb0 = bias[c];
          bb1 = bias[c + 1];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          if (r >= p.rows) continue;
          const int q = 4 * j + 2 * i;
          float y0, y1;
          if constexpr (EPI == OUT || EPI == OUT_RESID) {
            y0 = acc[q] + bb0;
            y1 = acc[q + 1] + bb1;
            if constexpr (EPI == OUT_RESID) {
              const float2 x = as_float2(xr[jj][i]);
              y0 += x.x;
              y1 += x.y;
            }
          } else if constexpr (EPI == STORE) {
            y0 = acc[q];
            y1 = acc[q + 1];
          } else {
            y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[q]), rs[i]), cs0);
            y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[q + 1]), rs[i]), cs1);
            if constexpr (EPI == Q8_RESID) {
              const float2 x = as_float2(xr[jj][i]);
              y0 = __fadd_rn(__fadd_rn(y0, bb0), x.x);
              y1 = __fadd_rn(__fadd_rn(y1, bb1), x.y);
            }
          }
          store2(out, (long long)r * p.ncols + c, y0, y1);
        }
      }
    }
  }
}

// one launch of (WG*64) x N tiles over all rows and columns, nz B maps
template <typename T, int EPI, int WG, int N, int STAGES, typename O = bf16>
cudaError_t launch_gemm(const Maps& maps, const GemmArgs& p, int nz, cudaStream_t st) {
  using S = Smem<WG, N, STAGES>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(gemm_kernel<T, EPI, WG, N, STAGES, O>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               S::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int col_tiles =
      EPI == GEGLU || EPI == Q8_GEGLU || EPI == Q8_GEGLU_S ? p.inner / BJ : (p.ncols + N - 1) / N;
  const dim3 grid(col_tiles, (p.rows + WG * 64 - 1) / (WG * 64), nz);
  gemm_kernel<T, EPI, WG, N, STAGES, O><<<grid, WG * 128 + 32, S::BYTES, st>>>(maps, p);
  return cudaGetLastError();
}

inline bool tile_ok(int bm, int bn) { return (bm == 64 || bm == 128) && (bn == 64 || bn == 128); }

// the GEMM on (bm, bn) output tiles, chosen by the caller so that the grid
// fills the card (rald_torch/ops/geglu_kernel.py gemm2_tile); map a's boxes
// are bm rows, the b maps' bn rows
template <typename T, int EPI, int STAGES, typename O = bf16>
cudaError_t launch_tiled(int bm, int bn, const Maps& maps, const GemmArgs& p, int nz,
                         cudaStream_t st) {
  if (bm == 128 && bn == 128) return launch_gemm<T, EPI, 2, 128, STAGES, O>(maps, p, nz, st);
  if (bm == 128) return launch_gemm<T, EPI, 2, 64, STAGES, O>(maps, p, nz, st);
  if (bn == 128) return launch_gemm<T, EPI, 1, 128, STAGES, O>(maps, p, nz, st);
  return launch_gemm<T, EPI, 1, 64, STAGES, O>(maps, p, nz, st);
}

}  // namespace sm90
