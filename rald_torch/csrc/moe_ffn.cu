// The routed experts' feed-forward of a mixture-of-experts layer, grouped by
// expert, bf16, Hopper (rald_torch/ops/moe_ffn.py moe_grouped_ffn).
//
// The rows x (rows, D) come sorted by expert: expert e owns rows
// [off[e], off[e+1]), off an (E + 1) int32 array in device memory. For each
// row r of expert e, with its float32 gate weight g[r]:
//
//     h = bf16(gelu(bf16(x W1_e^T + b1_e)))          (rows, inner) scratch
//     y = bf16(bf16(h W2_e^T + b2_e) * g[r])         (rows, D)
//
// with the weights stacked by expert: w1 (E, inner, D), b1 (E, inner), w2
// (E, D, inner), b2 (E, D); exact GELU (erff) in f32. These are the rounding
// points of the plain version, a per-expert loop of F.linear / F.gelu.
//
// Why a kernel: the routing is computed on the device, and a per-expert loop
// would need each expert's row count on the host, a synchronise that a
// captured CUDA graph cannot hold; computing every expert on every row, or
// padding each expert to the whole batch, does E / top_k or E times the
// routed work. Here each GEMM is one launch whose grid is fixed by the number
// of rows alone: ceil(rows / BM) + E row tiles (the most that E experts'
// ceil(n_e / BM) tiles can sum to) by the output's column tiles. A block
// reads the E + 1 offsets, finds which expert's tile its row tile is (the
// experts' tiles in expert order), and exits if it is past the last one. A
// tile that runs past its expert's end loads the next rows anyway (TMA; past
// the last row it reads zeros) and stores only its expert's rows, so no row
// is dropped and an expert is padded only to its last tile. Two launches a
// call, whatever the routing.
//
// Each GEMM is the warp-specialised TMA + wgmma GEMM of sm90_gemm.cuh, its
// block's A row and B (weight) row taken from the offsets: one producer warp
// keeps TMA loads of the 128-row A tile and the 128-row weight tile of its
// expert in flight through a ring of STAGES shared-memory stages; two
// consumer warpgroups of 64 rows run m64n128k16 wgmma with f32 sums in
// registers. Blocks are grouped GM row tiles at a time, the row tile moving
// fastest inside a group, so the group's A rows stay in L2 while its weight
// tiles stream once per group. No sum uses atomics: the output is the same
// from run to run, and a replay gives the eager call's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_gemm.cuh"

namespace {

using sm90::bf16;
using sm90::BK_BYTES;

constexpr int WG = 2;         // consumer warpgroups
constexpr int BM = WG * 64;   // rows of a tile
constexpr int BN = 128;       // output columns of a tile
constexpr int STAGES = 3;     // ring stages; two blocks per SM
constexpr int GM = 8;         // row tiles per group of the block order
constexpr int MAX_E = 256;

enum { GELU1 = 0, GATE2 = 1 };

struct Args {
  const int* off;      // (E + 1) row offsets of the experts
  int experts, rows;   // E; rows of A and of the output
  int k_tiles, ncols;  // K / 64; output columns (per expert)
  int row_tiles;       // ceil(rows / BM) + E
  const bf16* bias;    // (E, ncols)
  const float* gate;   // (rows), GATE2
  bf16* out;           // (rows, ncols)
};

// row tile t of the grouped M axis -> its expert e and rows [m0, m1) of the
// expert (m0 the tile's first row); false past the last expert's last tile
__device__ __forceinline__ bool find_tile(const int* off, int experts, int t, int& e, int& m0,
                                          int& m1) {
  int base = 0;
  for (int i = 0; i < experts; ++i) {
    const int a = off[i], b = off[i + 1];
    const int n = (b - a + BM - 1) / BM;
    if (t < base + n) {
      e = i;
      m0 = a + (t - base) * BM;
      m1 = b;
      return true;
    }
    base += n;
  }
  return false;
}

template <int EPI>
__global__ void __launch_bounds__(WG * 128 + 32, 2)
moe_grouped_ffn_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, const Args p) {
  using S = sm90::Smem<WG, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];

  // the block's row tile and column tile, grouped GM row tiles at a time
  const int n_tiles = p.ncols / BN;
  const int bid = blockIdx.x;
  const int group = bid / (GM * n_tiles);
  const int first = group * GM;
  const int gm = min(GM, p.row_tiles - first);
  const int local = bid - group * GM * n_tiles;
  const int t = first + local % gm;
  const int n0 = (local / gm) * BN;
  int e, m0, m1;
  if (!find_tile(p.off, p.experts, t, e, m0, m1)) return;  // uniform over the block

  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * S::STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], WG * 4);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == WG * 4) {
    // producer warp: one thread issues every TMA load of the block
    if (lane == 0) {
      const int b_row = e * p.ncols + n0;  // the expert's weight rows
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) sm90::mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* a = smem + s * S::STAGE;
        sm90::mbar_arrive_expect_tx(&full[s], S::STAGE);
        sm90::tma_load_2d(a, &map_a, &full[s], kt * 64, m0);
        sm90::tma_load_2d(a + S::A, &map_b, &full[s], kt * 64, b_row);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [m0 + 64 wg, m0 + 64 wg + 64) of the tile
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < p.k_tiles; ++kt) {
    const int s = kt % STAGES;
    sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint64_t da = sm90::desc_sw128(smem + s * S::STAGE + wg * 64 * BK_BYTES);
    const uint64_t db = sm90::desc_sw128(smem + s * S::STAGE + S::A);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK_BYTES / 32; ++k)
      sm90::wgmma_k(acc, sm90::desc_advance_k(da, k), sm90::desc_advance_k(db, k));
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    // the previous stage's products are done: hand its buffers back
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
    if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // register 4j + 2i + c of a thread holds row r0 + 8 i, column n0 + 8 j +
  // cq + c of the tile
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const bf16* bias = p.bias + (long long)e * p.ncols;
  float g[2] = {0.f, 0.f};
  if constexpr (EPI == GATE2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < m1) g[i] = p.gate[r0 + 8 * i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + cq;
    const float b0 = __bfloat162float(bias[c]), b1 = __bfloat162float(bias[c + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= m1) continue;
      const int q = 4 * j + 2 * i;
      float y0 = sm90::bf16_round(acc[q] + b0), y1 = sm90::bf16_round(acc[q + 1] + b1);
      if constexpr (EPI == GELU1) {
        y0 = 0.5f * y0 * (1.f + erff(y0 * 0.7071067811865476f));
        y1 = 0.5f * y1 * (1.f + erff(y1 * 0.7071067811865476f));
      } else {
        y0 *= g[i];
        y1 *= g[i];
      }
      sm90::store2(p.out, (long long)r * p.ncols + c, y0, y1);
    }
  }
}

template <int EPI>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const Args& p,
                   cudaStream_t st) {
  using S = sm90::Smem<WG, BN, STAGES>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(moe_grouped_ffn_kernel<EPI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               S::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int blocks = p.row_tiles * (p.ncols / BN);
  moe_grouped_ffn_kernel<EPI><<<blocks, WG * 128 + 32, S::BYTES, st>>>(map_a, map_b, p);
  return cudaGetLastError();
}

}  // namespace

// x (rows, dim) bf16 sorted by expert, off (experts + 1) int32 on the device,
// w1 (experts, inner, dim), b1 (experts, inner), w2 (experts, dim, inner),
// b2 (experts, dim) bf16, gate (rows) f32, scratch h (rows, inner) and out
// (rows, dim) bf16; dim and inner multiples of 128; x, w1, w2, h 16-byte
// aligned. Two launches.
extern "C" int rald_moe_grouped_ffn(const void* x, const int* off, int experts, int rows, int dim,
                                    int inner, const void* w1, const void* b1, const void* w2,
                                    const void* b2, const float* gate, void* h, void* out,
                                    void* stream) {
  if (experts <= 0 || experts > MAX_E || rows <= 0 || dim <= 0 || inner <= 0 || dim % BN != 0 ||
      inner % BN != 0 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(h) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap map_x, map_w1, map_h, map_w2;
  cudaError_t e = sm90::cached_map_bf16(&map_x, x, rows, dim, BM);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_w1, w1, (uint64_t)experts * inner, dim, BN);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_h, h, rows, inner, BM);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_w2, w2, (uint64_t)experts * dim, inner, BN);
  if (e != cudaSuccess) return (int)e;
  Args p = {};
  p.off = off;
  p.experts = experts;
  p.rows = rows;
  p.row_tiles = (rows + BM - 1) / BM + experts;
  p.k_tiles = dim * 2 / BK_BYTES;
  p.ncols = inner;
  p.bias = static_cast<const bf16*>(b1);
  p.out = static_cast<bf16*>(h);
  e = launch<GELU1>(map_x, map_w1, p, st);
  if (e != cudaSuccess) return (int)e;
  p.k_tiles = inner * 2 / BK_BYTES;
  p.ncols = dim;
  p.bias = static_cast<const bf16*>(b2);
  p.gate = gate;
  p.out = static_cast<bf16*>(out);
  return (int)launch<GATE2>(map_h, map_w2, p, st);
}
