// Fused LayerNorm/AdaLN-mod + GEGLU feed-forward + residual, bf16 or f32,
// Hopper.
//
// Replaces the TPU kernel rald_tpu/ops/geglu_kernel.py::fused_ln_geglu_residual
// (Pallas body _ln_kernel). For x (B, N, D) it computes
//
//     out = x + W2 (a * GELU(g)) + b2,   [a | g] = W1 mod(LN(x)) + b1
//
// with mod(h) = h (1 + s) + b (AdaLN, scale_shift_mod = 1) or h s + b (affine
// LayerNorm, scale_shift_mod = 0), one (s, b) row per batch element or one row
// broadcast over the batch (mod_bstride = 0). Weights come in the torch layout:
// w1 (2*inner, D) with value rows [0, inner) and gate rows [inner, 2*inner),
// w2 (D, inner). Rounding points mirror the TPU kernel and the plain PyTorch
// version (rald_torch/ops/geglu_kernel.py): LN statistics in f32 as
// E[x^2]-E[x]^2; h rounded to x's type after mod; W1 product + b1 rounded;
// GELU (exact erf) in f32 then rounded; a * GELU(g) rounded; W2 product + b2
// + x summed in f32 and rounded once. Every rounding is a no-op for f32 x.
//
// The same stages without the LN and the residual replace
// rald_tpu/ops/geglu_kernel.py::geglu_ff (Pallas body _kernel):
// out = W2 (a * GELU(g)) + b2 with [a | g] = W1 x + b1 over token-flattened
// x (tokens, D), at the same rounding points, with a free out_dim (w2
// (out_dim, inner), out_dim a multiple of 16).
//
// What bounds it on an H100: at D = 512, inner = 2048 the sublayer does
// 6.29 MFLOP per token row against ~2 KB of activation traffic per row plus
// 6 MB of weights, so from 512 rows on it is bound by tensor-core operations
// (3.22 GFLOP at B = 1: 3.3 us at 989 TFLOP/s bf16; 26 us at B = 8), not by
// bytes. Only wgmma reaches that rate, and only when its operands arrive in
// shared memory ahead of it and each weight tile there feeds many rows.
//
// Design (bf16): three launches per call, each one pass over its rows.
//  1. LN + mod (fused_ln_geglu_residual only; int8_common.cuh's
//     ln_quant_kernel): one warp per token row writes h = bf16(mod(LN(x)))
//     into a (rows, D) scratch; the modulation row of token row r is r / N
//     (mod_bstride = D) or row 0 (mod_bstride = 0).
//  2. GEMM1 with a GEGLU epilogue: P = h W1^T on 128-row tiles. A block's
//     output tile pairs 64 value columns [j, j+64) with their 64 gate columns
//     [inner+j, inner+j+64): two TMA boxes of W1 that sit back to back in
//     shared memory as one 128-row operand, so one m64n128k16 wgmma per
//     16-deep slice gives value and gate in the same registers of the same
//     thread. The epilogue adds b1, takes the gate's GELU and the gated
//     product in registers and stores g (rows, inner) bf16 (16 MB at B = 8,
//     L2-resident for the next launch).
//  3. GEMM2 with the output epilogue: out = bf16(g W2^T + b2 (+ x)), one K
//     loop over all inner columns in order (no split-K partials), on 64- or
//     128-row by 64- or 128-column tiles chosen by the wrapper so that the
//     grid fills the card (geglu_kernel.py gemm2_tile).
// Both GEMMs are sm90_gemm.cuh's warp-specialised GEMM (shared with
// attn.cu): one producer warp keeps TMA loads of the A tile and the weight
// boxes in flight through a ring of shared-memory stages (128-byte swizzle,
// one full and one empty mbarrier per stage), and one or two consumer
// warpgroups of 64 rows each run wgmma with f32 accumulators in registers,
// releasing a stage as soon as the products that read it are done. Rows past
// the end read as zeros (TMA) and are not stored. No sum uses atomics, so the
// output is the same from run to run. GEMM1's K loop is short (8 slices of
// 64), so a block spends much of its time filling the ring and in the GELU
// epilogue; it is compiled for two resident blocks per SM
// (__launch_bounds__ min 2: no spills on sm_90a), so one block's epilogue
// overlaps the other's products. (A persistent grid,
// tried on the card, gained nothing over that.) TMA descriptors are encoded
// on the host and cached by address, shape and box: the weights' hit every
// call, the scratch buffers' whenever the allocator hands back an address.
//
// Design (f32 x): the same three launches in f32, the GEMMs on the CUDA
// cores (f32_gemm.cuh: exact f32 products, as JAX's matmul_precision
// "highest" computes them; its GEGLU epilogue takes the TPU kernel's A&S
// rational erf). No TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_gemm.cuh"
#include "int8_common.cuh"
#include "sm90_gemm.cuh"

namespace {

using sm90::bf16;
using sm90::BJ;
using rald::D;               // model width (the only width this build takes)

constexpr int BM1 = 128;      // GEMM1 rows per block (two consumer warpgroups)
constexpr int STAGES1 = 3;    // GEMM1 stages (K = D: 8 slices)
constexpr int STAGES2 = 4;    // GEMM2 stages (K = inner)

// GEMM1: h (rows, D) x W1 -> g (rows, inner) with the GEGLU epilogue
cudaError_t launch_geglu(const CUtensorMap& map_a, const CUtensorMap& map_w1, int rows, int inner,
                         const void* b1, void* g, cudaStream_t st) {
  sm90::Maps maps = {};
  maps.a = map_a;
  maps.b[0] = map_w1;
  sm90::GemmArgs p = {};
  p.rows = rows;
  p.k_tiles = D * 2 / sm90::BK_BYTES;
  p.inner = inner;
  p.bias = b1;
  p.out[0] = g;
  return sm90::launch_gemm<bf16, sm90::GEGLU, 2, 2 * BJ, STAGES1>(maps, p, 1, st);
}

// GEMM2: g (rows, inner) x W2 -> out (rows, ncols) = bf16(acc + b2 (+ x))
// on (bm, bn) tiles
template <int EPI>
cudaError_t launch_out(int bm, int bn, const CUtensorMap& map_a, const CUtensorMap& map_b,
                       int rows, int inner, int ncols, const void* bias, const void* resid,
                       void* out, cudaStream_t st) {
  sm90::Maps maps = {};
  maps.a = map_a;
  maps.b[0] = map_b;
  sm90::GemmArgs p = {};
  p.rows = rows;
  p.k_tiles = inner * 2 / sm90::BK_BYTES;
  p.ncols = ncols;
  p.bias = bias;
  p.resid = resid;
  p.out[0] = out;
  return sm90::launch_tiled<bf16, EPI, STAGES2>(bm, bn, maps, p, 1, st);
}

// the float32 stages: GEMM1 with the GEGLU epilogue on 128 x 128 tiles,
// GEMM2 with EPI on (bm, bn) tiles (f32_gemm.cuh)
template <int EPI>
cudaError_t run_f32(const float* a, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* resid, float* g, void* out, int rows, int inner,
                    int ncols, int bm, int bn, cudaStream_t st) {
  f32g::Args p1 = {};
  p1.a = a;
  p1.b[0] = (const float*)w1;
  p1.out[0] = g;
  p1.bias = (const float*)b1;
  p1.rows = rows;
  p1.k = D;
  p1.inner = inner;
  cudaError_t e = f32g::launch<sm90::GEGLU>(128, 128, p1, 1, st);
  if (e != cudaSuccess) return e;
  f32g::Args p2 = {};
  p2.a = g;
  p2.b[0] = (const float*)w2;
  p2.out[0] = (float*)out;
  p2.bias = (const float*)b2;
  p2.resid = (const float*)resid;
  p2.rows = rows;
  p2.k = inner;
  p2.ncols = ncols;
  return f32g::launch<EPI>(bm, bn, p2, 1, st);
}

}  // namespace

extern "C" int rald_geglu_width() { return D; }

// inner must be a multiple of this: GEMM1's value / gate column tile and
// GEMM2's K slice
extern "C" int rald_geglu_inner_multiple() { return BJ; }

// x (batch, n_tok, D) of x's type (f32 = 1: float32, else bf16), and s, b,
// w1, b1, w2, b2 and the scratch of the same type: s, b mod rows, batch *
// mod_bstride apart; w1 (2*inner, D), w2 (D, inner); scratch h (batch *
// n_tok, D) and g (batch * n_tok, inner); GEMM2 tiles (bm, bn) in
// {64, 128}^2. x, w1, w2, h and g 16-byte aligned.
extern "C" int rald_fused_ln_geglu_residual(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* w1,
    const void* b1, const void* w2, const void* b2, void* h, void* g, void* out, int batch,
    int n_tok, int inner, int bm, int bn, int f32, int scale_shift_mod, float eps, void* stream) {
  const long long rows_ll = (long long)batch * n_tok;
  if (inner <= 0 || inner % BJ != 0 || n_tok <= 0 || batch <= 0 || rows_ll > (1 << 30) ||
      !sm90::tile_ok(bm, bn) || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const int rows = (int)rows_ll;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32) {
    cudaError_t e = rald::launch_ln_quant<float>(x, s, b, mod_bstride, nullptr, nullptr, h,
                                                 nullptr, rows, n_tok, scale_shift_mod, eps, st);
    if (e == cudaSuccess)
      e = run_f32<sm90::OUT_RESID>((const float*)h, w1, b1, w2, b2, x, (float*)g, out, rows,
                                   inner, D, bm, bn, st);
    return (int)e;
  }
  CUtensorMap map_h, map_w1, map_g, map_w2;
  cudaError_t e = sm90::cached_map_bf16(&map_h, h, rows, D, BM1);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_w1, w1, 2 * (uint64_t)inner, D, BJ);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_g, g, rows, inner, bm);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_w2, w2, D, inner, bn);
  if (e != cudaSuccess) return (int)e;
  e = rald::launch_ln_quant<bf16>(x, s, b, mod_bstride, nullptr, nullptr, h, nullptr, rows, n_tok,
                                  scale_shift_mod, eps, st);
  if (e == cudaSuccess)
    e = launch_geglu(map_h, map_w1, rows, inner, b1, g, st);
  if (e == cudaSuccess)
    e = launch_out<sm90::OUT_RESID>(bm, bn, map_g, map_w2, rows, inner, D, b2, x, out, st);
  return (int)e;
}

// geglu_ff: x (n_tok, D), w1 (2*inner, D), w2 (out_dim, inner), scratch g
// (n_tok, inner), out (n_tok, out_dim), all of x's type (f32 = 1: float32,
// else bf16); out_dim a multiple of 16; GEMM2 tiles (bm, bn) in {64, 128}^2.
// x, w1, w2 and g 16-byte aligned.
extern "C" int rald_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* g, void* out, int n_tok, int inner,
                             int out_dim, int bm, int bn, int f32, void* stream) {
  if (inner <= 0 || inner % BJ != 0 || n_tok <= 0 || out_dim <= 0 || out_dim % 16 != 0 ||
      !sm90::tile_ok(bm, bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return (int)run_f32<sm90::OUT>((const float*)x, w1, b1, w2, b2, nullptr, (float*)g, out,
                                   n_tok, inner, out_dim, bm, bn, st);
  CUtensorMap map_x, map_w1, map_g, map_w2;
  cudaError_t e = sm90::cached_map_bf16(&map_x, x, n_tok, D, BM1);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_w1, w1, 2 * (uint64_t)inner, D, BJ);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_g, g, n_tok, inner, bm);
  if (e == cudaSuccess) e = sm90::cached_map_bf16(&map_w2, w2, out_dim, inner, bn);
  if (e != cudaSuccess) return (int)e;
  e = launch_geglu(map_x, map_w1, n_tok, inner, b1, g, st);
  if (e == cudaSuccess)
    e = launch_out<sm90::OUT>(bm, bn, map_g, map_w2, n_tok, inner, out_dim, b2, nullptr, out, st);
  return (int)e;
}
