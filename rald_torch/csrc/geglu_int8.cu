// Fused LayerNorm/AdaLN-mod + int8 GEGLU feed-forward + residual, Hopper
// (sm_90a).
//
// Replaces the TPU kernels rald_tpu/ops/geglu_kernel.py
// ::fused_ln_geglu_residual_int8 (Pallas body _ln_int8_kernel) and
// ::fused_ln_geglu_residual_int8_static (_ln_int8_static_kernel). For x
// (B, N, D) bf16 or f32, int8 weights w1q (2*inner, D) / w2q (D, inner)
// (torch layout, value rows [0, inner), gate rows [inner, 2*inner)) with f32
// row scales and f32 biases:
//
//   h  = mod(LN(x)) in f32; hq = int8(h)          (dynamic: per row, 127/hmax;
//                                                   static: clip(h * inv_h))
//   p  = dequant(hq . w1q^T) + b1                 (dynamic: (acc*hmax/127)*s1;
//                                                   static: acc * d1)
//   g  = p[:, :inner] * gelu_poly(p[:, inner:])   (f32, transcendental-free)
//   gq = int8(g)                                  (dynamic: per row over all
//                                                   inner columns; static: inv_g)
//   out = round(dequant(gq . w2q^T) + b2 + x)     (x's type)
//
// What bounds it on an H100: at D = 512, inner = 2048 the sublayer does
// 6.29 M int8 operations per token row against ~1-2 KB of activations per
// row plus 3 MB of int8 weights: 3.22 G operations at B = 1 (1.6 us at 1,979
// TOPS int8) against 3.6 MB of bytes (1.1 us at 3.35 TB/s), so operations
// bound it, by little; at B = 8 operations by 8x. Only wgmma reaches the
// int8 rate.
//
// Design: the dynamic variant needs max|g| over a whole 2048-wide row before
// any column of g can be quantized, so the sublayer runs as stages, each one
// pass over its rows:
//   1. ln_quant_kernel (int8_common.cuh): one warp per row -> hq int8 (M, D)
//      and hmax/127;
//   2. GEMM1 hq . w1q^T on sm90_gemm.cuh's TMA-fed, warp-specialised int8
//      wgmma with the Q8_GEGLU epilogue: a block's 128-row B tile is 64
//      value rows of w1q and their 64 gate rows (two TMA boxes back to back,
//      as the bf16 kernel pairs them), so value and gate of a column sit in
//      the same thread; it dequantizes, forms g = val * gelu_poly(gate) and
//      writes g f32 (M, inner) with each row's max |g| over its 64 columns
//      into a (M, inner/64) partials buffer -- no zero fill, no atomics;
//   3. quant_rows_kernel: amax over the row's partials, g -> gq int8 and
//      gmax/127;
//   4. GEMM2 gq . w2q^T, K = inner, on the same GEMM with the Q8_RESID
//      epilogue (dequant + b2 + x, rounded once to x's type), on tiles the
//      wrapper picks so that the grid fills the card (gemm2_tile).
// The static variant knows its multipliers: GEMM1's epilogue (Q8_GEGLU_S)
// writes gq directly, stage 3 goes, and GEMM2 runs with no row scale (a scale of 1:
// (acc * 1) * d2 is bitwise acc * d2). Launches: 4 dynamic, 3 static. The
// s32 sums are exact and every dequant step keeps int8_common.cuh's order
// and _rn intrinsics, so the output does not depend on the tiling. With x in
// f32 only the LN input, the residual and the output change type: the codes
// and the GEMMs are the same.
#include "int8_common.cuh"
#include "sm90_gemm.cuh"

namespace {

using rald::D;
using sm90::BJ;

constexpr int BM1 = 128;     // GEMM1 rows per block (two consumer warpgroups)
constexpr int STAGES1 = 3;   // GEMM1 stages (K = D: 4 int8 slices)
constexpr int STAGES2 = 4;   // GEMM2 stages (K = inner)

template <typename T>
cudaError_t run(const void* x, const void* s, const void* b, long long mod_bstride,
                const void* w1q, const void* c1, const void* b1, const void* w2q, const void* c2,
                const void* b2, const void* inv_h, const void* inv_g, void* hq, void* hrow,
                void* g, void* gpart, void* gq, void* grow, void* out, int rows, int n_tok,
                int inner, int bm, int bn, int scale_shift_mod, float eps, cudaStream_t st) {
  const bool stat = inv_h != nullptr;
  sm90::Maps m1 = {}, m2 = {};
  cudaError_t e = sm90::cached_map(&m1.a, hq, rows, D, BM1, 1);
  if (e == cudaSuccess) e = sm90::cached_map(&m1.b[0], w1q, 2 * (uint64_t)inner, D, BJ, 1);
  if (e == cudaSuccess) e = sm90::cached_map(&m2.a, gq, rows, inner, bm, 1);
  if (e == cudaSuccess) e = sm90::cached_map(&m2.b[0], w2q, D, inner, bn, 1);
  if (e != cudaSuccess) return e;

  e = rald::launch_ln_quant<T>(x, s, b, mod_bstride, hq, stat ? nullptr : hrow, nullptr, inv_h,
                               rows, n_tok, scale_shift_mod, eps, st);
  if (e != cudaSuccess) return e;

  sm90::GemmArgs p1 = {};
  p1.rows = rows;
  p1.k_tiles = D / sm90::BK_BYTES;
  p1.inner = inner;
  p1.bias = b1;
  p1.rowscale = stat ? nullptr : (const float*)hrow;
  p1.colscale[0] = (const float*)c1;
  p1.out[0] = stat ? gq : g;
  p1.gpart = (float*)gpart;
  p1.inv_g = (const float*)inv_g;
  e = stat ? sm90::launch_gemm<int8_t, sm90::Q8_GEGLU_S, 2, 2 * BJ, STAGES1>(m1, p1, 1, st)
           : sm90::launch_gemm<int8_t, sm90::Q8_GEGLU, 2, 2 * BJ, STAGES1>(m1, p1, 1, st);
  if (e != cudaSuccess) return e;

  if (!stat) {
    e = rald::launch_quant_rows(g, rows, inner, gpart, inner / BJ, gq, grow, st);
    if (e != cudaSuccess) return e;
  }

  sm90::GemmArgs p2 = {};
  p2.rows = rows;
  p2.k_tiles = inner / sm90::BK_BYTES;
  p2.ncols = D;
  p2.bias = b2;
  p2.resid = x;
  p2.rowscale = stat ? nullptr : (const float*)grow;
  p2.colscale[0] = (const float*)c2;
  p2.out[0] = out;
  return sm90::launch_tiled<int8_t, sm90::Q8_RESID, STAGES2, T>(bm, bn, m2, p2, 1, st);
}

}  // namespace

extern "C" int rald_int8_width() { return D; }

// inner must be a multiple of this: GEMM1's value / gate column tile and
// GEMM2's 128-byte K slice
extern "C" int rald_int8_inner_multiple() { return 2 * BJ; }

// x, s, b and out of x's type (f32 = 1: float32, else bf16). Workspaces
// (allocated by the caller, 16-byte aligned): hq int8 (B*N, D); gq int8
// (B*N, inner); dynamic only: hrow f32 (B*N), g f32 (B*N, inner), gpart f32
// (B*N, inner / 64), grow f32 (B*N). c1 / c2 are s1 / s2 (dynamic) or d1 /
// d2 (static); inv_h / inv_g are device pointers to one f32 each, null for
// the dynamic variant. GEMM2 tiles (bm, bn) in {64, 128}^2.
extern "C" int rald_fused_ln_geglu_residual_int8(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* w1q,
    const void* c1, const void* b1, const void* w2q, const void* c2, const void* b2,
    const void* inv_h, const void* inv_g, void* hq, void* hrow, void* g, void* gpart, void* gq,
    void* grow, void* out, int batch, int n_tok, int inner, int bm, int bn, int f32,
    int scale_shift_mod, float eps, void* stream) {
  const long long rows = (long long)batch * n_tok;
  if (inner <= 0 || inner % (2 * BJ) != 0 || n_tok <= 0 || batch <= 0 || rows > (1 << 30) ||
      !sm90::tile_ok(bm, bn) || ((inv_h == nullptr) != (inv_g == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto launch = f32 ? &run<float> : &run<rald::bf16>;
  return (int)launch(x, s, b, mod_bstride, w1q, c1, b1, w2q, c2, b2, inv_h, inv_g, hq, hrow, g,
                     gpart, gq, grow, out, (int)rows, n_tok, inner, bm, bn, scale_shift_mod, eps,
                     st);
}
