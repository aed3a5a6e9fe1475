// Fused LayerNorm/AdaLN-mod + int8 GEGLU feed-forward + residual, Hopper.
//
// Replaces the TPU kernels rald_tpu/ops/geglu_kernel.py
// ::fused_ln_geglu_residual_int8 (Pallas body _ln_int8_kernel) and
// ::fused_ln_geglu_residual_int8_static (_ln_int8_static_kernel). For x
// (B, N, D) bf16, int8 weights w1q (2*inner, D) / w2q (D, inner) (torch
// layout, value rows [0, inner), gate rows [inner, 2*inner)) with f32 row
// scales and f32 biases:
//
//   h  = mod(LN(x)) in f32; hq = int8(h)          (dynamic: per row, 127/hmax;
//                                                   static: clip(h * inv_h))
//   p  = dequant(hq . w1q^T) + b1                 (dynamic: (acc*hmax/127)*s1;
//                                                   static: acc * d1)
//   g  = p[:, :inner] * gelu_poly(p[:, inner:])   (f32, transcendental-free)
//   gq = int8(g)                                  (dynamic: per row over all
//                                                   inner columns; static: inv_g)
//   out = bf16(dequant(gq . w2q^T) + b2 + x)
//
// What bounds it on an H100: at D = 512, inner = 2048 the sublayer does
// 6.29 M int8 operations per token row against ~1 KB of activations per row
// plus 3 MB of int8 weights: 3.22 G operations at B = 1 (1.6 us at 1,979
// TOPS int8) against 3.6 MB of bytes (1.1 us at 3.35 TB/s), so operations
// bound it, by little; at B = 8 operations by 8x.
//
// Design. The dynamic variant needs max|g| over a whole 2048-wide row before
// any column of g can be quantized, so the sublayer runs as stages rather
// than one fused loop (the bf16 kernel's chunk folding does not carry over):
//   1. ln_quant_kernel: one warp per row -> hq int8 (M, D) and hmax/127;
//   2. int8 GEMM hq . w1q^T with the GEGLU epilogue: each 64-column tile
//      pairs 32 value rows with the 32 matching gate rows of w1q, so a block
//      holds both halves of its g columns; it writes g f32 to a (M, inner)
//      workspace and folds its row maxima into a per-row atomicMax;
//   3. quant_rows_kernel: g -> gq int8 and gmax/127 per row;
//   4. int8 GEMM gq . w2q^T with the residual epilogue.
// The static variant knows its multipliers, so stage 2 writes gq directly
// and stage 3 goes. The GEMMs are mma.sync m16n8k32 int8 tensor-core tiles
// of 64 x 64 fed by a 3-stage cp.async ring (int8_common.cuh); wgmma and
// TMA are for a later change.
#include "int8_common.cuh"

using namespace rald;

extern "C" int rald_int8_width() { return D; }

// Workspaces (allocated by the caller): hq int8 (B*N, D); hrow f32 (B*N)
// (dynamic only); g f32 (B*N, inner) (dynamic only); gq int8 (B*N, inner);
// grow f32 (B*N) (dynamic only). c1 / c2 are s1 / s2 (dynamic) or d1 / d2
// (static); inv_h / inv_g are device pointers to one f32 each, null for the
// dynamic variant.
extern "C" int rald_fused_ln_geglu_residual_int8(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* w1q,
    const void* c1, const void* b1, const void* w2q, const void* c2, const void* b2,
    const void* inv_h, const void* inv_g, void* hq, void* hrow, void* g, void* gq, void* grow,
    void* out, int batch, int n_tok, int inner, int is_static, int scale_shift_mod, float eps,
    void* stream) {
  if (inner % BN != 0 || inner % BK != 0 || n_tok <= 0 || batch <= 0 ||
      (is_static && (inv_h == nullptr || inv_g == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = batch * n_tok;
  cudaError_t e = launch_ln_quant(x, s, b, mod_bstride, hq, is_static ? nullptr : hrow, nullptr,
                                  is_static ? inv_h : nullptr, rows, n_tok, scale_shift_mod, eps,
                                  st);
  if (e != cudaSuccess) return (int)e;
  if (!is_static) {
    e = cudaMemsetAsync(grow, 0, sizeof(float) * rows, st);
    if (e != cudaSuccess) return (int)e;
  }

  GemmParams p1 = gemm_params();
  p1.A = (const signed char*)hq;
  p1.lda = D;
  p1.M = rows;
  p1.K = D;
  p1.B = (const signed char*)w1q;
  p1.ldb = D;
  p1.half = inner;
  p1.rowscale = is_static ? nullptr : (const float*)hrow;
  p1.colscale = (const float*)c1;
  p1.bias = (const float*)b1;
  p1.g = (float*)g;
  p1.g_rowmax = (float*)grow;
  p1.gq = (signed char*)gq;
  p1.inv_g = is_static ? (const float*)inv_g : nullptr;
  e = launch_gemm<EPI_GEGLU>(p1, 2 * inner, st);
  if (e != cudaSuccess) return (int)e;

  if (!is_static) {
    e = launch_quant_rows(g, rows, inner, grow, 1, gq, grow, st);
    if (e != cudaSuccess) return (int)e;
  }

  GemmParams p2 = gemm_params();
  p2.A = (const signed char*)gq;
  p2.lda = inner;
  p2.M = rows;
  p2.K = inner;
  p2.B = (const signed char*)w2q;
  p2.ldb = inner;
  p2.rowscale = is_static ? nullptr : (const float*)grow;
  p2.colscale = (const float*)c2;
  p2.bias = (const float*)b2;
  p2.resid = (const bf16*)x;
  p2.out = (bf16*)out;
  p2.ldo = D;
  return (int)launch_gemm<EPI_RESID>(p2, D, st);
}
