// Fused LayerNorm/AdaLN-mod + self-attention + residual, int8 and bf16,
// Hopper.
//
// Replaces the TPU kernels rald_tpu/ops/attn_kernel.py
// ::fused_self_attention_block_int8 (Pallas body _int8_kernel),
// ::fused_self_attention_block_int8_vout (_int8_vout_kernel) and, in its
// bf16 mode (rald_fused_self_attention_block_bf16 at the end of this file),
// ::fused_self_attention_block (_kernel). The int8 kernels compute:
//
//   y = x + dequant(int8(attn_out) . wo^T) + bo,
//   attn_out = per head softmax(q k^T * dh^-0.5) v      (8 heads of 64)
//
// with q / k / v from h = mod(LN(x)) (f32) quantized per row once: int8
// projections dequantized (acc * hmax/127) * s and rounded to bf16; in the
// vout variant q and k come from bf16 h and bf16 weights (f32 sums). Scores
// f32, e = exp(s - max), a = bf16(e / sum e), a . v summed in f32; attn_out
// stays f32 and is quantized per row over all heads before the out
// projection.
//
// What bounds it on an H100: per batch element of 512 tokens the four
// projections are 1.07 G int8 operations (0.54 us at 1,979 TOPS) and the
// attention 0.54 GFLOP bf16 (0.54 us at 989 TFLOP/s), against 0.5 MB of
// activations in and out and 1 MB of int8 weights (0.6 us at 3.35 TB/s).
//
// Design. The TPU kernel holds one batch element's whole x (0.5 MB) and all
// weights in VMEM; an SM has 227 KB of shared memory, so the sublayer is
// tiled in stages:
//   1. ln_quant_kernel: one warp per row -> hq int8, hmax/127 (and bf16 h
//      for vout);
//   2. projection GEMMs (int8_common.cuh, 64 x 64 mma.sync tiles): q / k / v
//      in one launch (blockIdx.z picks the weight), or for vout q / k in one
//      bf16 launch and v in an int8 one. q, k land row-major (B*N, D) bf16,
//      v transposed per batch (B, D, N_pad) so that a . v reads it as the
//      mma's column operand;
//   3. attn_core_kernel: a block per (64-query tile, head, batch element)
//      keeps its 64 rows of scores for all N keys in shared memory
//      (64 x N_pad f32, 128 KB at N = 512), so the softmax is exact and not
//      online: the JAX kernel rounds the normalised weights to bf16 before
//      a . v, which an online softmax cannot reproduce. q . k^T and a . v
//      are bf16 m16n8k16 mma; the normalised weights overwrite their own
//      score rows in place as bf16. attn_out (f32) is written with each
//      row's max |value| over the head, folded into a per-row atomicMax;
//   4. quant_rows_kernel: attn_out -> int8 and amax/127 per row;
//   5. int8 GEMM with the residual epilogue: (acc * amax/127) * so + bo + x.
//
// The bf16 mode computes y = bf16(attn_out . wo^T + bo + x) with every
// projection bf16 (f32 sums rounded to bf16), bo rounded to bf16 by the
// caller, and each head's a . v rounded to bf16 (the TPU kernel's
// per-head astype): stage 1 writes only bf16 h, stage 2 is one bf16 launch
// for q / k / v, stage 3 stores bf16 attn_out and no row maxima, stage 4 is
// skipped, and stage 5 is a bf16 GEMM with the same residual epilogue. Per
// batch element of 512 tokens it does 1.07 GFLOP of bf16 projections and
// 0.54 GFLOP of attention (1.6 us at 989 TFLOP/s) against 2 MB of weights
// and 1 MB of activations (0.9 us at 3.35 TB/s): operations bound it.
#include <math.h>

#include "int8_common.cuh"

using namespace rald;

namespace {

constexpr int DH = 64;           // head width (the only one this build takes)
constexpr int BQ = 64;           // query rows per block (4 warps x 16)
constexpr int BKV = 64;          // keys per K / V^T tile
constexpr int AT = 128;
constexpr int KLD = DH + 8;      // bf16 per K / V^T tile row: 144 bytes, conflict-free
constexpr int MAX_TOKENS = 832;  // score rows of 64 x (832 + 4) f32 + one tile fit in 227 KB
constexpr size_t TILE_BYTES = size_t(BKV) * KLD * sizeof(bf16);

size_t core_smem(int n_pad) { return size_t(BQ) * (n_pad + 4) * sizeof(float) + TILE_BYTES; }

// grid (n_pad / BQ, heads, batch); q, k (B*N, D) bf16; vt (B, D, n_pad)
// bf16; o (B*N, D): f32 with amax (B*N) zero-filled, receiving max |o| per
// row, or (BF16_OUT) bf16 rounded per head, amax unused
template <bool BF16_OUT>
__global__ void __launch_bounds__(AT)
attn_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ vt, void* __restrict__ o, float* __restrict__ amax,
                 int n_tok, int n_pad, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sld = n_pad + 4;  // floats per score row
  float* S = reinterpret_cast<float*>(smem);
  bf16* T = reinterpret_cast<bf16*>(smem + size_t(BQ) * sld * sizeof(float));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r_loc = warp * 16 + g;             // this thread's first row in the block
  const int r0 = blockIdx.x * BQ + r_loc;      // its query rows r0, r0 + 8 (within batch)
  const long long rowbase = (long long)b * n_tok;

  // q fragments of the warp's 16 rows: 4 k-steps of 16 over the head width
  unsigned qf[4][4];
  {
    const bf16* qb = q + rowbase * D + h * DH + t * 2;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e & 1) * 8;
        const int c = ks * 16 + (e >> 1) * 8;
        qf[ks][e] = r < n_tok ? *reinterpret_cast<const unsigned*>(qb + (long long)r * D + c) : 0u;
      }
    }
  }

  // ---- scores: S[r][key] = (q . k) * scale for every key tile
  for (int kt = 0; kt < n_pad / BKV; ++kt) {
    __syncthreads();
    for (int i = tid; i < BKV * (DH / 8); i += AT) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int key = kt * BKV + r;
      const bool ok = key < n_tok;
      cp_async16(T + r * KLD + c, k + (rowbase + (ok ? key : 0)) * D + h * DH + c, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bf16* pb = T + (j * 8 + g) * KLD + ks * 16 + t * 2;
        const unsigned bb[2] = {*reinterpret_cast<const unsigned*>(pb),
                                *reinterpret_cast<const unsigned*>(pb + 8)};
        mma(c4, qf[ks], bb);
      }
      const int col = kt * BKV + j * 8 + t * 2;
      S[r_loc * sld + col] = __fmul_rn(c4[0], scale);
      S[r_loc * sld + col + 1] = __fmul_rn(c4[1], scale);
      S[(r_loc + 8) * sld + col] = __fmul_rn(c4[2], scale);
      S[(r_loc + 8) * sld + col + 1] = __fmul_rn(c4[3], scale);
    }
  }
  __syncwarp();

  // ---- softmax of the warp's own 16 rows; a = bf16(e / sum e) overwrites
  // the front of its score row (zeros for the padded keys)
  for (int rr = 0; rr < 16; ++rr) {
    float* srow = S + (warp * 16 + rr) * sld;
    float mx = -INFINITY;
    for (int j = lane; j < n_tok; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n_tok; j += 32) {
      const float e = expf(__fsub_rn(srow[j], mx));
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    bf16* arow = reinterpret_cast<bf16*>(srow);
    for (int j0 = 0; j0 < n_pad; j0 += 32) {
      const int j = j0 + lane;
      const float e = j < n_tok ? srow[j] : 0.f;
      __syncwarp();  // every lane has read before bf16 writes reach floats [j0/2, j0/2 + 16)
      arow[j] = __float2bfloat16(j < n_tok ? __fdiv_rn(e, sum) : 0.f);
      __syncwarp();
    }
  }

  // ---- attn_out = a . v over key tiles of V^T
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf16* vb = vt + ((long long)b * D + h * DH) * n_pad;
  const bf16* arow0 = reinterpret_cast<const bf16*>(S + r_loc * sld) + t * 2;
  const bf16* arow1 = reinterpret_cast<const bf16*>(S + (r_loc + 8) * sld) + t * 2;
  for (int kt = 0; kt < n_pad / BKV; ++kt) {
    __syncthreads();
    for (int i = tid; i < DH * (BKV / 8); i += AT) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int key0 = kt * BKV + c;
      const int valid = n_tok - key0;
      const int bytes = valid >= 8 ? 16 : (valid > 0 ? valid * 2 : 0);
      cp_async16(T + r * KLD + c, vb + (long long)r * n_pad + (bytes ? key0 : 0), bytes);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      const int kc = kt * BKV + ks * 16;
      const unsigned af[4] = {*reinterpret_cast<const unsigned*>(arow0 + kc),
                              *reinterpret_cast<const unsigned*>(arow1 + kc),
                              *reinterpret_cast<const unsigned*>(arow0 + kc + 8),
                              *reinterpret_cast<const unsigned*>(arow1 + kc + 8)};
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const bf16* pb = T + (j * 8 + g) * KLD + ks * 16 + t * 2;
        const unsigned bb[2] = {*reinterpret_cast<const unsigned*>(pb),
                                *reinterpret_cast<const unsigned*>(pb + 8)};
        mma(acc[j], af, bb);
      }
    }
  }

  if (BF16_OUT) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + hh * 8;
      if (r >= n_tok) continue;
      bf16* orow = reinterpret_cast<bf16*>(o) + (rowbase + r) * D + h * DH + t * 2;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
    return;
  }
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    m0 = fmaxf(m0, fmaxf(fabsf(acc[j][0]), fabsf(acc[j][1])));
    m1 = fmaxf(m1, fmaxf(fabsf(acc[j][2]), fabsf(acc[j][3])));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + hh * 8;
    if (r >= n_tok) continue;
    float* orow = reinterpret_cast<float*>(o) + (rowbase + r) * D + h * DH + t * 2;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    if (t == 0) atomic_max_nonneg(amax + rowbase + r, hh ? m1 : m0);
  }
}

// Opt the core kernel into its dynamic shared memory once per variant.
template <bool BF16_OUT>
cudaError_t core_attr() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(attn_core_kernel<BF16_OUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)core_smem(MAX_TOKENS));
  done = e == cudaSuccess;
  return e;
}

template <bool BF16_OUT>
cudaError_t launch_core(const void* q, const void* k, const void* vt, void* o, void* amax,
                        int batch, int n_tok, int n_pad, int heads, cudaStream_t st) {
  cudaError_t e = core_attr<BF16_OUT>();
  if (e != cudaSuccess) return e;
  attn_core_kernel<BF16_OUT><<<dim3(n_pad / BQ, heads, batch), AT, core_smem(n_pad), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)vt, o, (float*)amax, n_tok, n_pad,
      1.f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace

extern "C" int rald_attn_width() { return D; }
extern "C" int rald_attn_head_dim() { return DH; }
extern "C" int rald_attn_max_tokens() { return MAX_TOKENS; }

// vout = 0: wq / wk int8 with f32 row scales sq / sk; vout = 1: wq / wk bf16,
// sq / sk ignored. Workspaces (caller-allocated): hq int8 (B*N, D); hrow f32
// (B*N); hb bf16 (B*N, D) (vout only); q, k bf16 (B*N, D); vt bf16
// (B, D, n_pad) with n_pad = N rounded up to 64; o f32 (B*N, D); arow f32
// (B*N); aq int8 (B*N, D).
extern "C" int rald_fused_self_attention_block_int8(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* wq,
    const void* sq, const void* wk, const void* sk, const void* wv, const void* sv,
    const void* wo, const void* so, const void* bo, void* hq, void* hrow, void* hb, void* q,
    void* k, void* vt, void* o, void* arow, void* aq, void* out, int batch, int n_tok, int heads,
    int vout, int scale_shift_mod, float eps, void* stream) {
  if (heads * DH != D || n_tok <= 0 || n_tok > MAX_TOKENS || batch <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = batch * n_tok;
  const int n_pad = (n_tok + BKV - 1) / BKV * BKV;
  cudaError_t e = launch_ln_quant(x, s, b, mod_bstride, hq, hrow, vout ? hb : nullptr, nullptr,
                                  rows, n_tok, scale_shift_mod, eps, st);
  if (e != cudaSuccess) return (int)e;

  GemmParams pp = gemm_params();
  pp.M = rows;
  pp.ldo = D;
  pp.n_tok = n_tok;
  pp.n_pad = n_pad;
  if (vout) {
    pp.A = (const unsigned char*)hb;
    pp.lda = pp.K = D * (int)sizeof(bf16);
    pp.ldb = D * sizeof(bf16);
    pp.B[0] = (const unsigned char*)wq;
    pp.B[1] = (const unsigned char*)wk;
    pp.out[0] = q;
    pp.out[1] = k;
    e = launch_gemm<false, EPI_STORE>(pp, D, 2, st);
    if (e != cudaSuccess) return (int)e;
    pp.A = (const unsigned char*)hq;
    pp.lda = pp.K = D;
    pp.ldb = D;
    pp.rowscale = (const float*)hrow;
    pp.B[0] = (const unsigned char*)wv;
    pp.colscale[0] = (const float*)sv;
    pp.out[0] = vt;
    pp.transposed[0] = 1;
    e = launch_gemm<true, EPI_STORE>(pp, D, 1, st);
  } else {
    pp.A = (const unsigned char*)hq;
    pp.lda = pp.K = D;
    pp.ldb = D;
    pp.rowscale = (const float*)hrow;
    const void* ws[3] = {wq, wk, wv};
    const void* ss[3] = {sq, sk, sv};
    void* os[3] = {q, k, vt};
    for (int i = 0; i < 3; ++i) {
      pp.B[i] = (const unsigned char*)ws[i];
      pp.colscale[i] = (const float*)ss[i];
      pp.out[i] = os[i];
    }
    pp.transposed[2] = 1;
    e = launch_gemm<true, EPI_STORE>(pp, D, 3, st);
  }
  if (e != cudaSuccess) return (int)e;

  e = cudaMemsetAsync(arow, 0, sizeof(float) * rows, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_core<false>(q, k, vt, o, arow, batch, n_tok, n_pad, heads, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_quant_rows(o, rows, D, arow, aq, st);
  if (e != cudaSuccess) return (int)e;

  GemmParams po = gemm_params();
  po.A = (const unsigned char*)aq;
  po.lda = D;
  po.M = rows;
  po.K = D;
  po.B[0] = (const unsigned char*)wo;
  po.ldb = D;
  po.rowscale = (const float*)arow;
  po.colscale[0] = (const float*)so;
  po.bias = (const float*)bo;
  po.resid = (const bf16*)x;
  po.out[0] = out;
  po.ldo = D;
  return (int)launch_gemm<true, EPI_RESID>(po, D, 1, st);
}

// bf16 mode (fused_self_attention_block): wq / wk / wv / wo bf16 in the
// torch layout (out, in), bo f32 holding the bf16-rounded bias.
// Workspaces (caller-allocated): hb, q, k, o bf16 (B*N, D); vt bf16
// (B, D, n_pad) with n_pad = N rounded up to 64.
extern "C" int rald_fused_self_attention_block_bf16(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bo, void* hb, void* q, void* k,
    void* vt, void* o, void* out, int batch, int n_tok, int heads, int scale_shift_mod, float eps,
    void* stream) {
  if (heads * DH != D || n_tok <= 0 || n_tok > MAX_TOKENS || batch <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = batch * n_tok;
  const int n_pad = (n_tok + BKV - 1) / BKV * BKV;
  cudaError_t e = launch_ln_quant(x, s, b, mod_bstride, nullptr, nullptr, hb, nullptr, rows,
                                  n_tok, scale_shift_mod, eps, st);
  if (e != cudaSuccess) return (int)e;

  GemmParams pp = gemm_params();
  pp.A = (const unsigned char*)hb;
  pp.lda = pp.K = D * (int)sizeof(bf16);
  pp.M = rows;
  pp.ldb = D * sizeof(bf16);
  const void* ws[3] = {wq, wk, wv};
  void* os[3] = {q, k, vt};
  for (int i = 0; i < 3; ++i) {
    pp.B[i] = (const unsigned char*)ws[i];
    pp.out[i] = os[i];
  }
  pp.transposed[2] = 1;
  pp.ldo = D;
  pp.n_tok = n_tok;
  pp.n_pad = n_pad;
  e = launch_gemm<false, EPI_STORE>(pp, D, 3, st);
  if (e != cudaSuccess) return (int)e;

  e = launch_core<true>(q, k, vt, o, nullptr, batch, n_tok, n_pad, heads, st);
  if (e != cudaSuccess) return (int)e;

  GemmParams po = gemm_params();
  po.A = (const unsigned char*)o;
  po.lda = po.K = D * (int)sizeof(bf16);
  po.M = rows;
  po.B[0] = (const unsigned char*)wo;
  po.ldb = D * sizeof(bf16);
  po.bias = (const float*)bo;
  po.resid = (const bf16*)x;
  po.out[0] = out;
  po.ldo = D;
  return (int)launch_gemm<false, EPI_RESID>(po, D, 1, st);
}
