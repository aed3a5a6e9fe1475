// Building blocks shared by the int8 kernels (geglu_int8.cu, attn.cu):
// LayerNorm/mod + per-row int8 quantization, per-row quantization of an f32
// matrix, the mma.sync and cp.async helpers (attn.cu's attention core uses
// the bf16 m16n8k16 one), and geglu_int8.cu's tiled int8 GEMM (mma.sync
// m16n8k32 -> s32) whose epilogue dequantizes and adds bias / residual or
// forms the gated product.
//
// Rounding points follow the TPU kernels (rald_tpu/ops/geglu_kernel.py
// _ln_int8_kernel, attn_kernel.py _int8_kernel) and the plain PyTorch
// versions (rald_torch/ops/{geglu,attn}_kernel.py): LN statistics in f32 as
// E[x^2]-E[x]^2; codes round(v * (127 / amax)) half to even, with
// amax = max(max|v|, 1e-6) and 127/amax, amax/127 each one correctly rounded
// division; dequant (acc * rowscale) * colscale; products, sums and
// divisions where the plain version rounds are written with the _rn
// intrinsics so nvcc contracts none of them into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rald {

constexpr int D = 512;  // model width (the only width these builds take)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max of non-negative floats through their bit patterns (they order alike);
// the target is zero-filled before the first update
__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__device__ __forceinline__ signed char q8(float v) { return (signed char)__float2int_rn(v); }

// erf(x) ~= clamp(x, -3, 3) * P(x^2), Horner in f32 without FMA: the
// constrained minimax fit of rald_tpu/ops/geglu_kernel.py _ERF_POLY
__device__ __forceinline__ float gelu_poly(float x) {
  const float c[8] = {1.1278664111e+00f, -3.7308188663e-01f, 1.0751176122e-01f,
                      -2.2562818144e-02f, 3.2815626959e-03f, -3.0865364415e-04f,
                      1.6680301565e-05f, -3.9017459733e-07f};
  float u = fminf(fmaxf(__fmul_rn(x, 0.7071067811865476f), -3.f), 3.f);
  const float u2 = __fmul_rn(u, u);
  float p = c[7];
#pragma unroll
  for (int i = 6; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, u2), c[i]);
  const float erf = __fmul_rn(u, p);
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, erf)));
}

// ---------------------------------------------------------------- LN + quant
// One warp per token row, 16 contiguous columns per lane. h = mod(LN(x)) in
// f32, then int8 codes (when hq is given): dynamic (inv_h null)
// round(h * (127/hmax)) with hrow = hmax/127, or static
// round(clip(h * inv_h, +-127)). hb (optional) receives h rounded to bf16
// (the bf16 q / k / v input).
__global__ void ln_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ s,
                                const bf16* __restrict__ b, long long mod_bstride,
                                signed char* __restrict__ hq, float* __restrict__ hrow,
                                bf16* __restrict__ hb, const float* __restrict__ inv_h, int rows,
                                int n_tok, int scale_shift_mod, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  const long long bi = row / n_tok;
  float v[16], sc[16], sh[16];
  {
    const uint4* xp = reinterpret_cast<const uint4*>(x + (long long)row * D + lane * 16);
    const uint4* sp = reinterpret_cast<const uint4*>(s + bi * mod_bstride + lane * 16);
    const uint4* bp = reinterpret_cast<const uint4*>(b + bi * mod_bstride + lane * 16);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 xv = xp[h], sv = sp[h], bv = bp[h];
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
      const bf16* se = reinterpret_cast<const bf16*>(&sv);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[h * 8 + i] = __bfloat162float(xe[i]);
        sc[h * 8 + i] = __bfloat162float(se[i]);
        sh[h * 8 + i] = __bfloat162float(be[i]);
      }
    }
  }
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sum += v[i];
    sq += v[i] * v[i];
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = __fdiv_rn(sum, (float)D);
  const float var = __fsub_rn(__fdiv_rn(sq, (float)D), __fmul_rn(mean, mean));
  const float inv = rsqrtf(__fadd_rn(var, eps));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float h = __fmul_rn(__fsub_rn(v[i], mean), inv);
    h = scale_shift_mod ? __fadd_rn(__fmul_rn(h, __fadd_rn(1.f, sc[i])), sh[i])
                        : __fadd_rn(__fmul_rn(h, sc[i]), sh[i]);
    v[i] = h;
    amax = fmaxf(amax, fabsf(h));
  }
  if (hq != nullptr) {  // uniform over the warp
    float mult;
    if (inv_h == nullptr) {
      amax = fmaxf(warp_max(amax), 1e-6f);
      mult = __fdiv_rn(127.f, amax);
      if (lane == 0) hrow[row] = __fdiv_rn(amax, 127.f);
    } else {
      mult = *inv_h;
    }
    uint4 codes;
    signed char* ce = reinterpret_cast<signed char*>(&codes);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float u = __fmul_rn(v[i], mult);
      ce[i] = q8(inv_h == nullptr ? u : fminf(fmaxf(u, -127.f), 127.f));
    }
    *reinterpret_cast<uint4*>(hq + (long long)row * D + lane * 16) = codes;
  }
  if (hb != nullptr) {
    uint4 o[2];
    bf16* oe = reinterpret_cast<bf16*>(o);
#pragma unroll
    for (int i = 0; i < 16; ++i) oe[i] = __float2bfloat16(v[i]);
    uint4* dst = reinterpret_cast<uint4*>(hb + (long long)row * D + lane * 16);
    dst[0] = o[0];
    dst[1] = o[1];
  }
}

// ------------------------------------------------------------- row quantize
// One warp per row of an f32 (rows, cols) matrix (cols % 128 == 0): codes
// round(v * (127/amax)) with amax = max(max|v| of the row, 1e-6), where
// rowmax (rows, parts) holds max|v| over `parts` pieces of the row (the
// whole row, or one head each); scale[row] then receives amax/127, the
// row's dequant scale (scale may be rowmax itself when parts == 1).
__global__ void quant_rows_kernel(const float* __restrict__ v, int rows, int cols,
                                  const float* rowmax, int parts, signed char* __restrict__ q,
                                  float* scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  float amax = 0.f;
  for (int i = lane; i < parts; i += 32) amax = fmaxf(amax, rowmax[(long long)row * parts + i]);
  amax = fmaxf(warp_max(amax), 1e-6f);
  const float mult = __fdiv_rn(127.f, amax);
  __syncwarp();  // every lane has read rowmax before lane 0 may overwrite it
  const float4* src = reinterpret_cast<const float4*>(v + (long long)row * cols);
  char4* dst = reinterpret_cast<char4*>(q + (long long)row * cols);
  for (int c = lane; c < cols / 4; c += 32) {
    const float4 f = src[c];
    dst[c] = make_char4(q8(__fmul_rn(f.x, mult)), q8(__fmul_rn(f.y, mult)),
                        q8(__fmul_rn(f.z, mult)), q8(__fmul_rn(f.w, mult)));
  }
  if (lane == 0) scale[row] = __fdiv_rn(amax, 127.f);
}

// --------------------------------------------------------------------- GEMM
// C (M, N) = A (M, K) . B (N, K)^T, int8, A and B row-major (B in the torch
// weight layout). A block of 4 warps owns a 64 x 64 tile of C (each warp
// 32 x 32 = 2 x 4 mma tiles); 64-byte K slices of A and B stream through a
// 3-stage cp.async ring in shared memory, rows padded to 80 bytes so the
// fragment loads hit 32 different banks.
constexpr int BM = 64, BN = 64, BK = 64, LDS = BK + 16, NST = 3, GT = 128;
constexpr int TILE = BM * LDS;
constexpr size_t GEMM_SMEM = size_t(NST) * 2 * TILE;

enum Epi {
  EPI_RESID = 1,  // bf16 out = (acc [* rowscale]) * colscale + bias + resid
  EPI_GEGLU = 2,  // paired value/gate columns -> g = val * gelu_poly(gate)
};

struct GemmParams {
  const signed char* A;
  long long lda;
  int M, K;  // K a multiple of BK
  const signed char* B;
  long long ldb;
  // EPI_GEGLU: tile columns [0, BN/2) are B rows n0/2 + c (values), the rest
  // B rows half + n0/2 + c - BN/2 (gates)
  int half;
  const float* rowscale;  // (M) or null
  const float* colscale;  // (N)
  const float* bias;      // (N)
  const bf16* resid;      // (M, ldo)
  bf16* out;
  long long ldo;          // elements per output row
  // EPI_GEGLU: dynamic (inv_g null) writes g f32 (M, half) and max|g| per row
  // into g_rowmax; static writes codes round(clip(g * inv_g, +-127)) to gq
  float* g;
  float* g_rowmax;
  signed char* gq;
  const float* inv_g;
};

template <int EPI>
__global__ void __launch_bounds__(GT) gemm_kernel(const GemmParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  auto load = [&](int st, int kt) {
    unsigned char* as = smem + st * 2 * TILE;
    unsigned char* bs = as + TILE;
    const int kb = kt * BK;
#pragma unroll
    for (int i = tid; i < BM * (BK / 16); i += GT) {
      const int r = i >> 2, c = (i & 3) * 16;
      const int gm = m0 + r;
      const bool ok = gm < p.M;
      cp_async16(as + r * LDS + c, p.A + (long long)(ok ? gm : 0) * p.lda + kb + c, ok ? 16 : 0);
      int brow = n0 + r;
      if (EPI == EPI_GEGLU) brow = r < BN / 2 ? n0 / 2 + r : p.half + n0 / 2 + r - BN / 2;
      cp_async16(bs + r * LDS + c, p.B + (long long)brow * p.ldb + kb + c, 16);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = p.K / BK;
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < KT) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (kt + NST - 1 < KT) load((kt + NST - 1) % NST, kt + NST - 1);
    cp_async_commit();
    const unsigned char* as = smem + (kt % NST) * 2 * TILE;
    const unsigned char* bs = as + TILE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* pa = as + (wm * 32 + i * 16 + g) * LDS + ks + t * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(pa);
        af[i][1] = *reinterpret_cast<const unsigned*>(pa + 8 * LDS);
        af[i][2] = *reinterpret_cast<const unsigned*>(pa + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(pa + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* pb = bs + (wn * 32 + j * 8 + g) * LDS + ks + t * 4;
        bfr[j][0] = *reinterpret_cast<const unsigned*>(pb);
        bfr[j][1] = *reinterpret_cast<const unsigned*>(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if (EPI == EPI_GEGLU) {
    // dequantized (64, 64) tile of [value | gate] columns through shared memory
    constexpr int PLD = BN + 4;
    float* P = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + g + 8 * h;
          const int c = wn * 32 + j * 8 + t * 2;
          const int gc = c < BN / 2 ? n0 / 2 + c : p.half + n0 / 2 + c - BN / 2;
          const int gm = m0 + r;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float f = (float)acc[i][j][2 * h + e];
            if (p.rowscale != nullptr) f = __fmul_rn(f, gm < p.M ? p.rowscale[gm] : 0.f);
            P[r * PLD + c + e] = __fadd_rn(__fmul_rn(f, p.colscale[gc + e]), p.bias[gc + e]);
          }
        }
    __syncthreads();
    const int r = tid >> 1, j0 = (tid & 1) * 16;
    const int gm = m0 + r;
    float gv[16];
    float mx = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float val = P[r * PLD + j0 + jj];
      const float gate = P[r * PLD + BN / 2 + j0 + jj];
      gv[jj] = __fmul_rn(val, gelu_poly(gate));
      mx = fmaxf(mx, fabsf(gv[jj]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    if (gm < p.M) {
      const long long base = (long long)gm * p.half + n0 / 2 + j0;
      if (p.inv_g == nullptr) {
        float4* dst = reinterpret_cast<float4*>(p.g + base);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[q] = make_float4(gv[4 * q], gv[4 * q + 1], gv[4 * q + 2], gv[4 * q + 3]);
        if ((tid & 1) == 0) atomic_max_nonneg(p.g_rowmax + gm, mx);
      } else {
        const float ig = *p.inv_g;
        uint4 codes;
        signed char* ce = reinterpret_cast<signed char*>(&codes);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          ce[jj] = q8(fminf(fmaxf(__fmul_rn(gv[jj], ig), -127.f), 127.f));
        *reinterpret_cast<uint4*>(p.gq + base) = codes;
      }
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (gm >= p.M) continue;
        const int col = n0 + wn * 32 + j * 8 + t * 2;
        float f[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          f[e] = (float)acc[i][j][2 * h + e];
          if (p.rowscale != nullptr) f[e] = __fmul_rn(f[e], p.rowscale[gm]);
          f[e] = __fadd_rn(__fadd_rn(__fmul_rn(f[e], p.colscale[col + e]), p.bias[col + e]),
                           __bfloat162float(p.resid[(long long)gm * p.ldo + col + e]));
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)gm * p.ldo + col) =
            __floats2bfloat162_rn(f[0], f[1]);
      }
}

inline GemmParams gemm_params() {
  GemmParams p = {};
  return p;
}

template <int EPI>
inline cudaError_t launch_gemm(const GemmParams& p, int n_cols, cudaStream_t st) {
  const dim3 grid((p.M + BM - 1) / BM, n_cols / BN);
  gemm_kernel<EPI><<<grid, GT, GEMM_SMEM, st>>>(p);
  return cudaGetLastError();
}

inline cudaError_t launch_ln_quant(const void* x, const void* s, const void* b,
                                   long long mod_bstride, void* hq, void* hrow, void* hb,
                                   const void* inv_h, int rows, int n_tok, int scale_shift_mod,
                                   float eps, cudaStream_t st) {
  ln_quant_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      (const bf16*)x, (const bf16*)s, (const bf16*)b, mod_bstride, (signed char*)hq,
      (float*)hrow, (bf16*)hb, (const float*)inv_h, rows, n_tok, scale_shift_mod, eps);
  return cudaGetLastError();
}

inline cudaError_t launch_quant_rows(const void* v, int rows, int cols, const void* rowmax,
                                     int parts, void* q, void* scale, cudaStream_t st) {
  quant_rows_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const float*)v, rows, cols,
                                                    (const float*)rowmax, parts, (signed char*)q,
                                                    (float*)scale);
  return cudaGetLastError();
}

}  // namespace rald
