// float32 GEMM on the CUDA cores (FFMA), shared by geglu.cu and attn.cu for
// x in float32: C = A B^T with A (rows, K) and B (*, K) row-major (B in the
// torch weight layout), with sm90_gemm.cuh's GEGLU, OUT, OUT_RESID and STORE
// epilogues in f32.
//
// Why SIMT and not wgmma: the TPU kernels take x's dtype, and JAX's strict
// configuration (compute_dtype float32, matmul_precision highest) computes
// their products in full f32. Hopper's tensor cores take at best TF32 (10
// mantissa bits); FFMA gives the exact f32 product of each pair, rounded
// once into its f32 sum, which is what "highest" asks for. Its peak is 67
// TFLOP/s against 989 for bf16 wgmma: this path is for parity, not speed.
//
// Tiling: a block of 256 threads owns a BM x BN tile of C (BM, BN in
// {64, 128}); thread (ty, tx) of a 16 x 16 grid holds TM = BM/16 rows and
// TN = BN/16 columns, as two halves [ty TM/2, +TM/2) and [BM/2 + ty TM/2,
// +TM/2) (columns alike), so that its shared-memory reads are vectors and a
// warp's hit distinct banks. 16-deep K slices of A and B are stored
// transposed (K-major rows of BM + 4 / BN + 4 floats) in two shared-memory
// buffers; the next slice is loaded into registers while the current one is
// multiplied. Rows and columns past the end load as zeros and are not
// stored. Each output is one FFMA chain over K in order, so the result is
// the same from run to run.
//
// Epilogues, at the plain versions' rounding points (none in f32 but the
// sums' own):
//   GEGLU      B's 128 tile rows are W1's value rows [n0, n0+64) and their
//              gate rows [inner+n0, inner+n0+64), so a thread's two column
//              halves are a value column and its gate; out (rows, inner) =
//              (acc_v + b_v) * gelu(acc_g + b_g), GELU with the TPU kernel's
//              Abramowitz & Stegun rational erf (rald_tpu/ops/geglu_kernel.py
//              _erf, |err| <= 1.5e-7)
//   OUT        out (rows, ncols) = acc + bias
//   OUT_RESID  out = (acc + bias) + resid
//   STORE      out[z] = acc, z = blockIdx.z picking one of up to three B
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "sm90_gemm.cuh"

namespace f32g {

constexpr int BK = 16;       // K per slice
constexpr int THREADS = 256;
constexpr int BJ = 64;       // GEGLU: inner columns per block

struct Args {
  const float* a;        // (rows, k)
  const float* b[3];     // (ncols, k) per z; GEGLU (2 inner, k)
  float* out[3];         // per z
  const float* bias;     // (ncols); GEGLU (2 inner)
  const float* resid;    // (rows, ncols)
  int rows, k;           // k % BK == 0
  int inner, ncols;      // GEGLU: W1's value rows; others: columns of C
};

// erf by Abramowitz & Stegun 7.1.26 in the TPU kernel's order of operations
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, ax)));
  float p = 1.061405429f;
  p = __fadd_rn(__fmul_rn(p, t), -1.453152027f);
  p = __fadd_rn(__fmul_rn(p, t), 1.421413741f);
  p = __fadd_rn(__fmul_rn(p, t), -0.284496736f);
  p = __fadd_rn(__fmul_rn(p, t), 0.254829592f);
  const float y = __fsub_rn(1.f, __fmul_rn(__fmul_rn(p, t), expf(-__fmul_rn(ax, ax))));
  return __fmul_rn(s, y);
}

// 0.5 x (1 + erf(x / sqrt 2)), as the TPU kernel's _gelu_exact orders it
__device__ __forceinline__ float gelu_as(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf_as(__fmul_rn(x, 0.7071067811865476f))));
}

// n consecutive floats (n = 2 or 4, aligned) between registers and memory
template <int NV>
__device__ __forceinline__ void ld(float* r, const float* p) {
  if constexpr (NV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x, r[1] = v.y;
  }
}
template <int NV>
__device__ __forceinline__ void st(float* p, const float* r) {
  if constexpr (NV == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
}

template <int EPI, int BM, int BN>
__global__ void __launch_bounds__(THREADS) gemm_f32_kernel(const Args p) {
  constexpr int TM = BM / 16, TN = BN / 16, HM = TM / 2, HN = TN / 2;
  constexpr int ALD = BM + 4, BLD = BN + 4;
  constexpr int LA = BM * BK / 4 / THREADS, LB = BN * BK / 4 / THREADS;  // float4 loads a thread
  __shared__ __align__(16) float as[2][BK * ALD];
  __shared__ __align__(16) float bs[2][BK * BLD];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * (EPI == sm90::GEGLU ? BJ : BN);
  const float* bmat = z == 0 ? p.b[0] : z == 1 ? p.b[1] : p.b[2];
  const int brows = EPI == sm90::GEGLU ? 2 * p.inner : p.ncols;

  // slice kt of A and B into registers: element (row, 4 kq .. 4 kq + 3),
  // four threads a row, zeros past the end
  float4 ra[LA], rb[LB];
  auto fetch = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2, kq = idx & 3;
      const int gr = m0 + r;
      ra[i] = gr < p.rows ? *reinterpret_cast<const float4*>(p.a + (long long)gr * p.k + k0 + 4 * kq)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2, kq = idx & 3;
      int gr = n0 + r;
      if (EPI == sm90::GEGLU) gr = r < BJ ? n0 + r : p.inner + n0 + r - BJ;
      rb[i] = gr < brows ? *reinterpret_cast<const float4*>(bmat + (long long)gr * p.k + k0 + 4 * kq)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2, kq = idx & 3;
      float* d = as[buf] + 4 * kq * ALD + r;
      d[0] = ra[i].x, d[ALD] = ra[i].y, d[2 * ALD] = ra[i].z, d[3 * ALD] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2, kq = idx & 3;
      float* d = bs[buf] + 4 * kq * BLD + r;
      d[0] = rb[i].x, d[BLD] = rb[i].y, d[2 * BLD] = rb[i].z, d[3 * BLD] = rb[i].w;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kts = p.k / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < kts; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kts) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
      ld<HM>(a, as[buf] + k * ALD + ty * HM);
      ld<HM>(a + HM, as[buf] + k * ALD + BM / 2 + ty * HM);
      ld<HN>(b, bs[buf] + k * BLD + tx * HN);
      ld<HN>(b + HN, bs[buf] + k * BLD + BN / 2 + tx * HN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < kts) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + (i < HM ? ty * HM + i : BM / 2 + ty * HM + i - HM);
    if (r >= p.rows) continue;
    if constexpr (EPI == sm90::GEGLU) {
      // value columns n0 + tx HN + j, gates HN registers on
      const int c = n0 + tx * HN;
      float g[HN];
#pragma unroll
      for (int j = 0; j < HN; ++j) {
        const float val = __fadd_rn(acc[i][j], p.bias[c + j]);
        const float gate = __fadd_rn(acc[i][HN + j], p.bias[p.inner + c + j]);
        g[j] = __fmul_rn(val, gelu_as(gate));
      }
      st<HN>(p.out[0] + (long long)r * p.inner + c, g);
    } else {
      float* out = z == 0 ? p.out[0] : z == 1 ? p.out[1] : p.out[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + h * (BN / 2) + tx * HN;
        if (c >= p.ncols) continue;  // ncols % 4 == 0: a half is all in or all out
        float y[HN];
        const long long at = (long long)r * p.ncols + c;
#pragma unroll
        for (int j = 0; j < HN; ++j) {
          y[j] = acc[i][h * HN + j];
          if constexpr (EPI == sm90::OUT || EPI == sm90::OUT_RESID) y[j] = __fadd_rn(y[j], p.bias[c + j]);
          if constexpr (EPI == sm90::OUT_RESID) y[j] = __fadd_rn(y[j], p.resid[at + j]);
        }
        st<HN>(out + at, y);
      }
    }
  }
}

// one launch over all rows and columns on (bm, bn) tiles, chosen by the
// caller so that the grid fills the card (rald_torch/ops/geglu_kernel.py
// gemm2_tile); GEGLU takes 128 x 128 (64 inner columns a block)
template <int EPI>
cudaError_t launch(int bm, int bn, const Args& p, int nz, cudaStream_t st) {
  if (p.k % BK != 0 || (EPI != sm90::GEGLU && p.ncols % 4 != 0) ||
      (EPI == sm90::GEGLU && (p.inner % BJ != 0 || bm != 128 || bn != 128)))
    return cudaErrorInvalidValue;
  const int cols = EPI == sm90::GEGLU ? p.inner / BJ : (p.ncols + bn - 1) / bn;
  const dim3 grid(cols, (p.rows + bm - 1) / bm, nz);
  if (bm == 128 && bn == 128) {
    gemm_f32_kernel<EPI, 128, 128><<<grid, THREADS, 0, st>>>(p);
  } else if constexpr (EPI != sm90::GEGLU) {
    if (bm == 128) gemm_f32_kernel<EPI, 128, 64><<<grid, THREADS, 0, st>>>(p);
    else if (bn == 128) gemm_f32_kernel<EPI, 64, 128><<<grid, THREADS, 0, st>>>(p);
    else gemm_f32_kernel<EPI, 64, 64><<<grid, THREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace f32g
