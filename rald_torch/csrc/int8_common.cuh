// Building blocks shared by the kernels of geglu.cu, geglu_int8.cu and
// attn.cu: LayerNorm/mod of a bf16 or f32 row with optional per-row int8
// quantization, per-row quantization of an f32 matrix, the int8 kernels'
// transcendental-free GELU, and the bf16 mma.sync / cp.async helpers of
// attn.cu's attention core.
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
// 16 consecutive values of a bf16 or f32 row as f32, and back (16-byte
// aligned: 2 or 4 vector accesses)
__device__ __forceinline__ void load16(const bf16* p, float (&v)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = q[h];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      v[8 * h + 2 * i] = f.x;
      v[8 * h + 2 * i + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 f = q[h];
    v[4 * h] = f.x;
    v[4 * h + 1] = f.y;
    v[4 * h + 2] = f.z;
    v[4 * h + 3] = f.w;
  }
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[16]) {
  uint4 o[2];
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  uint4* dst = reinterpret_cast<uint4*>(p);
  dst[0] = o[0];
  dst[1] = o[1];
}
__device__ __forceinline__ void store16(float* p, const float (&v)[16]) {
  float4* dst = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int h = 0; h < 4; ++h) dst[h] = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}

// One warp per token row, 16 contiguous columns per lane; T (bf16 or f32)
// is the type of x, of the mod rows s / b and of hb. h = mod(LN(x)) in
// f32, then int8 codes (when hq is given): dynamic (inv_h null)
// round(h * (127/hmax)) with hrow = hmax/127, or static
// round(clip(h * inv_h, +-127)). hb (optional) receives h in x's type (the
// bf16 / f32 projections' input; a copy under f32).
template <typename T>
__global__ void ln_quant_kernel(const T* __restrict__ x, const T* __restrict__ s,
                                const T* __restrict__ b, long long mod_bstride,
                                signed char* __restrict__ hq, float* __restrict__ hrow,
                                T* __restrict__ hb, const float* __restrict__ inv_h, int rows,
                                int n_tok, int scale_shift_mod, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  const long long bi = row / n_tok;
  float v[16], sc[16], sh[16];
  load16(x + (long long)row * D + lane * 16, v);
  load16(s + bi * mod_bstride + lane * 16, sc);
  load16(b + bi * mod_bstride + lane * 16, sh);
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
  if (hb != nullptr) store16(hb + (long long)row * D + lane * 16, v);
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

// T: the activation type (bf16 or float)
template <typename T>
inline cudaError_t launch_ln_quant(const void* x, const void* s, const void* b,
                                   long long mod_bstride, void* hq, void* hrow, void* hb,
                                   const void* inv_h, int rows, int n_tok, int scale_shift_mod,
                                   float eps, cudaStream_t st) {
  ln_quant_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(
      (const T*)x, (const T*)s, (const T*)b, mod_bstride, (signed char*)hq, (float*)hrow, (T*)hb,
      (const float*)inv_h, rows, n_tok, scale_shift_mod, eps);
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
