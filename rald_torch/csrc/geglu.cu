// Fused LayerNorm/AdaLN-mod + GEGLU feed-forward + residual, bf16, Hopper.
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
// E[x^2]-E[x]^2; h rounded to bf16 after mod; W1 product + b1 rounded; GELU
// (exact erf) in f32 then rounded; a * GELU(g) rounded; W2 product + b2 + x
// summed in f32 and rounded once.
//
// What bounds it on an H100: at D = 512, inner = 2048 the sublayer does
// 6.29 MFLOP per token row against ~2 KB of activation traffic per row plus
// 6 MB of weights, so at 512+ rows it is bound by tensor-core operations
// (3.22 GFLOP at B = 1: 3.3 us at 989 TFLOP/s bf16), not by bytes (2.2 us).
//
// Design: a block of 8 warps owns a 32-row token tile of one batch element
// and a contiguous share of the inner axis. The (rows, 2*inner) intermediate
// never exists in full: the block loops over 64-column chunks of its inner
// share, computes the value and gate chunk with bf16 WMMA (mma.sync) tiles
// from the bf16 h tile kept in shared memory, applies bias / GELU / gate in
// shared memory, and immediately contracts the (32, 64) gated chunk with the
// matching W2 columns into a (32, 512) f32 accumulator held in registers
// (8 warps x 8 fragments). The weights are read straight from global memory
// (L2-resident), so one block's chunk loop is a chain of L2 round trips: the
// time is latency, not operations. The inner axis is therefore split over
// up to 16 blocks per token tile (split-K for the W2 product) until about
// two blocks per SM are in flight; each block stores its f32 partial to a
// workspace, and a second, elementwise kernel sums the partials in split
// order (deterministic), adds b2 and the residual, and rounds once. The
// ragged last token tile is masked on load; the workspace rows are padded to
// the tile so partial stores need no mask. TMA/cp.async staging and wgmma
// are for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int D = 512;            // model width (the only width this build takes)
constexpr int BM = 32;            // token rows per block
constexpr int IC = 64;            // inner columns per chunk
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WN = D / NWARPS;    // output columns per warp
constexpr int WT = WN / 16;       // 16-wide output tiles per warp
constexpr int RT = BM / 16;       // 16-high row tiles per block
constexpr int MAX_SPLITS = 16;

constexpr size_t SMEM_H = size_t(BM) * D * sizeof(__nv_bfloat16);
constexpr size_t SMEM_P = size_t(2) * BM * IC * sizeof(float);
constexpr size_t SMEM_G = size_t(BM) * IC * sizeof(__nv_bfloat16);
constexpr size_t SMEM_BYTES = SMEM_H + SMEM_P + SMEM_G;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// grid (row tiles, batch, splits); part is (splits, batch, n_pad, D) f32
__global__ void __launch_bounds__(NTHREADS, 2)
ln_geglu_partial_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ s,
                        const __nv_bfloat16* __restrict__ b,
                        long long mod_bstride,
                        const __nv_bfloat16* __restrict__ w1,
                        const __nv_bfloat16* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ w2,
                        float* __restrict__ part,
                        int n_tok, int n_pad, int inner, int scale_shift_mod, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* pv_s = reinterpret_cast<float*>(smem + SMEM_H);
  float* pg_s = pv_s + BM * IC;
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_H + SMEM_P);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int batch = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int share = inner / gridDim.z;  // a multiple of IC (launcher)
  const int j_begin = blockIdx.z * share;
  const __nv_bfloat16* xb = x + (long long)batch * n_tok * D;
  const __nv_bfloat16* sb = s + (long long)batch * mod_bstride;
  const __nv_bfloat16* bb = b + (long long)batch * mod_bstride;

  // ---- LN + mod -> bf16 h tile in shared memory (4 rows per warp)
  for (int r = warp; r < BM; r += NWARPS) {
    const int row = row0 + r;
    float v[D / 32];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      v[i] = row < n_tok ? __bfloat162float(xb[(long long)row * D + lane + 32 * i]) : 0.f;
      sum += v[i];
      sq += v[i] * v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mean = sum / D;
    const float var = sq / D - mean * mean;
    const float inv = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      const float sc = __bfloat162float(sb[c]);
      const float sh = __bfloat162float(bb[c]);
      float hv = (v[i] - mean) * inv;
      hv = scale_shift_mod ? hv * (1.f + sc) + sh : hv * sc + sh;
      h_s[r * D + c] = __float2bfloat16(hv);
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][WT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int t = 0; t < WT; ++t) wmma::fill_fragment(acc[i][t], 0.f);

  const int prt = warp / (IC / 16);  // this warp's (value, gate) tile in a chunk
  const int pct = warp % (IC / 16);

  for (int j0 = j_begin; j0 < j_begin + share; j0 += IC) {
    // ---- value / gate chunk: (BM, D) x (D, IC) twice
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bv, bg;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cv, cg;
      wmma::fill_fragment(cv, 0.f);
      wmma::fill_fragment(cg, 0.f);
      const __nv_bfloat16* wv = w1 + (long long)(j0 + pct * 16) * D;
      const __nv_bfloat16* wg = w1 + (long long)(inner + j0 + pct * 16) * D;
#pragma unroll 4
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::load_matrix_sync(af, h_s + prt * 16 * D + k0, D);
        wmma::load_matrix_sync(bv, wv + k0, D);
        wmma::load_matrix_sync(bg, wg + k0, D);
        wmma::mma_sync(cv, af, bv, cv);
        wmma::mma_sync(cg, af, bg, cg);
      }
      wmma::store_matrix_sync(pv_s + prt * 16 * IC + pct * 16, cv, IC, wmma::mem_row_major);
      wmma::store_matrix_sync(pg_s + prt * 16 * IC + pct * 16, cg, IC, wmma::mem_row_major);
    }
    __syncthreads();
    // ---- bias, GELU(gate), gate product -> bf16 chunk
    for (int idx = threadIdx.x; idx < BM * IC; idx += NTHREADS) {
      const int j = idx % IC;
      const float val = bf16_round(pv_s[idx] + __bfloat162float(b1[j0 + j]));
      const float gate = bf16_round(pg_s[idx] + __bfloat162float(b1[inner + j0 + j]));
      const float gl = bf16_round(0.5f * gate * (1.f + erff(gate * 0.7071067811865476f)));
      g_s[idx] = __float2bfloat16(val * gl);
    }
    __syncthreads();
    // ---- accumulate (BM, IC) x (IC, D) into the register tile
#pragma unroll
    for (int kk = 0; kk < IC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ga[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) wmma::load_matrix_sync(ga[i], g_s + i * 16 * IC + kk, IC);
#pragma unroll
      for (int t = 0; t < WT; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> wb;
        const int d0 = warp * WN + t * 16;
        wmma::load_matrix_sync(wb, w2 + (long long)d0 * inner + j0 + kk, inner);
#pragma unroll
        for (int i = 0; i < RT; ++i) wmma::mma_sync(acc[i][t], ga[i], wb, acc[i][t]);
      }
    }
    // the next chunk's first __syncthreads orders these g_s reads before
    // its g_s writes
  }

  float* pb = part + ((long long)blockIdx.z * gridDim.y + batch) * n_pad * D + (long long)row0 * D;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int t = 0; t < WT; ++t)
      wmma::store_matrix_sync(pb + i * 16 * D + warp * WN + t * 16, acc[i][t], D,
                              wmma::mem_row_major);
}

// out = bf16(sum_s part[s] + b2 + x), partials summed in split order
__global__ void geglu_finalize_kernel(const float* __restrict__ part,
                                      const __nv_bfloat16* __restrict__ x,
                                      const __nv_bfloat16* __restrict__ b2,
                                      __nv_bfloat16* __restrict__ out, int batch, int n_tok,
                                      int n_pad, int splits) {
  const long long total = (long long)batch * n_tok * D;
  const long long split_stride = (long long)batch * n_pad * D;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % D);
    const long long row = i / D;  // batch * n_tok + token
    const long long bi = row / n_tok;
    const long long p = (bi * n_pad + (row - bi * n_tok)) * D + c;
    float y = part[p];
    for (int sp = 1; sp < splits; ++sp) y += part[p + sp * split_stride];
    out[i] = __float2bfloat16(y + __bfloat162float(b2[c]) + __bfloat162float(x[i]));
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace

extern "C" int rald_geglu_width() { return D; }

extern "C" int rald_geglu_row_tile() { return BM; }

// How many blocks share one token tile's inner axis: doubled (while it
// divides the chunk count) until about two blocks per SM are in flight.
extern "C" int rald_geglu_splits(int batch, int n_tok, int inner) {
  const long long tiles = (long long)batch * ((n_tok + BM - 1) / BM);
  const int chunks = inner / IC;
  int splits = 1;
  while (splits * 2 <= MAX_SPLITS && chunks % (splits * 2) == 0 &&
         tiles * splits * 2 <= 2LL * sm_count())
    splits *= 2;
  return splits;
}

// part: workspace of rald_geglu_splits(...) * batch * n_pad * D floats, with
// n_pad = n_tok rounded up to rald_geglu_row_tile()
extern "C" int rald_fused_ln_geglu_residual_bf16(
    const void* x, const void* s, const void* b, long long mod_bstride,
    const void* w1, const void* b1, const void* w2, const void* b2, void* part, void* out,
    int batch, int n_tok, int inner, int splits, int scale_shift_mod, float eps, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ln_geglu_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (inner % IC != 0 || n_tok <= 0 || batch <= 0 || splits <= 0 ||
      (inner / IC) % splits != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_tok + BM - 1) / BM;
  const int n_pad = tiles * BM;
  cudaStream_t st = (cudaStream_t)stream;
  ln_geglu_partial_kernel<<<dim3(tiles, batch, splits), NTHREADS, SMEM_BYTES, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)s, (const __nv_bfloat16*)b, mod_bstride,
      (const __nv_bfloat16*)w1, (const __nv_bfloat16*)b1, (const __nv_bfloat16*)w2,
      (float*)part, n_tok, n_pad, inner, scale_shift_mod, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)batch * n_tok * D;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  geglu_finalize_kernel<<<blocks, 256, 0, st>>>((const float*)part, (const __nv_bfloat16*)x,
                                                (const __nv_bfloat16*)b2, (__nv_bfloat16*)out,
                                                batch, n_tok, n_pad, splits);
  return (int)cudaGetLastError();
}
