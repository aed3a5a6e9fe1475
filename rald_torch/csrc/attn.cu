// Fused LayerNorm/AdaLN-mod + multi-head self-attention + residual, bf16 and
// int8, with bf16 or f32 activations, Hopper (sm_90a).
//
// Replaces the TPU kernels of rald_tpu/ops/attn_kernel.py:
//   ::fused_self_attention_block (Pallas body _kernel), all projections of
//     x's type -> rald_fused_self_attention_block;
//   ::fused_self_attention_block_int8 (_int8_kernel), all projections int8,
//     and ::fused_self_attention_block_int8_vout (_int8_vout_kernel), q / k
//     of x's type, v and out int8 -> rald_fused_self_attention_block_int8.
// All compute y = x + Wo MHA(mod(LN x)) + bo with 8 heads of 64, at the
// rounding points of the TPU kernels and of the plain PyTorch versions
// (rald_torch/ops/attn_kernel.py): h = LN + mod in f32 (rounded to bf16 for a
// bf16 projection, quantized per row once for an int8 one); each projection
// summed in f32 / s32, dequantized (acc * max|h|/127) * s where int8, rounded to
// bf16; per head f32 scores s = (q . k^T) * dh^-0.5, e = exp(s - max s),
// a = bf16(e / sum e), a . v summed in f32 -- rounded to bf16 per head in the
// bf16 kernel, kept f32 and quantized per row over all heads before the int8
// out projection; out projection + bo + x summed in f32 and rounded once.
//
// What bounds it on an H100: per frame of 512 tokens the four 512 x 512
// projections are 1.07 G operations and the attention 0.54 GFLOP (q . k^T and
// a . v); this core recomputes q . k^T once more (below), 0.81 GFLOP in all.
// Against 1 MB of activations in and out and 0.5-2 MB of weights, operations
// bound every variant: 1.6 us a frame in bf16 at 989 TFLOP/s, less where the
// projections run int8 at 1,979 TOPS.
//
// Design: four to six launches per call, each one pass over its rows.
//   1. ln_quant_kernel (int8_common.cuh): one warp per row writes bf16 h
//      and / or int8 codes with their row scale max|h|/127.
//   2. Projections on sm90_gemm.cuh's TMA-fed, warp-specialised wgmma GEMM:
//      q / k / v in one launch, blockIdx.z picking the weight's TMA map (bf16
//      STORE, or int8 Q8_STORE with the dequant epilogue); in vout q / k are
//      one bf16 launch and v one int8 launch. q, k, v land row-major
//      (B*N, D) bf16.
//   3. attn_core_kernel: a block per (16*WARPS query rows, head, frame),
//      16 rows a warp (2, 4 or 8 warps, the largest block whose grid fills
//      the card), on bf16 mma.sync m16n8k16. The softmax is exact and
//      two-pass, not online: the TPU kernel rounds the normalised weights
//      a = e / sum e to bf16 before a . v, which needs the row's final max and
//      sum before any a . v, and an online (flash) softmax, which rescales
//      partial a . v sums as the max moves, cannot reproduce that rounding.
//      Pass 1 walks the key tiles keeping each thread's running row max m and
//      rescaled running sum l (exp(s - m) summed, l *= exp(m_old - m_new) when
//      the max moves), then merges the four threads of a row. l differs from
//      the plain version's sum(exp(s - max)) only by f32 rounding. Pass 2
//      recomputes s for each key tile and forms a = bf16(exp(s - m) / l) with
//      __fdiv_rn, in registers: the m16n8k16 accumulator layout of s is the A
//      fragment layout of a . v, so the weights never touch shared memory.
//      Shared memory holds only a 3-stage cp.async ring of 64-key K and V
//      tiles (144-byte rows: conflict-free ldmatrix; V row-major, read with
//      ldmatrix.trans), so the next tile's load is in flight during the
//      current products, several blocks fit an SM, and N has no limit but the
//      int range. Keys past N load as zeros and score -inf (weight 0).
//      bf16 mode writes each head's a . v rounded to bf16; the int8 modes
//      write it f32 with each row's max |value| over the head (hmax, one slot
//      per head: no atomics, no zero fill).
//   4. quant_rows_kernel (int8 modes, int8_common.cuh): one warp per row,
//      amax over the heads' maxima, codes round(o * 127/amax), row scale
//      amax/127.
//   5. Out projection on the same GEMM: bf16 OUT_RESID (bf16(acc + bo + x),
//      geglu.cu's GEMM2 epilogue) or int8 Q8_RESID ((acc * arow) * so + bo + x).
// Launches per call: bf16 4 (LN, q/k/v, core, out); int8 5; vout 6.
//
// With x in f32 (JAX's compute_dtype float32) every rounding to x's type is
// a no-op and the launches are the same: LN writes h in f32; the f32
// projections (q / k / v, vout's q / k, the bf16 mode's out) run on the
// CUDA cores (f32_gemm.cuh, exact f32 products, no TMA); the int8 ones on the
// same wgmma GEMM with f32 outputs and residual; the core is
// attn_core_f32_kernel, the same two-pass softmax in f32 on the CUDA cores.
#include <math.h>

#include "f32_gemm.cuh"
#include "int8_common.cuh"
#include "sm90_gemm.cuh"

namespace {

using rald::bf16;
using rald::D;

constexpr int DH = 64;              // head width (the only one this build takes)
constexpr int BKV = 64;             // keys per K / V tile
constexpr int KLD = DH + 8;         // bf16 per tile row in shared memory: 144 bytes
constexpr int TILE = BKV * KLD;     // bf16 per K or V tile
constexpr int CORE_STAGES = 3;      // K / V tile pairs in flight
constexpr int CORE_SMEM = CORE_STAGES * 2 * TILE * (int)sizeof(bf16);  // 55,296 bytes
constexpr int MAX_TOKENS = 1 << 20; // tokens per frame (no limit of the design)
constexpr int PROJ_STAGES = 3;      // GEMM ring stages (K = 512: 8 bf16 / 4 int8 slices)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; thread (g = lane/4, t = lane%4) receives
// elements (g, 2t..2t+1) of each (.trans: elements (2t..2t+1, g))
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// s[j] += the warp's 16 query rows . keys [8j, 8j+8) of the K tile kt (64 keys
// x 64 head columns, row-major, KLD apart): B fragments by ldmatrix, two
// key groups per load (lanes 16.. address keys +8, odd lane octets columns +8)
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const unsigned (&qf)[4][4],
                                            const bf16* kt, int lane) {
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned b[4];
      ldsm_x4(b, kt + (16 * jp + r + 8 * (i >> 1)) * KLD + 16 * ks + 8 * (i & 1));
      const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      rald::mma(s[2 * jp], qf[ks], b0);
      rald::mma(s[2 * jp + 1], qf[ks], b1);
    }
  }
}

// grid (ceil(N / (16 WARPS)), heads, batch); q, k, v (B*N, D) bf16 row-major.
// BF16_OUT: o (B*N, D) bf16, each head rounded. Else o f32 and hmax
// (B*N, heads) f32 receiving each row's max |o| over the head.
template <int WARPS, bool BF16_OUT>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 8 ? 2 : WARPS == 4 ? 3 : 1)
attn_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, void* __restrict__ o, float* __restrict__ hmax,
                 int n_tok, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // CORE_STAGES x (K tile, V tile)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, heads = gridDim.y, b = blockIdx.z;
  const int r0 = blockIdx.x * (16 * WARPS) + warp * 16 + g;  // rows r0, r0 + 8 of the frame
  const long long rowbase = (long long)b * n_tok;
  const int tiles = (n_tok + BKV - 1) / BKV;
  const int steps = 2 * tiles;  // pass 1: K tiles; pass 2: (K, V) tiles

  // step's tiles into its ring stage (keys past N as zeros); always commits a
  // group, so the wait count below stays uniform
  auto load = [&](int step) {
    if (step < steps) {
      const int tile = step < tiles ? step : step - tiles;
      bf16* kt = ring + (step % CORE_STAGES) * 2 * TILE;
      for (int i = tid; i < BKV * (DH / 8); i += WARPS * 32) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int key = tile * BKV + r;
        const bool ok = key < n_tok;
        const long long off = (rowbase + (ok ? key : 0)) * D + h * DH + c;
        rald::cp_async16(kt + r * KLD + c, k + off, ok ? 16 : 0);
        if (step >= tiles) rald::cp_async16(kt + TILE + r * KLD + c, v + off, ok ? 16 : 0);
      }
    }
    rald::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < CORE_STAGES - 1; ++st) load(st);

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

  // this thread's running max and sum of rows r0 (index 0) and r0 + 8 (1)
  // over its own columns; after pass 1 the row's over all keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int li = lane >> 3, lr = lane & 7;

  for (int step = 0; step < steps; ++step) {
    rald::cp_async_wait<CORE_STAGES - 2>();
    __syncthreads();  // this step's tiles landed; every warp is done with step - 1's stage
    load(step + CORE_STAGES - 1);
    const bf16* kt = ring + (step % CORE_STAGES) * 2 * TILE;
    const int tile = step < tiles ? step : step - tiles;
    float s[8][4];
    tile_scores(s, qf, kt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    if (tile == tiles - 1 && n_tok % BKV) {
      // keys past N score -inf, so weigh 0; register 4j + e holds row
      // r0 + 8 (e >> 1), key 8j + 2t + (e & 1) of the tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tile * BKV + 8 * j + 2 * t + (e & 1) >= n_tok) s[j][e] = -INFINITY;
    }

    if (step < tiles) {
      // ---- pass 1: running max and rescaled sum
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        if (mx != -INFINITY) {  // some key of this thread's columns so far is real
          float sum = m[hh] == -INFINITY ? 0.f : __fmul_rn(l[hh], expf(__fsub_rn(m[hh], mx)));
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum = __fadd_rn(__fadd_rn(sum, expf(__fsub_rn(s[j][2 * hh], mx))),
                            expf(__fsub_rn(s[j][2 * hh + 1], mx)));
          m[hh] = mx;
          l[hh] = sum;
        }
      }
      if (step == tiles - 1) {
        // merge the four threads of each row (lanes 4g .. 4g+3): the row max,
        // then each thread's sum rescaled to it; the butterfly gives every
        // thread the same bits
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = m[hh];
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          float sum = m[hh] == -INFINITY ? 0.f : __fmul_rn(l[hh], expf(__fsub_rn(m[hh], mx)));
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
          m[hh] = mx;
          l[hh] = sum;
        }
      }
      continue;
    }

    // ---- pass 2: a = bf16(exp(s - m) / l) as A fragments; acc += a . v.
    // A fragment of k-step ks (keys 16ks .. 16ks+15): registers 0 / 1 rows
    // r0 / r0+8 at keys 2t.. (score group 2ks), 2 / 3 the same at 2t+8..
    // (group 2ks+1)
    unsigned af[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = s[2 * ks + half];
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] = __fdiv_rn(expf(__fsub_rn(c[e], m[e >> 1])), l[e >> 1]);
        af[ks][2 * half] = pack_bf16(a[0], a[1]);
        af[ks][2 * half + 1] = pack_bf16(a[2], a[3]);
      }
    const bf16* vt = kt + TILE;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        // V rows 16ks.. (+8 for odd lane octets), head columns 16jp.. (+8 for
        // lane octets 2, 3), transposed into B fragments of column groups
        // 2jp and 2jp+1
        unsigned bb[4];
        ldsm_x4_t(bb, vt + (16 * ks + lr + 8 * (li & 1)) * KLD + 16 * jp + 8 * (li >> 1));
        const unsigned b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        rald::mma(acc[2 * jp], af[ks], b0);
        rald::mma(acc[2 * jp + 1], af[ks], b1);
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
    if (t == 0) hmax[(rowbase + r) * heads + h] = hh ? m1 : m0;
  }
}

template <int WARPS, bool BF16_OUT>
cudaError_t launch_core_w(const void* q, const void* k, const void* v, void* o, void* hmax,
                          int batch, int n_tok, int heads, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(attn_core_kernel<WARPS, BF16_OUT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               CORE_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((n_tok + 16 * WARPS - 1) / (16 * WARPS), heads, batch);
  attn_core_kernel<WARPS, BF16_OUT><<<grid, WARPS * 32, CORE_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, o, (float*)hmax, n_tok,
      1.f / sqrtf((float)DH));
  return cudaGetLastError();
}

// warps: 8, 4 or 2 (128, 64 or 32 query rows a block), chosen by the
// wrapper so that the grid fills the card (rald_torch/ops/attn_kernel.py
// core_rows): every block reads its head's K twice and V once, so the
// largest block that fills the card reads the least
template <bool BF16_OUT>
cudaError_t launch_core(int warps, const void* q, const void* k, const void* v, void* o,
                        void* hmax, int batch, int n_tok, int heads, cudaStream_t st) {
  if (warps == 8) return launch_core_w<8, BF16_OUT>(q, k, v, o, hmax, batch, n_tok, heads, st);
  if (warps == 4) return launch_core_w<4, BF16_OUT>(q, k, v, o, hmax, batch, n_tok, heads, st);
  return launch_core_w<2, BF16_OUT>(q, k, v, o, hmax, batch, n_tok, heads, st);
}

// ---- f32 core (x in float32): the same exact two-pass softmax on the CUDA
// cores. A block of 128 threads owns 32 query rows of one head of one frame,
// four threads a row: thread (r, qd) scores keys 4j + qd of each 64-key tile
// (j < 16) with the row's q in registers (exact f32 products, FFMA), keeps
// its running max and rescaled sum in pass 1 (merged over the row's four
// threads after the last tile), and in pass 2 recomputes the scores, writes
// a = exp(s - m) / l (__fdiv_rn) to a shared row of weights and sums a . v
// for head columns [16 qd, 16 qd + 16). o is f32 (rounding a head to x's
// type is a no-op); hmax, when given, receives each row's max |o| over the
// head. K and V tiles are staged in shared memory, keys past N as zeros
// scoring -inf. grid (ceil(N / 32), heads, batch); q, k, v, o (B*N, D) f32.
constexpr int F32_ROWS = 32;
constexpr int F32_KLD = DH + 4;  // floats per K / weight row in shared memory

__global__ void __launch_bounds__(F32_ROWS * 4)
attn_core_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ hmax, int n_tok, float scale) {
  __shared__ __align__(16) float ks[BKV * F32_KLD];
  __shared__ __align__(16) float vs[BKV * DH];
  __shared__ __align__(16) float ps[F32_ROWS * F32_KLD];
  const int tid = threadIdx.x, r = tid >> 2, qd = tid & 3;
  const int h = blockIdx.y, heads = gridDim.y;
  const int row = blockIdx.x * F32_ROWS + r;
  const long long rowbase = (long long)blockIdx.z * n_tok;
  const int tiles = (n_tok + BKV - 1) / BKV;

  float qr[DH];
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    const float4 f = row < n_tok ? *reinterpret_cast<const float4*>(
                                       q + (rowbase + row) * D + h * DH + 4 * d4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * d4] = f.x, qr[4 * d4 + 1] = f.y, qr[4 * d4 + 2] = f.z, qr[4 * d4 + 3] = f.w;
  }
  float m = -INFINITY, l = 0.f, acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int tile = 0; tile < tiles; ++tile) {
      __syncthreads();  // every thread is done with the previous tile
      for (int i = tid; i < BKV * (DH / 4); i += F32_ROWS * 4) {
        const int kr = i >> 4, c4 = i & 15;
        const int key = tile * BKV + kr;
        const long long off = (rowbase + key) * D + h * DH + 4 * c4;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(ks + kr * F32_KLD + 4 * c4) =
            key < n_tok ? *reinterpret_cast<const float4*>(k + off) : zero;
        if (pass)
          *reinterpret_cast<float4*>(vs + kr * DH + 4 * c4) =
              key < n_tok ? *reinterpret_cast<const float4*>(v + off) : zero;
      }
      __syncthreads();
      float s[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (4 * j + qd) * F32_KLD + 4 * d4);
          s[j] = fmaf(qr[4 * d4], kv.x, s[j]);
          s[j] = fmaf(qr[4 * d4 + 1], kv.y, s[j]);
          s[j] = fmaf(qr[4 * d4 + 2], kv.z, s[j]);
          s[j] = fmaf(qr[4 * d4 + 3], kv.w, s[j]);
        }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[j] = __fmul_rn(s[j], scale);
        if (tile * BKV + 4 * j + qd >= n_tok) s[j] = -INFINITY;
      }
      if (pass == 0) {
        float mx = m;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, s[j]);
        if (mx != -INFINITY) {
          float sum = m == -INFINITY ? 0.f : __fmul_rn(l, expf(__fsub_rn(m, mx)));
#pragma unroll
          for (int j = 0; j < 16; ++j) sum = __fadd_rn(sum, expf(__fsub_rn(s[j], mx)));
          m = mx;
          l = sum;
        }
        if (tile == tiles - 1) {
          // the row's four threads (lanes 4g .. 4g+3): its max, then each
          // thread's sum rescaled to it
          float mr = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
          float sum = m == -INFINITY ? 0.f : __fmul_rn(l, expf(__fsub_rn(m, mr)));
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
          m = mr;
          l = sum;
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        ps[r * F32_KLD + 4 * j + qd] = __fdiv_rn(expf(__fsub_rn(s[j], m)), l);
      __syncwarp();  // the row's weights come from its own four threads
#pragma unroll 4
      for (int kk = 0; kk < BKV; ++kk) {
        const float a = ps[r * F32_KLD + kk];
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + kk * DH + 16 * qd + 4 * c4);
          acc[4 * c4] = fmaf(a, vv.x, acc[4 * c4]);
          acc[4 * c4 + 1] = fmaf(a, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(a, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(a, vv.w, acc[4 * c4 + 3]);
        }
      }
    }
  }

  float am = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) am = fmaxf(am, fabsf(acc[i]));
  am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 1));
  am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 2));
  if (row >= n_tok) return;
  float* orow = o + (rowbase + row) * D + h * DH + 16 * qd;
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4)
    *reinterpret_cast<float4*>(orow + 4 * c4) =
        make_float4(acc[4 * c4], acc[4 * c4 + 1], acc[4 * c4 + 2], acc[4 * c4 + 3]);
  if (hmax != nullptr && qd == 0) hmax[(rowbase + row) * heads + h] = am;
}

cudaError_t launch_core_f32(const void* q, const void* k, const void* v, void* o, void* hmax,
                            int batch, int n_tok, int heads, cudaStream_t st) {
  const dim3 grid((n_tok + F32_ROWS - 1) / F32_ROWS, heads, batch);
  attn_core_f32_kernel<<<grid, F32_ROWS * 4, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)hmax, n_tok,
      1.f / sqrtf((float)DH));
  return cudaGetLastError();
}

// the f32 projections (f32_gemm.cuh): a (rows, D) times up to three (D, D)
// weights, with EPI (STORE: out[z] = acc; OUT_RESID: out = acc + bias + resid)
template <int EPI>
cudaError_t proj_f32(int bm, int bn, const void* a, const void* const* w, void* const* out,
                     int nw, const void* bias, const void* resid, int rows, cudaStream_t st) {
  f32g::Args p = {};
  p.a = (const float*)a;
  for (int i = 0; i < nw; ++i) {
    p.b[i] = (const float*)w[i];
    p.out[i] = (float*)out[i];
  }
  p.bias = (const float*)bias;
  p.resid = (const float*)resid;
  p.rows = rows;
  p.k = D;
  p.ncols = D;
  return f32g::launch<EPI>(bm, bn, p, nw, st);
}

bool shape_ok(int batch, int n_tok, int heads, int warps, int pm, int pn, int om, int on) {
  return heads * DH == D && n_tok > 0 && n_tok <= MAX_TOKENS && batch > 0 &&
         (long long)batch * n_tok <= (1 << 30) && (warps == 2 || warps == 4 || warps == 8) &&
         sm90::tile_ok(pm, pn) && sm90::tile_ok(om, on);
}

// a (rows, D) activation map with pm-row boxes and up to three (D, D)
// weight maps with pn-row boxes, of elem_bytes-wide values
cudaError_t proj_maps(sm90::Maps* maps, const void* a, int rows, int pm, const void* const* w,
                      int nw, int pn, int elem_bytes) {
  cudaError_t e = sm90::cached_map(&maps->a, a, rows, D, pm, elem_bytes);
  for (int i = 0; i < nw && e == cudaSuccess; ++i)
    e = sm90::cached_map(&maps->b[i], w[i], D, D, pn, elem_bytes);
  return e;
}

sm90::GemmArgs gemm_args(int rows, int elem_bytes) {
  sm90::GemmArgs p = {};
  p.rows = rows;
  p.k_tiles = D * elem_bytes / sm90::BK_BYTES;
  p.ncols = D;
  return p;
}

}  // namespace

extern "C" int rald_attn_width() { return D; }
extern "C" int rald_attn_head_dim() { return DH; }
extern "C" int rald_attn_max_tokens() { return MAX_TOKENS; }

// bf16 / f32 mode (fused_self_attention_block): x (batch, n_tok, D), s, b,
// wq / wk / wv / wo in the torch layout (out, in) and bo all of x's type
// (f32 = 1: float32, else bf16); warps the bf16 core's block (2, 4 or 8),
// (pm, pn) the q / k / v GEMM's tile and (om, on) the out GEMM's, each in
// {64, 128}^2. Workspaces (caller-allocated, 16-byte aligned, x's type): hb,
// q, k, v, o (B*N, D).
extern "C" int rald_fused_self_attention_block(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bo, void* hb, void* q, void* k,
    void* v, void* o, void* out, int batch, int n_tok, int heads, int warps, int pm, int pn,
    int om, int on, int f32, int scale_shift_mod, float eps, void* stream) {
  if (!shape_ok(batch, n_tok, heads, warps, pm, pn, om, on)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = batch * n_tok;
  const void* wqkv[3] = {wq, wk, wv};
  void* oqkv[3] = {q, k, v};
  if (f32) {
    cudaError_t e = rald::launch_ln_quant<float>(x, s, b, mod_bstride, nullptr, nullptr, hb,
                                                 nullptr, rows, n_tok, scale_shift_mod, eps, st);
    if (e == cudaSuccess)
      e = proj_f32<sm90::STORE>(pm, pn, hb, wqkv, oqkv, 3, nullptr, nullptr, rows, st);
    if (e == cudaSuccess) e = launch_core_f32(q, k, v, o, nullptr, batch, n_tok, heads, st);
    if (e == cudaSuccess)
      e = proj_f32<sm90::OUT_RESID>(om, on, o, &wo, &out, 1, bo, x, rows, st);
    return (int)e;
  }
  sm90::Maps mp = {}, mo = {};
  cudaError_t e = proj_maps(&mp, hb, rows, pm, wqkv, 3, pn, 2);
  if (e == cudaSuccess) e = proj_maps(&mo, o, rows, om, &wo, 1, on, 2);
  if (e != cudaSuccess) return (int)e;

  e = rald::launch_ln_quant<bf16>(x, s, b, mod_bstride, nullptr, nullptr, hb, nullptr, rows,
                                  n_tok, scale_shift_mod, eps, st);
  if (e != cudaSuccess) return (int)e;
  sm90::GemmArgs pp = gemm_args(rows, 2);
  for (int i = 0; i < 3; ++i) pp.out[i] = oqkv[i];
  e = sm90::launch_tiled<bf16, sm90::STORE, PROJ_STAGES>(pm, pn, mp, pp, 3, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_core<true>(warps, q, k, v, o, nullptr, batch, n_tok, heads, st);
  if (e != cudaSuccess) return (int)e;
  sm90::GemmArgs po = gemm_args(rows, 2);
  po.bias = bo;
  po.resid = x;
  po.out[0] = out;
  return (int)sm90::launch_tiled<bf16, sm90::OUT_RESID, PROJ_STAGES>(om, on, mo, po, 1, st);
}

// int8 modes, x (and s, b, out, the workspaces hb, q, k, v) of x's type
// (f32 = 1: float32, else bf16). vout = 0 (fused_self_attention_block_int8):
// wq / wk / wv int8 with f32 row scales sq / sk / sv; vout = 1: wq / wk of
// x's type (sq / sk ignored), wv int8. wo int8 with scale so, bo f32. Tiles
// as above. Workspaces (caller-allocated, 16-byte aligned): hq int8 (B*N,
// D); hrow f32 (B*N); hb (B*N, D) (vout only); q, k, v (B*N, D); o f32
// (B*N, D); hmax f32 (B*N, heads); arow f32 (B*N); aq int8 (B*N, D).
template <typename T>
cudaError_t run_int8(const void* x, const void* s, const void* b, long long mod_bstride,
                     const void* wq, const void* sq, const void* wk, const void* sk,
                     const void* wv, const void* sv, const void* wo, const void* so,
                     const void* bo, void* hq, void* hrow, void* hb, void* q, void* k, void* v,
                     void* o, void* hmax, void* arow, void* aq, void* out, int batch, int n_tok,
                     int heads, int vout, int warps, int pm, int pn, int om, int on,
                     int scale_shift_mod, float eps, cudaStream_t st) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int rows = batch * n_tok;
  sm90::Maps mqk = {}, mv = {}, mo = {};
  const void* wqkv[3] = {wq, wk, wv};
  void* oqkv[3] = {q, k, v};
  cudaError_t e = cudaSuccess;
  if (vout && !F32) e = proj_maps(&mqk, hb, rows, pm, wqkv, 2, pn, 2);
  if (!vout) e = proj_maps(&mqk, hq, rows, pm, wqkv, 3, pn, 1);
  if (e == cudaSuccess && vout) e = proj_maps(&mv, hq, rows, pm, &wv, 1, pn, 1);
  if (e == cudaSuccess) e = proj_maps(&mo, aq, rows, om, &wo, 1, on, 1);
  if (e != cudaSuccess) return e;

  e = rald::launch_ln_quant<T>(x, s, b, mod_bstride, hq, hrow, vout ? hb : nullptr, nullptr, rows,
                               n_tok, scale_shift_mod, eps, st);
  if (e != cudaSuccess) return e;
  if (vout) {
    if constexpr (F32) {
      e = proj_f32<sm90::STORE>(pm, pn, hb, wqkv, oqkv, 2, nullptr, nullptr, rows, st);
    } else {
      sm90::GemmArgs pp = gemm_args(rows, 2);
      pp.out[0] = q;
      pp.out[1] = k;
      e = sm90::launch_tiled<bf16, sm90::STORE, PROJ_STAGES>(pm, pn, mqk, pp, 2, st);
    }
    if (e != cudaSuccess) return e;
    sm90::GemmArgs pv = gemm_args(rows, 1);
    pv.rowscale = (const float*)hrow;
    pv.colscale[0] = (const float*)sv;
    pv.out[0] = v;
    e = sm90::launch_tiled<int8_t, sm90::Q8_STORE, PROJ_STAGES, T>(pm, pn, mv, pv, 1, st);
  } else {
    sm90::GemmArgs pp = gemm_args(rows, 1);
    pp.rowscale = (const float*)hrow;
    const void* ss[3] = {sq, sk, sv};
    for (int i = 0; i < 3; ++i) {
      pp.colscale[i] = (const float*)ss[i];
      pp.out[i] = oqkv[i];
    }
    e = sm90::launch_tiled<int8_t, sm90::Q8_STORE, PROJ_STAGES, T>(pm, pn, mqk, pp, 3, st);
  }
  if (e != cudaSuccess) return e;

  e = F32 ? launch_core_f32(q, k, v, o, hmax, batch, n_tok, heads, st)
          : launch_core<false>(warps, q, k, v, o, hmax, batch, n_tok, heads, st);
  if (e != cudaSuccess) return e;
  e = rald::launch_quant_rows(o, rows, D, hmax, heads, aq, arow, st);
  if (e != cudaSuccess) return e;

  sm90::GemmArgs po = gemm_args(rows, 1);
  po.rowscale = (const float*)arow;
  po.colscale[0] = (const float*)so;
  po.bias = bo;
  po.resid = x;
  po.out[0] = out;
  return sm90::launch_tiled<int8_t, sm90::Q8_RESID, PROJ_STAGES, T>(om, on, mo, po, 1, st);
}

extern "C" int rald_fused_self_attention_block_int8(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* wq,
    const void* sq, const void* wk, const void* sk, const void* wv, const void* sv,
    const void* wo, const void* so, const void* bo, void* hq, void* hrow, void* hb, void* q,
    void* k, void* v, void* o, void* hmax, void* arow, void* aq, void* out, int batch,
    int n_tok, int heads, int vout, int warps, int pm, int pn, int om, int on, int f32,
    int scale_shift_mod, float eps, void* stream) {
  if (!shape_ok(batch, n_tok, heads, warps, pm, pn, om, on)) return (int)cudaErrorInvalidValue;
  const auto run = f32 ? &run_int8<float> : &run_int8<bf16>;
  return (int)run(x, s, b, mod_bstride, wq, sq, wk, sk, wv, sv, wo, so, bo, hq, hrow, hb, q, k,
                  v, o, hmax, arow, aq, out, batch, n_tok, heads, vout, warps, pm, pn, om, on,
                  scale_shift_mod, eps, (cudaStream_t)stream);
}
