// Fused LayerNorm/AdaLN-mod + multi-head self-attention + residual, bf16 and
// int8, Hopper (sm_90a).
//
// Replaces the TPU kernels of rald_tpu/ops/attn_kernel.py:
//   ::fused_self_attention_block (Pallas body _kernel), all projections bf16
//     -> rald_fused_self_attention_block_bf16;
//   ::fused_self_attention_block_int8 (_int8_kernel), all projections int8,
//     and ::fused_self_attention_block_int8_vout (_int8_vout_kernel), q / k
//     bf16, v and out int8 -> rald_fused_self_attention_block_int8.
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
#include <math.h>

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

// bf16 mode (fused_self_attention_block): wq / wk / wv / wo bf16 in the torch
// layout (out, in), bo bf16, x (batch, n_tok, D) bf16; warps the core's
// block (2 or 4), (pm, pn) the q / k / v GEMM's tile and (om, on) the out
// GEMM's, each in {64, 128}^2. Workspaces (caller-allocated, 16-byte
// aligned): hb, q, k, v, o bf16 (B*N, D).
extern "C" int rald_fused_self_attention_block_bf16(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bo, void* hb, void* q, void* k,
    void* v, void* o, void* out, int batch, int n_tok, int heads, int warps, int pm, int pn,
    int om, int on, int scale_shift_mod, float eps, void* stream) {
  if (!shape_ok(batch, n_tok, heads, warps, pm, pn, om, on)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = batch * n_tok;
  sm90::Maps mp = {}, mo = {};
  const void* wqkv[3] = {wq, wk, wv};
  cudaError_t e = proj_maps(&mp, hb, rows, pm, wqkv, 3, pn, 2);
  if (e == cudaSuccess) e = proj_maps(&mo, o, rows, om, &wo, 1, on, 2);
  if (e != cudaSuccess) return (int)e;

  e = rald::launch_ln_quant(x, s, b, mod_bstride, nullptr, nullptr, hb, nullptr, rows, n_tok,
                            scale_shift_mod, eps, st);
  if (e != cudaSuccess) return (int)e;
  sm90::GemmArgs pp = gemm_args(rows, 2);
  pp.out[0] = q;
  pp.out[1] = k;
  pp.out[2] = v;
  e = sm90::launch_tiled<bf16, sm90::STORE, PROJ_STAGES>(pm, pn, mp, pp, 3, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_core<true>(warps, q, k, v, o, nullptr, batch, n_tok, heads, st);
  if (e != cudaSuccess) return (int)e;
  sm90::GemmArgs po = gemm_args(rows, 2);
  po.bias = bo;
  po.resid = (const bf16*)x;
  po.out[0] = out;
  return (int)sm90::launch_tiled<bf16, sm90::OUT_RESID, PROJ_STAGES>(om, on, mo, po, 1, st);
}

// int8 modes. vout = 0 (fused_self_attention_block_int8): wq / wk / wv int8
// with f32 row scales sq / sk / sv; vout = 1: wq / wk bf16 (sq / sk
// ignored), wv int8. wo int8 with scale so, bo f32. Tiles as above.
// Workspaces (caller-allocated, 16-byte aligned): hq int8 (B*N, D); hrow f32
// (B*N); hb bf16 (B*N, D) (vout only); q, k, v bf16 (B*N, D); o f32
// (B*N, D); hmax f32 (B*N, heads); arow f32 (B*N); aq int8 (B*N, D).
extern "C" int rald_fused_self_attention_block_int8(
    const void* x, const void* s, const void* b, long long mod_bstride, const void* wq,
    const void* sq, const void* wk, const void* sk, const void* wv, const void* sv,
    const void* wo, const void* so, const void* bo, void* hq, void* hrow, void* hb, void* q,
    void* k, void* v, void* o, void* hmax, void* arow, void* aq, void* out, int batch,
    int n_tok, int heads, int vout, int warps, int pm, int pn, int om, int on,
    int scale_shift_mod, float eps, void* stream) {
  if (!shape_ok(batch, n_tok, heads, warps, pm, pn, om, on)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = batch * n_tok;
  sm90::Maps mqk = {}, mv = {}, mo = {};
  const void* wqkv[3] = {wq, wk, wv};
  cudaError_t e = vout ? proj_maps(&mqk, hb, rows, pm, wqkv, 2, pn, 2)
                       : proj_maps(&mqk, hq, rows, pm, wqkv, 3, pn, 1);
  if (e == cudaSuccess && vout) e = proj_maps(&mv, hq, rows, pm, &wv, 1, pn, 1);
  if (e == cudaSuccess) e = proj_maps(&mo, aq, rows, om, &wo, 1, on, 1);
  if (e != cudaSuccess) return (int)e;

  e = rald::launch_ln_quant(x, s, b, mod_bstride, hq, hrow, vout ? hb : nullptr, nullptr, rows,
                            n_tok, scale_shift_mod, eps, st);
  if (e != cudaSuccess) return (int)e;
  if (vout) {
    sm90::GemmArgs pp = gemm_args(rows, 2);
    pp.out[0] = q;
    pp.out[1] = k;
    e = sm90::launch_tiled<bf16, sm90::STORE, PROJ_STAGES>(pm, pn, mqk, pp, 2, st);
    if (e != cudaSuccess) return (int)e;
    sm90::GemmArgs pv = gemm_args(rows, 1);
    pv.rowscale = (const float*)hrow;
    pv.colscale[0] = (const float*)sv;
    pv.out[0] = v;
    e = sm90::launch_tiled<int8_t, sm90::Q8_STORE, PROJ_STAGES>(pm, pn, mv, pv, 1, st);
  } else {
    sm90::GemmArgs pp = gemm_args(rows, 1);
    pp.rowscale = (const float*)hrow;
    const void* ss[3] = {sq, sk, sv};
    void* os[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      pp.colscale[i] = (const float*)ss[i];
      pp.out[i] = os[i];
    }
    e = sm90::launch_tiled<int8_t, sm90::Q8_STORE, PROJ_STAGES>(pm, pn, mqk, pp, 3, st);
  }
  if (e != cudaSuccess) return (int)e;

  e = launch_core<false>(warps, q, k, v, o, hmax, batch, n_tok, heads, st);
  if (e != cudaSuccess) return (int)e;
  e = rald::launch_quant_rows(o, rows, D, hmax, heads, aq, arow, st);
  if (e != cudaSuccess) return (int)e;

  sm90::GemmArgs po = gemm_args(rows, 1);
  po.rowscale = (const float*)arow;
  po.colscale[0] = (const float*)so;
  po.bias = bo;
  po.resid = (const bf16*)x;
  po.out[0] = out;
  return (int)sm90::launch_tiled<int8_t, sm90::Q8_RESID, PROJ_STAGES>(om, on, mo, po, 1, st);
}
