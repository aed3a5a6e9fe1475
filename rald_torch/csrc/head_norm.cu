// RMS QK-norm of 128-wide attention heads, read and written in the layout
// the q and k projections wrote them: one launch an attention, for its q and
// its k.
//
// Replaces no TPU kernel: rald_tpu has no Hunyuan3D DiT. It does what
// rald_torch/models/hunyuan_dit.py's attentions did with PyTorch ops
// (ops/head_norm.py::head_rms_norm_plain): view each (B, L, H*128)
// projection output as (B, H, L, 128) heads, then F.rms_norm them, which
// first copies the strided view contiguous and then runs a row-per-block
// norm kernel over 128-wide rows.
//
// Arithmetic, as F.rms_norm's: per head of 128 values, ss = sum x^2 in
// float32, r = rsqrt(ss / 128 + eps), y = (x * r) * w in float32, rounded to
// the input's type once; a zero head stays zero. Each square of a bf16 value
// is exact in float32; only the order of the sum differs from PyTorch's (16
// lanes of 8 values, then a tree of 4 shuffles), so a bf16 output may differ
// by one unit in the last place.
//
// What bounds it on an H100: bytes. It reads every value of q and k once and
// writes it once, about 1 FLOP a byte. At the Hunyuan3D-2.1 cell's shapes (B
// 2 guidance rows, H 16, bf16) a self-attention's q and k hold 2 * 2 * 4097 *
// 2048 values, 134.2 MB moved (40.1 us at 3.35 TB/s), and a cross-attention's,
// q of the 4097 tokens and k of the 1370 condition tokens, 89.6 MB (26.7 us).
//
// Design. One thread per 8 bf16 values of a head (16 bytes), 16 neighbouring
// lanes per head: each lane loads its values with one 16-byte load, sums
// their squares, and four xor shuffles give every lane of the head the
// head's sum, with no shared memory. A warp covers 2 heads of one token (one
// coalesced 512-byte read and write). The grid is flat over (tensor, b, l,
// 8-value chunk of the row), q's chunks first, then k's, 256 threads a block:
// 16,388 blocks for a self-attention at the cell's shapes and 10,934 for a
// cross-attention, many waves over 132 SMs. A lane past the end computes on
// the last chunk and stores nothing, so every lane of a warp takes part in
// each shuffle. Each lane reads its 16 bytes before it writes them back, and
// no other lane touches them, so the kernel norms the rows in place.
//
// Two choices, measured on an H100 80GB HBM3 at 700 W, B 2, H 16, bf16, in
// replayed CUDA graphs, from HBM (8 input sets): (1) the layout: in place in
// the projection's (B, L, H * 128) output, against a version of this kernel
// that wrote contiguous (B, H, L, 128) buffers. The kernel alone took 0.0465
// / 0.0322 ms in place (self / cross; 86 / 83 % of the bound) against 0.0471
// / 0.0323 into buffers, but a whole DiT evaluation took 72.9-73.7 ms in place
// against 75.1-76.5 into buffers (and 81.6-82.1 with the F.rms_norm
// composite): cuDNN's SDPA reads the strided q, k and v with no copy kernel
// and returns its output in q's (B, L, H, 128) order, so the output
// projection reads it as a view; into buffers, its 42 transposing copies an
// evaluation (2.2 ms) stay. So the kernel writes where it read. (2) One
// launch an attention for q and k: 0.0465-0.0468 / 0.0322-0.0323 ms against
// 0.0496 / 0.0347 for one launch a tensor, whose smaller grids each end on a
// partial wave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <stdint.h>

namespace {

constexpr int HD = 128;          // head width
constexpr int VEC = 8;           // values a lane holds: 16 bytes
constexpr int LANES = HD / VEC;  // lanes a head
constexpr int NT = 256;          // threads a block

struct Vec8 {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ __forceinline__ void get(float (&f)[VEC]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ void set(const float (&f)[VEC]) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
};

// One tensor: (batch, n, heads * HD) rows x at element strides (xb, xr),
// unit stride along a row, normed in place; its HD-value scale w.
struct Part {
  __nv_bfloat16* x;
  const __nv_bfloat16* w;
  long long xb, xr;
  int n;
};

__global__ void __launch_bounds__(NT) head_rms_norm_kernel(Part p0, Part p1, int heads,
                                                           int total0, int total, float eps) {
  const int g = blockIdx.x * NT + threadIdx.x;
  const bool live = g < total;
  int gg = live ? g : total - 1;
  const bool second = gg >= total0;
  const Part p = second ? p1 : p0;
  if (second) gg -= total0;
  const int chunks = heads * LANES;  // chunks a token
  const int t = gg / chunks;         // token row b * n + l
  const int c = gg - t * chunks;
  const int b = t / p.n, l = t - b * p.n;
  const int lane = c % LANES;

  __nv_bfloat16* at = p.x + b * p.xb + l * p.xr + c * VEC;
  Vec8 x;
  x.load(at);
  float f[VEC];
  x.get(f);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) ss += f[i] * f[i];
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, m);
  const float r = rsqrtf(ss * (1.f / HD) + eps);
  Vec8 w;
  w.load(p.w + lane * VEC);
  float wf[VEC];
  w.get(wf);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = (f[i] * r) * wf[i];
  x.set(f);
  if (live) x.store(at);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q: (batch, nq, heads * HD) bf16 rows at element strides qs = (batch, row),
// unit stride along a row, normed in place; wq: its HD bf16 scales. k, ks,
// wk, nk likewise. Every pointer 16-byte aligned and every stride a whole
// number of 16-byte steps.
extern "C" int rald_head_rms_norm(void* q, const long long* qs, const void* wq, int nq, void* k,
                                  const long long* ks, const void* wk, int nk, int batch,
                                  int heads, float eps, void* stream) {
  constexpr long long step = 16 / sizeof(__nv_bfloat16);
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {(const void*)q, wq, (const void*)k, wk})
    if (!aligned(ptr)) return (int)cudaErrorInvalidValue;
  for (const long long s : {qs[0], qs[1], ks[0], ks[1]})
    if (s % step) return (int)cudaErrorInvalidValue;
  const long long total0 = (long long)batch * nq * heads * LANES;
  const long long total = total0 + (long long)batch * nk * heads * LANES;
  if (total > 0x7fffffffLL - NT) return (int)cudaErrorInvalidValue;
  const int grid = (int)((total + NT - 1) / NT);
  const Part pq{(__nv_bfloat16*)q, (const __nv_bfloat16*)wq, qs[0], qs[1], nq};
  const Part pk{(__nv_bfloat16*)k, (const __nv_bfloat16*)wk, ks[0], ks[1], nk};
  head_rms_norm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(pq, pk, heads, (int)total0,
                                                              (int)total, eps);
  return (int)cudaGetLastError();
}
