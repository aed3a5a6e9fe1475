// The split of a QKV projection's rows into attention heads, with RMS
// QK-norm, written straight into the (B, H, L, 64) tensors SDPA reads.
//
// Replaces no TPU kernel: rald_tpu has no Hunyuan3D DiT. It does, in one
// pass a stream, what rald_torch/models/mmdit.py's blocks did with PyTorch
// ops (ops/qk_norm.py::split_qk_norm_plain): view the (B, L, 3*H*64) qkv rows
// as heads, permute them to (B, H, L, 64), F.rms_norm q and k (each copying
// its strided view contiguous first), and, in a dual-stream block, torch.cat
// both streams' q, k and v into the joint tensors over [c ; x].
//
// Arithmetic, as F.rms_norm's: per head of 64 values, ss = sum x^2 in
// float32, r = rsqrt(ss / 64 + eps), y = (x * r) * w in float32, rounded to
// the input's type once. Each square of a bf16 value is exact in float32;
// only the order of the sum differs from PyTorch's (8 lanes of 8 values,
// then a tree of 3 shuffles), and rsqrtf is the one PyTorch's CUDA kernel
// uses, so a bf16 output may differ by one unit in the last place. v is
// copied bit for bit.
//
// What bounds it on an H100: bytes. Per token it reads the 3*H*64 values of
// q, k and v and writes them again (2*H*64 each way where v is not written:
// the single-stream blocks leave v a view of the qkv rows); about 1 FLOP a
// byte. At the published model's shapes (B 2 guidance rows, H 16, bf16) that
// is 75.5 MB at L 3072 (22.5 us at 3.35 TB/s), 33.7 MB at L 1370 (10.0 us)
// and, without v, 72.8 MB at L 4442 (21.7 us).
//
// Design. One thread per 8 values of a head (16 bytes in bf16, 32 in
// float32), 8 neighbouring lanes per head: each lane loads its values with
// 16-byte loads, sums their squares, and three xor shuffles give every lane
// of the head the head's sum, with no shared memory. A warp covers 4 heads of
// one token's row (one coalesced 512-byte read in bf16) and writes four whole
// 128-byte lines, one per head, at (b, h, off + l). The grid is flat over
// (b, l, 8-value chunk of the row), 256 threads a block: 13,000 blocks at B 2,
// L 4442, and 4,100 at L 1370, many waves over 132 SMs. A lane past the end
// computes on the last chunk and stores nothing, so every lane of a warp
// takes part in each shuffle. The launcher takes the qkv rows' batch and row
// strides, so the single-stream blocks' [qkv | MLP] rows are read in place,
// and a token offset into the outputs, so two launches (condition stream at
// 0, latent stream at n_c) fill the joint tensors in [c ; x] order.
//
// Two choices, measured on an H100 80GB HBM3 at 700 W, B 2, H 16, bf16, in a
// replayed CUDA graph: (1) one launch a stream: the dual-stream pair takes
// 0.0415 ms against its 0.0326 ms bound (78 %), so one launch over both
// streams could save at most that 0.009 ms gap. (2) The single-stream
// blocks leave v a view of the qkv rows: cuDNN's SDPA reads it in place (no
// copy kernel in its profile), at L 4442 in 0.4255 and 0.4202 ms in two runs
// against 0.4105 and 0.4279 with a contiguous v, while writing v here would
// move 36 MB more, ~0.011-0.014 ms at this kernel's rate: no net gain, and
// no v buffer to hold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;           // head width
constexpr int VEC = 8;           // values a lane holds
constexpr int LANES = HD / VEC;  // lanes a head
constexpr int NT = 256;          // threads a block

template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
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

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = a;
    reinterpret_cast<float4*>(p)[1] = b;
  }
  __device__ __forceinline__ void get(float (&f)[VEC]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
  __device__ __forceinline__ void set(const float (&f)[VEC]) {
    a = make_float4(f[0], f[1], f[2], f[3]);
    b = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// qkv rows (batch, n, >= chunks * VEC) at strides (sb, sr), unit stride along
// a row; q, k and, when v is not null, v: (batch, heads, n_tot, HD), this
// call's tokens at [off, off + n). chunks = (v ? 3 : 2) * heads * LANES.
template <typename T>
__global__ void __launch_bounds__(NT) split_qk_norm_kernel(
    const T* __restrict__ qkv, long long sb, long long sr, const T* __restrict__ wq,
    const T* __restrict__ wk, T* __restrict__ q, T* __restrict__ k, T* __restrict__ v, int n,
    int heads, int n_tot, int off, int chunks, int total, float eps) {
  const int g = blockIdx.x * NT + threadIdx.x;
  const bool live = g < total;
  const int gg = live ? g : total - 1;
  const int t = gg / chunks;  // token row b * n + l
  const int c = gg - t * chunks;
  const int b = t / n, l = t - b * n;
  const int per = heads * LANES;  // chunks of q, of k, of v
  const int part = c / per;       // 0 q, 1 k, 2 v
  const int cc = c - part * per;
  const int h = cc / LANES, lane = cc % LANES;

  Vec8<T> x;
  x.load(qkv + b * sb + l * sr + (long long)c * VEC);
  float f[VEC];
  x.get(f);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) ss += f[i] * f[i];
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, m);
  if (part < 2) {
    const float r = rsqrtf(ss * (1.f / HD) + eps);
    Vec8<T> w;
    w.load((part ? wk : wq) + lane * VEC);
    float wf[VEC];
    w.get(wf);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = (f[i] * r) * wf[i];
    x.set(f);
  }
  T* dst = part == 0 ? q : part == 1 ? k : v;
  if (live) x.store(dst + (((long long)b * heads + h) * n_tot + off + l) * HD + lane * VEC);
}

template <typename T>
int launch(const void* qkv, long long sb, long long sr, const void* wq, const void* wk, void* q,
           void* k, void* v, int batch, int n, int heads, int n_tot, int off, float eps,
           cudaStream_t st) {
  const long long chunks = (long long)(v ? 3 : 2) * heads * LANES;
  const long long total = (long long)batch * n * chunks;
  if (total > (1LL << 31) - NT) return (int)cudaErrorInvalidValue;
  const int grid = (int)((total + NT - 1) / NT);
  split_qk_norm_kernel<T><<<grid, NT, 0, st>>>(
      (const T*)qkv, sb, sr, (const T*)wq, (const T*)wk, (T*)q, (T*)k, (T*)v, n, heads, n_tot,
      off, (int)chunks, (int)total, eps);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// qkv: (batch, n, >= 3 * heads * HD) rows of x's type (f32 = 1: float32,
// else bf16) at element strides (sb, sr), q columns first, then k, then v;
// wq, wk: HD scales of the same type; q, k and, unless v is null, v:
// contiguous (batch, heads, n_tot, HD), written at tokens [off, off + n).
// Every pointer 16-byte aligned, sb and sr whole 16-byte steps.
extern "C" int rald_split_qk_norm(const void* qkv, long long sb, long long sr, const void* wq,
                                  const void* wk, void* q, void* k, void* v, int batch, int n,
                                  int heads, int n_tot, int off, int f32, float eps,
                                  void* stream) {
  const long long step = 16 / (f32 ? 4 : 2);
  if (batch <= 0 || n <= 0 || heads <= 0 || off < 0 || (long long)off + n > n_tot ||
      sb % step || sr % step || sr < 3LL * heads * HD || !aligned(qkv) || !aligned(wq) ||
      !aligned(wk) || !aligned(q) || !aligned(k) || (v && !aligned(v)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32) return launch<float>(qkv, sb, sr, wq, wk, q, k, v, batch, n, heads, n_tot, off, eps, st);
  return launch<__nv_bfloat16>(qkv, sb, sr, wq, wk, q, k, v, batch, n, heads, n_tot, off, eps,
                               st);
}
