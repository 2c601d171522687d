// Fused fine-grained retrieval score for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel valor_tpu/ops/pallas/fine_score.py:_make_kernel (`kernel`, launched
// by fine_score_fused).  For query items a with token features fa[a, t, :] and gallery items b
// with token features fb[b, v, :] (masked tokens zeroed by the caller, so that they dot to a
// literal 0) and token weights wa[a, t], wb[b, v] (softmaxed over the valid tokens by the
// caller):
//   s[a, b, t, v] = <fa[a, t], fb[b, v]>                       (fp32 accumulation)
//   out[a, b] = 0.5 * (sum_t wa[a, t] * max_v s[a, b, t, v] + sum_v wb[b, v] * max_t s[a, b, t, v])
// without ever writing the [A, B, T, V] logits to device memory (1.28 GB at the MSR-VTT 1k-A
// gallery for one group).
//
// What bounds it on an H100: operations.  It does 2 * A * B * T * V * D flops on
// (A * T + B * V) * D feature values: at A = B = 1000, T = 32, V = 10, D = 512 that is 327.7
// GFLOP on 21 MB, about 16,000 flops a byte, far above the card's balance point.  This first
// version runs on the fp32 FMA units (67 TFLOP/s, not the tensor cores: TF32 would not hold the
// 1e-5 tolerance of the fp32 eval path), so the design is a register-blocked SGEMM with a fused
// epilogue:
//   * one CTA per tile of TA query items x TB gallery items, TA = 128 / T and TB = 128 / V, so
//     the tile's logits are a [TA * T, TB * V] block of at most 128 x 128 that holds whole items
//     on both sides: every max and every weighted sum of the tile's outputs is inside the CTA,
//     and no partial result crosses CTAs (no atomics, no second pass);
//   * the product [TA * T, D] x [D, TB * V] goes through shared memory in 8-deep D-stages, double
//     buffered through registers, with 256 threads each accumulating an 8 x 8 block of logits in
//     fp32 registers (16-byte vector loads where D and the pointers allow, bf16 converted to fp32
//     on load);
//   * then the logits tile goes to shared memory (128 x 129 floats: 66 KB, over the staging
//     buffers it aliases) and a group of lanes per (a, b) output (one lane where the tile has
//     256 outputs or more, up to a warp where it has 8 or fewer) takes, in a fixed order, the
//     max over v for each t weighted by wa and the max over t for each v weighted by wb, each
//     summed across the group by shuffles: the same inputs give the same bits.
// Rows of the tile past its last item (or past A or B) are zero in the product and are never
// read by the epilogue: bounds checks keep padding out of every max, so an all-negative row keeps
// its negative max.  bf16 features take the same fp32 FMA path, although their products are
// exact in fp32 and the card's bound for them is the bf16 tensor-core rate (989 TFLOP/s dense):
// wgmma, TMA and bf16 tensor cores are later performance work.
//
// The caller allocates the output and passes the current stream; the kernel does not
// synchronise.  The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kTile = 128;     // token rows of a CTA's logits tile on each side
constexpr int kBK = 8;         // depth of one shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 logits each
constexpr int kPitch = kTile + 1;  // padded row of the logits tile in shared memory
constexpr int kMaxTokens = 128;
constexpr int kMaxDim = 4096;
constexpr size_t kSmemBytes = sizeof(float) * kTile * kPitch;  // 66,048 B; the stages alias it
static_assert(4 * kBK * kTile * sizeof(float) <= kSmemBytes, "the stages fit under the tile");

struct Params {
  const void* fa;  // [A, T, D]
  const void* fb;  // [B, V, D]
  const float* wa;  // [A, T]
  const float* wb;  // [B, V]
  float* out;       // [A, B]
  int a_n, b_n, t_n, v_n, d;
  int ta, tb;     // items a tile holds on each side
  int b_tiles;    // tiles along B
  int vec;        // 1 when 4-element vector loads are allowed
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Elements k .. k+3 of one feature row as fp32; zero past D, and zero for a row that is padding
// (row == nullptr).
template <typename T>
__device__ __forceinline__ void load4(const T* row, int k, int d, bool vec, float out[4]) {
  if (row == nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = 0.f;
    return;
  }
  if (vec && k + 4 <= d) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + k));
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    } else {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(row + k);
      const float2 lo = __bfloat1622float2(p[0]);
      const float2 hi = __bfloat1622float2(p[1]);
      out[0] = lo.x;
      out[1] = lo.y;
      out[2] = hi.x;
      out[3] = hi.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = k + j < d ? to_f32(row[k + j]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) fine_score_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  // stages: as[2][kBK][kTile] then bs[2][kBK][kTile], k-major so a thread reads 4 rows at once
  float* as = smem;
  float* bs = smem + 2 * kBK * kTile;
  float* tile = smem;  // [kTile][kPitch] logits, after the product

  const int tid = threadIdx.x;
  const int a_tile = blockIdx.x / p.b_tiles;
  const int b_tile = blockIdx.x % p.b_tiles;
  const int a0 = a_tile * p.ta;
  const int b0 = b_tile * p.tb;
  const int na = min(p.ta, p.a_n - a0);  // items of this tile
  const int nb = min(p.tb, p.b_n - b0);

  // each thread stages 4 consecutive k of one row of each side
  const int ld_row = tid >> 1;
  const int ld_k = (tid & 1) * 4;
  const T* pa = ld_row < na * p.t_n
                    ? static_cast<const T*>(p.fa) + (static_cast<int64_t>(a0) * p.t_n + ld_row) * p.d
                    : nullptr;
  const T* pb = ld_row < nb * p.v_n
                    ? static_cast<const T*>(p.fb) + (static_cast<int64_t>(b0) * p.v_n + ld_row) * p.d
                    : nullptr;
  const bool vec = p.vec != 0;

  // this thread's logits: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise by tx
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  float ra[4], rb[4];
  load4(pa, ld_k, p.d, vec, ra);
  load4(pb, ld_k, p.d, vec, rb);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    as[(ld_k + j) * kTile + ld_row] = ra[j];
    bs[(ld_k + j) * kTile + ld_row] = rb[j];
  }
  __syncthreads();

  int stage = 0;
  for (int k0 = 0; k0 < p.d; k0 += kBK) {
    const bool more = k0 + kBK < p.d;
    if (more) {  // the next stage's loads are in flight during this stage's FMAs
      load4(pa, k0 + kBK + ld_k, p.d, vec, ra);
      load4(pb, k0 + kBK + ld_k, p.d, vec, rb);
    }
    const float* sa = as + stage * kBK * kTile;
    const float* sb = bs + stage * kBK * kTile;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(sa + k * kTile + ty * 4);
      const float4 a_hi = *reinterpret_cast<const float4*>(sa + k * kTile + 64 + ty * 4);
      const float4 b_lo = *reinterpret_cast<const float4*>(sb + k * kTile + tx * 4);
      const float4 b_hi = *reinterpret_cast<const float4*>(sb + k * kTile + 64 + tx * 4);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) {
      // nobody reads stage ^ 1 any more: every thread passed the barrier after its last use
      float* na_ = as + (stage ^ 1) * kBK * kTile;
      float* nb_ = bs + (stage ^ 1) * kBK * kTile;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        na_[(ld_k + j) * kTile + ld_row] = ra[j];
        nb_[(ld_k + j) * kTile + ld_row] = rb[j];
      }
      __syncthreads();
      stage ^= 1;
    }
  }
  __syncthreads();  // every warp is done with the stages, which the logits tile overwrites

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      tile[m * kPitch + n] = acc[i][j];
    }
  }
  __syncthreads();

  // a group of `gl` lanes per output of the tile (a power of two: as many as the tile's
  // outputs leave room for, so a tile of many outputs runs one a thread and a tile of few a
  // warp each); the group's lanes split the tokens, then a fixed-order shuffle sum.  Every
  // lane runs the same number of rounds, so the shuffles see the whole warp.
  const int n_out = na * nb;
  int gl = 32;
  while (gl > 1 && n_out * gl > kThreads) gl >>= 1;
  const int groups = kThreads / gl;
  const int li = tid & (gl - 1);
  for (int base = 0; base < n_out; base += groups) {
    const int o = base + tid / gl;
    const bool active = o < n_out;
    float q = 0.f;  // query-token direction: max over the gallery item's tokens
    float g = 0.f;  // gallery-token direction: max over the query item's tokens
    if (active) {
      const int al = o / nb;
      const int bl = o % nb;
      const float* s = tile + al * p.t_n * kPitch + bl * p.v_n;  // s[t * kPitch + v]
      const float* wa = p.wa + static_cast<int64_t>(a0 + al) * p.t_n;
      const float* wb = p.wb + static_cast<int64_t>(b0 + bl) * p.v_n;
      for (int t = li; t < p.t_n; t += gl) {
        float m = s[t * kPitch];
        for (int v = 1; v < p.v_n; ++v) m = fmaxf(m, s[t * kPitch + v]);
        q = fmaf(wa[t], m, q);
      }
      for (int v = li; v < p.v_n; v += gl) {
        float m = s[v];
        for (int t = 1; t < p.t_n; ++t) m = fmaxf(m, s[t * kPitch + v]);
        g = fmaf(wb[v], m, g);
      }
    }
    for (int offset = gl >> 1; offset > 0; offset >>= 1) {
      q += __shfl_xor_sync(0xffffffffu, q, offset);
      g += __shfl_xor_sync(0xffffffffu, g, offset);
    }
    if (active && li == 0) {
      p.out[static_cast<int64_t>(a0 + o / nb) * p.b_n + b0 + o % nb] = 0.5f * (q + g);
    }
  }
}

// The kernels take 66 KB of dynamic shared memory, above the default 48 KB: the attribute is
// set once per device and instantiation (never inside a CUDA graph capture after the first call).
std::mutex g_attr_mutex;
unsigned g_attr_done[2] = {0u, 0u};  // bit per device, per instantiation (f32, bf16)

template <typename T>
cudaError_t allow_smem(int which) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_attr_mutex);
  if (g_attr_done[which] & (1u << dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(fine_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) g_attr_done[which] |= 1u << dev;
  return err;
}

template <typename T>
int launch(const Params& p, int64_t blocks, cudaStream_t s, int which) {
  const cudaError_t err = allow_smem<T>(which);
  if (err != cudaSuccess) return static_cast<int>(err);
  fine_score_kernel<T><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[A, B] (fp32) = the fine score of fa [A, T, D] and fb [B, V, D] (both fp32, or both bf16 when
// feat_is_bf16), with fp32 softmaxed token weights wa [A, T] and wb [B, V]; every array
// contiguous.  Takes 1 <= A, B; 1 <= T, V <= 128; 1 <= D <= 4096.
extern "C" int valor_fine_score(const void* fa, const void* fb, const void* wa, const void* wb,
                                void* out, int a_n, int b_n, int t_n, int v_n, int d,
                                int feat_is_bf16, void* stream) {
  if (a_n < 1 || b_n < 1 || t_n < 1 || t_n > kMaxTokens || v_n < 1 || v_n > kMaxTokens || d < 1 ||
      d > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ta = kTile / t_n;
  const int tb = kTile / v_n;
  const int64_t a_tiles = (static_cast<int64_t>(a_n) + ta - 1) / ta;
  const int64_t b_tiles = (static_cast<int64_t>(b_n) + tb - 1) / tb;
  const int64_t blocks = a_tiles * b_tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = feat_is_bf16 ? 8 : 16;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(fa) % align == 0 &&
                  reinterpret_cast<uintptr_t>(fb) % align == 0;
  const Params p{fa, fb, static_cast<const float*>(wa), static_cast<const float*>(wb),
                 static_cast<float*>(out), a_n, b_n, t_n, v_n, d, ta, tb,
                 static_cast<int>(b_tiles), vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feat_is_bf16) return launch<__nv_bfloat16>(p, blocks, s, 1);
  return launch<float>(p, blocks, s, 0);
}
