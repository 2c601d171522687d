// Row LayerNorm forward and backward for Hopper (sm_90a), with a plain C interface.
//
// FORWARD.  Replaces the TPU kernel valor_tpu/ops/pallas/layernorm.py:_fwd_kernel
// (launched by _run_fwd under fused_layernorm): over the last dim of x [N, C],
//   mean = sum(x) / C,  var = sum((x - mean)^2) / C,  rstd = rsqrt(var + eps),
//   y = (x - mean) * rstd * w + b,
// with fp32 statistics, x in fp32 or bf16, w and b in fp32, y in fp32 or bf16.
//
// What bounds it on an H100: device memory.  Each row is read once and written once,
// N * C * (in_bytes + out_bytes) bytes, against about eight flops per element, far below
// the card's ~300 flops per byte balance point.  So the design moves each byte once:
//   * one warp per row, the whole row held in registers as fp32 (at most C = 4096, i.e.
//     128 floats a thread), so the two-pass statistics (mean first, then the mean of
//     squared deviations, as the JAX formula does; no E[x^2] - mean^2) re-read registers,
//     not memory;
//   * 16-byte vector loads and stores when C and every pointer allow, neighbouring lanes
//     on neighbouring addresses; a scalar path for any other C;
//   * warp shuffles for the two row reductions: no shared memory, no block barrier;
//   * the register array is sized at compile time (ITERS vectors a lane, a power of two
//     picked per call), so a row of 768 does not pay registers for a row of 4096.
// No tensor cores, TMA or wgmma: a row reduction has no matrix product to feed them.
//
// BACKWARD.  Replaces valor_tpu/ops/pallas/layernorm.py:_bwd_kernel (launched by _run_bwd):
// from x (the forward's input), w and dy, with mean and rstd RECOMPUTED from x as the TPU
// kernel does (so the forward saves no statistics),
//   xhat = (x - mean) * rstd,  g = dy * w,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  dw = sum_rows dy * xhat,  db = sum_rows dy.
// Bound on an H100: device memory again, N * C * (|x| + |dy| + |dx|) bytes against about
// twenty flops per element.  The TPU kernel's grid runs in order and writes (8, C) partial
// sums per 256-row tile that the caller adds up; Hopper's blocks run in no order, so:
//   * dx: one row group per row, both row statistics in fp32 over registers, as the forward;
//   * dw, db: each block owns a contiguous range of rows and accumulates dy * xhat and dy per
//     column in registers, adds its row groups' sums in shared memory in a fixed order, and
//     writes one [C] partial; a second kernel adds the partials in a fixed order.  No
//     atomics: the same inputs give the same bits on every run.  The grid is one wave, sized
//     by the occupancy API for the instantiation, so no block waits for a second wave and
//     the partials stay few (one per resident block).
//   * registers: a thread holds x, dy and the two column sums, 4 * C / (threads a row)
//     floats.  A row group is one warp up to C = 1024, two warps up to 2048 and four (the
//     whole block) up to 4096, so a thread never holds more than 32 floats of each, and
//     the row reductions of a multi-warp group go through shared memory.
//
// The caller allocates every output and the partials and passes the current stream; the
// kernels do not synchronise.  Each entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxCols = 4096;
constexpr int kMaxPerLane = kMaxCols / 32;

struct Params {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  int64_t n_rows;
  int cols;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// N consecutive values from a 16-byte aligned address, widened to fp32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  static_assert(N % 4 == 0, "fp32 vectors are loaded 4 at a time");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x;
    out[i + 1] = v.y;
    out[i + 2] = v.z;
    out[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  static_assert(N % 8 == 0, "bf16 vectors are loaded 8 at a time");
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  static_assert(N % 4 == 0, "fp32 vectors are stored 4 at a time");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 raw;
      raw.x = pack_bf16x2(v[i], v[i + 1]);
      raw.y = pack_bf16x2(v[i + 2], v[i + 3]);
      raw.z = pack_bf16x2(v[i + 4], v[i + 5]);
      raw.w = pack_bf16x2(v[i + 6], v[i + 7]);
      *reinterpret_cast<uint4*>(p + i) = raw;
    }
  } else {
    static_assert(N % 4 == 0, "bf16 vectors are stored 4 at a time");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      uint2 raw;
      raw.x = pack_bf16x2(v[i], v[i + 1]);
      raw.y = pack_bf16x2(v[i + 2], v[i + 3]);
      *reinterpret_cast<uint2*>(p + i) = raw;
    }
  }
}

// One warp per row.  Lane l owns columns [(it*32 + l)*VEC, +VEC) for it < ITERS.
// VEC > 1 requires cols % VEC == 0 and 16-byte aligned x, y, w and b.
template <typename Tin, typename Tout, int VEC, int ITERS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    layernorm_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, Tout* __restrict__ y, int64_t n_rows,
                         int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const Tin* xr = x + row * cols;
  Tout* yr = y + row * cols;

  float v[ITERS * VEC];
  float sum = 0.f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int col = (it * 32 + lane) * VEC;
    if (col < cols) {
      if constexpr (VEC == 1) {
        v[it] = to_f32(xr[col]);
      } else {
        load_vec<VEC>(xr + col, v + it * VEC);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) sum += v[it * VEC + j];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(cols);

  float sq = 0.f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int col = (it * 32 + lane) * VEC;
    if (col < cols) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[it * VEC + j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(cols) + eps);

#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int col = (it * 32 + lane) * VEC;
    if (col < cols) {
      float wv[VEC], bv[VEC], out[VEC];
      if constexpr (VEC == 1) {
        wv[0] = w[col];
        bv[0] = b[col];
      } else {
        load_vec<VEC>(w + col, wv);
        load_vec<VEC>(b + col, bv);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = (v[it * VEC + j] - mean) * rstd * wv[j] + bv[j];
      if constexpr (VEC == 1) {
        yr[col] = from_f32<Tout>(out[0]);
      } else {
        store_vec<VEC>(yr + col, out);
      }
    }
  }
}

template <typename Tin, typename Tout, int VEC, int ITERS>
void launch(const Params& p, cudaStream_t stream) {
  const int64_t blocks = (p.n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_fwd_kernel<Tin, Tout, VEC, ITERS>
      <<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const Tin*>(p.x), p.w, p.b, static_cast<Tout*>(p.y), p.n_rows, p.cols,
          p.eps);
}

// Smallest power-of-two ITERS >= needed, up to kMaxPerLane values a lane.
template <typename Tin, typename Tout, int VEC, int ITERS>
void dispatch_iters(int needed, const Params& p, cudaStream_t stream) {
  if constexpr (ITERS * VEC < kMaxPerLane) {
    if (needed > ITERS) {
      dispatch_iters<Tin, Tout, VEC, ITERS * 2>(needed, p, stream);
      return;
    }
  }
  launch<Tin, Tout, VEC, ITERS>(p, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

template <typename Tin, typename Tout>
void run(const Params& p, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(Tin));
  const bool vec_ok = p.cols % kVec == 0 && aligned16(p.x) && aligned16(p.y) &&
                      aligned16(p.w) && aligned16(p.b);
  if (vec_ok) {
    dispatch_iters<Tin, Tout, kVec, 1>((p.cols + 32 * kVec - 1) / (32 * kVec), p, stream);
  } else {
    dispatch_iters<Tin, Tout, 1, 1>((p.cols + 31) / 32, p, stream);
  }
}

// ---- backward -------------------------------------------------------------------------

constexpr int kBwdThreads = 128;  // 4 warps a block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxPerThread = 32;  // floats of x (and of dy, dw, db) a thread holds
constexpr int kRedCols = 32;          // partial reduction: columns a block
constexpr int kRedSlices = 32;        // partial reduction: row slices a block

struct BwdParams {
  const void* x;
  const float* w;
  const void* dy;
  void* dx;
  float* part_dw;  // [n_parts, cols]
  float* part_db;  // [n_parts, cols]
  int64_t n_rows;
  int64_t rows_per_block;
  int cols;
  int warps_per_row;
  float eps;
};

int warps_per_row(int cols) { return cols <= 1024 ? 1 : (cols <= 2048 ? 2 : 4); }

// (a, b) summed over the threads of this thread's row group, in a fixed order.  A group of
// one warp reduces with shuffles; a wider group also through shared memory, with block
// barriers, so every thread of the block has to call it the same number of times.
__device__ __forceinline__ float2 group_sum2(float a, float b, int wpr, float2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (wpr == 1) return make_float2(a, b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  const int first = warp - warp % wpr;
  float2 s = make_float2(0.f, 0.f);
  for (int k = 0; k < wpr; ++k) {
    s.x += scratch[first + k].x;
    s.y += scratch[first + k].y;
  }
  __syncthreads();  // scratch is written again by the next call
  return s;
}

template <int VEC, typename T>
__device__ __forceinline__ void load_any(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    load_vec<VEC>(p, out);
  }
}

// Block b owns rows [b * rows_per_block, +rows_per_block).  Its kBwdWarps / wpr row groups
// take the block's rows in turn (row r0 + s * n_groups + group at step s).  Thread t of a
// group owns columns [(it * tpr + t) * VEC, +VEC) for it < ITERS.  VEC > 1 requires
// cols % VEC == 0 and 16-byte aligned x, dy, dx and w.
template <typename Tx, typename Tdy, int VEC, int ITERS>
__global__ void __launch_bounds__(kBwdThreads) layernorm_bwd_kernel(BwdParams p) {
  extern __shared__ float red[];  // [2, cols]: the block's dw and db sums
  __shared__ float2 scratch[kBwdWarps];
  constexpr int kN = ITERS * VEC;
  const int wpr = p.warps_per_row;
  const int tpr = wpr * 32;
  const int n_groups = kBwdWarps / wpr;
  const int group = (threadIdx.x >> 5) / wpr;
  const int t = threadIdx.x - group * tpr;
  const int cols = p.cols;
  const float fcols = static_cast<float>(cols);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * p.rows_per_block;
  const int64_t r1 = r0 + p.rows_per_block < p.n_rows ? r0 + p.rows_per_block : p.n_rows;
  const Tx* x = static_cast<const Tx*>(p.x);
  const Tdy* dy = static_cast<const Tdy*>(p.dy);
  Tx* dx = static_cast<Tx*>(p.dx);

  float acc_w[kN], acc_b[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc_w[i] = acc_b[i] = 0.f;

  const int64_t steps = (p.rows_per_block + n_groups - 1) / n_groups;
  for (int64_t s = 0; s < steps; ++s) {
    const int64_t row = r0 + s * n_groups + group;
    const bool valid = row < r1;  // uniform over the group: its barriers stay matched
    const Tx* xr = x + row * cols;
    const Tdy* gr = dy + row * cols;
    float xv[kN], gv[kN];
    float sum = 0.f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = (it * tpr + t) * VEC;
      if (valid && col < cols) {
        load_any<VEC>(xr + col, xv + it * VEC);
        load_any<VEC>(gr + col, gv + it * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) sum += xv[it * VEC + j];
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) xv[it * VEC + j] = gv[it * VEC + j] = 0.f;
      }
    }
    const float mean = group_sum2(sum, 0.f, wpr, scratch).x / fcols;

    float sq = 0.f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = (it * tpr + t) * VEC;
      if (valid && col < cols) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = xv[it * VEC + j] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(group_sum2(sq, 0.f, wpr, scratch).x / fcols + p.eps);

    // xv becomes xhat and gv becomes g = dy * w, in place
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = (it * tpr + t) * VEC;
      if (valid && col < cols) {
        float wv[VEC];
        load_any<VEC>(p.w + col, wv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = it * VEC + j;
          const float xh = (xv[i] - mean) * rstd;
          const float g = gv[i];
          acc_b[i] += g;
          acc_w[i] += g * xh;
          xv[i] = xh;
          gv[i] = g * wv[j];
          s1 += gv[i];
          s2 += gv[i] * xh;
        }
      }
    }
    const float2 m = group_sum2(s1, s2, wpr, scratch);
    const float m1 = m.x / fcols, m2 = m.y / fcols;

#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = (it * tpr + t) * VEC;
      if (valid && col < cols) {
        float out[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = it * VEC + j;
          out[j] = rstd * (gv[i] - m1 - xv[i] * m2);
        }
        if constexpr (VEC == 1) {
          dx[row * cols + col] = from_f32<Tx>(out[0]);
        } else {
          store_vec<VEC>(dx + row * cols + col, out);
        }
      }
    }
  }

  // the block's column sums: row group 0 writes, the others add in turn
  for (int g = 0; g < n_groups; ++g) {
    if (group == g) {
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int col = (it * tpr + t) * VEC;
        if (col < cols) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int i = it * VEC + j;
            red[col + j] = g == 0 ? acc_w[i] : red[col + j] + acc_w[i];
            red[cols + col + j] = g == 0 ? acc_b[i] : red[cols + col + j] + acc_b[i];
          }
        }
      }
    }
    __syncthreads();
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += kBwdThreads) {
    p.part_dw[base + c] = red[c];
    p.part_db[base + c] = red[cols + c];
  }
}

// dw[c] = sum over parts of part_dw[., c] (and db alike).  Thread (x, y) adds parts y, y + 32,
// ... of column blockIdx.x * 32 + x, four loads in flight; the 32 slices are then added in
// order.
__global__ void __launch_bounds__(kRedCols * kRedSlices)
    layernorm_bwd_reduce_kernel(const float* __restrict__ part_dw,
                                const float* __restrict__ part_db, float* __restrict__ dw,
                                float* __restrict__ db, int n_parts, int cols) {
  __shared__ float sw[kRedSlices][kRedCols], sb[kRedSlices][kRedCols];
  const int c = blockIdx.x * kRedCols + threadIdx.x;
  float aw = 0.f, ab = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int i = threadIdx.y; i < n_parts; i += kRedSlices) {
      aw += part_dw[static_cast<int64_t>(i) * cols + c];
      ab += part_db[static_cast<int64_t>(i) * cols + c];
    }
  }
  sw[threadIdx.y][threadIdx.x] = aw;
  sb[threadIdx.y][threadIdx.x] = ab;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int k = 0; k < kRedSlices; ++k) {
      tw += sw[k][threadIdx.x];
      tb += sb[k][threadIdx.x];
    }
    dw[c] = tw;
    db[c] = tb;
  }
}

using BwdKernel = void (*)(BwdParams);

// The instantiation for a call: the smallest power-of-two ITERS that covers a row.
template <typename Tx, typename Tdy, int VEC, int ITERS>
BwdKernel bwd_pick_iters(int needed) {
  if constexpr (ITERS * VEC < kBwdMaxPerThread) {
    if (needed > ITERS) return bwd_pick_iters<Tx, Tdy, VEC, ITERS * 2>(needed);
  }
  return layernorm_bwd_kernel<Tx, Tdy, VEC, ITERS>;
}

template <typename Tx, typename Tdy>
BwdKernel bwd_pick_types(int cols, bool vec_ok) {
  constexpr int kVec = 8;
  const int tpr = warps_per_row(cols) * 32;
  if (vec_ok && cols % kVec == 0) {
    return bwd_pick_iters<Tx, Tdy, kVec, 1>((cols + tpr * kVec - 1) / (tpr * kVec));
  }
  return bwd_pick_iters<Tx, Tdy, 1, 1>((cols + tpr - 1) / tpr);
}

BwdKernel bwd_pick(int cols, bool vec_ok, int x_is_bf16, int dy_is_bf16) {
  if (x_is_bf16) {
    return dy_is_bf16 ? bwd_pick_types<__nv_bfloat16, __nv_bfloat16>(cols, vec_ok)
                      : bwd_pick_types<__nv_bfloat16, float>(cols, vec_ok);
  }
  return dy_is_bf16 ? bwd_pick_types<float, __nv_bfloat16>(cols, vec_ok)
                    : bwd_pick_types<float, float>(cols, vec_ok);
}

// Blocks of one wave for (device, kernel, cols), from the occupancy API, queried once and
// cached: the first call of a shape runs outside any CUDA graph capture, and later ones ask
// the runtime nothing but the current device.
cudaError_t bwd_wave(BwdKernel kernel, int cols, int64_t* wave) {
  static std::mutex mu;
  static std::map<std::pair<int, std::pair<const void*, int>>, int64_t> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(dev, std::make_pair(reinterpret_cast<const void*>(kernel), cols));
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *wave = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads,
                                                        2 * cols * sizeof(float));
  }
  if (err != cudaSuccess) return err;
  *wave = cache[key] = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// Rows a block of the backward takes: the grid is one wave, or fewer blocks when each row
// group would get less than one row.  The caller sizes the partials by the same rule.
cudaError_t bwd_rows_per_block(BwdKernel kernel, int64_t n_rows, int cols, int64_t* rows) {
  int64_t wave = 0;
  const cudaError_t err = bwd_wave(kernel, cols, &wave);
  if (err != cudaSuccess) return err;
  const int n_groups = kBwdWarps / warps_per_row(cols);
  int64_t blocks = (n_rows + n_groups - 1) / n_groups;
  if (blocks > wave) blocks = wave;
  *rows = (n_rows + blocks - 1) / blocks;
  return cudaSuccess;
}

bool bwd_vec_ok(const void* x, const void* dy, const void* dx, const void* w) {
  return aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(w);
}

}  // namespace

extern "C" int valor_layernorm_fwd(const void* x, const void* w, const void* b, void* y,
                                   int64_t n_rows, int cols, float eps, int x_is_bf16,
                                   int y_is_bf16, void* stream) {
  if (n_rows <= 0 || cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, static_cast<const float*>(w), static_cast<const float*>(b), y, n_rows, cols,
                 eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    if (y_is_bf16) {
      run<__nv_bfloat16, __nv_bfloat16>(p, s);
    } else {
      run<__nv_bfloat16, float>(p, s);
    }
  } else {
    if (y_is_bf16) {
      run<float, __nv_bfloat16>(p, s);
    } else {
      run<float, float>(p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows of the backward's partial sums for these arguments: the caller allocates two
// [parts, cols] fp32 buffers and passes parts back to valor_layernorm_bwd.  0 on an error.
extern "C" int64_t valor_layernorm_bwd_parts(const void* x, const void* w, const void* dy,
                                             const void* dx, int64_t n_rows, int cols,
                                             int x_is_bf16, int dy_is_bf16) {
  if (n_rows <= 0 || cols < 1 || cols > kMaxCols) return 0;
  const BwdKernel k = bwd_pick(cols, bwd_vec_ok(x, dy, dx, w), x_is_bf16, dy_is_bf16);
  int64_t rows = 0;
  if (bwd_rows_per_block(k, n_rows, cols, &rows) != cudaSuccess) return 0;
  return (n_rows + rows - 1) / rows;
}

extern "C" int valor_layernorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                                   void* dw, void* db, void* partials, int64_t n_rows, int cols,
                                   float eps, int x_is_bf16, int dy_is_bf16, int64_t n_parts,
                                   void* stream) {
  if (n_rows <= 0 || cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel kernel = bwd_pick(cols, bwd_vec_ok(x, dy, dx, w), x_is_bf16, dy_is_bf16);
  int64_t rows_per_block = 0;
  const cudaError_t qerr = bwd_rows_per_block(kernel, n_rows, cols, &rows_per_block);
  if (qerr != cudaSuccess) return static_cast<int>(qerr);
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks != n_parts) return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(partials);
  const BwdParams p{x, static_cast<const float*>(w), dy, dx, part, part + n_parts * cols,
                    n_rows, rows_per_block, cols, warps_per_row(cols), eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  kernel<<<nb, kBwdThreads, 2 * cols * sizeof(float), s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 red_block(kRedCols, kRedSlices);
  layernorm_bwd_reduce_kernel<<<(cols + kRedCols - 1) / kRedCols, red_block, 0, s>>>(
      p.part_dw, p.part_db, static_cast<float*>(dw), static_cast<float*>(db), nb, cols);
  return static_cast<int>(cudaGetLastError());
}
