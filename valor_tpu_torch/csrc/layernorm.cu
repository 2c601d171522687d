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
// the card's ~300 flops per byte balance point.  At the model's shapes (a few hundred to a
// few thousand rows of 512 or 768) a call is over in one or two memory round trips, so
// the design moves each byte once and puts one round trip on a row's critical path:
//   * one warp per row, the whole row held in registers as fp32, so the two-pass
//     statistics (mean first, then the mean of squared deviations, as the JAX formula
//     does; no E[x^2] - mean^2) re-read registers, not memory;
//   * on the vector path, w and b are loaded with x, before the two warp reductions,
//     wherever a lane holds at most 32 values of a row (C up to 1024): their loads overlap
//     x's, so no row waits on a second memory trip before its store.  A wider row, and the
//     scalar path, load them after the reductions: registers limit the first, and the
//     second measured slower with them early.  (Staging w and b through shared memory with
//     cp.async and a block barrier measured slower at every bf16 shape.)
//   * 16-byte vector loads and stores when C and every pointer allow, neighbouring lanes
//     on neighbouring addresses; a scalar path for any other C;
//   * warp shuffles for the two row reductions: no shared memory, no block barrier;
//   * the register array is sized at compile time to the row: ITERS vectors a lane, taken
//     exactly for the model's widths (2 at C = 512 and 3 at C = 768 in bf16), so a row of
//     768 pays registers for neither a row of 1024 nor one of 4096.
// No tensor cores, TMA or wgmma: a row reduction has no matrix product to feed them.
//
// BACKWARD.  Replaces valor_tpu/ops/pallas/layernorm.py:_bwd_kernel (launched by _run_bwd):
// from x (the forward's input), w and dy, with mean and rstd RECOMPUTED from x as the TPU
// kernel does (so the forward saves no statistics),
//   xhat = (x - mean) * rstd,  g = dy * w,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  dw = sum_rows dy * xhat,  db = sum_rows dy.
// Bound on an H100: device memory again, N * C * (|x| + |dy| + |dx|) bytes against about
// twenty flops per element.  The TPU kernel's grid runs in order and writes (8, C) partial
// sums per 256-row tile that the caller adds up.  Hopper's blocks run in no order, and at
// the model's small shapes ([1280, 768]: 1.3 us of bytes) a second launch for the
// cross-block sum costs more than the bytes do.  So ONE cooperative launch does it all:
//   * the grid is at most one wave (co-resident by the cooperative launch's guarantee; the
//     caller sizes it from the occupancy this library reports).  A block of 8 warps owns a
//     contiguous range of rows; its row groups (1 warp for C <= 768, 2 up to 1536, 4 up to
//     3072, the whole block up to 4096, so a thread holds at most 24 values of a row; 16 on
//     the scalar path, whose group widens at 512) each take the same number of rows,
//     STEPS, so no group runs an idle second step.  At small N a group takes one row, and
//     every row of the call is in flight at once;
//   * loads of x and dy are 8 values a lane where x is bf16 and C % 8 == 0, 4 where x is
//     fp32 (16 bytes a lane: whole sectors a warp-wide access) or C % 4 == 0, else 1; w
//     sits in shared memory, copied once a block by cp.async while the first row's loads
//     are in flight, so a row pays one device-memory trip.  Shared memory is read and
//     written as float4s: a lane's columns are 8 floats from its neighbour's, so scalar
//     accesses would meet 8 to a bank;
//   * where a group takes more than one row, its rows pass through a cp.async pipeline in
//     shared memory (3 stages where x and dy are bf16, else 2; at most 112 KB a block, so
//     two blocks fit an SM): while one row is reduced the next ones load, and no registers
//     are held for them;
//   * dx: both row statistics in fp32 over registers, as the forward; a group wider than a
//     warp adds through shared memory with one block barrier a reduction;
//   * dw, db: each thread sums dy * xhat and dy for its columns in registers over its
//     group's rows; the groups' sums meet in shared memory and are added in group order,
//     and the block writes one [2, C] partial (160 at [1280, 768]);
//   * a grid-wide barrier (cooperative groups' grid.sync), after which block b adds the
//     partials of its slice of the 2 * C columns in partial order, every block busy.  A
//     fixed order everywhere and no atomics: the same inputs give the same bits on every
//     run.  A cooperative launch captures into and replays from a CUDA graph, which is how
//     the smoke run times it and how a later step graph will launch it.  (Thread block
//     clusters, launched cooperatively with the partials added over distributed shared
//     memory, 20 partials at [1280, 768], were as exact and slower at every small shape on
//     an H100: the cluster barriers cost more than the partials they save.)
//   * registers: x, dy and the two column sums, 4 * 24 floats a thread at most (96);
//     __launch_bounds__(256, 2) keeps two blocks, 16 warps, on each SM
//     (valor_tpu_torch/tools/kernel_resources.py prints each instantiation's registers and
//     spills; valor_tpu_torch/tools/layernorm_phases.py times the kernel's phases).
//
// The caller allocates every output and the partials, sizes the grid (blocks, steps) from
// valor_layernorm_bwd_info, and passes the current stream; the kernels do not synchronise.
// Each entry point returns the CUDA error of its launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxCols = 4096;
constexpr int kMaxPerLane = kMaxCols / 32;
constexpr int kEarlyMax = 32;  // values of a row a lane holds up to which w and b load with x

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
  if constexpr (N % 8 != 0) {
    static_assert(N % 4 == 0, "bf16 vectors are loaded 4 or 8 at a time");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      out[i] = lo.x;
      out[i + 1] = lo.y;
      out[i + 2] = hi.x;
      out[i + 3] = hi.y;
    }
  } else {
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

template <int VEC, typename T>
__device__ __forceinline__ void load_any(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    load_vec<VEC>(p, out);
  }
}

// src[0, n) into shared dst[0, n) by cp.async, STAGE floats a copy (4: 16 bytes, both
// 16-byte aligned and n % 4 == 0), threads of the block in turn.  The copies do not hold
// the thread: it goes on with its row while they land; __pipeline_wait_prior(0) and a
// barrier come before the block reads dst.
template <int STAGE>
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n, int threads) {
  for (int c = threadIdx.x * STAGE; c < n; c += threads * STAGE) {
    __pipeline_memcpy_async(dst + c, src + c, STAGE * sizeof(float));
  }
}

// VEC floats of shared memory (16-byte aligned where VEC % 4 == 0) as float4s: a lane's
// neighbours sit VEC floats away, so scalar accesses would meet in one bank VEC / 2 times
// more often than float4 ones.
template <int VEC>
__device__ __forceinline__ void load_smem(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
    load_vec<VEC>(p, out);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = p[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store_smem(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
    store_vec<VEC>(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_any(T* p, const float* v) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    store_vec<VEC>(p, v);
  }
}

// One warp per row.  Lane l owns columns [(it*32 + l)*VEC, +VEC) for it < ITERS.
// VEC > 1 requires cols % VEC == 0 and 16-byte aligned x, y, w and b.
template <typename Tin, typename Tout, int VEC, int ITERS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    layernorm_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, Tout* __restrict__ y, int64_t n_rows,
                         int cols, float eps) {
  constexpr int kN = ITERS * VEC;
  constexpr bool kEarly = VEC > 1 && kN <= kEarlyMax;  // w and b in registers, loaded with x
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const Tin* xr = x + row * cols;
  Tout* yr = y + row * cols;

  // the early path issues every load before the first add; the late one adds as x lands
  // (each order measured faster than the other on its path)
  float v[kN];
  float wv[kEarly ? kN : 1], bv[kEarly ? kN : 1];
  float sum = 0.f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int col = (it * 32 + lane) * VEC;
    if (col < cols) {
      load_any<VEC>(xr + col, v + it * VEC);
      if constexpr (kEarly) {
        load_vec<VEC>(w + col, wv + it * VEC);
        load_vec<VEC>(b + col, bv + it * VEC);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sum += v[it * VEC + j];
      }
    }
  }
  if constexpr (kEarly) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      if ((it * 32 + lane) * VEC < cols) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sum += v[it * VEC + j];
      }
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(cols);

  float sq = 0.f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    if ((it * 32 + lane) * VEC < cols) {
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
      float out[VEC];
      if constexpr (kEarly) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = it * VEC + j;
          out[j] = (v[i] - mean) * rstd * wv[i] + bv[i];
        }
      } else {
        float wl[VEC], bl[VEC];
        load_any<VEC>(w + col, wl);
        load_any<VEC>(b + col, bl);
#pragma unroll
        for (int j = 0; j < VEC; ++j) out[j] = (v[it * VEC + j] - mean) * rstd * wl[j] + bl[j];
      }
      store_any<VEC>(yr + col, out);
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

// The vector path's ITERS: every count up to 4, then steps of 2, 4 and 8, so C = 512 and
// C = 768 get exactly the registers they need (2 and 3 in bf16, 4 and 6 in fp32) and no
// row pays for more than a third over its width.  The scalar path (C not a multiple of the
// vector) keeps powers of two.
constexpr int next_iters(int iters, int vec) {
  return vec == 1 ? 2 * iters
                  : (iters < 4 ? iters + 1
                               : (iters < 8 ? iters + 2 : (iters < 16 ? iters + 4 : iters + 8)));
}

// The smallest ITERS of the list that covers a row, up to kMaxPerLane values a lane.
template <typename Tin, typename Tout, int VEC, int ITERS>
void dispatch_iters(int needed, const Params& p, cudaStream_t stream) {
  constexpr int kNext = next_iters(ITERS, VEC);
  if constexpr (kNext * VEC <= kMaxPerLane) {
    if (needed > ITERS) {
      dispatch_iters<Tin, Tout, VEC, kNext>(needed, p, stream);
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

constexpr int kBwdThreads = 256;  // 8 warps a block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxPerThread = 24;  // values of a row a thread holds (of x, dy, dw and db)
constexpr int kBwdMaxPerThreadScalar = 16;  // the same on the scalar path, which spills at 24

struct BwdParams {
  const void* x;
  const float* w;
  const void* dy;
  void* dx;
  float* dw;
  float* db;
  float* part;  // [gridDim.x, 2 * cols]: each block's dw sums, then its db sums
  int64_t n_rows;
  int64_t steps;  // rows each row group takes
  int cols;
  int warps_per_row;
  float eps;
};

// Stages of the row pipeline: rows in shared memory at once per row group, each holding that
// row's x and dy as they are in device memory (3 where both are bf16, else 2, so that a block
// stays within 112 KB and two blocks fit on an SM).
__host__ __device__ constexpr int bwd_stages(int x_bytes, int dy_bytes) {
  return x_bytes + dy_bytes <= 4 ? 3 : 2;
}

// Bytes of one staged row: x, then dy, each padded to 16 bytes.
__host__ __device__ constexpr int64_t bwd_pad16(int64_t bytes) {
  return (bytes + 15) & ~int64_t{15};
}

// The vector width of a call: 8 values a load where x is bf16 and C % 8 == 0; 4 where x is
// fp32 (16 bytes a lane, so that each warp-wide load and store of x and dx covers whole
// 32-byte sectors: with 8 fp32 values a lane, two instructions each use half of every
// sector, which was slower at [1280, 768] on an H100) or C % 4 == 0; else 1.  A width > 1 needs
// x, dy, dx and w 16-byte aligned (`aligned`).
int bwd_vec_width(int cols, bool aligned, int x_is_bf16) {
  if (!aligned) return 1;
  if (x_is_bf16 && cols % 8 == 0) return 8;
  return cols % 4 == 0 ? 4 : 1;
}

// Warps of a row group: the fewest that keep a thread at kBwdMaxPerThread values of a row
// (vector path: 1 warp up to C = 768, 2 to 1536, 4 to 3072, 8 to 4096) or at
// kBwdMaxPerThreadScalar (scalar path: 1 warp up to 512, 2 to 1024, 4 to 2048, 8 to 4096).
int bwd_warps_per_row(int cols, bool vec) {
  const int per = 32 * (vec ? kBwdMaxPerThread : kBwdMaxPerThreadScalar);
  return cols <= per ? 1 : (cols <= 2 * per ? 2 : (cols <= 4 * per ? 4 : 8));
}

// The cross-block sum: a block adds nv * nb partials, fewer than 2 * cols + nb, which its
// threads load kFinChunk at a time (one memory trip at the model's widths).
constexpr int kFinChunk = 8;
constexpr int kBwdMaxBlocks = 2048;

// Shared memory of a block of a grid of `blocks`, in bytes: during the rows, w [cols rounded
// up to 4] and, where rows are staged (`staged`), the stages of every row group's x and dy;
// after the rows, the groups' sums [groups, 2, cols]; after the grid barrier, a slice of the
// partials, fewer than 2 * cols + blocks floats, and the runs of their sums, kBwdThreads.
size_t bwd_smem_bytes(int cols, int vec, int x_is_bf16, int dy_is_bf16, bool staged,
                      int64_t blocks) {
  const int64_t groups = kBwdWarps / bwd_warps_per_row(cols, vec > 1);
  const int xb = x_is_bf16 ? 2 : 4, gb = dy_is_bf16 ? 2 : 4;
  const int64_t row_bytes = bwd_pad16(static_cast<int64_t>(cols) * xb) +
                            bwd_pad16(static_cast<int64_t>(cols) * gb);
  const int64_t rows =
      ((cols + 3) & ~3) * 4 + (staged ? bwd_stages(xb, gb) * groups * row_bytes : 0);
  const int64_t sums = groups * 2 * cols * 4;
  const int64_t slice = (2 * static_cast<int64_t>(cols) + blocks + kBwdThreads) * 4;
  const int64_t most = rows > sums ? rows : sums;
  return static_cast<size_t>(most > slice ? most : slice);
}

// (a, b) summed over the threads of this thread's row group, in a fixed order.  A group of
// one warp reduces with shuffles; a wider group also through `scratch` in shared memory, with
// one block barrier, so every thread of the block has to call it the same number of times.
// A row's three calls take three scratch arrays in turn: the next write to an array comes
// two barriers after its reads, so no second barrier is needed to protect them.
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
  return s;
}

// The c-th of the 2 * cols column sums: dw for c < cols, then db.
__device__ __forceinline__ void put_sum(const BwdParams& p, int c, float value) {
  if (c < p.cols) {
    p.dw[c] = value;
  } else {
    p.db[c - p.cols] = value;
  }
}

// x and dy of one row into registers, as fp32; zeros where the row or column is outside.
template <int VEC, int ITERS, typename Tx, typename Tdy>
__device__ __forceinline__ void bwd_load_row(const Tx* x, const Tdy* dy, int64_t row, bool valid,
                                             int cols, int tpr, int t, float* xv, float* gv) {
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int col = (it * tpr + t) * VEC;
    if (valid && col < cols) {
      load_any<VEC>(x + row * cols + col, xv + it * VEC);
      load_any<VEC>(dy + row * cols + col, gv + it * VEC);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) xv[it * VEC + j] = gv[it * VEC + j] = 0.f;
    }
  }
}

// BYTES (8, 16 or 32) from src to shared dst by cp.async, up to 16 bytes a copy, both aligned
// to the copy.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  static_assert(BYTES == 8 || BYTES % 16 == 0, "staged rows are copied 8 or 16 bytes at a time");
  constexpr int kStep = BYTES < 16 ? BYTES : 16;
#pragma unroll
  for (int o = 0; o < BYTES; o += kStep) {
    __pipeline_memcpy_async(static_cast<char*>(dst) + o, static_cast<const char*>(src) + o, kStep);
  }
}

// This thread's columns of x and dy of one row into a stage (sx, sdy: the row's place in
// shared memory) by cp.async, in their own types; nothing where the row is outside.  The
// thread later reads back exactly the columns it copied, so no barrier is needed.
template <int VEC, int ITERS, typename Tx, typename Tdy>
__device__ __forceinline__ void bwd_stage_row(const Tx* x, const Tdy* dy, int64_t row, bool valid,
                                              int cols, int tpr, int t, Tx* sx, Tdy* sdy) {
  if constexpr (VEC > 1) {  // the scalar path does not stage rows
    if (!valid) return;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = (it * tpr + t) * VEC;
      if (col < cols) {
        copy_async<VEC * sizeof(Tx)>(sx + col, x + row * cols + col);
        copy_async<VEC * sizeof(Tdy)>(sdy + col, dy + row * cols + col);
      }
    }
  }
}

// Block b owns rows [b * n_groups * steps, +n_groups * steps); its row groups take them in
// turn (row r0 + s * n_groups + group at step s < steps).  Thread t of a group owns columns
// [(it * tpr + t) * VEC, +VEC) for it < ITERS.  VEC > 1 requires cols % VEC == 0 and 16-byte
// aligned x, dy, dx and w.  Launched cooperatively: grid.sync() needs every block resident.
template <typename Tx, typename Tdy, int VEC, int ITERS>
__global__ void __launch_bounds__(kBwdThreads, 2) layernorm_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];  // w and the row stages; then the groups' sums
  __shared__ float2 scratch[3][kBwdWarps];
  constexpr int kN = ITERS * VEC;
  constexpr int kStages = bwd_stages(sizeof(Tx), sizeof(Tdy));
  const int wpr = p.warps_per_row;
  const int tpr = wpr * 32;
  const int n_groups = kBwdWarps / wpr;
  const int group = (threadIdx.x >> 5) / wpr;
  const int t = threadIdx.x - group * tpr;
  const int cols = p.cols;
  const float fcols = static_cast<float>(cols);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * n_groups * p.steps;
  const Tx* x = static_cast<const Tx*>(p.x);
  const Tdy* dy = static_cast<const Tdy*>(p.dy);
  Tx* dx = static_cast<Tx*>(p.dx);

  // Where a group takes more than one row on a vector path, its rows run through a pipeline
  // of kStages stages in shared memory: while row s is reduced, rows s + 1 .. s + kStages - 1
  // are loading, with no registers held for them.  Stage k of group g holds x then dy of one
  // row, after w.
  const bool staged = VEC > 1 && p.steps > 1;
  const int64_t x_bytes = bwd_pad16(static_cast<int64_t>(cols) * sizeof(Tx));
  const int64_t row_bytes = x_bytes + bwd_pad16(static_cast<int64_t>(cols) * sizeof(Tdy));
  char* const stages = reinterpret_cast<char*>(smem + ((cols + 3) & ~3));
  auto stage_x = [&](int64_t s) {
    return reinterpret_cast<Tx*>(stages + ((s % kStages) * n_groups + group) * row_bytes);
  };
  auto stage_dy = [&](int64_t s) {
    return reinterpret_cast<Tdy*>(stages + ((s % kStages) * n_groups + group) * row_bytes +
                                  x_bytes);
  };
  auto row_of = [&](int64_t s) { return r0 + s * n_groups + group; };

  float acc_w[kN], acc_b[kN], xv[kN], gv[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc_w[i] = acc_b[i] = 0.f;

  // the first row's loads go out before w's, so both are in flight together
  if (staged) {
    bwd_stage_row<VEC, ITERS>(x, dy, row_of(0), row_of(0) < p.n_rows, cols, tpr, t, stage_x(0),
                              stage_dy(0));
  } else {
    bwd_load_row<VEC, ITERS>(x, dy, row_of(0), row_of(0) < p.n_rows, cols, tpr, t, xv, gv);
  }
  if constexpr (VEC > 1) {
    for (int c = threadIdx.x * 4; c < cols; c += kBwdThreads * 4) {
      __pipeline_memcpy_async(smem + c, p.w + c, 16);
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kBwdThreads) {
      __pipeline_memcpy_async(smem + c, p.w + c, 4);
    }
  }
  __pipeline_commit();  // group 0: w and the first row
  if (staged) {
#pragma unroll
    for (int s = 1; s < kStages - 1; ++s) {  // one group a row, up to kStages - 1 rows ahead
      if (s < p.steps) {
        bwd_stage_row<VEC, ITERS>(x, dy, row_of(s), row_of(s) < p.n_rows, cols, tpr, t,
                                  stage_x(s), stage_dy(s));
      }
      __pipeline_commit();
    }
    __pipeline_wait_prior(kStages - 2);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncthreads();  // w, copied by every thread of the block

  for (int64_t s = 0; s < p.steps; ++s) {
    const int64_t row = row_of(s);
    const bool valid = row < p.n_rows;  // uniform over the group: its barriers stay matched
    if (staged) {
      const int64_t ahead = s + kStages - 1;
      if (ahead < p.steps) {
        bwd_stage_row<VEC, ITERS>(x, dy, row_of(ahead), row_of(ahead) < p.n_rows, cols, tpr, t,
                                  stage_x(ahead), stage_dy(ahead));
      }
      __pipeline_commit();  // always, so that the group count stays at kStages + s
      __pipeline_wait_prior(kStages - 1);  // this thread's copies of row s have landed
      const Tx* sx = stage_x(s);
      const Tdy* sdy = stage_dy(s);
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int col = (it * tpr + t) * VEC;
        if (valid && col < cols) {
          load_any<VEC>(sx + col, xv + it * VEC);
          load_any<VEC>(sdy + col, gv + it * VEC);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) xv[it * VEC + j] = gv[it * VEC + j] = 0.f;
        }
      }
    } else if (s > 0) {
      bwd_load_row<VEC, ITERS>(x, dy, row, valid, cols, tpr, t, xv, gv);
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) sum += xv[i];  // zeros outside the row
    const float mean = group_sum2(sum, 0.f, wpr, scratch[0]).x / fcols;

    float sq = 0.f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      if (valid && (it * tpr + t) * VEC < cols) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = xv[it * VEC + j] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(group_sum2(sq, 0.f, wpr, scratch[1]).x / fcols + p.eps);

    // xv becomes xhat and gv becomes g = dy * w, in place
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = (it * tpr + t) * VEC;
      if (valid && col < cols) {
        float wv[VEC];
        load_smem<VEC>(smem + col, wv);
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
    const float2 m = group_sum2(s1, s2, wpr, scratch[2]);
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
        store_any<VEC>(dx + row * cols + col, out);
      }
    }
  }

  // the block's column sums: each group's in its own slice (over w and the stages, which no
  // thread reads any more), then added in group order into the block's partial
  __syncthreads();
  float* red = smem + static_cast<size_t>(group) * 2 * cols;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int col = (it * tpr + t) * VEC;
    if (col < cols) {
      store_smem<VEC>(red + col, acc_w + it * VEC);
      store_smem<VEC>(red + cols + col, acc_b + it * VEC);
    }
  }
  __syncthreads();
  const int two_c = 2 * cols;
  const int nb = static_cast<int>(gridDim.x);
  float* part = p.part + static_cast<int64_t>(blockIdx.x) * two_c;
  for (int c = threadIdx.x; c < two_c; c += kBwdThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < kBwdWarps; ++g) {  // the groups' loads go out together
      if (g < n_groups) a += smem[g * two_c + c];
    }
    if (nb == 1) {  // one block: its sums are dw and db, with no barrier and no second pass
      put_sum(p, c, a);
    } else {
      part[c] = a;
    }
  }
  if (nb == 1) return;

  cg::this_grid().sync();

  // Block b adds every block's partial of its slice [v0, v0 + nv) of the 2 * cols sums.
  // Its nv * nb loads go out kFinChunk a thread at a time (predicated, into registers;
  // __ldcg bypasses L1: other SMs wrote them) and land in shared memory as [nb, nv]; then
  // they are added in a fixed order: a warp (or half a warp) a sum where a block has at most
  // 16 sums (the model's widths), a thread a sum where the partials are few, runs of them
  // in between.
  const int per = (two_c + nb - 1) / nb;
  const int v0 = static_cast<int>(blockIdx.x) * per;
  const int nv = two_c - v0 < per ? two_c - v0 : per;
  if (nv <= 0) return;
  const int total = nv * nb;
  const int dk = kBwdThreads / nv, dv = kBwdThreads % nv;  // (k, v) of i, stepped by threads
  int k = threadIdx.x / nv, v = threadIdx.x % nv;
  for (int i0 = 0; i0 < total; i0 += kFinChunk * kBwdThreads) {
    float r[kFinChunk];
#pragma unroll
    for (int j = 0; j < kFinChunk; ++j) {
      if (i0 + threadIdx.x + j * kBwdThreads < total) {
        r[j] = __ldcg(p.part + static_cast<int64_t>(k) * two_c + v0 + v);
      }
      k += dk;
      v += dv;
      if (v >= nv) {
        v -= nv;
        ++k;
      }
    }
#pragma unroll
    for (int j = 0; j < kFinChunk; ++j) {
      const int i = i0 + threadIdx.x + j * kBwdThreads;
      if (i < total) smem[i] = r[j];
    }
  }
  __syncthreads();
  if (nv <= kBwdWarps) {  // a warp a sum: lane l adds partials l, l + 32, ... in order,
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;  // then a shuffle tree
    if (warp < nv) {
      float a = 0.f;
      for (int kk = lane; kk < nb; kk += 32) a += smem[kk * nv + warp];
      a = warp_sum(a);
      if (lane == 0) put_sum(p, v0 + warp, a);
    }
    return;
  }
  if (nv <= 2 * kBwdWarps) {  // the same with half a warp a sum, so that all go in one
    // round (at [1280, C], 160 blocks and 10 sums a block, faster on an H100 than two warps
    // taking two sums each)
    const int vv = threadIdx.x >> 4, lane = threadIdx.x & 15;
    float a = 0.f;
    if (vv < nv) {
      for (int kk = lane; kk < nb; kk += 16) a += smem[kk * nv + vv];
    }
#pragma unroll
    for (int offset = 8; offset > 0; offset >>= 1) a += __shfl_xor_sync(0xffffffffu, a, offset);
    if (vv < nv && lane == 0) put_sum(p, v0 + vv, a);
    return;
  }
  if (nv >= kBwdThreads) {  // few blocks: a thread a sum, over all partials
    for (int vv = threadIdx.x; vv < nv; vv += kBwdThreads) {
      float a = 0.f;
      for (int kk = 0; kk < nb; ++kk) a += smem[kk * nv + vv];
      put_sum(p, v0 + vv, a);
    }
    return;
  }
  // between: `slices` threads a sum add contiguous runs of partials, then one adds the runs
  float* runs = smem + total;  // [slices, nv], past the staged partials
  const int slices = kBwdThreads / nv;
  const int run = (nb + slices - 1) / slices;
  const int vs = threadIdx.x % nv, sl = threadIdx.x / nv;
  if (sl < slices) {
    float a = 0.f;
    const int k1 = (sl + 1) * run < nb ? (sl + 1) * run : nb;
    for (int kk = sl * run; kk < k1; ++kk) a += smem[kk * nv + vs];
    runs[threadIdx.x] = a;
  }
  __syncthreads();
  if (threadIdx.x < nv) {
    float a = 0.f;
    for (int kk = 0; kk < slices; ++kk) a += runs[kk * nv + threadIdx.x];
    put_sum(p, v0 + threadIdx.x, a);
  }
}

using BwdKernel = void (*)(BwdParams);

// The instantiation for a call.  The 8-wide path takes ITERS exactly (1 to 3: C = 512 gets
// 2 and C = 768 gets 3, 16 and 24 values a thread); the 4-wide path 2, 4 or 6 (C = 512 gets
// 4, C = 768 gets 6); the scalar path 8 or 16.
template <typename Tx, typename Tdy, int VEC, int ITERS>
BwdKernel bwd_pick_iters(int needed) {
  constexpr int kNext = VEC == 1 ? ITERS + 8 : (VEC == 4 ? ITERS + 2 : ITERS + 1);
  if constexpr (kNext * VEC <= (VEC == 1 ? kBwdMaxPerThreadScalar : kBwdMaxPerThread)) {
    if (needed > ITERS) return bwd_pick_iters<Tx, Tdy, VEC, kNext>(needed);
  }
  return layernorm_bwd_kernel<Tx, Tdy, VEC, ITERS>;
}

template <typename Tx, typename Tdy>
BwdKernel bwd_pick_types(int cols, int vec) {
  const int tpr = bwd_warps_per_row(cols, vec > 1) * 32;
  if (vec == 8) return bwd_pick_iters<Tx, Tdy, 8, 1>((cols + tpr * 8 - 1) / (tpr * 8));
  if (vec == 4) return bwd_pick_iters<Tx, Tdy, 4, 2>((cols + tpr * 4 - 1) / (tpr * 4));
  return bwd_pick_iters<Tx, Tdy, 1, 8>((cols + tpr - 1) / tpr);
}

// vec: the vector width, bwd_vec_width.
BwdKernel bwd_pick(int cols, int vec, int x_is_bf16, int dy_is_bf16) {
  if (x_is_bf16) {
    return dy_is_bf16 ? bwd_pick_types<__nv_bfloat16, __nv_bfloat16>(cols, vec)
                      : bwd_pick_types<__nv_bfloat16, float>(cols, vec);
  }
  return dy_is_bf16 ? bwd_pick_types<float, __nv_bfloat16>(cols, vec)
                    : bwd_pick_types<float, float>(cols, vec);
}

bool bwd_aligned(const void* x, const void* dy, const void* dx, const void* w) {
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

// What the caller needs to size a backward call at this width, types and alignment (aligned:
// x, dy, dx and w 16-byte aligned), on the current device: out[0] row groups a block, out[1]
// blocks that are resident at once (the cooperative grid's limit), out[2] kernel launches a
// call (1: the cross-block sum is inside the kernel).  Query it once a key, before the first
// launch, and cache it: it sets the kernel's shared-memory limit and asks the runtime for the
// occupancy.
extern "C" int valor_layernorm_bwd_info(int cols, int x_is_bf16, int dy_is_bf16, int aligned,
                                        int64_t* out) {
  if (cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = bwd_vec_width(cols, aligned != 0, x_is_bf16);
  const void* fn = reinterpret_cast<const void*>(bwd_pick(cols, vec, x_is_bf16, dy_is_bf16));
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attrs;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  // the instantiation serves several widths: its limit is the card's, not this width's
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, fn);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attrs.sharedSizeBytes));
  }
  if (err == cudaSuccess) {  // the most a launch of this width asks: staged rows, 8 blocks an SM
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kBwdThreads,
        bwd_smem_bytes(cols, vec, x_is_bf16, dy_is_bf16, vec > 1, 8 * static_cast<int64_t>(sms)));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t wave = static_cast<int64_t>(sms) * per_sm;
  out[0] = kBwdWarps / bwd_warps_per_row(cols, vec > 1);
  out[1] = wave < kBwdMaxBlocks ? wave : kBwdMaxBlocks;
  out[2] = 1;
  return 0;
}

// dx, dw and db for rows [0, n_rows) in one cooperative launch of `blocks` blocks whose row
// groups take `steps` rows each: blocks * groups * steps must cover n_rows with no block
// empty, and blocks may not pass the resident limit of valor_layernorm_bwd_info (the
// launch is refused if it does).  `partials` holds blocks * 2 * cols floats.
extern "C" int valor_layernorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                                   void* dw, void* db, void* partials, int64_t n_rows, int cols,
                                   float eps, int x_is_bf16, int dy_is_bf16, int64_t blocks,
                                   int64_t steps, void* stream) {
  if (n_rows <= 0 || cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = bwd_vec_width(cols, bwd_aligned(x, dy, dx, w), x_is_bf16);
  const int wpr = bwd_warps_per_row(cols, vec > 1);
  const int64_t rows_per_block = static_cast<int64_t>(kBwdWarps / wpr) * steps;
  if (blocks < 1 || steps < 1 || blocks > kBwdMaxBlocks || blocks * rows_per_block < n_rows ||
      (blocks - 1) * rows_per_block >= n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdKernel kernel = bwd_pick(cols, vec, x_is_bf16, dy_is_bf16);
  BwdParams p{x,      static_cast<const float*>(w), dy,    dx,  static_cast<float*>(dw),
              static_cast<float*>(db), static_cast<float*>(partials), n_rows, steps, cols,
              wpr,    eps};
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned int>(blocks)),
      dim3(kBwdThreads), args,
      bwd_smem_bytes(cols, vec, x_is_bf16, dy_is_bf16, vec > 1 && steps > 1, blocks),
      static_cast<cudaStream_t>(stream)));
}
