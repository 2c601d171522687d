// Fused fine-grained retrieval score for Hopper (sm_90a) on the tensor cores, with a plain C
// interface.
//
// Replaces the TPU kernel valor_tpu/ops/pallas/fine_score.py:_make_kernel (`kernel`, launched
// by fine_score_fused).  For query items a with token features fa[a, t, :] and gallery items b
// with token features fb[b, v, :], token masks ma[a, t], mb[b, v] in {0, 1} and token weights
// wa[a, t], wb[b, v] (softmaxed over the valid tokens by the caller):
//   s[a, b, t, v] = <fa[a, t] * ma[a, t], fb[b, v] * mb[b, v]>    (fp32 accumulation)
//   out[a, b] = 0.5 * (sum_t wa[a, t] * max_v s[a, b, t, v] + sum_v wb[b, v] * max_t s[a, b, t, v])
// without ever writing the [A, B, T, V] logits to device memory (1.28 GB at the MSR-VTT 1k-A
// gallery for one group).  A masked token adds a literal 0 to both maxes.
//
// What bounds it on an H100: operations.  It does 2 * A * B * T * V * D flops on
// (A * T + B * V) * D feature values: at A = B = 1000, T = 32, V = 10, D = 512 that is 327.7
// GFLOP on 21 MB, far above the card's balance point.  bf16 features run on the bf16 tensor
// cores (989 TFLOP/s dense; products of bf16 values are exact in fp32, so only the order of the
// sum differs from the plain version).  fp32 features run as 3xTF32 on the TF32 tensor cores:
// each value x is split into hi = tf32(x) and lo = tf32(x - hi), and the product is
// hi.hi + hi.lo + lo.hi, three TF32 products at 495 TFLOP/s, i.e. 165 TFLOP/s of fp32-accurate
// work against 67 TFLOP/s on the FMA units.  One TF32 product keeps 11 bits of each operand
// (relative error about 2^-11 a term, some 2e-5 on a 512-long dot of unit vectors), which misses
// the 1e-5 tolerance of the fp32 eval path; the three products drop only lo.lo and the rounding of
// lo, each about 2^-22 of a term, below fp32's own rounding of the sum.  What is left is the
// tensor cores' own accumulation, which loses up to an ulp of the accumulator at each wgmma: over
// the 3 D / 8 wgmmas of a whole dot in one accumulator that reached 4e-6 on a 512-long dot whose
// terms all share a sign (a score of 0.64), and grows with D.  So the fp32 route sums each group of
// 4 stages (48 wgmmas, 128 values of D) into an accumulator of its own and adds that to the dot's
// in fp32: 9e-7 there, and no more at D = 4096 (groups of one stage: 3e-7, 5 % slower).  bf16
// keeps one accumulator (its [128, 256] tile leaves no registers for a second): 9.4e-6 at
// D = 4096 with every term of one sign (chip_smoke.py phase 10, negative_rows), against a
// tolerance of 1.64e-5 there.
//
// The design:
//   * a pack pre-pass (pack_kernel, one launch a side) reads feat * mask and writes the
//     operands into scratch that the caller allocates: masked rows zeroed, D padded with zeros
//     to a whole 128-byte row (64 bf16 or 32 fp32 values), fp32 split into hi and lo (tf32
//     rounded to nearest even), and every stage's operand laid out as the shared-memory image
//     that wgmma reads (rows of 128 bytes, 16-byte groups XOR-swizzled by row % 8: the 128-byte
//     swizzle), so that one bulk copy a side fills a stage;
//   * one CTA a tile of TA = 128 / T query items x TB = N / V gallery items, N = 256 for bf16 and
//     128 for fp32 (whose group sums take a second set of accumulator registers): its logits
//     are a [128, N] block that holds whole items on both sides (rows and columns past the tile's
//     last item are zero and never read), so every max and weighted sum of the tile's outputs is
//     inside the CTA: no atomics, no second pass, and the same inputs give the same bits;
//   * a ring of shared-memory stages (4 of 48 KB for bf16: 64 values of D; 3 of 64 KB for fp32:
//     32 values of D, hi and lo) filled by cp.async.bulk copies that complete on mbarriers, kept
//     full by one producer warp while two consumer warpgroups each run wgmma on their 64 rows
//     (bf16 m64n256k16; tf32 m64n128k8 three times a step), fp32 accumulators in registers; a
//     stage is released once the products of the next stage are issued (wgmma.wait_group 1), and
//     the last of an fp32 group once its products are done, before the group joins the dot;
//   * then the accumulators go to shared memory (128 x (N + 1) floats over the ring; the tile's
//     token weights beside them, loaded before the product so that their latency hides in it)
//     and a group of lanes per (a, b) output takes, in a fixed order, the max over v for each t
//     weighted by wa and the max over t for each v weighted by wb, summed across the group by
//     shuffles.
// CTAs walk the tiles in groups of 16 query tiles, so the operands of the CTAs in flight stay in
// the 50 MB L2.  (Clusters of 2 x 2 CTAs that multicast each stage to the two CTAs reading it
// halved the operand traffic and ran slower: it is the product, not the copies, that bounds the
// kernel.)
//
// A wait on the ring that has not completed after 10 s of the card's clock (%globaltimer) traps.
// A resident CTA's wait lasts one stage of the other side's work, microseconds, or a time slice
// of another context on a shared card, milliseconds; 10 s is no legitimate wait.  A trap is
// a sticky error: the process's CUDA context is lost, and every later call in it fails.  That is
// what a wait that never ends costs anyway (a copy that faulted or a barrier count that is wrong
// is a bug of this file; the kernel would spin until the process is killed, with the card held
// and nothing reported), so the trap only turns a hang into an error that the caller sees.
//
// The caller sizes the scratch with valor_fine_score_layout (this file holds the only copy of
// the layout), allocates it and the output, and passes the current stream; nothing here
// synchronises.  The entry point returns the first CUDA error of its three launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kM = 128;                    // query-token rows of a CTA's tile
constexpr int kRowBytes = 128;             // one row of a stage: the 128-byte swizzle's width
constexpr int kConsumers = 256;            // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kGroupA = 16;                // query tiles of a raster group
constexpr int kMaxTokens = 128;
constexpr int kMaxDim = 4096;
constexpr int kRingBytes = 196608;         // 4 x 48 KB (bf16) or 3 x 64 KB (fp32)
constexpr int kBarBytes = 64;              // full[4] and empty[4] mbarriers
constexpr size_t kSmemBytes = kRingBytes + kBarBytes + 1024;  // and room to align to 1024 B
constexpr int kSumStages = 4;  // fp32: stages summed apart before they join the dot
constexpr uint64_t kHangNs = 10ull * 1000 * 1000 * 1000;  // a ring wait's limit: 10 s

// per feature type: gallery-token columns of a tile, values of one 128-byte row, operand parts
// (fp32: hi and lo), stages of the ring
template <bool kBf16>
struct Cfg {
  static constexpr int kN = kBf16 ? 256 : 128;
  static constexpr int kPitch = kN + 1;  // padded row of the logits tile in shared memory
  static constexpr int kElems = kBf16 ? 64 : 32;
  static constexpr int kParts = kBf16 ? 1 : 2;
  static constexpr int kABytes = kParts * kM * kRowBytes;  // one stage of one side
  static constexpr int kBBytes = kParts * kN * kRowBytes;
  static constexpr int kStages = kRingBytes / (kABytes + kBBytes);
  static_assert(kStages * (kABytes + kBBytes) == kRingBytes && kStages <= 4, "ring");
  static_assert(sizeof(float) * (kM * kPitch + kM + kN) <= kRingBytes,
                "the logits tile and the token weights fit over the ring");
};

struct Params {
  const uint8_t* pa;  // packed query side: [a_tiles][kc_n][parts][kM][128 B]
  const uint8_t* pb;  // packed gallery side: [b_tiles][kc_n][parts][Cfg::kN][128 B]
  const float* wa;    // [A, T]
  const float* wb;    // [B, V]
  float* out;         // [A, B]
  int a_n, b_n, t_n, v_n;
  int ta, tb;            // items a tile holds on each side
  int a_tiles, b_tiles;  // tiles along A and B
  int kc_n;              // stages of D
};

// -- the pack --------------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x rounded to TF32 (10 explicit mantissa bits), to nearest even, on its bit pattern; inf and
// NaN as they are.  The tensor cores read the top 19 bits of each value, which this leaves exact.
__device__ __forceinline__ float tf32_rne(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return x;
  u += 0xfffu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xffffe000u);
}

// One thread a 16-byte group of one row of one stage's operand: `tile_rows` rows a tile, the
// first `used` of them the rows of the tile's whole items (the rest, and rows past the end,
// zero), the group at its 128-byte-swizzled place.
template <typename T>
__global__ void __launch_bounds__(256) pack_kernel(const T* __restrict__ feat,
                                                   const float* __restrict__ mask,
                                                   uint8_t* __restrict__ out, int64_t rows_n,
                                                   int used, int tile_rows, int d, int kc_n,
                                                   int64_t n_groups, int vec) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values of a 16-byte group
  using C = Cfg<kBf16>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_groups;
       i += stride) {
    const int g = static_cast<int>(i & 7);
    const int64_t rest = i >> 3;
    const int r = static_cast<int>(rest % tile_rows);
    const int64_t chunk = rest / tile_rows;  // tile * kc_n + kc
    const int kc = static_cast<int>(chunk % kc_n);
    const int64_t row = (chunk / kc_n) * used + r;
    const int c0 = kc * C::kElems + g * kPer;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = 0.f;
    if (r < used && row < rows_n && c0 < d) {
      const float m = mask[row];
      const T* src = feat + row * d + c0;
      if (vec) {  // d % kPer == 0 and 16-byte aligned rows: c0 + kPer <= d
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[j] = to_f32(e[j]) * m;
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[j] = c0 + j < d ? to_f32(src[j]) * m : 0.f;
      }
    }
    uint8_t* dst = out + chunk * C::kParts * tile_rows * kRowBytes + r * kRowBytes +
                   ((g ^ (r & 7)) << 4);
    if constexpr (kBf16) {
      uint4 packed;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int j = 0; j < kPer; ++j) e[j] = __float2bfloat16_rn(v[j]);  // exact: m is 0 or 1
      *reinterpret_cast<uint4*>(dst) = packed;
    } else {
      float4 hi, lo;
      float* h = reinterpret_cast<float*>(&hi);
      float* l = reinterpret_cast<float*>(&lo);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        h[j] = tf32_rne(v[j]);
        l[j] = isfinite(h[j]) ? tf32_rne(v[j] - h[j]) : 0.f;  // x - hi is exact in fp32
      }
      *reinterpret_cast<float4*>(dst) = hi;
      *reinterpret_cast<float4*>(dst + tile_rows * kRowBytes) = lo;
    }
  }
}

// -- mbarriers, bulk copies and wgmma ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase `parity` of the mbarrier; traps once kHangNs of the card's clock have
// passed since the first failed try (see the note at the top).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t since = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (since == 0) {
      since = now;
    } else if (now - since > kHangNs) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte swizzle: start address,
// leading offset 1 (unused by this layout), 1024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t{1} << 62) | (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 16) |
         static_cast<uint64_t>((addr >> 4) & 0x3fffu);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators as asm operands: reads and writes of them stay on their side of a wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VALOR_ACC8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define VALOR_ACC32(i) VALOR_ACC8(i), VALOR_ACC8(i + 8), VALOR_ACC8(i + 16), VALOR_ACC8(i + 24)
#define VALOR_ACC64 VALOR_ACC32(0), VALOR_ACC32(32)
#define VALOR_ACC128 VALOR_ACC64, VALOR_ACC32(64), VALOR_ACC32(96)
#define VALOR_REGS64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define VALOR_REGS128                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "       \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "       \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "       \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "   \
  "%125, %126, %127}, "

// d[64 x 256 fragment] += A[64 x 16] . B[256 x 16]^T, bf16, both K-major in shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " VALOR_REGS128
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : VALOR_ACC128
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128 fragment] = A[64 x 8] . B[128 x 8]^T (+ d where `add`), tf32, both K-major in
// shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VALOR_REGS64
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : VALOR_ACC64
      : "l"(da), "l"(db), "r"(add));
}

// -- the product and the epilogue ----------------------------------------------------------

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) fine_score_kernel(const Params p) {
  using C = Cfg<kBf16>;
  constexpr int kPitch = C::kPitch;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle wants 1024 B
  const uint32_t ring = smem_u32(base);
  const uint32_t full = ring + kRingBytes;  // full[s] at full + 8 s, empty[s] at full + 32 + 8 s
  const uint32_t empty = full + 32;
  float* tile = reinterpret_cast<float*>(base);  // [kM][kPitch] logits, after the product

  const int tid = threadIdx.x;
  const int per_group = kGroupA * p.b_tiles;
  const int first_a = blockIdx.x / per_group * kGroupA;
  const int group_a = min(kGroupA, p.a_tiles - first_a);
  const int in_group = blockIdx.x % per_group;
  const int a_tile = first_a + in_group % group_a;
  const int b_tile = in_group / group_a;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);                      // the producer's arrival and the bytes
      mbar_init(empty + 8 * s, kConsumers / 32);       // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one lane keeps the ring full
    if (tid == kConsumers) {
      const uint8_t* ga = p.pa + static_cast<int64_t>(a_tile) * p.kc_n * C::kABytes;
      const uint8_t* gb = p.pb + static_cast<int64_t>(b_tile) * p.kc_n * C::kBBytes;
      for (int kc = 0; kc < p.kc_n; ++kc) {
        const int s = kc % C::kStages;
        mbar_wait(empty + 8 * s, ((kc / C::kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, C::kABytes + C::kBBytes);
        const uint32_t st = ring + s * (C::kABytes + C::kBBytes);
        bulk_load(st, ga + static_cast<int64_t>(kc) * C::kABytes, C::kABytes, full + 8 * s);
        bulk_load(st + C::kABytes, gb + static_cast<int64_t>(kc) * C::kBBytes, C::kBBytes,
                  full + 8 * s);
      }
    }
    return;
  }

  // the consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of the tile
  const int wg = tid >> 7;
  const int a0 = a_tile * p.ta;
  const int b0 = b_tile * p.tb;
  const int na = min(p.ta, p.a_n - a0);  // items of this tile
  const int nb = min(p.tb, p.b_n - b0);
  // the tile's token weights, one of each side a thread at most (na T <= 128, nb V <= 256),
  // loaded before the product so that their latency hides behind it
  const float wa_own = tid < na * p.t_n ? p.wa[static_cast<int64_t>(a0) * p.t_n + tid] : 0.f;
  const float wb_own = tid < nb * p.v_n ? p.wb[static_cast<int64_t>(b0) * p.v_n + tid] : 0.f;
  float d[C::kN / 2];
  [[maybe_unused]] float c[kBf16 ? 1 : C::kN / 2];  // fp32: the sum of the current group of stages
#pragma unroll
  for (int i = 0; i < C::kN / 2; ++i) d[i] = 0.f;
  fence_acc(d);
  for (int kc = 0; kc < p.kc_n; ++kc) {
    const int s = kc % C::kStages;
    mbar_wait(full + 8 * s, (kc / C::kStages) & 1);
    const uint32_t st_a = ring + s * (C::kABytes + C::kBBytes) + wg * 64 * kRowBytes;
    const uint32_t st_b = ring + s * (C::kABytes + C::kBBytes) + C::kABytes;
    wgmma_fence();
    if constexpr (kBf16) {
#pragma unroll
      for (int k = 0; k < 4; ++k)  // 32 bytes of each row a step: 16 bf16 values
        wgmma_bf16(d, smem_desc(st_a + 32 * k), smem_desc(st_b + 32 * k));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kc > 0 && (tid & 31) == 0) mbar_arrive(empty + 8 * ((kc - 1) % C::kStages));
    } else {
      // hi.hi + hi.lo + lo.hi of a group of kSumStages stages (32 values of D each) into a sum
      // of their own (the group's first product overwrites it), added to d in fp32 once the
      // group is done: the tensor cores' rounding of their accumulator then acts on a group's
      // sum, not on the whole dot.  A stage is released once its products are done.
      const bool opens = kc % kSumStages == 0;
      const bool closes = kc % kSumStages == kSumStages - 1 || kc == p.kc_n - 1;
      const uint32_t a_lo = st_a + kM * kRowBytes, b_lo = st_b + C::kN * kRowBytes;
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // 32 bytes of each row a step: 8 tf32 values
        wgmma_tf32(c, smem_desc(st_a + 32 * k), smem_desc(st_b + 32 * k), k > 0 || !opens);
        wgmma_tf32(c, smem_desc(st_a + 32 * k), smem_desc(b_lo + 32 * k), 1);
        wgmma_tf32(c, smem_desc(a_lo + 32 * k), smem_desc(st_b + 32 * k), 1);
      }
      wgmma_commit();
      if (closes) {
        wgmma_wait<0>();
        fence_acc(c);
      } else {
        wgmma_wait<1>();
      }
      if (!opens && (tid & 31) == 0) mbar_arrive(empty + 8 * ((kc - 1) % C::kStages));
      if (closes) {
        if ((tid & 31) == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
        for (int i = 0; i < C::kN / 2; ++i) d[i] += c[i];
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  // both warpgroups are done with the ring before the logits tile overwrites it
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  {
    // the accumulator fragment: warp w of the warpgroup holds rows 16 w .. 16 w + 15; lane l
    // holds, for each 8 columns j, d[4j], d[4j+1] at row l / 4, columns 8j + 2 (l % 4) + {0, 1},
    // and d[4j+2], d[4j+3] 8 rows below
    const int lane = tid & 31;
    const int row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < C::kN / 8; ++j) {
      float* t0 = tile + row * kPitch + 8 * j + col;
      t0[0] = d[4 * j];
      t0[1] = d[4 * j + 1];
      t0[8 * kPitch] = d[4 * j + 2];
      t0[8 * kPitch + 1] = d[4 * j + 3];
    }
  }
  float* wa_s = tile + kM * kPitch;  // [na T] and [nb V], after the logits tile
  float* wb_s = wa_s + kM;
  if (tid < na * p.t_n) wa_s[tid] = wa_own;
  if (tid < nb * p.v_n) wb_s[tid] = wb_own;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // a group of `gl` lanes per output of the tile (a power of two: as many as the tile's
  // outputs leave room for, so a tile of many outputs runs one a thread and a tile of few a
  // warp each); the group's lanes split the tokens, then a fixed-order shuffle sum.  Every
  // lane runs the same number of rounds, so the shuffles see the whole warp.
  const int n_out = na * nb;
  int gl = 32;
  while (gl > 1 && n_out * gl > kConsumers) gl >>= 1;
  const int groups = kConsumers / gl;
  const int li = tid & (gl - 1);
  for (int first = 0; first < n_out; first += groups) {
    const int o = first + tid / gl;
    const bool active = o < n_out;
    float q = 0.f;  // query-token direction: max over the gallery item's tokens
    float g = 0.f;  // gallery-token direction: max over the query item's tokens
    if (active) {
      const int al = o / nb;
      const int bl = o % nb;
      const float* s = tile + al * p.t_n * kPitch + bl * p.v_n;  // s[t * kPitch + v]
      const float* wa = wa_s + al * p.t_n;
      const float* wb = wb_s + bl * p.v_n;
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

// The product kernels take 194 KB of dynamic shared memory, above the default 48 KB: the
// attribute is set once per device and instantiation (never inside a CUDA graph capture after
// the first call).
std::mutex g_attr_mutex;
unsigned g_attr_done[2] = {0u, 0u};  // bit per device, per instantiation (fp32, bf16)

template <bool kBf16>
cudaError_t allow_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_attr_mutex);
  if (g_attr_done[kBf16] & (1u << dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(fine_score_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) g_attr_done[kBf16] |= 1u << dev;
  return err;
}

template <typename T>
cudaError_t pack(const void* feat, const void* mask, uint8_t* out, int64_t rows_n, int used,
                 int tile_rows, int d, int kc_n, int64_t tiles, cudaStream_t s) {
  const int64_t n_groups = tiles * kc_n * tile_rows * 8;
  const int64_t blocks = (n_groups + 255) / 256;
  const int vec = d % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  pack_kernel<T><<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536), 256, 0, s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(mask), out, rows_n, used, tile_rows,
      d, kc_n, n_groups, vec);
  return cudaGetLastError();
}

bool takes(int a_n, int b_n, int t_n, int v_n, int d) {
  return a_n >= 1 && b_n >= 1 && t_n >= 1 && t_n <= kMaxTokens && v_n >= 1 && v_n <= kMaxTokens &&
         d >= 1 && d <= kMaxDim;
}

// The tiles and the scratch of a call, in the order of valor_fine_score_layout's `out`.
struct Layout {
  int64_t ta, tb;            // whole items a tile holds on each side
  int64_t rows, cols;        // the tile's rows and columns that those items fill
  int64_t a_tiles, b_tiles;  // tiles along A and B
  int64_t d_pad;             // D padded to whole stages
  int64_t scratch_bytes;     // the packed operands of both sides
  int64_t read_bytes;        // what the product's tiles copy from them in all
};

template <bool kBf16>
Layout layout_of(int a_n, int b_n, int t_n, int v_n, int d) {
  using C = Cfg<kBf16>;
  Layout l;
  l.ta = kM / t_n;
  l.tb = C::kN / v_n;
  l.rows = l.ta * t_n;
  l.cols = l.tb * v_n;
  l.a_tiles = (a_n + l.ta - 1) / l.ta;
  l.b_tiles = (b_n + l.tb - 1) / l.tb;
  const int64_t kc_n = (d + C::kElems - 1) / C::kElems;
  l.d_pad = kc_n * C::kElems;
  l.scratch_bytes = (l.a_tiles * C::kABytes + l.b_tiles * C::kBBytes) * kc_n;
  l.read_bytes = l.a_tiles * l.b_tiles * (C::kABytes + C::kBBytes) * kc_n;
  return l;
}

template <typename T>
int run(const void* fa, const void* fb, const void* ma, const void* mb, const void* wa,
        const void* wb, void* out, uint8_t* scratch, int64_t scratch_bytes, int a_n, int b_n,
        int t_n, int v_n, int d, cudaStream_t s) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using C = Cfg<kBf16>;
  const Layout l = layout_of<kBf16>(a_n, b_n, t_n, v_n, d);
  const int kc_n = static_cast<int>(l.d_pad / C::kElems);
  const int64_t a_bytes = l.a_tiles * kc_n * C::kABytes;
  if (l.a_tiles * l.b_tiles > 0x7fffffff || scratch_bytes < l.scratch_bytes ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<kBf16>();
  if (err == cudaSuccess)
    err = pack<T>(fa, ma, scratch, static_cast<int64_t>(a_n) * t_n, static_cast<int>(l.rows), kM,
                  d, kc_n, l.a_tiles, s);
  if (err == cudaSuccess)
    err = pack<T>(fb, mb, scratch + a_bytes, static_cast<int64_t>(b_n) * v_n,
                  static_cast<int>(l.cols), C::kN, d, kc_n, l.b_tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{scratch, scratch + a_bytes, static_cast<const float*>(wa),
                 static_cast<const float*>(wb), static_cast<float*>(out), a_n, b_n, t_n, v_n,
                 static_cast<int>(l.ta), static_cast<int>(l.tb), static_cast<int>(l.a_tiles),
                 static_cast<int>(l.b_tiles), kc_n};
  fine_score_kernel<kBf16>
      <<<static_cast<unsigned>(l.a_tiles * l.b_tiles), kThreads, kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layout of a call of valor_fine_score with these sizes, into out[9]: the items a tile holds
// along A and along B, the rows and columns they fill, the tiles along A and B, D padded, the
// bytes of scratch the call needs, and the bytes its tiles copy from that scratch.  The caller
// sizes the scratch from here, so this file alone says what the kernel's layout is.  Takes what
// valor_fine_score takes; returns 0, or cudaErrorInvalidValue.
extern "C" int valor_fine_score_layout(int a_n, int b_n, int t_n, int v_n, int d, int feat_is_bf16,
                                       long long* out) {
  if (!takes(a_n, b_n, t_n, v_n, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = feat_is_bf16 ? layout_of<true>(a_n, b_n, t_n, v_n, d)
                                : layout_of<false>(a_n, b_n, t_n, v_n, d);
  const int64_t fields[9] = {l.ta,      l.tb,    l.rows,          l.cols,      l.a_tiles,
                             l.b_tiles, l.d_pad, l.scratch_bytes, l.read_bytes};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return 0;
}

// out[A, B] (fp32) = the fine score of fa [A, T, D] and fb [B, V, D] (both fp32, or both bf16 when
// feat_is_bf16) under fp32 token masks ma [A, T], mb [B, V] ({0, 1}), with fp32 softmaxed token
// weights wa [A, T] and wb [B, V]; every array contiguous.  `scratch` (16-byte aligned) holds the
// packed operands: at least valor_fine_score_layout's scratch bytes.  Takes 1 <= A, B;
// 1 <= T, V <= 128; 1 <= D <= 4096.
extern "C" int valor_fine_score(const void* fa, const void* fb, const void* ma, const void* mb,
                                const void* wa, const void* wb, void* out, void* scratch,
                                long long scratch_bytes, int a_n, int b_n, int t_n, int v_n, int d,
                                int feat_is_bf16, void* stream) {
  if (!takes(a_n, b_n, t_n, v_n, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  if (feat_is_bf16)
    return run<__nv_bfloat16>(fa, fb, ma, mb, wa, wb, out, sc, scratch_bytes, a_n, b_n, t_n, v_n,
                              d, s);
  return run<float>(fa, fb, ma, mb, wa, wb, out, sc, scratch_bytes, a_n, b_n, t_n, v_n, d, s);
}
