// Hopper building blocks of the bfloat16 attention kernels (the forwards of
// ct_attention_cm.cu, the serving head of ct_attention_serving.cu, the
// backwards of ct_attention_bwd_bf16.cu): warpgroup matrix products (wgmma)
// on operand tiles in shared memory, bulk asynchronous copies of whole
// tiles into shared memory that complete on an mbarrier, the elementwise
// steps between two products, the forwards' two walks over an image's keys
// (which the serving head shares), and the prep kernel that lays k and v
// out as tiles for all of them.
//
// The operand tiles. A tile is kTile = 64 rows (anchors or keys) of CP
// bf16 classes (CP = 16 or 64), a row's classes contiguous: the layout in
// which wgmma reads an operand K-major when the classes are the summed
// dimension (the scores S = Q K^T, dP = GV V^T and their transposes) and
// MN-major when the rows are (O += P V, dQ += ds K, delta += attn V, dK +=
// ds^T Q, dV += attn^T GV). Within each group of rows that a swizzle
// pattern spans the 16-byte chunks of a row are permuted, as wgmma expects
// them, so that the eight rows a product reads at once fall on distinct
// banks:
//  * CP = 64, rows of 128 bytes: the 128-byte swizzle, chunk c of row r at
//    chunk c ^ (r % 8), eight rows a pattern (1024 bytes);
//  * CP = 16, rows of 32 bytes: the 32-byte swizzle, chunk c of row r at
//    c ^ ((r / 4) % 2), eight rows a pattern (256 bytes).
// The pattern is a function of the shared-memory address, so a tile is
// placed on a 1024-byte boundary; the prep kernels write the scratch in the
// same layout, tile after tile, so that staging a tile is one contiguous
// copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace ct {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // rows of an operand tile
constexpr int kThreads = 128;  // one warpgroup

// The class count padded for the tiles: C classes and v's ones column (the
// forwards' denominator), so C < CP: 15 in CP = 16, up to 63 in CP = 64.
__host__ __device__ constexpr int padded_classes(int C) {
  return C < 16 ? 16 : 64;
}

// lo and hi rounded to bf16 (nearest even) by the conversion unit, packed
// as a bf16x2 with lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The halves of a bf16x2 as floats (exact).
__device__ __forceinline__ float unpack_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float unpack_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// Bytes of a [kTile][CP] bf16 tile.
template <int CP>
constexpr int kTileBytes = kTile * CP * 2;

// The 16-byte chunk of row r where chunk c of its classes lies.
template <int CP>
__host__ __device__ __forceinline__ int chunk_at(int r, int c) {
  static_assert(CP == 16 || CP == 64, "tile widths");
  return CP == 64 ? c ^ (r & 7) : c ^ ((r >> 2) & 1);
}

// Offset in bf16 of (row r, class c) in a tile or a run of whole tiles.
template <int CP>
__host__ __device__ __forceinline__ int at(int r, int c) {
  return r * CP + chunk_at<CP>(r, c >> 3) * 8 + (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor of a tile at p (1024-byte aligned, or
// advanced from such a tile within its pattern): start address, leading
// and stride byte offsets (lbo, sbo) and the swizzle mode, 1 for 128 bytes
// and 3 for 32, all as wgmma reads them.
template <int CP>
__device__ __forceinline__ uint64_t desc(const void* p) {
  // sbo: eight rows, from one pattern to the next (K-major: the next eight
  // rows of M or N; MN-major: the next eight rows of K); lbo: the next
  // pattern along M or N (unused: a tile is one pattern wide)
  constexpr uint64_t sbo = 8 * CP * 2;
  constexpr uint64_t lbo = kTileBytes<CP>;
  constexpr uint64_t mode = CP == 64 ? 1 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (mode << 62);
}

// The descriptor advanced by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t advance(uint64_t d, int bytes) {
  return d + static_cast<uint64_t>(bytes >> 4);
}

// A K-major operand's k-th 16 classes: 32 bytes along its rows.
__device__ __forceinline__ uint64_t k_step(uint64_t d, int k) {
  return advance(d, 32 * k);
}

// An MN-major operand's k-th 16 rows.
template <int CP>
__device__ __forceinline__ uint64_t row_step(uint64_t d, int k) {
  return advance(d, 16 * CP * 2 * k);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving a read of an accumulator above the wait
// that completes the product writing it.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d (+)= A B on one warpgroup: A [64 x 16] and B [16 x 64] from shared
// memory (descriptors da, db), both K-major; accumulate = 0 starts d
// from zero.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B on one warpgroup: A [64 x 16] from registers (a, the
// m16n8k16 A fragment of each warp's 16 rows) and B [16 x 64] from shared
// memory, MN-major (a row of B contiguous); accumulate = 0 starts d from
// zero.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (+)= A B on one warpgroup: A [64 x 16] from registers (a, the
// m16n8k16 A fragment of each warp's 16 rows) and B [16 x 16] from shared
// memory, MN-major (a row of B contiguous); accumulate = 0 starts d from
// zero.
__device__ __forceinline__ void mma_rs_n16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (+)= A B with B MN-major [16 x CP].
template <int CP>
__device__ __forceinline__ void mma_rs(float (&d)[CP / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  if constexpr (CP == 64) {
    mma_rs_n64(d, a, db, accumulate);
  } else {
    mma_rs_n16(d, a, db, accumulate);
  }
}

// --- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the copy engine (then a block
// barrier makes them visible to the other threads).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on bar, expecting `bytes` of copies to complete on it.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; the copy completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The first 1024-byte boundary at or after p (shared memory).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// s = A B^T, [64 x 64], A and B [64][CP] K-major tiles (descriptors), into
// s from zero; issued, not waited for.
template <int CP>
__device__ __forceinline__ void scores(float (&s)[32], uint64_t da,
                                       uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    mma_ss_n64(s, k_step(da, kk), k_step(db, kk), kk > 0);
  }
}

// Make this thread's writes to shared memory visible to the products
// (the async proxy) that a block barrier after it lets read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- the elementwise steps between two products ---------------------------

constexpr float kLog2e = 1.4426950408889634f;

// n rounded up to whole tiles.
__host__ __device__ __forceinline__ int whole_tiles(int n) {
  return (n + kTile - 1) / kTile * kTile;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf() of a finite x, nearest even, on the integer pipe: the bits of
// __bfloat162float(__float2bfloat16_rn(x)) without the conversion unit.
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// The A fragments over 64 columns of a [64 x 64] accumulator x (element
// 4i + r: row g + 8(r/2) of the warp's 16, column 8i + 2t + r%2), rounded
// to bf16 by the conversion unit, a pair an instruction (in the forward,
// rounding and packing on the integer pipe took 12-24% longer, PERF.md
// §6): a[kk] covers columns 16kk .. 16kk + 15.
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Set to `to` the elements of a [64 x 64] accumulator whose column (key
// j0 + 8(i/4) + 2t + i%2 for element i) lies past K.
__device__ __forceinline__ void mask_keys(float (&x)[32], int j0, int K,
                                          int t, float to = 0.f) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (j0 + 8 * (i / 4) + 2 * t + (i & 1) >= K) x[i] = to;
  }
}

// d = A B over 64 rows of B (an MN-major [64][CP] tile), A the fragments
// a, into d from zero; issued, not waited for.
template <int CP>
__device__ __forceinline__ void rows_product(float (&d)[CP / 2],
                                             const uint32_t (&a)[4][4],
                                             uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_rs<CP>(d, a[kk], row_step<CP>(db, kk), kk > 0);
  }
}

template <int N>
__device__ __forceinline__ void add_to(float (&sum)[N], const float (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] += t[i];
}

// --- the forwards' walk over an image's keys ------------------------------

// The key tiles of one image in shared memory, kStages stages of a k tile
// and a v tile (kTileBytes<CP> each, from `stages`, 1024-byte aligned), and
// their mbarriers. Load n is walk 1's k tile n for n < tiles, then walk
// 2's k and v tiles n - tiles: one cp.async.bulk a tile, issued by thread 0
// into stage n % kStages. kb and vb are the image's keys and values in the
// tile layout (prep_kv), tiles * kTile of them.
template <int CP>
struct KeyTiles {
  static constexpr int kStages = 2;
  static constexpr int kBytes = kStages * 2 * kTileBytes<CP>;

  uint8_t* stages;
  uint64_t* bar;  // kStages
  const bf16* kb;
  const bf16* vb;
  int tiles;

  __device__ __forceinline__ uint8_t* k_tile(int s) const {
    return stages + s * 2 * kTileBytes<CP>;
  }
  __device__ __forceinline__ uint8_t* v_tile(int s) const {
    return k_tile(s) + kTileBytes<CP>;
  }

  __device__ __forceinline__ void issue(int n) const {
    constexpr int TB = kTileBytes<CP>;
    const int s = n % kStages;
    const size_t off = static_cast<size_t>(n % tiles) * kTile * CP;
    const bool values = n >= tiles;
    bar_expect(&bar[s], values ? 2 * TB : TB);
    bulk_copy(k_tile(s), kb + off, TB, &bar[s]);
    if (values) bulk_copy(v_tile(s), vb + off, TB, &bar[s]);
  }

  // Every thread of the block: thread 0 initialises the barriers and, once
  // the block has passed them, issues the first kStages loads. Walk 1's
  // first loads fill no v tile unless the image has one tile of keys, so
  // stage 0's v tile is free for the caller until walk() begins.
  __device__ __forceinline__ void start() const {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) bar_init(&bar[i], 1);
      bar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int n = 0; n < kStages && n < 2 * tiles; ++n) issue(n);
    }
  }
};

// Bytes of dynamic shared memory of a block that walks the keys: its q
// tile, the key tiles' stages, and the slack to align them (41 KB at
// CP=64, under the 48 KB a launch may ask without an attribute).
template <int CP>
constexpr int kWalkSmem = kTileBytes<CP> + KeyTiles<CP>::kBytes + 1024;

// The two walks of the bf16 forwards over the keys of ks (after
// ks.start()) for the 64 rows of the q tile at dq (a [kTile][CP] tile,
// read K-major), one warpgroup, every thread calling it:
//  * walk 1, the max: S = Q K^T (m64n64k16, both tiles K-major), the row
//    max of the live keys over a row's four threads;
//  * walk 2: S again, e = 2^(s log2 e - m log2 e) (one FMA; kExpBf16 rounds
//    s - m to bf16 first and then scales it), keys past K masked, e rounded
//    to bf16 and packed two by two into A fragments by the conversion unit,
//    O += P V from the staged v tile read MN-major, its numerators and
//    (column C) denominator in one product; each tile's product in a fresh
//    accumulator, added with rounded f32 adds (the tensor cores truncate
//    their accumulator). kSumF32 also sums the unrounded f32 weights.
// On return, for row h = 16w + g + 8h of the tile: mx[h] the row max (f32),
// element 4i + 2h + u of o its class 8i + 2t + u, and lsum[h] (kSumF32)
// this thread's share of the unrounded weights' sum. Ends with a block
// barrier after the last tile, with no copy in flight: the caller may then
// reuse the tiles' shared memory.
template <int CP, bool kExpBf16, bool kSumF32>
__device__ __forceinline__ void walk(const KeyTiles<CP>& ks, uint64_t dq,
                                     int K, float (&mx)[2], float (&lsum)[2],
                                     float (&o)[CP / 2]) {
  constexpr int kStages = KeyTiles<CP>::kStages;
  const int tid = threadIdx.x;
  const int t = tid % 4;
  const int tiles = ks.tiles;
  const int loads = 2 * tiles;  // walk 1 the k tiles, walk 2 k and v
  // mx: the max over the thread's keys until the end of walk 1, the row's
  // after it
  float ml[2] = {0.f, 0.f};
  mx[0] = mx[1] = -INFINITY;
  lsum[0] = lsum[1] = 0.f;
  zero(o);
#pragma unroll 1
  for (int n = 0; n < loads; ++n) {
    const int s = n % kStages;
    bar_wait(&ks.bar[s], (n / kStages) & 1);
    __syncwarp();
    const int j0 = (n % tiles) * kTile;
    const bool ragged = j0 + kTile > K;
    float sc[32];
    fence();
    scores<CP>(sc, dq, desc<CP>(ks.k_tile(s)));
    commit();
    wait<0>();
    keep(sc);
    if (n < tiles) {
      // walk 1: the max of the live keys' scores
      if (ragged) mask_keys(sc, j0, K, t, -INFINITY);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      if (n == tiles - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          ml[h] = __fmul_rn(mx[h], kLog2e);
        }
      }
    } else {
      // walk 2: the weights against the final max, O += bf(e) V
      if (kExpBf16) {  // s - m rounded to bf16 two at a time (one cvt)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {  // elements i, i + 1: one row
          const int h = (i >> 1) & 1;
          const uint32_t d2 = pack(sc[i] - mx[h], sc[i + 1] - mx[h]);
          sc[i] = ex2(__fmul_rn(__uint_as_float(d2 << 16), kLog2e));
          sc[i + 1] =
              ex2(__fmul_rn(__uint_as_float(d2 & 0xffff0000u), kLog2e));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = ex2(__fmaf_rn(sc[i], kLog2e, -ml[(i >> 1) & 1]));
        }
      }
      if (ragged) mask_keys(sc, j0, K, t);
      if (kSumF32) {  // the weights before their rounding
#pragma unroll
        for (int i = 0; i < 32; ++i) lsum[(i >> 1) & 1] += sc[i];
      }
      uint32_t a[4][4];
      to_frags(sc, a);
      float ot[CP / 2];
      fence();
      rows_product<CP>(ot, a, desc<CP>(ks.v_tile(s)));
      commit();
      wait<0>();
      keep(ot);
      add_to(o, ot);
    }
    // every thread is done with stage s: refill it
    __syncthreads();
    if (tid == 0 && n + kStages < loads) ks.issue(n + kStages);
  }
}

// --- the prep of k and v ---------------------------------------------------

constexpr int kPrepThreads = 256;

// k and v [B,K,C] bf16 → kp and vp [B][Kp][CP] in the tile layout, zero
// past C and K; kOnes: vp's column C is 1 for each live key (the
// forwards' denominator, from the same product as the numerators; C <
// CP). A thread a 16-byte chunk of a row.
template <int CP, bool kOnes>
__global__ void __launch_bounds__(kPrepThreads)
prep_kv(const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
        bf16* __restrict__ kp, bf16* __restrict__ vp, int B, int K, int Kp,
        int C) {
  constexpr int kChunks = CP / 8;
  constexpr uint32_t kOne = 0x3f80u;  // 1.0 in bf16
  const long long n = static_cast<long long>(B) * Kp * kChunks;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = e / kChunks;  // b * Kp + j
    const int ch = static_cast<int>(e % kChunks);
    const int b = static_cast<int>(row / Kp);
    const int j = static_cast<int>(row % Kp);
    uint32_t kw[4], vw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t k2 = 0, v2 = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * ch + 2 * u + h;
        if (j < K && c < C) {
          const size_t at = (static_cast<size_t>(b) * K + j) * C + c;
          k2 |= static_cast<uint32_t>(k[at]) << (16 * h);
          v2 |= static_cast<uint32_t>(v[at]) << (16 * h);
        } else if (kOnes && j < K && c == C) {
          v2 |= kOne << (16 * h);
        }
      }
      kw[u] = k2;
      vw[u] = v2;
    }
    const size_t o = static_cast<size_t>(row) * CP + chunk_at<CP>(j, ch) * 8;
    *reinterpret_cast<uint4*>(kp + o) = make_uint4(kw[0], kw[1], kw[2], kw[3]);
    *reinterpret_cast<uint4*>(vp + o) = make_uint4(vw[0], vw[1], vw[2], vw[3]);
  }
}

// Launch prep_kv on st for Kp = whole_tiles(K) → the launch status.
template <int CP, bool kOnes>
int launch_prep_kv(const void* k, const void* v, bf16* kp, bf16* vp, int B,
                   int K, int Kp, int C, cudaStream_t st) {
  const long long chunks = static_cast<long long>(B) * Kp * (CP / 8);
  const long long blocks = (chunks + kPrepThreads - 1) / kPrepThreads;
  prep_kv<CP, kOnes>
      <<<static_cast<int>(blocks < 8192 ? blocks : 8192), kPrepThreads, 0,
         st>>>(static_cast<const uint16_t*>(k),
               static_cast<const uint16_t*>(v), kp, vp, B, K, Kp, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace ct
