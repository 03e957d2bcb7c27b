// K5: the Gram G = XᵀX of a row-major float32 X (n × d) at float32 grade,
// one triangle, on the tensor cores.
//
// Replaces no TPU kernel.  The JAX package leaves the Gram range finder's
// XᵀX to XLA, which runs a float32 product on the TPU as multi-pass bf16.  The port's counterpart was
// `xc.mT @ xc` in IEEE float32: cuBLAS's SIMT sgemm, both triangles of a
// symmetric result on the CUDA cores (≈ 52 TFLOP/s of the card's 67).
//
// What bounds it on an H100: operations.  At 1M × 4096 the triangle in
// 128 × 128 tiles is 528 tiles, 4 waves of 132 SMs; with the split below
// that is 3 · 528 · 2 · 128² · n ≈ 5.4e13 TF32 operations, 110 ms at
// 495 TFLOP/s, against 16 GiB of X (≈ 5 ms at 3.35 TB/s per read).  It
// runs at ≈ 65% of that rate: with no products at all, the loads, splits
// and barriers alone take 60% of its time (PERF.md §6).
//
// Float32 grade from TF32: each element is split as x = hi + lo with
// hi = tf32(x) (round to nearest, ties away, as cvt.rna) and lo = x − hi,
// which the tensor cores read truncated to tf32; a product is
// hi·lo + lo·hi + hi·hi, the small products first, and lo·lo (≈ 2⁻²² of
// the product) is dropped.  The tensor core's
// accumulator is not held to IEEE rounding, so it sums only one chunk of
// rows (`chunk_rows`, a multiple of 32); after each chunk it is added into
// a float32 register accumulator with ordinary round-to-nearest adds and
// cleared.
//
// Design:
// * Persistent CTAs, one per SM, walk the upper-triangle tiles (bi ≤ bj)
//   in row-major order, each over all n rows, so the CTAs of a wave walk
//   X's rows together and read each row from L2 after the first.
// * A CTA is three warpgroups.  Warp 8 issues TMA loads of the two 128-
//   column panels of a tile (the I panel only, on the diagonal) in stages
//   of 32 rows, four 32 × 32 boxes a panel with the 128-byte swizzle,
//   through a ring of RAW_STAGES with full/empty mbarriers.
// * Warps 9-11 split the J panel of each stage into tf32 hi/lo and write
//   it transposed, in the 128-byte-swizzled K-major layout wgmma reads B
//   in (TF32 wgmma takes K-major operands only; X's panels are MN-major),
//   into a second ring of SPLIT_STAGES.  A splitter thread
//   takes one column's 8 rows of a k-step at a time.
// * Warpgroups 0 and 1 each own 64 of the tile's 128 rows and all 128
//   columns: per 8-row k-step they load their A fragments straight from
//   the raw I panel (A from registers), split them in registers, and
//   issue 3 wgmma m64n128k8 (hi·lo, lo·hi, hi·hi) against the split J
//   panel.  The A fragments are double-buffered, so one k-step's products
//   run while the next is loaded and split.
// * The k order inside a k-step and the row order inside the m64 tile are
//   permuted so that every fragment load is a conflict-free float2: wgmma
//   k slot s holds X row 2s (s < 4) or 2(s − 4) + 1, and m64 row
//   16w + g + 8h holds panel column 16w + 2g + h.  The splitters write B
//   in the same k order.
// * Each off-diagonal tile is written to G and transposed to its mirror;
//   a diagonal tile writes its upper triangle and mirrors it.  So G is
//   whole and bitwise symmetric.  No atomics and a fixed order of every
//   sum: the same bits on every call.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kTile = 128;     // G tile edge
constexpr int kRows = 32;      // X rows a stage
constexpr int kSteps = kRows / 8;     // 8-row k-steps a stage
constexpr int kBox = 4096;            // one 32 × 32 float box, bytes
constexpr int kPanel = 4 * kBox;      // 128 columns × 32 rows
constexpr int kRaw = 2 * kPanel;      // I and J panels
constexpr int kSplit = 2 * kTile * kRows * 4;  // hi and lo of a stage
constexpr int RAW_STAGES = 3;
constexpr int SPLIT_STAGES = 3;
constexpr int SPLIT_OFF = RAW_STAGES * kRaw;
constexpr int BAR_OFF = SPLIT_OFF + SPLIT_STAGES * kSplit;
constexpr int SMEM = BAR_OFF + 2 * 8 * (RAW_STAGES + SPLIT_STAGES) + 1024;
constexpr int kSplitters = 96;  // warps 9-11
constexpr uint32_t kTf32Mask = 0xFFFFE000u;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase differs from `parity`.  A wait that
// lasts ~10 s of SM clock traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
        "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// D(64×128 f32) += A(64×8 tf32, registers) · B(8×128 tf32, descriptor).
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The descriptor of a K-major B block with the 128-byte swizzle, one k-step
// of it at shared address `addr` (the block 1024-byte aligned, `addr` 32
// bytes a k-step into its rows): a column's 32 k (a stage's rows) are one
// 128-byte row, SBO 1024 B between 8-column groups, LBO unused.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// x = hi + lo: hi is x rounded to tf32 (nearest, ties away from zero, as
// cvt.rna.tf32.f32, in two integer operations: half of the 13 dropped
// bits' range added to the magnitude, then the bits cleared), lo the
// exact float32 remainder, whose low 13 bits the tensor cores drop
// (truncation, ≤ 2⁻²² of x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Byte offset of float (row r, panel column c) in a stage's 128-column
// panel: four 32-column boxes of 32 rows × 128 bytes, chunk q of 16 bytes
// of row r at chunk q ^ (r % 8) (TMA's 128-byte swizzle).
__device__ __forceinline__ uint32_t raw_off(int r, int c) {
  return (c >> 5) * kBox + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         ((c & 3) << 2);
}

// Upper-triangle tile t of T × T blocks, row-major: (bi, bj), bi ≤ bj.
__device__ __forceinline__ void tile_coords(int t, int blocks, int& bi,
                                            int& bj) {
  int i = 0;
  while (t >= blocks - i) {
    t -= blocks - i;
    ++i;
  }
  bi = i;
  bj = i + t;
}

// Boxes of a panel starting at column c0 that hold any column < d.
__device__ __forceinline__ int panel_boxes(int c0, int d) {
  const int b = (d - c0 + 31) >> 5;
  return b < 4 ? b : 4;
}

struct Rings {
  uint32_t base;
  __device__ uint32_t full_raw(int s) const { return base + BAR_OFF + 8 * s; }
  __device__ uint32_t empty_raw(int s) const {
    return base + BAR_OFF + 8 * (RAW_STAGES + s);
  }
  __device__ uint32_t full_split(int s) const {
    return base + BAR_OFF + 8 * (2 * RAW_STAGES + s);
  }
  __device__ uint32_t empty_split(int s) const {
    return base + BAR_OFF + 8 * (2 * RAW_STAGES + SPLIT_STAGES + s);
  }
};

template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ void produce(const CUtensorMap* xmap, Rings rings, int64_t n,
                        int d, int blocks, int n_tiles) {
  const int stages = static_cast<int>((n + kRows - 1) / kRows);
  Ring<RAW_STAGES> raw;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int bi, bj;
    tile_coords(tile, blocks, bi, bj);
    const int nb_i = panel_boxes(bi * kTile, d);
    const int nb_j = bi == bj ? 0 : panel_boxes(bj * kTile, d);
    for (int st = 0; st < stages; ++st) {
      mbar_wait(rings.empty_raw(raw.stage), raw.phase ^ 1);
      const uint32_t full = rings.full_raw(raw.stage);
      const uint32_t dst = rings.base + raw.stage * kRaw;
      mbar_expect_tx(full, (nb_i + nb_j) * kBox);
      for (int b = 0; b < nb_i; ++b) {
        tma_load(dst + b * kBox, xmap, full, bi * kTile + 32 * b, st * kRows);
      }
      for (int b = 0; b < nb_j; ++b) {
        tma_load(dst + kPanel + b * kBox, xmap, full, bj * kTile + 32 * b,
                 st * kRows);
      }
      raw.next();
    }
  }
}

// Warps 9-11: each stage's J panel → tf32 hi/lo, K-major.  Split stage
// layout: [hi, lo][128 columns][32 k] floats, each column's 128 bytes in
// 16-byte chunks q at chunk q ^ (column % 8) (the 128-byte swizzle);
// chunk 2·ks + h holds k-step ks's rows 2s + h, s = 0…3 (wgmma k slots
// 4h + s).  A unit is one column's 8 rows of one k-step: eight
// conflict-free loads (a warp's lanes are 32 neighbouring columns of one
// box row) and four 16-byte stores, eight lanes to a wavefront.
__device__ void split(uint8_t* smem, Rings rings, int64_t n, int blocks,
                      int n_tiles) {
  const int sid = threadIdx.x - (kThreads - kSplitters);
  const int lane = threadIdx.x & 31;
  const int stages = static_cast<int>((n + kRows - 1) / kRows);
  Ring<RAW_STAGES> raw;
  Ring<SPLIT_STAGES> spl;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int bi, bj;
    tile_coords(tile, blocks, bi, bj);
    const int panel = bi == bj ? 0 : kPanel;
    for (int st = 0; st < stages; ++st) {
      mbar_wait(rings.full_raw(raw.stage), raw.phase);
      mbar_wait(rings.empty_split(spl.stage), spl.phase ^ 1);
      const uint8_t* src = smem + raw.stage * kRaw + panel;
      uint8_t* dst = smem + SPLIT_OFF + spl.stage * kSplit;
#pragma unroll 2
      for (int u = sid; u < kSteps * kTile; u += kSplitters) {
        const int j = u & (kTile - 1);
        const int ks = u >> 7;
        const int c = (j & 31) >> 2;
        const uint8_t* p = src + (j >> 5) * kBox + ks * 1024 + (j & 3) * 4;
        uint32_t hi[8], lo[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float v =
              *reinterpret_cast<const float*>(p + m * 128 + ((c ^ m) << 4));
          split_tf32(v, hi[m], lo[m]);
        }
        uint8_t* q = dst + j * 128;
        const int c0 = ((2 * ks) ^ (j & 7)) << 4;
        const int c1 = ((2 * ks + 1) ^ (j & 7)) << 4;
        *reinterpret_cast<uint4*>(q + c0) = make_uint4(hi[0], hi[2], hi[4], hi[6]);
        *reinterpret_cast<uint4*>(q + c1) = make_uint4(hi[1], hi[3], hi[5], hi[7]);
        q += kSplit / 2;
        *reinterpret_cast<uint4*>(q + c0) = make_uint4(lo[0], lo[2], lo[4], lo[6]);
        *reinterpret_cast<uint4*>(q + c1) = make_uint4(lo[1], lo[3], lo[5], lo[7]);
      }
      // The wgmma reads of the split stage go through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(rings.empty_raw(raw.stage));
        mbar_arrive(rings.full_split(spl.stage));
      }
      raw.next();
      spl.next();
    }
  }
}

// The A fragment of one k-step, split: a[hi, lo][4].  Warpgroup wg owns
// I-panel columns 64·wg…64·wg + 63.
__device__ __forceinline__ void load_a(const uint8_t* raw, int ks, int wg,
                                       int warp, int g, int t,
                                       uint32_t (&a)[2][4]) {
  const int c = 64 * wg + 16 * warp + 2 * g;
  const int r = 8 * ks + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(raw + raw_off(r, c));
  const float2 v1 = *reinterpret_cast<const float2*>(raw + raw_off(r + 1, c));
  // a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4),
  // a3 (row g + 8, k t + 4); row g + 8h is column c + h, k t row 2t,
  // k t + 4 row 2t + 1.
  split_tf32(v0.x, a[0][0], a[1][0]);
  split_tf32(v0.y, a[0][1], a[1][1]);
  split_tf32(v1.x, a[0][2], a[1][2]);
  split_tf32(v1.y, a[0][3], a[1][3]);
}

__device__ __forceinline__ void mma_step(float (&acc)[64],
                                         const uint32_t (&a)[2][4],
                                         uint32_t split_step) {
  const uint64_t dh = b_desc(split_step);
  const uint64_t dl = b_desc(split_step + kSplit / 2);
  wgmma_fence();
  wgmma_tf32(acc, a[0], dl);  // hi·lo
  wgmma_tf32(acc, a[1], dh);  // lo·hi
  wgmma_tf32(acc, a[0], dh);  // hi·hi
  wgmma_commit();
}

// A consumer warpgroup's loop.  When to promote a chunk depends on nothing
// that differs between threads: where it depended on the warpgroup (the
// two promoting half a chunk apart), ptxas serialized the wgmmas.
__device__ void consume(uint8_t* smem, Rings rings, float* __restrict__ g_out,
                        int64_t n, int d, int blocks, int n_tiles,
                        int chunk_stages) {
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int stages = static_cast<int>((n + kRows - 1) / kRows);
  Ring<RAW_STAGES> raw;
  Ring<SPLIT_STAGES> spl;
  float acc[64];
  float sum[64];
  uint32_t a0[2][4], a1[2][4];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int bi, bj;
    tile_coords(tile, blocks, bi, bj);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      sum[i] = 0.f;
    }
    int pend = -1;  // split stage whose last k-step's products are in flight
    mbar_wait(rings.full_raw(raw.stage), raw.phase);
    load_a(smem + raw.stage * kRaw, 0, wg, warp, g, t, a0);

    for (int st = 0; st < stages; ++st) {
      const uint8_t* rs = smem + raw.stage * kRaw;
      const uint32_t ss = rings.base + SPLIT_OFF + spl.stage * kSplit;
      mbar_wait(rings.full_split(spl.stage), spl.phase);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (ks % 2 == 0) {
          mma_step(acc, a0, ss + ks * 32);  // k-step ks: 32 bytes a row
        } else {
          mma_step(acc, a1, ss + ks * 32);
        }
        // The k-step before this one is done: its A registers are free,
        // and if it closed a split stage, so is that stage.
        wgmma_wait<1>();
        if (pend >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(rings.empty_split(pend));
          pend = -1;
        }
        if (ks + 1 < kSteps) {
          if (ks % 2 == 0) {
            load_a(rs, ks + 1, wg, warp, g, t, a1);
          } else {
            load_a(rs, ks + 1, wg, warp, g, t, a0);
          }
          if (ks + 1 == kSteps - 1) {
            __syncwarp();
            if (lane == 0) mbar_arrive(rings.empty_raw(raw.stage));
          }
        }
      }
      pend = spl.stage;
      raw.next();
      spl.next();
      if ((st + 1) % chunk_stages == 0 || st + 1 == stages) {
        // Promote the chunk's tensor-core sum into the float32 sum.
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(rings.empty_split(pend));
        pend = -1;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          sum[i] = __fadd_rn(sum[i], acc[i]);
          acc[i] = 0.f;
        }
      }
      if (st + 1 < stages) {
        mbar_wait(rings.full_raw(raw.stage), raw.phase);
        load_a(smem + raw.stage * kRaw, 0, wg, warp, g, t, a0);
      }
    }

    // sum[4i + 2h + c]: m64 row 16·warp + g + 8h (I-panel column
    // 64·wg + 16·warp + 2g + h), column 8i + 2t + c (J-panel column).
    const bool diag = bi == bj;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pi = 64 * wg + 16 * warp + 2 * g + h;
      const int gi = bi * kTile + pi;
      if (gi >= d) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int pj = 8 * i + 2 * t + c;
          const int gj = bj * kTile + pj;
          if (gj >= d || (diag && pi > pj)) continue;
          const float v = sum[4 * i + 2 * h + c];
          g_out[static_cast<int64_t>(gi) * d + gj] = v;
          if (gi != gj) g_out[static_cast<int64_t>(gj) * d + gi] = v;
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gram_syrk_kernel(const __grid_constant__ CUtensorMap xmap,
                 float* __restrict__ g_out, int64_t n, int d, int blocks,
                 int n_tiles, int chunk_stages) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring.
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const Rings rings{smem_u32(smem)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) {
      mbar_init(rings.full_raw(s), 1);
      mbar_init(rings.empty_raw(s), 8 + kSplitters / 32);
    }
    for (int s = 0; s < SPLIT_STAGES; ++s) {
      mbar_init(rings.full_split(s), kSplitters / 32);
      mbar_init(rings.empty_split(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == 256) {
      produce(&xmap, rings, n, d, blocks, n_tiles);
    } else if (threadIdx.x >= kThreads - kSplitters) {
      split(smem, rings, n, blocks, n_tiles);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    consume(smem, rings, g_out, n, d, blocks, n_tiles, chunk_stages);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link against libcuda.
cudaError_t encode_x_map(CUtensorMap* map, const float* x, int64_t n, int d,
                         int64_t ld) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
    if (err == cudaSuccess && q != cudaDriverEntryPointSuccess) {
      err = cudaErrorSymbolNotFound;
    }
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault);
#endif
    if (err != cudaSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(kRows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// CTAs of a launch: one per SM, no more than there are tiles.
int petal_gram_syrk_grid(int d, int sms) {
  const int blocks = (d + kTile - 1) / kTile;
  const int tiles = blocks * (blocks + 1) / 2;
  return tiles < sms ? tiles : sms;
}

// X: n × d float32 on the device, row stride `ld` elements (ld ≥ d,
// ld·4 and the base 16-byte aligned, n < 2³¹ − 32).  G: d × d float32,
// contiguous, written whole.  chunk_rows: rows a tensor-core sum covers
// before it is added into the float32 sum, a positive multiple of 32.
int petal_gram_syrk_f32(const void* x, void* g, int64_t n, int d, int64_t ld,
                        int grid, int chunk_rows, void* stream) {
  if (n < 1 || n > INT32_MAX - kRows || d < 1 || ld < d || (ld * 4) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || grid < 1 || chunk_rows < kRows ||
      chunk_rows % kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  CUtensorMap map = {};
  cudaError_t err = encode_x_map(&map, xf, n, d, ld);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gram_syrk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d + kTile - 1) / kTile;
  const int tiles = blocks * (blocks + 1) / 2;
  gram_syrk_kernel<<<grid, kThreads, SMEM, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(g), n, d, blocks, tiles, chunk_rows / kRows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
