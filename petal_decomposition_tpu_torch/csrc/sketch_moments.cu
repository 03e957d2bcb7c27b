// Fused sketch + moments pass: Y = X·W, colsum = Σᵢ X[i,:], sqnorm = ‖X‖²_F
// in one read of X.
//
// Replaces: petal_decomposition_tpu/ops/pallas/sketch_kernel.py:_kernel
// (called through _call_kernel / fused_sketch_moments_on), the TPU kernel
// of the Gram range finder's data-side recovery.
//
// What bounds it on an H100: reading X.  At the flagship (X 1M×1024 f32,
// W 1024×42) that is 4.2 GB, 1.27 ms at 3.35 TB/s.  The product runs on
// the tensor cores as the TPU kernel's bf16×3 split, xh·wh + xl·wh + xh·wl
// with float32 accumulation (one bf16 pass was measured too coarse there,
// sketch_kernel.py:79-86): 3 × 86 GFLOP, 0.26 ms at 989 TFLOP/s.
//
// Design:
// * Persistent CTAs, one per SM, walk tiles (a strip of BM rows × one
//   column chunk of N ≤ 192 sketch columns) in a fixed order.  A CTA is
//   three warpgroups: two consumers, each owning 64·MT rows of the strip
//   (MT = 3 at N ≤ 48, so the flagship's strips are 384 rows), and one
//   producer.
// * The producer streams the strip in k-tiles of 32 columns through a
//   ring of STAGES shared-memory stages, each an X tile of BM rows × 128
//   bytes (128-byte swizzle) and the matching pre-split W slice, with
//   full/empty mbarriers.  X comes by TMA (one thread, rows past n and
//   columns past d zero-filled by the hardware); where TMA cannot take X
//   (d not a multiple of 4 or below 32, a base not 16-byte aligned, n
//   beyond int32) the producer warpgroup copies it with 4-byte cp.async,
//   zero-filling the ragged edge itself.  The W slice always comes by one
//   bulk copy.
// * W is split once per call by presplit_w_kernel into bf16 hi/lo, in
//   the no-swizzle K-major core-matrix layout the wgmma descriptor reads
//   (LBO 128 B between the two k-halves, SBO 256 B between 8-column
//   groups), with the k order permuted so that each consumer thread reads
//   its A fragment as one float4 per row: thread t of a quad holds wgmma
//   k indices {2t, 2t+1, 2t+8, 2t+9} of k-step s, which are X columns
//   4(2t+s)..4(2t+s)+3 of the tile.  With the 128-byte swizzle those
//   float4 loads are free of bank conflicts.
// * A consumer loads its fragment of the X tile into registers, splits it
//   into bf16 hi/lo (round to nearest even, as astype(bfloat16)), and
//   runs the three wgmma m64nNk16 products per k-step with A from
//   registers.  While they run, the same registers give the column sums
//   (a 7-shuffle butterfly, then the four warps in order through shared
//   memory) and the sum of squares.
// * Determinism: each consumer warpgroup adds its column sums of every
//   strip, in float64, to its own row of cs_part (no atomics), each
//   thread keeps ‖X‖² in float64, and a second kernel sums the partials
//   in a fixed order.  The same launch gives the same bits every time.
// * Sketch widths above 192 go in chunks of 128 columns (at N = 256 the
//   accumulators leave ptxas too few registers and it serializes the
//   wgmmas): tile (strip, chunk c > 0) reads the strip again, from L2 as
//   its neighbour tiles have just read it, and takes no moments.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kTK = 32;        // X columns per k-tile (128 bytes)
constexpr int kSmemBudget = 200 * 1024;

// 64-row m-tiles a consumer warpgroup takes of a strip: as many as its
// accumulators leave registers for.  Taller strips read each W slice
// for more rows of X (384 rows against 256: 2% faster at N = 48).
constexpr int m_tiles(int n_width) {
  return n_width <= 48 ? 3 : n_width <= 64 ? 2 : 1;
}

template <int N>
struct Cfg {
  static constexpr int MT = m_tiles(N);
  static constexpr int BM = 128 * MT;         // rows per strip
  static constexpr int BOX = BM > 256 ? BM / 2 : BM;  // TMA box rows
  static constexpr int X_BYTES = BM * kTK * 4;
  static constexpr int W_BYTES = 128 * N;  // 32 k × N × (hi, lo) × bf16
  static constexpr int STAGES =
      kSmemBudget / (X_BYTES + W_BYTES) < 8
          ? kSmemBudget / (X_BYTES + W_BYTES) : 8;
  static constexpr int W_OFF = STAGES * X_BYTES;
  static constexpr int BAR_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int RED_OFF = BAR_OFF + 2 * STAGES * 8;
  static constexpr int SQ_OFF = RED_OFF + 2 * 2 * 4 * 32 * 4;
  static constexpr int SMEM = SQ_OFF + 8 * 8 + 1024;  // + alignment slack
};

// The sketch-column chunk of a call: the narrowest instantiated N ≥ l,
// or 128 in chunks.
int chunk_width(int l) {
  const int widths[] = {16, 32, 48, 64, 96, 128, 192};
  for (int w : widths) {
    if (l <= w) return w;
  }
  return 128;
}

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

__device__ __forceinline__ void tma_load_x(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
        "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// D(64×P f32) += A(64×16 bf16, registers) · B(16×P bf16, descriptor).
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The descriptor of a no-swizzle K-major B block at shared address `addr`:
// LBO 128 B (the two 8-wide k halves), SBO 256 B (8-column groups).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// acc(64×N) += A · B over the N columns, in m64n64 / n32 / n16 pieces.
// A piece starting at column c is 32·c bytes further into B, which is
// (32·c) >> 4 in the descriptor's address field.
template <int N>
__device__ __forceinline__ void mma_row(float* acc, const uint32_t* a,
                                        uint64_t desc) {
#pragma unroll
  for (int p = 0; p < N / 64; ++p) {
    wgmma_n64(acc + 32 * p, a, desc + ((64 * p * 32) >> 4));
  }
  constexpr int kRest = N % 64;
  constexpr int kOff = N - kRest;
  if constexpr (kRest >= 32) {
    wgmma_n32(acc + kOff / 2, a, desc + ((kOff * 32) >> 4));
  }
  if constexpr (kRest % 32 == 16) {
    constexpr int kOff16 = N - 16;
    wgmma_n16(acc + kOff16 / 2, a, desc + ((kOff16 * 32) >> 4));
  }
}

// Round two floats to bf16 (nearest even) as hi, and their remainders as
// lo, packed with `a` in the low half.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// W (d×l, row-major f32) → per (chunk, k-tile): [s 2][hi/lo 2][N/8 groups]
// [k half 2][8 columns][8 k] bf16, the layout b_desc reads, with the k
// order of the consumers' float4 fragments.  Rows ≥ d and columns ≥ l are
// zero.
__global__ void presplit_w_kernel(const float* __restrict__ w,
                                  __nv_bfloat16* __restrict__ out, int d,
                                  int l, int n_width, int kt_count,
                                  int64_t total) {
  const int groups = n_width / 8;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(idx & 7);
    const int r = static_cast<int>((idx >> 3) & 7);
    const int h = static_cast<int>((idx >> 6) & 1);
    int64_t rest = idx >> 7;
    const int j = static_cast<int>(rest % groups);
    rest /= groups;
    const int p = static_cast<int>(rest & 1);
    const int s = static_cast<int>((rest >> 1) & 1);
    rest >>= 2;
    const int kt = static_cast<int>(rest % kt_count);
    const int chunk = static_cast<int>(rest / kt_count);
    const int col = chunk * n_width + 8 * j + r;
    const int kappa = 8 * h + e;  // wgmma k index within the k-step
    const int t = (kappa & 7) >> 1;
    const int k = kt * kTK + 4 * (2 * t + s) + (kappa & 1) + 2 * (kappa >> 3);
    const float v = (k < d && col < l) ? w[static_cast<int64_t>(k) * l + col]
                                       : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    out[idx] = p == 0 ? hi : __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

template <int N>
__device__ __forceinline__ void produce(
    const CUtensorMap* xmap, const float* __restrict__ x,
    const uint8_t* __restrict__ wpre, uint32_t base, int64_t n, int d,
    int n_chunks, int64_t n_tiles, bool use_tma) {
  using C = Cfg<N>;
  const int ptid = threadIdx.x - 256;
  if (use_tma && ptid != 0) return;
  const int kt_count = (d + kTK - 1) / kTK;
  const uint32_t full0 = base + C::BAR_OFF;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (tile / n_chunks) * C::BM;
    const int chunk = static_cast<int>(tile % n_chunks);
    for (int kt = 0; kt < kt_count; ++kt) {
      const uint32_t full = full0 + 8 * stage;
      const uint32_t xs = base + stage * C::X_BYTES;
      const uint8_t* wsrc =
          wpre + (static_cast<int64_t>(chunk) * kt_count + kt) * C::W_BYTES;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (use_tma) {
        mbar_expect_tx(full, C::X_BYTES + C::W_BYTES);
#pragma unroll
        for (int b = 0; b < C::BM / C::BOX; ++b) {
          tma_load_x(xs + b * C::BOX * 128, xmap, full, kt * kTK,
                     static_cast<int>(row0) + b * C::BOX);
        }
        bulk_load(base + C::W_OFF + stage * C::W_BYTES, wsrc, C::W_BYTES,
                  full);
      } else {
        if (ptid == 0) {
          mbar_expect_tx(full, C::W_BYTES);
          bulk_load(base + C::W_OFF + stage * C::W_BYTES, wsrc, C::W_BYTES,
                    full);
        }
        // The same swizzled layout TMA writes: 16-byte chunk c of row r
        // at chunk c ^ (r % 8).
        for (int e = ptid; e < C::BM * kTK; e += 128) {
          const int r = e >> 5;
          const int c = e & 31;
          const int64_t gr = row0 + r;
          const int gc = kt * kTK + c;
          const bool ok = gr < n && gc < d;
          const float* src = ok ? x + gr * d + gc : x;
          cp_async4(xs + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4,
                    src, ok);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                         full) : "memory");
      }
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint32_t base, float* __restrict__ y,
    double* __restrict__ cs_part, double* __restrict__ sq_part, int64_t n,
    int d, int l, int n_chunks, int64_t n_tiles) {
  using C = Cfg<N>;
  constexpr int MT = C::MT;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kt_count = (d + kTK - 1) / kTK;
  const uint32_t full0 = base + C::BAR_OFF;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  float* red = reinterpret_cast<float*>(smem + C::RED_OFF);
  double* sq_red = reinterpret_cast<double*>(smem + C::SQ_OFF);
  double* my_cs = cs_part + (static_cast<int64_t>(blockIdx.x) * 2 + wg) * d;
  const int row_in = wg * 64 * MT + warp * 16 + g;  // + mt·64, + 8
  double sq_acc = 0.0;
  int stage = 0;
  uint32_t phase = 0;
  int par = 0;
  float acc[MT][N / 2];

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (tile / n_chunks) * C::BM;
    const int chunk = static_cast<int>(tile % n_chunks);
    const bool moments = chunk == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;

    for (int kt = 0; kt < kt_count; ++kt) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint8_t* xs = smem + stage * C::X_BYTES;
      uint32_t a[MT][2][2][4];  // [m-tile][k-step][hi, lo][register]
      float cs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[i] = 0.f;
      float sq = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = row_in + mt * 64;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int off = (((2 * t + s) ^ g) << 4);
          const float4 v = *reinterpret_cast<const float4*>(xs + r * 128 + off);
          const float4 u =
              *reinterpret_cast<const float4*>(xs + (r + 8) * 128 + off);
          split2(v.x, v.y, a[mt][s][0][0], a[mt][s][1][0]);
          split2(u.x, u.y, a[mt][s][0][1], a[mt][s][1][1]);
          split2(v.z, v.w, a[mt][s][0][2], a[mt][s][1][2]);
          split2(u.z, u.w, a[mt][s][0][3], a[mt][s][1][3]);
          cs[4 * s + 0] += v.x + u.x;
          cs[4 * s + 1] += v.y + u.y;
          cs[4 * s + 2] += v.z + u.z;
          cs[4 * s + 3] += v.w + u.w;
          sq = fmaf(v.x, v.x, sq);
          sq = fmaf(v.y, v.y, sq);
          sq = fmaf(v.z, v.z, sq);
          sq = fmaf(v.w, v.w, sq);
          sq = fmaf(u.x, u.x, sq);
          sq = fmaf(u.y, u.y, sq);
          sq = fmaf(u.z, u.z, sq);
          sq = fmaf(u.w, u.w, sq);
        }
      }
      const uint32_t wb = base + C::W_OFF + stage * C::W_BYTES;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint64_t dh = b_desc(wb + (2 * s + 0) * N * 32);
        const uint64_t dl = b_desc(wb + (2 * s + 1) * N * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_row<N>(acc[mt], a[mt][s][0], dh);  // xh·wh
          mma_row<N>(acc[mt], a[mt][s][1], dh);  // xl·wh
          mma_row<N>(acc[mt], a[mt][s][0], dl);  // xh·wl
        }
      }
      wgmma_commit();

      if (moments) {
        // Butterfly over the 8 row groups: 8 partials → 1 a lane.  Lane
        // g ends with partial g = 4s + j, tile column 4(2t + s) + j.
        float v4[4], v2[2];
        const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float keep = b16 ? cs[i + 4] : cs[i];
          const float send = b16 ? cs[i] : cs[i + 4];
          v4[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float keep = b8 ? v4[i + 2] : v4[i];
          const float send = b8 ? v4[i] : v4[i + 2];
          v2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        const float keep = b4 ? v2[1] : v2[0];
        const float send = b4 ? v2[0] : v2[1];
        const float v1 = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        const int col = 4 * (2 * t + (g >> 2)) + (g & 3);
        float* rb = red + (par * 2 + wg) * 128;
        rb[warp * 32 + col] = v1;
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        const int gc = kt * kTK + lane;
        if (warp == 0 && gc < d) {
          const double s4 = static_cast<double>(rb[lane]) + rb[32 + lane] +
                            rb[64 + lane] + rb[96 + lane];
          my_cs[gc] += s4;
        }
        par ^= 1;
        sq_acc += static_cast<double>(sq);
      }

      wgmma_wait_all();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Accumulator fragment: acc[4i + 2h + c] is row 16·warp + g + 8h,
    // column 8i + 2t + c of the m-tile.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + row_in + mt * 64 + 8 * h;
        if (row >= n) continue;
        float* yr = y + row * l;
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          const int col = chunk * N + 8 * i + 2 * t;
          if (col < l) yr[col] = acc[mt][4 * i + 2 * h];
          if (col + 1 < l) yr[col + 1] = acc[mt][4 * i + 2 * h + 1];
        }
      }
    }
  }

  // ‖X‖²: a fixed shuffle tree, then the eight warps in order.
  double v = sq_acc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) sq_red[wg * 4 + warp] = v;
  asm volatile("bar.sync 3, 256;" ::: "memory");
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < 8; ++i) s += sq_red[i];
    sq_part[blockIdx.x] = s;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
sketch_moments_kernel(const __grid_constant__ CUtensorMap xmap,
                      const float* __restrict__ x,
                      const uint8_t* __restrict__ wpre, float* __restrict__ y,
                      double* __restrict__ cs_part,
                      double* __restrict__ sq_part, int64_t n, int d, int l,
                      int n_chunks, int64_t n_tiles, int use_tma) {
  using C = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring.
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = smem_u32(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(base + C::BAR_OFF + 8 * s, use_tma ? 1 : 129);
      mbar_init(base + C::BAR_OFF + 8 * (C::STAGES + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    produce<N>(&xmap, x, wpre, base, n, d, n_chunks, n_tiles, use_tma != 0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    consume<N>(smem, base, y, cs_part, sq_part, n, d, l, n_chunks, n_tiles);
  }
}

// Second pass: each column's partials summed in float64 in a fixed order,
// in 8 interleaved groups of partial rows (one warp each, a lane per
// column) and then the 8 group sums in turn.
constexpr int kFinishGroups = 8;

__global__ void __launch_bounds__(32 * kFinishGroups)
moments_finish_kernel(const double* __restrict__ cs_part,
                      const double* __restrict__ sq_part,
                      float* __restrict__ colsum, float* __restrict__ sqnorm,
                      int d, int n_parts, int n_ctas) {
  __shared__ double group_sum[kFinishGroups][32];
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (c < d) {
    for (int p = group; p < n_parts; p += kFinishGroups) {
      s += cs_part[static_cast<int64_t>(p) * d + c];
    }
  }
  group_sum[group][lane] = s;
  __syncthreads();
  if (group == 0 && c < d) {
    double t = 0.0;
#pragma unroll
    for (int g = 0; g < kFinishGroups; ++g) t += group_sum[g][lane];
    colsum[c] = static_cast<float>(t);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    double t = 0.0;
    for (int b = 0; b < n_ctas; ++b) t += sq_part[b];
    sqnorm[0] = static_cast<float>(t);
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
                         int bm) {
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
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTK),
                             static_cast<cuuint32_t>(bm)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N>
cudaError_t launch(const float* x, const float* w, float* y, uint8_t* wpre,
                   double* cs_part, double* sq_part, int64_t n, int d, int l,
                   int grid, cudaStream_t stream) {
  using C = Cfg<N>;
  const int kt_count = (d + kTK - 1) / kTK;
  const int n_chunks = (l + N - 1) / N;
  const int64_t n_tiles = ((n + C::BM - 1) / C::BM) * n_chunks;
  const int64_t total = static_cast<int64_t>(n_chunks) * kt_count * 64 * N;
  presplit_w_kernel<<<static_cast<int>((total + 255) / 256 < 4096
                                           ? (total + 255) / 256 : 4096),
                      256, 0, stream>>>(
      w, reinterpret_cast<__nv_bfloat16*>(wpre), d, l, N, kt_count, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool use_tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       d % 4 == 0 && d >= kTK && n <= INT32_MAX - C::BM;
  CUtensorMap map = {};
  if (use_tma) {
    err = encode_x_map(&map, x, n, d, C::BOX);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(sketch_moments_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  sketch_moments_kernel<N><<<grid, kThreads, C::SMEM, stream>>>(
      map, x, wpre, y, cs_part, sq_part, n, d, l, n_chunks, n_tiles,
      use_tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// CTAs of a launch: one per SM, no more than there are tiles.
int petal_sketch_grid(int64_t n, int l, int sms) {
  const int w = chunk_width(l);
  const int bm = 128 * m_tiles(w);  // Cfg<w>::BM
  const int64_t tiles = ((n + bm - 1) / bm) * ((l + w - 1) / w);
  return static_cast<int>(tiles < sms ? tiles : sms);
}

// Bytes of the pre-split W scratch.
int64_t petal_sketch_wpre_bytes(int d, int l) {
  const int w = chunk_width(l);
  const int64_t kt_count = (d + kTK - 1) / kTK;
  return ((l + w - 1) / w) * kt_count * 128 * static_cast<int64_t>(w);
}

// X (n×d), W (d×l), Y (n×l): row-major float32 on the device; X needs
// only 4-byte alignment.  wpre is petal_sketch_wpre_bytes(d, l) bytes,
// 16-byte aligned; cs_part is 2·grid×d float64 and must be zero;
// sq_part is grid float64; grid is petal_sketch_grid(n, l, SMs) or
// fewer.  colsum (d) and sqnorm (1) are float32 outputs.
int petal_sketch_moments_f32(const void* x, const void* w, void* y,
                             void* wpre, void* cs_part, void* sq_part,
                             void* colsum, void* sqnorm, int64_t n, int d,
                             int l, int grid, void* stream) {
  if (n < 1 || d < 1 || l < 1 || l > 512 || grid < 1 ||
      reinterpret_cast<uintptr_t>(wpre) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* yf = static_cast<float*>(y);
  auto* wp = static_cast<uint8_t*>(wpre);
  auto* csp = static_cast<double*>(cs_part);
  auto* sqp = static_cast<double*>(sq_part);
  cudaError_t err;
  switch (chunk_width(l)) {
    case 16: err = launch<16>(xf, wf, yf, wp, csp, sqp, n, d, l, grid, s); break;
    case 32: err = launch<32>(xf, wf, yf, wp, csp, sqp, n, d, l, grid, s); break;
    case 48: err = launch<48>(xf, wf, yf, wp, csp, sqp, n, d, l, grid, s); break;
    case 64: err = launch<64>(xf, wf, yf, wp, csp, sqp, n, d, l, grid, s); break;
    case 96: err = launch<96>(xf, wf, yf, wp, csp, sqp, n, d, l, grid, s); break;
    case 128: err = launch<128>(xf, wf, yf, wp, csp, sqp, n, d, l, grid, s); break;
    default: err = launch<192>(xf, wf, yf, wp, csp, sqp, n, d, l, grid, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_finish_kernel<<<(d + 31) / 32, 32 * kFinishGroups, 0, s>>>(
      csp, sqp, static_cast<float*>(colsum), static_cast<float*>(sqnorm), d,
      2 * grid, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
