// K6: the sums of one FastICA step over the whitened data X₁, in one pass.
//
// For a float32 k×k W and the k×n X₁ (row-major, row stride ld) it returns
//
//   gx   = g(W·X₁)·X₁ᵀ          (k×k)
//   gsum = Σ_cols g′(W·X₁)      (k)
//
// unscaled, for the contrast g chosen by the template parameter F
// (logcosh: g = tanh y, g′ = 1 − g²; exp: g = y·e^(−y²/2), g′ = (1 − y²)·
// e^(−y²/2); cube: g = y³, g′ = 3y²): models/fast_ica.py::_block_sums,
// which ran them as two IEEE-float32 matmuls, the contrast's elementwise
// launches and a row reduction, seven launches that wrote and re-read three
// k×n temporaries (77 MB a step at the benchmark's k = 64, n = 100,000).
//
// Replaces no TPU kernel.  The JAX package runs these sums as XLA ops inside
// its lax.while_loop, where they cost no launches; the port's loop runs on
// the host.
//
// What bounds it on this card: operations.  A step is 4·k²·n float32
// operations (two k×k×n products), 1.64 GFLOP at k = 64, n = 100,000: 24.5 µs
// at 67 TFLOP/s on the CUDA cores, against 7.6 µs to read X₁'s 25.6 MB at
// 3.35 TB/s.  On the CUDA cores (FFMA) the products ran at ≈ 57% of that
// rate whatever the tiling (4×4 or 8×8 a thread, with or without their
// shared-memory loads), held by FFMA issue itself, and the kernel took
// 53 µs on an H100.  So the products run on the tensor cores at float32
// grade, K5's way (csrc/gram_syrk.cu): each operand x = hi + lo,
// hi = x rounded to TF32 (nearest, ties away), lo the float32 remainder,
// whose low bits the tensor cores drop; a product is hi·lo + lo·hi + hi·hi,
// three mma.sync m16n8k8 TF32, and the tensor cores' sums are added into
// float32 with IEEE adds every kChunk terms.  The design reads X₁ once:
//
// - A persistent grid (as many CTAs as fit, at most two an SM) of 256-thread
//   CTAs.  A CTA is groups of KP/16 warps (KP is k padded to 32, 64 or 128)
//   that share one copy of W in shared memory; each group walks its own
//   column blocks of X₁, which arrive through its own two-stage ring filled
//   by cp.async (16-byte copies where the rows are 16-byte aligned, 4-byte
//   copies otherwise; the ragged last block is zero-filled by the copy), and
//   syncs on its own named barrier.  Each warp owns 16 rows.
// - Phase 1: Y = W·X_blk for the warp's rows on the tensor cores (W by
//   ldmatrix, X by single loads), then g and g′ in registers: g goes to the
//   group's shared-memory block, g′ into each thread's running row sums
//   (columns past n are left out).
// - Phase 3: the warp's rows of g·X_blkᵀ on the tensor cores (both operands
//   by ldmatrix), added into the group's partial gx, kept in registers over
//   all its blocks.
// - The groups' partials are added in order in shared memory, and each CTA
//   writes its partial gx and gsum to device memory; after one grid barrier
//   (a cooperative launch, so every CTA is resident) each CTA sums a slice
//   of the entries over all CTAs' partials in a fixed order.  One launch a
//   step, and no atomics in any sum: two calls give the same bits.
//
// Measured on an H100 at k = 64, n = 100,000: 50 µs, of which the products
// ≈ 30 (≈ 0.4 m16n8k8 an SM a cycle, near what mma.sync issues; the SM clock
// falls to 1.77 GHz), the first blocks' arrival 2.5, the partials' sums and
// the grid barrier 4; at k = 128 140 µs against the FFMA design's 201.
// wgmma, the Hopper tensor cores' full rate, is the next step.
//
// tanh is tanhf, and the elementwise contrast is written with the _rn
// intrinsics in the host arithmetic's order, so that it rounds as PyTorch's
// elementwise kernels do.  Shared-memory rows are padded to BN + 4 and
// KP + 4 floats, so each 8-row ldmatrix meets no bank twice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
// Resident CTAs an SM at most.
constexpr int kMaxCtasPerSm = 2;
// The fixed-order sum of the partials: kSumCols entries at a time, each
// over kThreads / kSumCols slices of the CTAs, the slices added in order.
constexpr int kSumCols = 16;
constexpr int kSumSlices = kThreads / kSumCols;
constexpr int kBn = 64;  // columns of X₁ a block
// Terms the tensor cores sum before their sum is added into float32, in
// both products: one k-step.  Against float64 sums of a config-3 step's
// operands (H100, k = 64, three contrasts, two calls) chunks of 8 terms err
// 1.8-2.9e-7 in gx and 1.4-2.9e-7 in gsum, the IEEE-float32 matmuls
// 2.8-4.7e-7 and 0.85-1.3e-7: the tensor cores' truncating sums leave y a
// one-way error that gsum adds up over the columns.  Chunks of 64 erred
// 6.0e-7-1.7e-6 and 3.1e-7-1.0e-6, for 3.7 µs less.
constexpr int kChunk = 8;
constexpr uint32_t kTf32Mask = 0xffffe000u;

enum Contrast { kLogcosh = 0, kExp = 1, kCube = 2 };

// A CTA is GROUPS groups of GT = 2·KP threads (KP/16 warps of 16 rows).
template <int KP_>
struct Geometry {
  static constexpr int KP = KP_;
  static constexpr int BN = kBn;
  static constexpr int GT = 2 * KP;
  static constexpr int GROUPS = kThreads / GT;
  static constexpr int NT = KP / 8;   // phase 3's n-tiles (gx columns)
  static constexpr int P = BN + 4;    // row pitch of X and g blocks
  static constexpr int PW = KP + 4;   // row pitch of W
  static constexpr int CP = KP + 8;   // row pitch of a group's partial gx
  static constexpr int W_FLOATS = KP * PW;
  static constexpr int STAGE_FLOATS = KP * P;
  static constexpr int GROUP_FLOATS = (kStages + 1) * STAGE_FLOATS;
  static constexpr int SMEM_FLOATS = W_FLOATS + GROUPS * GROUP_FLOATS;
  static_assert(GROUPS * GT == kThreads, "whole groups");
  // After the loop the groups' partials, then their g' sums, fit the rings.
  static_assert(GROUPS * (KP * CP + KP) <= GROUPS * GROUP_FLOATS,
                "the groups' partials fit the rings");
};
// Groups a CTA and shared memory: 4 groups of 2 warps and 106 KiB at KP 32,
// 2 of 4 and 119 KiB at 64, 1 of 8 and 168 KiB at 128.

template <int F>
__device__ __forceinline__ void contrast(float y, float& g, float& gp) {
  if constexpr (F == kLogcosh) {
    g = tanhf(y);
    gp = __fsub_rn(1.f, __fmul_rn(g, g));
  } else if constexpr (F == kExp) {
    const float q = __fmul_rn(y, y);
    const float e = expf(__fmul_rn(-q, 0.5f));
    g = __fmul_rn(y, e);
    gp = __fmul_rn(__fsub_rn(1.f, q), e);
  } else {
    const float q = __fmul_rn(y, y);
    g = __fmul_rn(q, y);
    gp = __fmul_rn(__fmul_rn(3.f, y), y);
  }
}

// x = hi + lo: hi is x rounded to TF32 (nearest, ties away from zero, as
// cvt.rna.tf32.f32), lo the float32 remainder (K5's split_tf32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a·b, one m16n8k8 TF32 product on the tensor cores (not volatile:
// the compiler may interleave independent products).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[nt] += a·b[nt] at float32 grade for N n-tiles: hi·lo + lo·hi + hi·hi,
// each pass over all n-tiles before the next, so consecutive products
// write different accumulators.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4],
                                           const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t (*b_hi)[2],
                                           const uint32_t (*b_lo)[2]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) mma_tf32(d[nt], a_hi, b_lo[nt]);
#pragma unroll
  for (int nt = 0; nt < N; ++nt) mma_tf32(d[nt], a_lo, b_hi[nt]);
#pragma unroll
  for (int nt = 0; nt < N; ++nt) mma_tf32(d[nt], a_hi, b_hi[nt]);
}

// Four 8×8 matrices of 16-bit pairs (here 8 rows × 4 floats each) from the
// row addresses lanes 0-7, 8-15, 16-23 and 24-31 give: lane l receives
// float l % 4 of row l / 4 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const float* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A group's thread gt copies its share of rows [0, k) of column block `blk`
// into a stage; columns at or past n read as zero.  Rows [k, KP) of every
// stage were zeroed once.
template <int KP, bool VEC>
__device__ __forceinline__ void load_block(float* stage, const float* x,
                                           long long ld, int k, long long n,
                                           long long blk, int gt) {
  using G = Geometry<KP>;
  const long long col0 = blk * G::BN;
  if constexpr (VEC) {
    constexpr int Q = G::BN / 4;  // float4s a row
    for (int q = gt; q < k * Q; q += G::GT) {
      const int row = q / Q, c = 4 * (q % Q);
      const long long left = n - (col0 + c);
      const int bytes = left >= 4 ? 16 : left > 0 ? 4 * static_cast<int>(left)
                                                  : 0;
      const float* src = bytes ? x + row * ld + col0 + c : x;
      cp_async16(stage + row * G::P + c, src, bytes);
    }
  } else {
    for (int q = gt; q < k * G::BN; q += G::GT) {
      const int row = q / G::BN, c = q % G::BN;
      const bool in = col0 + c < n;
      cp_async4(stage + row * G::P + c, in ? x + row * ld + col0 + c : x,
                in ? 4 : 0);
    }
  }
}

// The barrier of one group of GT threads (named barrier 1 + group).
template <int GT>
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(GT) : "memory");
}

template <int KP, int F, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    ica_sums_kernel(const float* __restrict__ w, const float* __restrict__ x,
                    long long ld, int k, long long n, float* __restrict__ sums,
                    float* __restrict__ parts) {
  using G = Geometry<KP>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;  // W, row-major, pitch PW
  const int t = threadIdx.x, lane = t % 32;
  const int group = t / G::GT, gt = t % G::GT;
  const int row0 = 16 * (gt / 32);  // this warp's 16 rows
  const int qg = lane / 4, qt = lane % 4;  // the mma fragments' (g, t)
  float* ring = smem + G::W_FLOATS + group * G::GROUP_FLOATS;  // pitch P
  float* gs = ring + kStages * G::STAGE_FLOATS;  // g of one block, pitch P

  // This group's blocks: gid, gid + groups, ... (none for n = 0).
  const long long nblk = (n + G::BN - 1) / G::BN;
  const long long groups = static_cast<long long>(gridDim.x) * G::GROUPS;
  const long long gid = static_cast<long long>(blockIdx.x) * G::GROUPS + group;
  const long long mine = gid < nblk ? (nblk - gid + groups - 1) / groups : 0;

  // W (every thread a share) and the first blocks by cp.async, W in the
  // first group of copies; then zeros in W's padding and the stages'
  // padding rows.
  if (k % 4 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0) {
    for (int q = t; q < k * k / 4; q += kThreads) {
      const int i = q / (k / 4), j = 4 * (q % (k / 4));
      cp_async16(ws + i * G::PW + j, w + i * k + j, 16);
    }
  } else {
    for (int e = t; e < k * k; e += kThreads) {
      cp_async4(ws + (e / k) * G::PW + e % k, w + e, 4);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) {
      load_block<KP, VEC>(ring + s * G::STAGE_FLOATS, x, ld, k, n,
                          gid + s * groups, gt);
    }
    cp_async_commit();
  }
  for (int e = t; e < KP * KP; e += kThreads) {
    const int i = e / KP, j = e % KP;
    if (i >= k || j >= k) ws[i * G::PW + j] = 0.f;
  }
  for (int s = 0; s < kStages; ++s) {
    for (int e = k * G::P + gt; e < KP * G::P; e += G::GT) {
      ring[s * G::STAGE_FLOATS + e] = 0.f;
    }
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();  // W is whole: every thread copied a share of it

  // ldmatrix row addresses: lanes 0-7 rows 0-7, lanes 8-15 rows 8-15 of a
  // 16-row A tile at k columns 0-3, lanes 16-31 the same at columns 4-7,
  // giving the m16n8k8 A fragment (g, t), (g + 8, t), (g, t + 4),
  // (g + 8, t + 4); for B from an n-major tile, lanes 0-7 rows 0-7 at k
  // columns 0-3, 8-15 the same at 4-7, then 16-31 the next n-tile.
  const int a_row = lane % 16, a_col = 4 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = 4 * ((lane / 8) % 2);

  float acc[G::NT][4];  // the group's partial gx: rows row0 + qg (+ 8)
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  float gsum[2] = {0.f, 0.f};  // rows row0 + qg, row0 + qg + 8

  for (long long it = 0; it < mine; ++it) {
    cp_async_wait<kStages - 2>();
    group_sync<G::GT>(group);  // this block landed; the last one is consumed
    {
      const long long next = it + kStages - 1;
      if (next < mine) {
        load_block<KP, VEC>(ring + (next % kStages) * G::STAGE_FLOATS, x, ld,
                            k, n, gid + next * groups, gt);
      }
      cp_async_commit();
    }
    const float* xs = ring + (it % kStages) * G::STAGE_FLOATS;
    const long long col0 = (gid + it * groups) * G::BN;

    // Phase 1: this warp's 16 rows of Y = W·X_blk (8 n-tiles of 8 columns),
    // summed on the tensor cores over chunks of kChunk terms, each chunk
    // added into y in float32; then g into gs and g′ into the row sums.
    float y[G::BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < G::BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;
    }
#pragma unroll 1
    for (int k0 = 0; k0 < KP; k0 += kChunk) {
      float yc[G::BN / 8][4];
#pragma unroll
      for (int nt = 0; nt < G::BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) yc[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = k0 / 8; ks < (k0 + kChunk) / 8; ++ks) {
        uint32_t a[4], a_hi[4], a_lo[4];
        ldmatrix_x4(a, ws + (row0 + a_row) * G::PW + 8 * ks + a_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(__uint_as_float(a[e]), a_hi[e], a_lo[e]);
        }
        uint32_t b_hi[G::BN / 8][2], b_lo[G::BN / 8][2];
#pragma unroll
        for (int nt = 0; nt < G::BN / 8; ++nt) {
          split_tf32(xs[(8 * ks + qt) * G::P + 8 * nt + qg], b_hi[nt][0],
                     b_lo[nt][0]);
          split_tf32(xs[(8 * ks + qt + 4) * G::P + 8 * nt + qg], b_hi[nt][1],
                     b_lo[nt][1]);
        }
        mma_3xtf32<G::BN / 8>(yc, a_hi, a_lo, b_hi, b_lo);
      }
#pragma unroll
      for (int nt = 0; nt < G::BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) y[nt][e] += yc[nt][e];
      }
    }
#pragma unroll
    for (int nt = 0; nt < G::BN / 8; ++nt) {
      const int c = 8 * nt + 2 * qt;  // this thread's columns c, c + 1
      const long long valid = n - (col0 + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows qg, qg + 8
        float g0, g1, gp0, gp1;
        contrast<F>(y[nt][2 * half], g0, gp0);
        contrast<F>(y[nt][2 * half + 1], g1, gp1);
        if (valid > 0) gsum[half] += gp0;
        if (valid > 1) gsum[half] += gp1;
        *reinterpret_cast<float2*>(gs + (row0 + qg + 8 * half) * G::P + c) =
            make_float2(g0, g1);
      }
    }
    group_sync<G::GT>(group);

    // Phase 3: this warp's 16 rows of g_blk·X_blkᵀ (NT n-tiles of gx
    // columns), summed on the tensor cores over chunks of kChunk columns,
    // each chunk added into acc in float32.
#pragma unroll 1
    for (int c0 = 0; c0 < G::BN; c0 += kChunk) {
      float d[G::NT][4];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = c0 / 8; ks < (c0 + kChunk) / 8; ++ks) {
        uint32_t a[4], a_hi[4], a_lo[4];
        ldmatrix_x4(a, gs + (row0 + a_row) * G::P + 8 * ks + a_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(__uint_as_float(a[e]), a_hi[e], a_lo[e]);
        }
        uint32_t b_hi[G::NT][2], b_lo[G::NT][2];
#pragma unroll
        for (int nt = 0; nt < G::NT; nt += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, xs + (8 * nt + b_row) * G::P + 8 * ks + b_col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split_tf32(__uint_as_float(b[e]), b_hi[nt + e / 2][e % 2],
                       b_lo[nt + e / 2][e % 2]);
          }
        }
        mma_3xtf32<G::NT>(d, a_hi, a_lo, b_hi, b_lo);
      }
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += d[nt][e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every group is done with its ring

  // The groups' partials in shared memory (rows padded to CP floats), then
  // this CTA's partials (gx row-major, then gsum) to device memory, the
  // groups added in order.  A row's g′ sums are the four lanes of its quad,
  // added in lane order.
  float* comb = smem + G::W_FLOATS;            // GROUPS × KP × CP
  float* red = comb + G::GROUPS * KP * G::CP;  // GROUPS × KP
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      *reinterpret_cast<float2*>(
          comb + (group * KP + row0 + qg + 8 * half) * G::CP + 8 * nt +
          2 * qt) = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float s1 = __shfl_down_sync(0xffffffffu, gsum[half], 1);
    const float s2 = __shfl_down_sync(0xffffffffu, gsum[half], 2);
    const float s3 = __shfl_down_sync(0xffffffffu, gsum[half], 3);
    if (qt == 0) {
      red[group * KP + row0 + qg + 8 * half] = ((gsum[half] + s1) + s2) + s3;
    }
  }
  __syncthreads();
  const int count = k * k + k;
  float* out = parts + static_cast<long long>(blockIdx.x) * count;
  for (int e = t; e < k * k; e += kThreads) {
    const int i = e / k, j = e % k;
    float v = comb[i * G::CP + j];
#pragma unroll
    for (int q = 1; q < G::GROUPS; ++q) v += comb[(q * KP + i) * G::CP + j];
    out[e] = v;
  }
  for (int i = t; i < k; i += kThreads) {
    float v = red[i];
#pragma unroll
    for (int q = 1; q < G::GROUPS; ++q) v += red[q * KP + i];
    out[k * k + i] = v;
  }

  // Every CTA's partials are written: CTA b sums entries [e0, e1) over the
  // CTAs, slice q adding CTAs q, q + kSumSlices, ... in order, then the
  // slices in order.  The partials are read from L2 (__ldcg): another SM
  // wrote them.
  cg::this_grid().sync();
  const int per = (count + gridDim.x - 1) / gridDim.x;
  const int e0 = blockIdx.x * per;
  const int e1 = e0 + per < count ? e0 + per : count;
  const int col = t % kSumCols, slice = t / kSumCols;
  float* part_sums = ws;  // kSumSlices × kSumCols; W is no longer read
  for (int base = e0; base < e1; base += kSumCols) {
    const int e = base + col;
    float s = 0.f;
    if (e < e1) {
#pragma unroll 8
      for (int p = slice; p < static_cast<int>(gridDim.x); p += kSumSlices) {
        s += __ldcg(parts + static_cast<long long>(p) * count + e);
      }
    }
    part_sums[slice * kSumCols + col] = s;
    __syncthreads();
    if (t < kSumCols && base + t < e1) {
      float total = part_sums[t];
#pragma unroll
      for (int q = 1; q < kSumSlices; ++q) {
        total += part_sums[q * kSumCols + t];
      }
      sums[base + t] = total;
    }
    __syncthreads();
  }
}

// The CTAs a launch of this instantiation keeps resident, over the card.
template <int KP, int F, bool VEC>
cudaError_t grid_for(int sms, int* ctas) {
  constexpr int bytes = Geometry<KP>::SMEM_FLOATS * sizeof(float);
  static int occupancy[64] = {};  // set once a device
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return st;
  if (dev < 64 && occupancy[dev] > 0) {
    *ctas = occupancy[dev] * sms;
    return cudaSuccess;
  }
  st = cudaFuncSetAttribute(ica_sums_kernel<KP, F, VEC>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (st != cudaSuccess) return st;
  int occ = 0;
  st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, ica_sums_kernel<KP, F, VEC>, kThreads, bytes);
  if (st != cudaSuccess) return st;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  occ = occ < kMaxCtasPerSm ? occ : kMaxCtasPerSm;
  if (dev < 64) occupancy[dev] = occ;
  *ctas = occ * sms;
  return cudaSuccess;
}

template <int KP, int F, bool VEC>
cudaError_t launch(const float* w, const float* x, long long ld, int k,
                   long long n, int sms, int max_parts, float* out,
                   float* parts, cudaStream_t stream) {
  using G = Geometry<KP>;
  int ctas = 0;
  cudaError_t st = grid_for<KP, F, VEC>(sms, &ctas);
  if (st != cudaSuccess) return st;
  const long long nblk = (n + G::BN - 1) / G::BN;
  const long long need = (nblk + G::GROUPS - 1) / G::GROUPS;
  // At least one CTA, which writes zeros for n = 0.
  int grid = static_cast<int>(need < ctas ? need : ctas);
  grid = grid > 1 ? grid : 1;
  if (grid > max_parts) return cudaErrorInvalidValue;
  void* args[] = {&w, &x, &ld, &k, &n, &out, &parts};
  st = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ica_sums_kernel<KP, F, VEC>), dim3(grid),
      dim3(kThreads), args, G::SMEM_FLOATS * sizeof(float), stream);
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

template <int KP, int F>
cudaError_t launch_aligned(const float* w, const float* x, long long ld,
                           int k, long long n, int sms, int max_parts,
                           float* out, float* parts, cudaStream_t stream) {
  const bool vec = (k == 1 || ld % 4 == 0) &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  if (vec) {
    return launch<KP, F, true>(w, x, ld, k, n, sms, max_parts, out, parts,
                               stream);
  }
  return launch<KP, F, false>(w, x, ld, k, n, sms, max_parts, out, parts,
                              stream);
}

template <int KP>
cudaError_t launch_contrast(int fun, const float* w, const float* x,
                            long long ld, int k, long long n, int sms,
                            int max_parts, float* out, float* parts,
                            cudaStream_t stream) {
  switch (fun) {
    case kLogcosh:
      return launch_aligned<KP, kLogcosh>(w, x, ld, k, n, sms, max_parts, out,
                                          parts, stream);
    case kExp:
      return launch_aligned<KP, kExp>(w, x, ld, k, n, sms, max_parts, out,
                                      parts, stream);
    case kCube:
      return launch_aligned<KP, kCube>(w, x, ld, k, n, sms, max_parts, out,
                                       parts, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// w: k×k row-major; x: k×n with unit column stride and row stride ld; out:
// k·k + k floats (gx row-major, then gsum); parts: max_parts·(k·k + k)
// floats of scratch, max_parts ≥ max(1, min(⌈n / kBn⌉, 2·sms)); all
// float32 on the current device.  fun: 0 logcosh, 1 exp, 2 cube.
// 1 ≤ k ≤ 128, n ≥ 0.  Returns a cudaError_t.
int petal_ica_sums_f32(const void* w, const void* x, long long ld, int k,
                       long long n, int fun, int sms, int max_parts,
                       void* out, void* parts, void* stream) {
  const auto* wp = static_cast<const float*>(w);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(parts);
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || n < 0 || sms < 1 || max_parts < 0 ||
      (k > 1 && ld < n)) {
    return cudaErrorInvalidValue;
  }
  if (k <= 32) {
    return launch_contrast<32>(fun, wp, xp, ld, k, n, sms, max_parts, op, pp,
                               s);
  }
  if (k <= 64) {
    return launch_contrast<64>(fun, wp, xp, ld, k, n, sms, max_parts, op, pp,
                               s);
  }
  return launch_contrast<128>(fun, wp, xp, ld, k, n, sms, max_parts, op, pp,
                              s);
}

}  // extern "C"
