// One-sided Jacobi SVD of an m×n panel as a block Jacobi, in one cooperative
// launch whose CTAs each work on one block pair on chip.  Templated on the
// scalar type: jacobi_svd.cu instantiates float (K2), jacobi_svd_f64.cu
// double (K3); each builds into its own library.
//
// What bounds it on an H100: latency.  A sweep of a one-sided Jacobi is a
// chain of ≈2n dependent steps, each a few dot products, a rotation and a
// barrier; the arithmetic (≈1.8 GFLOP for 12 sweeps of a 256×256 panel,
// 0.027 ms at 67 TFLOP/s, float32 outside the tensor cores or float64 on
// them) is not the limit.  The panels these kernels serve (the 1024×43 Bᵀ of
// a randomized fit, a 1000×64 panel, the n×n R of a tall QR up to 632×632 in
// float32 and 512×512 in float64) mostly exceed one CTA's 227 KB of shared
// memory, so a one-block design walks every step through L1/L2 on one SM.
// Inside a CTA, a step that reads its columns from shared memory for the dot
// products and again for the rotation is bound by shared-memory bandwidth
// (128 B a cycle), so the columns live in registers during the inner sweep.
//
// Design (the wrappers, ops/kernels/jacobi_kernels.py and
// jacobi_f64_kernel.py through jacobi_block.py, pick w, P and R):
// * Blocks of columns.  The n columns, padded with zero columns (which never
//   rotate) to n2 = 2·w·P, form 2P blocks of width w.  An outer sweep pairs the
//   blocks by the circle method: 2P−1 outer steps, each with P disjoint block
//   pairs.  One CTA per block pair loads the pair's m×2w columns into shared
//   memory (cp.async), and each thread takes its rows of them into registers.
//   The CTA runs one inner sweep over all 2w(2w−1)/2 column pairs there (2w−1
//   inner steps of the circle method), accumulating the rotations into a
//   2w×2w orthogonal J whose rows are held by J threads beside the panel's,
//   writes the columns back and updates V's two blocks as V_pq ← V_pq·J (FMA,
//   with V_pq copied into shared memory by cp.async during the inner sweep).
//   Each column is reused 2w−1 times per trip through L2 instead of once.
// * Registers, not indices: a thread holds `rpt` panel rows (or one row of J)
//   of all 2w columns in slot order, and the column pairs of an inner step are
//   always the slots (c, 2w−1−c).  After each step the slots move one place
//   along the circle (register moves), so the columns are addressed at compile
//   time; the kernel is instantiated for every even 2w ≤ 48.  After 2w−1 steps
//   every column is back in its slot.  A float takes one register and a
//   double two, so a float32 thread holds about twice the rows.
// * An inner step has one barrier.  Each warp of panel rows forms its partial
//   dot products for all w pairs and sums them over its lanes by a transposed
//   shuffle reduction (each level halves the values a lane holds, up to eight
//   pairs at a time) into shared memory, double-buffered by the step's parity.
//   After the barrier every warp, one lane per pair, adds the warps' partials
//   in a fixed order (so all warps agree), forms the pair's rotation without a
//   division, and rotates its rows.
// * One launch per call: a cooperative grid of P·R co-resident CTAs, one grid
//   barrier per outer step; the convergence measure and the stop decision are
//   reduced on the device, once a sweep.  Every CTA reduces the same values in
//   the same order, so all take the same decision and leave the loop together.
// * One CTA when the panel fits (P = 1): the whole panel and J (which is then
//   V) stay on chip for every sweep, with no grid barrier.
// * A panel whose block pairs are taller than one CTA holds (m beyond ~9k rows
//   in float64, ~13k in float32) is split by rows: each block pair goes to R
//   CTAs, each holding its rows of the pair's columns (and all of J), and the
//   three dot products of each column pair are summed over the R CTAs through
//   device memory with one grid barrier per inner step.  All R CTAs form the
//   same rotations; the first of them updates V.
// * Same rotation, skip rule and certificate as the TPU kernels, with the
//   outer step in place of the step: off of an outer sweep is the maximum over
//   its outer steps of (largest |apq| of any pair visit in that step, over all
//   CTAs) / (largest app or aqq seen in that step).  The maxima propagate NaN,
//   so a non-finite panel cannot report convergence; a zero or padding column
//   has apq = 0 and skips.
// * float32 (K2) holds c as 1 + (c − 1) and adds x last (`rotate`): c of a
//   small rotation rounds to 1 in float32, and the norms would grow (1e-5 of
//   σ₁ on a 632×632 panel); held so, σ stay within 3e-7 of σ₁ (measured
//   on an H100 against copies of K2 without the choice).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxW2 = 48;       // widest block pair (2w columns; wider spill)
constexpr int kRegWords = 168;   // 32-bit registers of rows and partial sums
constexpr int kRowWords = 120;   // 32-bit registers of rows (see Cfg)
constexpr int kMaxDevices = 16;  // launcher caches, one entry per device

// A CTA has at most 256 threads, two warps on each of the SM's four
// sub-partitions, so that each thread may use 255 registers.
// ops/kernels/jacobi_block.py mirrors these constants.
constexpr int kMaxThreads = 256;

// What differs between the two element types, beside the rotation.
template <typename T>
struct Elem;

// kWords: the 32-bit registers an element takes.  kRowGuards: whether a
// thread tests each of its register rows against its row count in the inner
// step.  Rows past the count hold zeros, which neither the dot products nor
// the rotations change, so float32 skips the tests: without their branches
// the rows' FMAs interleave, 10-18% off a sweep of K2's panels with bitwise
// the same result (measured on an H100).  K3 keeps them, and with them its
// times as measured in PR 3.
template <>
struct Elem<double> {
  using Vec2 = double2;
  static constexpr int kWords = 2;
  static constexpr bool kRowGuards = true;
};

template <>
struct Elem<float> {
  using Vec2 = float2;
  static constexpr int kWords = 1;
  static constexpr bool kRowGuards = false;
};

// FMA and |x| by the element type, with no overload left to the math headers.
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }

// Per element type and block-pair width: the column pairs reduced together
// (kChunk, a power of two, at most 8) and the rows a thread may hold, so that
// its rows and one chunk of partial sums stay within kRegWords registers, its
// rows within kRowWords where the chunk is of eight pairs or the element a
// float (more spills: ptxas -v, 60 doubles of rows at 2w ≥ 10, 82 floats of
// rows at 2w = 2).
template <typename T, int W2>
struct Cfg {
  static constexpr int kW = W2 / 2;
  static constexpr int kChunk = kW >= 5 ? 8 : (kW >= 3 ? 4 : kW);
  static constexpr int kLevels = kChunk == 8 ? 3 : (kChunk == 4 ? 2 : kChunk - 1);
  static constexpr int kChunks = (kW + kChunk - 1) / kChunk;
  static constexpr int kData = kChunk == 8 || Elem<T>::kWords == 1
                                   ? kRowWords / Elem<T>::kWords
                                   : kRegWords / Elem<T>::kWords - 3 * kChunk;
  static constexpr int kRpt = kData / W2 >= 1 ? kData / W2 : 1;
};

template <typename T>
struct Args {
  const T* at;  // n × m row-major: row j is column j of the input
  T* a;         // n2 × ldg: row j is column j of the rotated panel
  T* v;         // n2 × n2: row j is column j of V
  T* off_out;   // 1 value
  T* part;      // cross-CTA scratch: [2][P][w][R][3] dot sums, [2][2P−1][P·R][2] maxima
  int m, n, w, P, R, mr, ld, ldg, max_sweeps;
  int rpt, ta, tj;  // panel rows a thread holds; threads of panel rows, of J
                    // rows (one row of J each)
  T eps, tol;
};

// max that propagates NaN (fmax would drop it).
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Circle method over `players` (even): round `round`, pair `i` — the same
// table as ops/jacobi.py's round_robin_pairings.
__device__ __forceinline__ void rr_pair(int players, int round, int i, int& p,
                                        int& q) {
  const int l = players - 1;
  p = i == 0 ? 0 : 1 + ((i - 1 - round) % l + l) % l;
  q = 1 + ((players - 2 - i - round) % l + l) % l;
}

// Copy two elements into shared memory: 16 bytes of double through L2 only
// (.cg), 8 bytes of float (.cg takes only 16-byte copies).  So the rows,
// offsets and leading dimensions stay even for both types; four floats go
// as one 16-byte copy where they are multiples of four (5-7% off a sweep of
// the 1024×43 and 632×632 panels, measured on an H100).
__device__ __forceinline__ void cp_async_pair(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_pair(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_quad(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The rotation (c, s) that zeroes apq; the identity where |apq| ≤
// eps·√(app·aqq), which also covers zero columns.  With d = aqq − app and
// b = 2|apq|, t = sign(d)·b/(|d| + √(d² + b²)) is τ's t = sign(τ)/(|τ| +
// √(1+τ²)) for τ = d/b, and c = 1/√(1+t²) = u/√(u² + b²) with u = |d| +
// √(d² + b²): two reciprocal square roots (√q as q·rsqrt(q)), no division.
// (d, b) are first scaled by a power of two near 1/max(|d|, b), so d² + b²
// neither overflows nor underflows.
__device__ __forceinline__ double2 rotation(double app, double aqq, double apq,
                                            double eps) {
  const double abs_pq = fabs(apq);
  const bool skip = abs_pq <= eps * sqrt(app * aqq);
  const double d = aqq - app, b = 2.0 * abs_pq;
  long long e = (__double_as_longlong(fmax(fabs(d), b)) >> 52) & 0x7ff;
  e = e < 1 ? 1 : (e > 2045 ? 2045 : e);
  const double scale = __longlong_as_double((2046LL - e) << 52);
  const double ds = d * scale, bs = b * scale, b2 = bs * bs;
  const double q = fma(ds, ds, b2);
  const double u = fabs(ds) + q * rsqrt(q);
  const double k = rsqrt(fma(u, u, b2));
  double c = u * k, s = bs * k;
  if ((d < 0.0) != (apq < 0.0)) s = -s;
  if (skip) {
    c = 1.0;
    s = 0.0;
  }
  return make_double2(c, s);
}

// rsqrtf (up to 2 ulp off) and one Newton step, its residual by FMA: within
// about 1 ulp and unbiased.
__device__ __forceinline__ float rsqrt_refined(float x) {
  const float y = rsqrtf(x);
  return fmaf(0.5f * y, fmaf(-x * y, y, 1.0f), y);
}

// The same rotation in float32 (exponent field 8 bits, bias 127), returned
// as (c − 1, s) with c − 1 = −s²/(1 + c): see `rotate`.
__device__ __forceinline__ float2 rotation(float app, float aqq, float apq,
                                           float eps) {
  const float abs_pq = fabsf(apq);
  const bool skip = abs_pq <= eps * sqrtf(app * aqq);
  const float d = aqq - app, b = 2.0f * abs_pq;
  int e = (__float_as_int(fmaxf(fabsf(d), b)) >> 23) & 0xff;
  e = e < 1 ? 1 : (e > 253 ? 253 : e);
  const float scale = __int_as_float((254 - e) << 23);
  const float ds = d * scale, bs = b * scale, b2 = bs * bs;
  const float q = fmaf(ds, ds, b2);
  const float u = fabsf(ds) + q * rsqrt_refined(q);
  const float k = rsqrt_refined(fmaf(u, u, b2));
  const float c = u * k;
  float s = bs * k;
  if ((d < 0.0f) != (apq < 0.0f)) s = -s;
  float cm1 = -(s * s) * __frcp_rn(1.0f + c);
  if (skip) {
    cm1 = 0.0f;
    s = 0.0f;
  }
  return make_float2(cm1, s);
}

// (x, y) ← (c·x − s·y, s·x + c·y).  In float64 from (c, s).  In float32
// from (c − 1, s), as x + ((c − 1)·x − s·y): c of a small rotation rounds
// to 1 in float32, and c = 1 with s = t grows each pair's norm by 1 + t², a
// drift that the late sweeps' thousands of small rotations add up.  The two
// small terms are summed first and x added last, in one rounding: (c − 1)·x
// is below half an ulp of x, and added to an already rounded x − s·y it
// would be lost every time (‖A·V‖_F then grows by 1e-5 of ‖A‖_F on a
// 632×632 panel, measured on an H100).
__device__ __forceinline__ void rotate(double2 r, double& x, double& y) {
  const double xa = x, xb = y;
  x = r.x * xa - r.y * xb;
  y = r.y * xa + r.x * xb;
}

__device__ __forceinline__ void rotate(float2 r, float& x, float& y) {
  const float xa = x, xb = y;
  x = xa + fmaf(r.x, xa, -r.y * xb);
  y = xb + fmaf(r.x, xb, r.y * xa);
}

// One level of the transposed reduction: lanes `o` apart swap halves of
// their `2·kHalf` values; each keeps one half, summed with its partner's.
template <int kHalf, typename T>
__device__ __forceinline__ void fold(T* v, int lane, int o) {
  const bool upper = lane & o;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const T send = upper ? v[j] : v[j + kHalf];
    const T keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// The three dot products of each column pair of this thread's rows, summed
// over the warp's lanes and written to red[(c·nwa + warp)·3 + {0, 1, 2}].
// A chunk of kChunk = 2^f pairs holds 3·2^f values a lane; f levels of
// `fold` (lanes 16, 8, 4 apart) leave lane l three values of pair l >> (5−f),
// and the remaining levels add lanes that hold the same pair.
template <typename T, int W2>
__device__ __forceinline__ void warp_dots(const Args<T>& p,
                                          const T (&x)[Cfg<T, W2>::kRpt][W2],
                                          T* red, int nwa) {
  using C = Cfg<T, W2>;
  constexpr int W = C::kW, CH = C::kChunk, F = C::kLevels;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int ch = 0; ch < C::kChunks; ++ch) {
    T v[3 * CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = ch * CH + j;
      T app = T(0), aqq = T(0), apq = T(0);
      if (c < W) {
#pragma unroll
        for (int k = 0; k < C::kRpt; ++k) {
          if (!Elem<T>::kRowGuards || k < p.rpt) {
            const T xa = x[k][c], xb = x[k][W2 - 1 - c];
            app = fmadd(xa, xa, app);
            aqq = fmadd(xb, xb, aqq);
            apq = fmadd(xa, xb, apq);
          }
        }
      }
      v[3 * j] = app;
      v[3 * j + 1] = aqq;
      v[3 * j + 2] = apq;
    }
    if constexpr (F >= 1) fold<3 * CH / 2>(v, lane, 16);
    if constexpr (F >= 2) fold<3 * CH / 4>(v, lane, 8);
    if constexpr (F >= 3) fold<3 * CH / 8>(v, lane, 4);
#pragma unroll
    for (int o = 16 >> F; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < 3; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
    }
    const int c = ch * CH + (lane >> (5 - F));
    if ((lane & ((32 >> F) - 1)) == 0 && c < W) {
      T* out = red + (c * nwa + warp) * 3;
      out[0] = v[0];
      out[1] = v[1];
      out[2] = v[2];
    }
  }
}

// One inner sweep over the 2w columns a CTA holds: x holds this thread's rows
// (panel rows when `panel` is set, else rows of J) in slot order.  Each
// step: the panel warps' partial dot products into `red` (double-buffered by
// the step's parity), one barrier, then every warp sums them (lane c, pair
// c, in a fixed order, so all warps agree), forms the rotations, passes them
// to its lanes through its row of `cs` and rotates its rows.  Warp 0's lanes
// collect the certificate's maxima of the pair visits in apq_max and
// nrm_max; `ks` counts inner steps for the parities.
template <typename T, int W2>
__device__ __forceinline__ void inner_sweep(
    const Args<T>& p, T (&x)[Cfg<T, W2>::kRpt][W2], bool panel,
    typename Elem<T>::Vec2* cs, T* red, T& apq_max, T& nrm_max, int& ks,
    cg::grid_group& grid) {
  using C = Cfg<T, W2>;
  constexpr int W = C::kW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwa = p.ta / 32, R = p.R;
  const int nk = panel ? p.rpt : 1;  // rows this thread holds
  typename Elem<T>::Vec2* mine = cs + warp * W;
#pragma unroll 1
  for (int step = 0; step < W2 - 1; ++step, ++ks) {
    T* buf = red + (ks & 1) * 3 * W * nwa;
    if (panel) warp_dots<T, W2>(p, x, buf, nwa);
    __syncthreads();
    T app = T(0), aqq = T(0), apq = T(0);
    if (lane < W) {
      // All loads first, then the sums in warp order.
      T part[kMaxThreads / 32][3];
#pragma unroll
      for (int i = 0; i < kMaxThreads / 32; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          part[i][j] = i < nwa ? buf[(lane * nwa + i) * 3 + j] : T(0);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxThreads / 32; ++i) {
        app += part[i][0];
        aqq += part[i][1];
        apq += part[i][2];
      }
    }
    if (R > 1) {
      // Rows split over R CTAs: each CTA's sums go through device memory,
      // double-buffered by the parity of the inner step.  CTA pair·R + r
      // holds row group r of block pair `pair`.
      const int pair = blockIdx.x / R, r = blockIdx.x % R;
      T* slot = p.part + (static_cast<int64_t>(ks & 1) * p.P + pair) * W * R * 3;
      if (warp == 0 && lane < W) {
        T* out = slot + (static_cast<int64_t>(lane) * R + r) * 3;
        out[0] = app;
        out[1] = aqq;
        out[2] = apq;
      }
      grid.sync();
      app = aqq = apq = T(0);
      if (lane < W) {
        for (int j = 0; j < R; ++j) {
          const T* in = slot + (static_cast<int64_t>(lane) * R + j) * 3;
          app += __ldcg(in);
          aqq += __ldcg(in + 1);
          apq += __ldcg(in + 2);
        }
      }
    }
    if (lane < W) {
      if (warp == 0) {
        apq_max = max_nan(apq_max, absval(apq));
        nrm_max = max_nan(nrm_max, max_nan(app, aqq));
      }
      mine[lane] = rotation(app, aqq, apq, p.eps);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const auto r = mine[c];
#pragma unroll
      for (int k = 0; k < C::kRpt; ++k) {
        if (!Elem<T>::kRowGuards || k < nk) rotate(r, x[k][c], x[k][W2 - 1 - c]);
      }
    }
    __syncwarp();
    // The circle method's move: slot 1 ← slot 2w−1, slot j ← slot j−1.
#pragma unroll
    for (int k = 0; k < C::kRpt; ++k) {
      const T last = x[k][W2 - 1];
#pragma unroll
      for (int j = W2 - 1; j >= 2; --j) x[k][j] = x[k][j - 1];
      x[k][1] = last;
    }
  }
}

// Global column of local column c of the block pair (bp, bq).
__device__ __forceinline__ int gcol(int c, int w, int bp, int bq) {
  return c < w ? bp * w + c : bq * w + (c - w);
}

// S ← rows [row0, row0 + mr) of the pair's columns, read from the input (zero
// beyond m and n).
template <typename T>
__device__ void load_input(const Args<T>& p, T* S, int bp, int bq, int row0) {
  for (int c = 0; c < 2 * p.w; ++c) {
    const int col = gcol(c, p.w, bp, bq);
    const T* src = p.at + static_cast<int64_t>(col) * p.m;
    T* dst = S + static_cast<int64_t>(c) * p.ld;
    for (int i = threadIdx.x; i < p.mr; i += blockDim.x) {
      const int row = row0 + i;
      dst[i] = (col < p.n && row < p.m) ? src[row] : T(0);
    }
  }
}

// Start copying rows [row0, row0 + rows) of the pair's columns of a
// column-major buffer with leading dimension `ldsrc` into S (row0, rows and
// ldsrc even: two-element copies, or four floats), by `nthreads` threads of
// which this is thread `t`.
template <typename T>
__device__ void load_async(const Args<T>& p, T* S, const T* src, int ldsrc,
                           int bp, int bq, int row0, int rows, int t,
                           int nthreads) {
  for (int c = 0; c < 2 * p.w; ++c) {
    const T* from =
        src + static_cast<int64_t>(gcol(c, p.w, bp, bq)) * ldsrc + row0;
    T* to = S + static_cast<int64_t>(c) * p.ld;
    if constexpr (sizeof(T) == 4) {
      if (((ldsrc | row0 | rows | p.ld) & 3) == 0) {
        for (int i = 4 * t; i < rows; i += 4 * nthreads) {
          cp_async_quad(to + i, from + i);
        }
        continue;
      }
    }
    for (int i = 2 * t; i < rows; i += 2 * nthreads) cp_async_pair(to + i, from + i);
  }
  cp_async_commit();
}

// Rows [row0, row0 + mr) of the pair's columns of A ← S.
template <typename T>
__device__ void store_a(const Args<T>& p, const T* S, int bp, int bq,
                        int row0) {
  for (int c = 0; c < 2 * p.w; ++c) {
    T* dst = p.a + static_cast<int64_t>(gcol(c, p.w, bp, bq)) * p.ldg + row0;
    const T* src = S + static_cast<int64_t>(c) * p.ld;
    for (int i = threadIdx.x; i < p.mr; i += blockDim.x) dst[i] = src[i];
  }
}

// This thread's registers ← its rows: panel rows tid + k·ta of S, or row
// tid − ta of the identity J.
template <typename T, int W2>
__device__ __forceinline__ void pull(const Args<T>& p, const T* S, bool panel,
                                     T (&x)[Cfg<T, W2>::kRpt][W2]) {
#pragma unroll
  for (int k = 0; k < Cfg<T, W2>::kRpt; ++k) {
    const int row = panel ? threadIdx.x + k * p.ta : threadIdx.x - p.ta;
    const bool live = panel ? k < p.rpt && row < p.mr : k == 0;
#pragma unroll
    for (int c = 0; c < W2; ++c) {
      x[k][c] = !live ? T(0)
                      : (panel ? S[static_cast<int64_t>(c) * p.ld + row]
                               : (row == c ? T(1) : T(0)));
    }
  }
}

// Rows [row0, row0 + mr) of the pair's columns of A ← this thread's panel
// rows (coalesced: consecutive threads hold consecutive rows).
template <typename T, int W2>
__device__ __forceinline__ void push_a(const Args<T>& p,
                                       const T (&x)[Cfg<T, W2>::kRpt][W2],
                                       int bp, int bq, int row0) {
#pragma unroll
  for (int k = 0; k < Cfg<T, W2>::kRpt; ++k) {
    const int row = threadIdx.x + k * p.ta;
    if (k >= p.rpt || row >= p.mr) continue;
#pragma unroll
    for (int c = 0; c < W2; ++c) {
      p.a[static_cast<int64_t>(gcol(c, p.w, bp, bq)) * p.ldg + row0 + row] =
          x[k][c];
    }
  }
}

// out[c·ldo + r] ← J[r][c] for this J thread's row r (< 2w).
template <typename T, int W2>
__device__ __forceinline__ void push_j(const Args<T>& p,
                                       const T (&x)[Cfg<T, W2>::kRpt][W2],
                                       T* out, int ldo) {
  const int row = threadIdx.x - p.ta;
  if (row >= W2) return;
#pragma unroll
  for (int c = 0; c < W2; ++c) out[static_cast<int64_t>(c) * ldo + row] = x[0][c];
}

// V_pq ← V_pq·J for the n2 rows of V, with V_pq staged in T (column k at
// T + k·ld) and J column-major (J[r][c] at J + c·2w + r).  Each warp computes
// 64-row × 8-column tiles, two rows and eight columns a thread.
template <typename T>
__device__ void update_v(const Args<T>& p, const T* Vs, const T* J, int bp,
                         int bq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // A multiple of four warps, so that each SM sub-partition gets its share.
  const int warps = blockDim.x >= 128 ? (blockDim.x >> 7) << 2 : blockDim.x >> 5;
  if (warp >= warps) return;
  const int w2 = 2 * p.w, n2 = 2 * p.w * p.P;
  const int nrb = (n2 + 63) / 64, ncb = (w2 + 7) / 8;
  for (int item = warp; item < nrb * ncb; item += warps) {
    const int r0 = (item % nrb) * 64 + lane, r1 = r0 + 32;
    const int c0 = (item / nrb) * 8;
    T acc0[8], acc1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc0[j] = acc1[j] = T(0);
    for (int k = 0; k < w2; k += 2) {
      const T* tk = Vs + static_cast<int64_t>(k) * p.ld;
      const T t00 = r0 < n2 ? tk[r0] : T(0);
      const T t01 = r0 < n2 ? tk[p.ld + r0] : T(0);
      const T t10 = r1 < n2 ? tk[r1] : T(0);
      const T t11 = r1 < n2 ? tk[p.ld + r1] : T(0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c0 + j < w2) {
          const auto jk = *reinterpret_cast<const typename Elem<T>::Vec2*>(
              J + (c0 + j) * w2 + k);
          acc0[j] = fmadd(t01, jk.y, fmadd(t00, jk.x, acc0[j]));
          acc1[j] = fmadd(t11, jk.y, fmadd(t10, jk.x, acc1[j]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < w2) {
        T* out = p.v + static_cast<int64_t>(gcol(c0 + j, p.w, bp, bq)) * n2;
        if (r0 < n2) out[r0] = acc0[j];
        if (r1 < n2) out[r1] = acc1[j];
      }
    }
  }
}

template <typename T, int W2>
__global__ void __launch_bounds__(kMaxThreads, 1)
block_jacobi_kernel(Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __shared__ T bcast;
  using Vec2 = typename Elem<T>::Vec2;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n2 = W2 * p.P;
  const int pair_i = blockIdx.x / p.R, r = blockIdx.x % p.R;
  const int row0 = r * p.mr;
  const bool panel = tid < p.ta;
  // Shared memory: the block pair (or V_pq) S, J, the rotations, the warps'
  // partial dot products.
  T* S = reinterpret_cast<T*>(smem_bytes);
  T* J = S + static_cast<int64_t>(p.ld) * W2;
  Vec2* cs = reinterpret_cast<Vec2*>(J + W2 * W2);
  T* red = J + W2 * W2 + (blockDim.x / 32) * W2;
  T x[Cfg<T, W2>::kRpt][W2];
  T off = INFINITY;
  int ks = 0;  // inner steps run, for the parity of the cross-CTA scratch

  if (p.P == 1) {
    // Resident: the panel's rows and J = V stay on chip throughout.
    load_input(p, S, 0, 1, row0);
    __syncthreads();
    pull<T, W2>(p, S, panel, x);
    for (int sweep = 0; sweep < p.max_sweeps; ++sweep) {
      T apq_max = T(0), nrm_max = T(0);
      inner_sweep<T, W2>(p, x, panel, cs, red, apq_max, nrm_max, ks, grid);
      if (warp == 0) {
        apq_max = warp_max(apq_max);
        nrm_max = warp_max(nrm_max);
        if (tid == 0) bcast = apq_max / (nrm_max > T(0) ? nrm_max : T(1));
      }
      __syncthreads();
      off = bcast;
      if (off <= p.tol) break;
    }
    if (panel) {
      push_a<T, W2>(p, x, 0, 1, row0);
    } else if (r == 0) {
      push_j<T, W2>(p, x, p.v, n2);
    }
  } else {
    // Each CTA's maxima of each outer step, by the parity of the sweep;
    // read once a sweep, after its last grid barrier.
    T* maxima = p.part + static_cast<int64_t>(6) * p.w * p.P * p.R;
    const int nctas = gridDim.x, steps = 2 * p.P - 1;
    if (p.max_sweeps == 0) {
      // Nothing rotates: A is the padded input and V the identity.  The
      // first outer step's pairs cover every block once.
      int bp, bq;
      rr_pair(2 * p.P, 0, pair_i, bp, bq);
      load_input(p, S, bp, bq, row0);
      __syncthreads();
      store_a(p, S, bp, bq, row0);
      for (int c = 0; c < W2; ++c) {
        const int col = gcol(c, p.w, bp, bq);
        for (int row = tid; row < n2; row += blockDim.x) {
          p.v[static_cast<int64_t>(col) * n2 + row] = row == col ? T(1) : T(0);
        }
      }
    }
    for (int sweep = 0; sweep < p.max_sweeps; ++sweep) {
      T* mine = maxima + static_cast<int64_t>(sweep & 1) * steps * nctas * 2;
      for (int t = 0; t < steps; ++t) {
        const bool first = sweep == 0 && t == 0;
        int bp, bq;
        rr_pair(2 * p.P, t, pair_i, bp, bq);
        if (first) {
          load_input(p, S, bp, bq, row0);
        } else {
          load_async(p, S, p.a, p.ldg, bp, bq, row0, p.mr, tid, blockDim.x);
          cp_async_wait_all();
        }
        __syncthreads();
        pull<T, W2>(p, S, panel, x);
        __syncthreads();
        // V_pq streams into S during the inner sweep, copied by the J warps
        // while the panel warps form the first dot products (V starts as the
        // identity, which is not stored).  Of the pair's R CTAs, which all
        // form the same J, row group 0 updates V.
        const bool owns_v = r == 0;
        if (!first && !panel && owns_v) {
          load_async(p, S, p.v, n2, bp, bq, 0, n2, tid - p.ta, p.tj);
        }
        T apq_max = T(0), nrm_max = T(0);
        inner_sweep<T, W2>(p, x, panel, cs, red, apq_max, nrm_max, ks, grid);
        if (panel) {
          push_a<T, W2>(p, x, bp, bq, row0);
        } else {
          push_j<T, W2>(p, x, J, W2);
        }
        if (first && owns_v) {
          for (int c = 0; c < W2; ++c) {
            const int col = gcol(c, p.w, bp, bq);
            for (int row = tid; row < n2; row += blockDim.x) {
              S[static_cast<int64_t>(c) * p.ld + row] = row == col ? T(1) : T(0);
            }
          }
        }
        cp_async_wait_all();
        __syncthreads();
        if (owns_v) update_v(p, S, J, bp, bq);
        if (warp == 0) {
          apq_max = warp_max(apq_max);
          nrm_max = warp_max(nrm_max);
          if (tid == 0) {
            T* slot = mine + (static_cast<int64_t>(t) * nctas + blockIdx.x) * 2;
            slot[0] = apq_max;
            slot[1] = nrm_max;
          }
        }
        grid.sync();
      }
      if (warp == 0) {
        T off_sweep = T(0);
        for (int t = 0; t < steps; ++t) {
          const T* slot = mine + static_cast<int64_t>(t) * nctas * 2;
          T mx = T(0), my = T(0);
          for (int i = tid; i < nctas; i += 32) {
            mx = max_nan(mx, __ldcg(slot + 2 * i));
            my = max_nan(my, __ldcg(slot + 2 * i + 1));
          }
          mx = warp_max(mx);
          my = warp_max(my);
          off_sweep = max_nan(off_sweep, mx / (my > T(0) ? my : T(1)));
        }
        if (tid == 0) bcast = off_sweep;
      }
      __syncthreads();
      off = bcast;
      if (off <= p.tol) break;
    }
  }
  if (blockIdx.x == 0 && tid == 0) p.off_out[0] = off;
}

template <typename T>
using KernelFn = void (*)(Args<T>);

template <typename T, int... I>
constexpr auto kernel_table(std::integer_sequence<int, I...>) {
  struct Table {
    KernelFn<T> fn[sizeof...(I)];
    int rpt[sizeof...(I)];
  };
  return Table{{&block_jacobi_kernel<T, 2 * (I + 1)>...},
               {Cfg<T, 2 * (I + 1)>::kRpt...}};
}

// Entry i is the kernel for a block pair of 2(i + 1) columns.
template <typename T>
const auto kKernels =
    kernel_table<T>(std::make_integer_sequence<int, kMaxW2 / 2>{});

// Per device: SMs, the largest dynamic shared memory a CTA may opt into, and
// which instantiations have opted in.
struct DeviceLimits {
  int sms = 0;
  size_t max_dyn_smem = 0;
  bool opted[kMaxW2 / 2] = {};
};

template <typename T>
cudaError_t device_limits(int device, int wi, DeviceLimits& out) {
  static DeviceLimits cache[kMaxDevices];
  DeviceLimits local;
  DeviceLimits& lim =
      device >= 0 && device < kMaxDevices ? cache[device] : local;
  cudaError_t err = cudaSuccess;
  if (lim.sms == 0) {
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&lim.sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return err;
    // The kernels' static shared memory (one element) stays out of this.
    lim.max_dyn_smem = static_cast<size_t>(max_smem) - 1024;
  }
  if (!lim.opted[wi]) {
    err = cudaFuncSetAttribute(kKernels<T>.fn[wi],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(lim.max_dyn_smem));
    if (err != cudaSuccess) return err;
    lim.opted[wi] = true;
  }
  out = lim;
  return cudaSuccess;
}

// at: n×m row-major (row j = column j of A).  Block plan from the wrapper:
// block width w ≤ 24, P block pairs, R row groups of mr rows (mr even,
// R·mr ≥ m), rpt rows a thread, ta threads of panel rows and tj of J rows
// (multiples of 32, ta·rpt ≥ mr, tj ≥ 2w, rpt within the instantiation's rows
// and ta + tj ≤ 256).  a_work: n2 × (R·mr) and v_work: n2 × n2 row-major (row
// j = column j of the rotated panel and of V), n2 = 2·w·P ≥ n.  scratch: at
// least 6·w·P·R + 4·(2P−1)·P·R elements.  off: 1 element.  Returns a
// cudaError_t: invalid values for a plan that breaks these rules or does not
// fit shared memory, cudaErrorCooperativeLaunchTooLarge for a grid that cannot
// be co-resident.
template <typename T>
int launch_block_jacobi(const void* at, void* a_work, void* v_work, void* off,
                        void* scratch, int m, int n, int w, int P, int R,
                        int mr, int rpt, int ta, int tj, int max_sweeps,
                        T eps, T tol, void* stream) {
  const int64_t n2 = 2LL * w * P;
  const int wi = w - 1;
  if (m < n || n < 2 || w < 1 || 2 * w > kMaxW2 || P < 1 || R < 1 ||
      n2 < n || n2 > 1024 || mr < 2 || (mr & 1) ||
      static_cast<int64_t>(mr) * R < m || max_sweeps < 0 ||
      rpt < 1 || rpt > kKernels<T>.rpt[wi] || ta < 32 ||
      tj < 32 || (ta & 31) || (tj & 31) ||
      ta + tj > kMaxThreads ||
      static_cast<int64_t>(ta) * rpt < mr || tj < 2 * w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ld64 = P == 1 ? mr : (mr > n2 ? mr : n2);
  const int ld = static_cast<int>(ld64);
  // S, J, each warp's rotations, the panel warps' partial sums (two steps).
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(ld) * 2 * w +
                   static_cast<size_t>(4) * w * w +
                   static_cast<size_t>(2) * w * ((ta + tj) / 32) +
                   static_cast<size_t>(6) * w * (ta / 32));
  int device = 0;
  DeviceLimits lim;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = device_limits<T>(device, wi, lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > lim.max_dyn_smem) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kKernels<T>.fn[wi], ta + tj, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(per_sm) * lim.sms < static_cast<int64_t>(P) * R) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  Args<T> args{static_cast<const T*>(at), static_cast<T*>(a_work),
               static_cast<T*>(v_work), static_cast<T*>(off),
               static_cast<T*>(scratch), m, n, w, P, R, mr, ld,
               mr * R, max_sweeps, rpt, ta, tj, eps, tol};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kKernels<T>.fn[wi]), dim3(P * R),
      dim3(ta + tj), params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
