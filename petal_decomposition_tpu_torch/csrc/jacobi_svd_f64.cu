// One-sided Jacobi SVD of an m×n float64 panel in one launch of one block.
//
// Replaces: petal_decomposition_tpu/ops/pallas/jacobi_f64_kernel.py:_svd_kernel
// (called through _jacobi_svd_vmem_f64 / jacobi_svd_vmem_f64).  A TPU has no
// native f64 vector arithmetic, so that kernel carries every value as an f32
// (hi, lo) pair (ops/pallas/df64.py) at a unit roundoff of ~2^-48.  Hopper has
// native f64 FMA, so this is the f32 kernel of jacobi_svd.cu at double
// precision, with the TPU kernel's constants (skip at 2^-48, stop at
// 2^-46·√max(m, n_pad)); the (hi, lo) arithmetic is not ported.
//
// What bounds it on an H100: latency.  A sweep is n_pad−1 dependent steps;
// each step reduces and rotates n_pad/2 column pairs and must finish before
// the next step reads them.  Unlike K2, the panels this kernel serves do not
// fit a block's 227 KB of shared memory (Bᵀ of the f64 randomized fit,
// 1024×42 = 344 KB; a 1000×64 panel, 512 KB; the 256×256 R factor of a tall
// QR, 512 KB plus 512 KB of V), so each step's loads come from L1/L2.
//
// Design:
// * The panel and V live in device memory, in work buffers the wrapper
//   allocates, column-major (each column contiguous, as K2's Aᵀ layout).  The
//   kernel copies the input in, pads an odd n with one zero column, and
//   rotates in place; a zero column never rotates, so it is never written.
//   The launch asks for the largest L1 carve-out: the kernel's own shared
//   memory is 8 KB, and the panel stays resident in L1 and the 50 MB L2.
// * Each step ends in __syncthreads(), which orders the block's device-memory
//   writes (the rotated columns, and the per-pair values of the convergence
//   measure) before any thread's reads in the next step.
// * One warp per column pair: app/aqq/apq are lane-strided dot products
//   finished by an xor-shuffle tree, which leaves the identical sum in every
//   lane, so all lanes derive the same rotation.  Pairs are disjoint within a
//   step (the circle-method table of the wrapper, K2's pair_table), so no two
//   warps touch one column.
// * Same rotation, skip rule (|apq| ≤ eps·√(app·aqq), which also turns a zero
//   or rank-deficient column into the identity instead of a NaN) and
//   norm-wise convergence measure as the TPU kernel: off is reset every
//   sweep, is the max over steps of max|apq| / max(app, aqq), and sweeps stop
//   once off ≤ tol.  The per-pair values are double-buffered by step parity,
//   so a step needs one barrier; warp 0 reduces them after it.  The maxima
//   propagate NaN, so a non-finite panel cannot report convergence.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 256;  // n_pad ≤ 512, as the wrapper's supports()

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max that propagates NaN (fmax would drop it).
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
jacobi_svd_f64_kernel(const double* __restrict__ at, double* __restrict__ a,
                      double* __restrict__ v, double* __restrict__ off_out,
                      const int* __restrict__ pairs, int m, int n, int n_pad,
                      int max_sweeps, double eps, double tol) {
  __shared__ double pair_off[2][kMaxPairs];  // |apq| per pair
  __shared__ double pair_nrm[2][kMaxPairs];  // max(app, aqq) per pair
  __shared__ double s_off;
  __shared__ int s_done;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = n_pad / 2;
  const int64_t n_real = static_cast<int64_t>(n) * m;
  const int64_t n_all = static_cast<int64_t>(n_pad) * m;
  const int64_t v_all = static_cast<int64_t>(n_pad) * n_pad;

  for (int64_t i = tid; i < n_all; i += kThreads) a[i] = i < n_real ? at[i] : 0.0;
  for (int64_t i = tid; i < v_all; i += kThreads) {
    v[i] = (i / n_pad == i % n_pad) ? 1.0 : 0.0;
  }
  if (tid == 0) {
    s_off = INFINITY;
    s_done = 0;
  }
  __syncthreads();

  for (int sweep = 0; sweep < max_sweeps && !s_done; ++sweep) {
    double off = 0.0;  // tracked by warp 0, identical in its lanes
    for (int step = 0; step < n_pad - 1; ++step) {
      const int* pq = pairs + static_cast<int64_t>(step) * n_pad;
      const int buf = step & 1;
      for (int i = warp; i < h; i += kWarps) {
        const int p = pq[i];
        const int q = pq[h + i];
        double* ap = a + static_cast<int64_t>(p) * m;
        double* aq = a + static_cast<int64_t>(q) * m;
        double app = 0.0, aqq = 0.0, apq = 0.0;
        for (int r = lane; r < m; r += 32) {
          const double xp = ap[r], xq = aq[r];
          app = fma(xp, xp, app);
          aqq = fma(xq, xq, aqq);
          apq = fma(xp, xq, apq);
        }
        app = warp_sum(app);
        aqq = warp_sum(aqq);
        apq = warp_sum(apq);
        const double abs_pq = fabs(apq);
        const bool skip = abs_pq <= eps * sqrt(app * aqq);
        if (lane == 0) {
          pair_off[buf][i] = abs_pq;
          pair_nrm[buf][i] = max_nan(app, aqq);
        }
        if (skip) continue;  // c = 1, s = 0: the identity
        const double sgn = apq >= 0.0 ? 1.0 : -1.0;
        const double tau = (aqq - app) / (2.0 * abs_pq);
        const double sign_tau = tau > 0.0 ? 1.0 : (tau < 0.0 ? -1.0 : 0.0);
        double t = sign_tau / (fabs(tau) + sqrt(1.0 + tau * tau));
        if (tau == 0.0) t = 1.0;
        t *= sgn;
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double s = c * t;
        for (int r = lane; r < m; r += 32) {
          const double xp = ap[r], xq = aq[r];
          ap[r] = c * xp - s * xq;
          aq[r] = s * xp + c * xq;
        }
        double* vp = v + static_cast<int64_t>(p) * n_pad;
        double* vq = v + static_cast<int64_t>(q) * n_pad;
        for (int r = lane; r < n_pad; r += 32) {
          const double xp = vp[r], xq = vq[r];
          vp[r] = c * xp - s * xq;
          vq[r] = s * xp + c * xq;
        }
      }
      __syncthreads();
      if (warp == 0) {
        double nrm = 0.0, opq = 0.0;
        for (int i = lane; i < h; i += 32) {
          nrm = max_nan(nrm, pair_nrm[buf][i]);
          opq = max_nan(opq, pair_off[buf][i]);
        }
        nrm = warp_max(nrm);
        opq = warp_max(opq);
        off = max_nan(off, opq / (nrm > 0.0 ? nrm : 1.0));
      }
    }
    if (tid == 0) {
      s_off = off;
      s_done = off <= tol;
    }
    __syncthreads();
  }
  if (tid == 0) off_out[0] = s_off;
}

}  // namespace

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// at: n×m row-major (row j = column j of A).  a_work: n_pad×m and v_work:
// n_pad×n_pad row-major (row j = column j of the rotated panel and of V),
// filled by the kernel; n_pad = n + (n odd).  off: 1 double.  pairs:
// (n_pad−1)×n_pad int32, step s pairs pairs[s][i] with pairs[s][h+i].
int petal_jacobi_svd_f64(const void* at, void* a_work, void* v_work, void* off,
                         const void* pairs, int m, int n, int max_sweeps,
                         double eps, double tol, void* stream) {
  const int n_pad = n + (n & 1);
  if (m < n || n < 2 || n_pad > 2 * kMaxPairs || max_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_svd_f64_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxL1));
  if (err != cudaSuccess) return static_cast<int>(err);
  jacobi_svd_f64_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(at), static_cast<double*>(a_work),
      static_cast<double*>(v_work), static_cast<double*>(off),
      static_cast<const int*>(pairs), m, n, n_pad, max_sweeps, eps, tol);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
