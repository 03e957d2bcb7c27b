// One-sided Jacobi SVD of an m×n float32 panel in one launch of one block.
//
// Replaces: petal_decomposition_tpu/ops/pallas/jacobi_kernels.py:_svd_kernel
// (called through _jacobi_svd_vmem / jacobi_svd_vmem), the TPU kernel that
// keeps the whole panel in VMEM and runs every rotation step and sweep in
// one invocation.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A sweep is n−1
// dependent steps; each step reduces and rotates n/2 column pairs and must
// finish before the next step reads them.  At the flagship panel (Bᵀ,
// 1024×43 → 44 columns) a step is ~0.2 MFLOP, so the time is the chain of
// steps × (warp reduction + block barrier).
//
// Design:
// * The whole panel lives in one block's dynamic shared memory: at the
//   flagship 1024×44 f32 = 180 KB plus V 44×44 = 7.7 KB, which fits under
//   the 227 KB a block may use only after cudaFuncSetAttribute(
//   MaxDynamicSharedMemorySize).  No step touches device memory.
// * Each matrix column is contiguous (the panel is stored column-major).
//   The caller passes Aᵀ row-major, which for the randomized fit is the
//   projected panel B itself (B's rows are Bᵀ's columns): no transpose copy.
// * One warp per column pair: app/aqq/apq are lane-strided dot products
//   finished by an xor-shuffle tree, which leaves the identical sum in every
//   lane, so all lanes derive the same rotation with no shared memory.
// * The circle-method pairing comes from an index table the wrapper builds
//   (the JAX kernel's _tournament_perms), read per step.  Columns stay in
//   place; the TPU kernel's physical column shuffle becomes this relabeling,
//   which after n−1 steps is the identity again.
// * Same rotation, skip rule (|apq| ≤ eps·√(app·aqq)) and norm-wise
//   convergence measure as the TPU kernel: off is reset every sweep, is the
//   max over steps of max|apq| / max(app, aqq), and sweeps stop once
//   off ≤ tol.  The per-pair values for that measure are double-buffered by
//   step parity, so a step needs one barrier.  The maxima propagate NaN, so a
//   non-finite panel cannot report convergence.
// * An odd n gets a zero column in shared memory only: a zero column never
//   rotates, so the outputs hold just the n real columns.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max that propagates NaN (fmaxf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__global__ void __launch_bounds__(kThreads, 1)
jacobi_svd_kernel(const float* __restrict__ at, float* __restrict__ arot_t,
                  float* __restrict__ v_t, float* __restrict__ off_out,
                  const int* __restrict__ pairs, int m, int n, int n_pad,
                  int max_sweeps, float tol) {
  extern __shared__ float smem[];
  float* a = smem;                                   // n_pad columns × m
  float* v = a + static_cast<int64_t>(n_pad) * m;    // n_pad columns × n_pad
  float* pair_off = v + n_pad * n_pad;               // [2][h]: |apq|
  float* pair_nrm = pair_off + n_pad;                // [2][h]: max(app, aqq)
  __shared__ float s_off;
  __shared__ int s_done;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = n_pad / 2;
  const int64_t n_real = static_cast<int64_t>(n) * m;
  const int64_t n_all = static_cast<int64_t>(n_pad) * m;

  for (int64_t i = tid; i < n_all; i += kThreads) a[i] = i < n_real ? at[i] : 0.f;
  for (int i = tid; i < n_pad * n_pad; i += kThreads) {
    v[i] = (i / n_pad == i % n_pad) ? 1.f : 0.f;
  }
  if (tid == 0) {
    s_off = INFINITY;
    s_done = 0;
  }
  __syncthreads();

  const float eps = FLT_EPSILON;
  for (int sweep = 0; sweep < max_sweeps && !s_done; ++sweep) {
    float off = 0.f;  // tracked by thread 0
    for (int step = 0; step < n_pad - 1; ++step) {
      const int* pq = pairs + static_cast<int64_t>(step) * n_pad;
      const int buf = (step & 1) * h;
      for (int i = warp; i < h; i += kWarps) {
        const int p = pq[i];
        const int q = pq[h + i];
        float* ap = a + static_cast<int64_t>(p) * m;
        float* aq = a + static_cast<int64_t>(q) * m;
        float app = 0.f, aqq = 0.f, apq = 0.f;
        for (int r = lane; r < m; r += 32) {
          const float xp = ap[r], xq = aq[r];
          app = fmaf(xp, xp, app);
          aqq = fmaf(xq, xq, aqq);
          apq = fmaf(xp, xq, apq);
        }
        app = warp_sum(app);
        aqq = warp_sum(aqq);
        apq = warp_sum(apq);
        const float abs_pq = fabsf(apq);
        const bool skip = abs_pq <= eps * sqrtf(app * aqq);
        if (lane == 0) {
          pair_off[buf + i] = abs_pq;
          pair_nrm[buf + i] = max_nan(app, aqq);
        }
        if (skip) continue;  // c = 1, s = 0: the identity
        const float sgn = apq >= 0.f ? 1.f : -1.f;
        const float tau = (aqq - app) / (2.f * abs_pq);
        const float sign_tau = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : 0.f);
        float t = sign_tau / (fabsf(tau) + sqrtf(1.f + tau * tau));
        if (tau == 0.f) t = 1.f;
        t *= sgn;
        const float c = 1.f / sqrtf(1.f + t * t);
        const float s = c * t;
        for (int r = lane; r < m; r += 32) {
          const float xp = ap[r], xq = aq[r];
          ap[r] = c * xp - s * xq;
          aq[r] = s * xp + c * xq;
        }
        float* vp = v + p * n_pad;
        float* vq = v + q * n_pad;
        for (int r = lane; r < n_pad; r += 32) {
          const float xp = vp[r], xq = vq[r];
          vp[r] = c * xp - s * xq;
          vq[r] = s * xp + c * xq;
        }
      }
      __syncthreads();
      if (tid == 0) {
        float nrm = 0.f, opq = 0.f;
        for (int i = 0; i < h; ++i) {
          nrm = max_nan(nrm, pair_nrm[buf + i]);
          opq = max_nan(opq, pair_off[buf + i]);
        }
        off = max_nan(off, opq / (nrm > 0.f ? nrm : 1.f));
      }
    }
    if (tid == 0) {
      s_off = off;
      s_done = off <= tol;
    }
    __syncthreads();
  }

  for (int64_t i = tid; i < n_real; i += kThreads) arot_t[i] = a[i];
  for (int i = tid; i < n * n; i += kThreads) {
    v_t[i] = v[(i / n) * n_pad + i % n];
  }
  if (tid == 0) off_out[0] = s_off;
}

}  // namespace

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Dynamic shared memory the kernel needs for an m×n panel, in bytes.
int64_t petal_jacobi_smem_bytes(int m, int n) {
  const int64_t n_pad = n + (n & 1);
  return static_cast<int64_t>(sizeof(float)) * (n_pad * m + n_pad * n_pad + 2 * n_pad);
}

// at: n×m row-major (row j = column j of A); arot_t: n×m and v_t: n×n
// row-major outputs (row j = column j of A·V and of V); off: 1 float;
// pairs: (n_pad−1)×n_pad int32, step s pairs pairs[s][i] with pairs[s][h+i].
int petal_jacobi_svd_f32(const void* at, void* arot_t, void* v_t, void* off,
                         const void* pairs, int m, int n, int max_sweeps,
                         float tol, void* stream) {
  if (m < 1 || n < 2 || max_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_pad = n + (n & 1);
  const int64_t smem = petal_jacobi_smem_bytes(m, n);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_svd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  jacobi_svd_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(at), static_cast<float*>(arot_t),
      static_cast<float*>(v_t), static_cast<float*>(off),
      static_cast<const int*>(pairs), m, n, n_pad, max_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
