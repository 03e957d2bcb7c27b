// Fused sketch + moments pass: Y = X·W, colsum = Σᵢ X[i,:], sqnorm = ‖X‖²_F
// in one read of X.
//
// Replaces: petal_decomposition_tpu/ops/pallas/sketch_kernel.py:_kernel
// (called through _call_kernel / fused_sketch_moments_on), the TPU kernel
// of the Gram range finder's data-side recovery.
//
// What bounds it on an H100: reading X.  At the flagship (X 1M×1024 f32,
// W 1024×42) that is 4.2 GB, about 1.3 ms at 3.35 TB/s; the product is
// 86 GFLOP, about 1.3 ms at the 67 TFLOP/s float32 (non-tensor) peak, so
// the two bounds are close and the kernel needs both a full memory stream
// and dense FMA throughput.
//
// Design (a simple kernel that is right first):
// * A block owns strips of BM = 128 rows (grid-stride over strips).  The
//   strip is walked in d-tiles of TD = 32 columns: each tile of X and the
//   matching TD×LC slice of W go through shared memory, and every thread
//   accumulates an 8-row × CT-column register tile of Y in float32 FMA
//   (IEEE float32: at least the TPU kernel's bf16×3 grade; one bf16 pass
//   was measured too coarse there, sketch_kernel.py:79-86).
// * The column sums and ‖X‖² are taken from the same loaded values, so X
//   is read once.  Each thread of a warp loads one column of the tile
//   (lane = column), which keeps the loads coalesced and gives each lane a
//   partial column sum with no shuffles.
// * Blocks run in parallel with no carried state (the TPU kernel's
//   sequential pl.when(i == 0) accumulation): each block writes per-block
//   partial column sums and ‖X‖² in float64 to scratch, and a second,
//   deterministic pass sums them in float64 and casts to float32.  No float
//   atomics, so the result does not depend on block scheduling.
// * Rows ≥ n and columns ≥ d of the ragged edge are zero by bounds checks.
// * Panels wider than LC = 64 columns are walked in column chunks; X is
//   then re-read per chunk (from L2 while the strip is hot).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps; 16×16 thread grid for the Y tile
constexpr int kBM = 128;       // rows per strip
constexpr int kTD = 32;        // X/W depth tile (one warp-wide row segment)
constexpr int kRM = kBM / 16;  // Y rows per thread

template <int CT>
__global__ void __launch_bounds__(kThreads)
sketch_moments_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, double* __restrict__ cs_part,
                      double* __restrict__ sq_part, int64_t n, int d, int l,
                      int64_t n_strips) {
  constexpr int kLC = 16 * CT;  // Y columns per chunk
  __shared__ float xs[kBM][kTD + 1];
  __shared__ float ws[kTD][kLC];
  __shared__ float red[kThreads / 32][32];
  __shared__ double sq_red[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_chunks = (l + kLC - 1) / kLC;
  double* my_cs = cs_part + static_cast<int64_t>(blockIdx.x) * d;
  double sq_acc = 0.0;

  for (int64_t strip = blockIdx.x; strip < n_strips; strip += gridDim.x) {
    const int64_t row0 = strip * kBM;
    const bool first_strip = strip == blockIdx.x;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int c0 = chunk * kLC;
      float acc[kRM][CT];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < d; k0 += kTD) {
        const int kk = k0 + lane;
        float cs_local = 0.f;
        float sq_local = 0.f;
#pragma unroll
        for (int i = 0; i < kBM / 8; ++i) {
          const int r = warp + 8 * i;
          const int64_t gr = row0 + r;
          float val = 0.f;
          if (gr < n && kk < d) val = x[gr * d + kk];
          xs[r][lane] = val;
          cs_local += val;
          sq_local = fmaf(val, val, sq_local);
        }
        for (int e = tid; e < kTD * kLC; e += kThreads) {
          const int kr = e / kLC;
          const int c = e - kr * kLC;
          const int gk = k0 + kr;
          const int gc = c0 + c;
          ws[kr][c] = (gk < d && gc < l)
                          ? w[static_cast<int64_t>(gk) * l + gc] : 0.f;
        }
        if (chunk == 0) {
          red[warp][lane] = cs_local;
          sq_acc += static_cast<double>(sq_local);
        }
        __syncthreads();
        if (chunk == 0 && warp == 0 && kk < d) {
          // Column kk is always finished by this same thread, so the
          // read-modify-write of the block's partial needs no atomics.
          double s = 0.0;
#pragma unroll
          for (int wi = 0; wi < kThreads / 32; ++wi) s += red[wi][lane];
          my_cs[kk] = first_strip ? s : my_cs[kk] + s;
        }
#pragma unroll 8
        for (int k = 0; k < kTD; ++k) {
          float b[CT];
#pragma unroll
          for (int j = 0; j < CT; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const float a = xs[ty + 16 * i][k];
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int64_t gr = row0 + ty + 16 * i;
        if (gr >= n) continue;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int gc = c0 + tx + 16 * j;
          if (gc < l) y[gr * l + gc] = acc[i][j];
        }
      }
    }
  }

  // Deterministic block reduction of ‖X‖² (fixed shuffle tree, then warps
  // in order).
  double v = sq_acc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) sq_red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < kThreads / 32; ++i) s += sq_red[i];
    sq_part[blockIdx.x] = s;
  }
}

// Second pass: sum the per-block partials in float64, in block order.
__global__ void moments_finish_kernel(const double* __restrict__ cs_part,
                                      const double* __restrict__ sq_part,
                                      float* __restrict__ colsum,
                                      float* __restrict__ sqnorm, int d,
                                      int n_blocks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < d) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += cs_part[static_cast<int64_t>(b) * d + c];
    colsum[c] = static_cast<float>(s);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += sq_part[b];
    sqnorm[0] = static_cast<float>(s);
  }
}

template <int CT>
void launch(const float* x, const float* w, float* y, double* cs_part,
            double* sq_part, int64_t n, int d, int l, int64_t n_strips,
            int grid, cudaStream_t stream) {
  sketch_moments_kernel<CT><<<grid, kThreads, 0, stream>>>(
      x, w, y, cs_part, sq_part, n, d, l, n_strips);
}

}  // namespace

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int petal_sketch_rows_per_strip() { return kBM; }

// X (n×d), W (d×l), Y (n×l): row-major float32 on the device.  cs_part is
// grid×d float64 and sq_part grid float64 scratch; grid must not exceed
// ceil(n / rows_per_strip).  colsum (d) and sqnorm (1) are float32 outputs.
int petal_sketch_moments_f32(const void* x, const void* w, void* y,
                             void* cs_part, void* sq_part, void* colsum,
                             void* sqnorm, int64_t n, int d, int l, int grid,
                             void* stream) {
  const int64_t n_strips = (n + kBM - 1) / kBM;
  if (n < 1 || d < 1 || l < 1 || grid < 1 || grid > n_strips) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* yf = static_cast<float*>(y);
  auto* csp = static_cast<double*>(cs_part);
  auto* sqp = static_cast<double*>(sq_part);
  // Column micro-tile: the narrowest of 16·CT ≥ l, CT ≤ 4 (chunks beyond).
  const int ct = l <= 16 ? 1 : l <= 32 ? 2 : l <= 48 ? 3 : 4;
  switch (ct) {
    case 1: launch<1>(xf, wf, yf, csp, sqp, n, d, l, n_strips, grid, s); break;
    case 2: launch<2>(xf, wf, yf, csp, sqp, n, d, l, n_strips, grid, s); break;
    case 3: launch<3>(xf, wf, yf, csp, sqp, n, d, l, n_strips, grid, s); break;
    default: launch<4>(xf, wf, yf, csp, sqp, n, d, l, n_strips, grid, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_finish_kernel<<<(d + 255) / 256, 256, 0, s>>>(
      csp, sqp, static_cast<float*>(colsum), static_cast<float*>(sqnorm), d,
      grid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
