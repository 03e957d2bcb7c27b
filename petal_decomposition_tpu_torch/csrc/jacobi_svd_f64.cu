// K3: one-sided Jacobi SVD of an m×n float64 panel, the float64 instance of
// the block Jacobi in jacobi_block.cuh (design and bounds there).
//
// Replaces: petal_decomposition_tpu/ops/pallas/jacobi_f64_kernel.py:_svd_kernel
// (called through _jacobi_svd_vmem_f64 / jacobi_svd_vmem_f64).  A TPU has no
// native f64 vector arithmetic, so that kernel carries every value as an f32
// (hi, lo) pair (ops/pallas/df64.py) at a unit roundoff of ~2^-48 and keeps the
// whole panel in VMEM.  Hopper has native f64 FMA, so the (hi, lo) arithmetic
// is not ported; the TPU kernel's constants are (skip at 2^-48·√(app·aqq), stop
// at 2^-46·√max(m, n_pad)), passed in by the wrapper.

#include "jacobi_block.cuh"

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The arguments of launch_block_jacobi (jacobi_block.cuh), in float64.
int petal_jacobi_svd_f64(const void* at, void* a_work, void* v_work,
                         void* off, void* scratch, int m, int n, int w, int P,
                         int R, int mr, int rpt, int ta, int tj,
                         int max_sweeps, double eps, double tol,
                         void* stream) {
  return launch_block_jacobi<double>(at, a_work, v_work, off, scratch, m, n, w,
                                     P, R, mr, rpt, ta, tj, max_sweeps, eps,
                                     tol, stream);
}

}  // extern "C"
