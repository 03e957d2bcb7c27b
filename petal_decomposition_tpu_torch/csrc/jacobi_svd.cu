// K2: one-sided Jacobi SVD of an m×n float32 panel, the float32 instance of
// the block Jacobi in jacobi_block.cuh (design and bounds there).
//
// Replaces: petal_decomposition_tpu/ops/pallas/jacobi_kernels.py:_svd_kernel
// (called through _jacobi_svd_vmem / jacobi_svd_vmem), the TPU kernel that
// keeps the whole panel in VMEM and runs every rotation step and sweep in
// one invocation.  Its constants: skip at FLT_EPSILON·√(app·aqq), stop at
// FLT_EPSILON·√max(m, n_pad), passed in by the wrapper.  IEEE float32 FMA on
// the CUDA cores throughout: the dot products decide convergence, and TF32
// or bf16 products would stall it near 1e-3.

#include "jacobi_block.cuh"

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The arguments of launch_block_jacobi (jacobi_block.cuh), in float32.
int petal_jacobi_svd_f32(const void* at, void* a_work, void* v_work,
                         void* off, void* scratch, int m, int n, int w, int P,
                         int R, int mr, int rpt, int ta, int tj,
                         int max_sweeps, float eps, float tol, void* stream) {
  return launch_block_jacobi<float>(at, a_work, v_work, off, scratch, m, n, w,
                                    P, R, mr, rpt, ta, tj, max_sweeps, eps,
                                    tol, stream);
}

}  // extern "C"
