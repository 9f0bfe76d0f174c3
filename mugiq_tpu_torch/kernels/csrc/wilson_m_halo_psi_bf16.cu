// K7a, bf16 spinors, one site a thread (an odd X or a base not two words
// aligned; the bf16 Krylov basis under --mesh; the output bf16,
// as the TPU kernels' out_shape): the C entry point over wilson_m_halo.cuh
// (the kernel, its layouts and design notes are there), M and M^dag,
// Wilson and clover.

#include "wilson_m_halo.cuh"

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_wilson_m_halo_psi_bf16(const void* psi_ext, const void* U,
                                            const void* Ut, const void* A, void* out,
                                            int Zl, int Yl, int X, int t0, int nrows,
                                            int tstep, int ext, float kappa, int dagger,
                                            int clover, int link_bf16, void* stream) {
  return wilson_m_halo_entry<1, __nv_bfloat16>(psi_ext, U, Ut, A, out, Zl, Yl, X, t0,
                                               nrows, tstep, ext, kappa, dagger, clover,
                                               link_bf16, stream);
}
