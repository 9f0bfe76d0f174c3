// K4-halo, bf16 spinors, one site a thread (an odd X or a base not two
// words aligned; bf16 out, as the TPU kernels' out_shape): the C
// entry point over wilson_m_halo.cuh (the kernel, its layouts and design
// notes are there), instantiated with no diagonal: 2 daggers x 3 halo
// forms x 2 link types.

#include "wilson_m_halo.cuh"

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_dslash_hop_halo_psi_bf16(const void* psi_ext, const void* U,
                                              const void* Ut, void* out, int Zl, int Yl,
                                              int X, int t0, int nrows, int tstep, int ext,
                                              int dagger, int link_bf16, void* stream) {
  return dslash_hop_halo_entry<1, __nv_bfloat16>(psi_ext, U, Ut, out, Zl, Yl, X, t0, nrows,
                                                 tstep, ext, dagger, link_bf16, stream);
}
