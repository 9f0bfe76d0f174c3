// K4-halo, f32 spinors: the bare hop D psi / D^dag psi of one rank's block
// from its halo-extended input; the C entry point over wilson_m_halo.cuh
// (the kernel, its layouts and design notes are there), instantiated with
// no diagonal: 2 daggers x 3 halo forms x 2 link types.

#include "wilson_m_halo.cuh"

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_dslash_hop_halo(const void* psi_ext, const void* U, const void* Ut,
                                     void* out, int Zl, int Yl, int X, int t0, int nrows,
                                     int tstep, int ext, int dagger, int link_bf16,
                                     void* stream) {
  return dslash_hop_halo_entry<1, float>(psi_ext, U, Ut, out, Zl, Yl, X, t0, nrows, tstep,
                                         ext, dagger, link_bf16, stream);
}
