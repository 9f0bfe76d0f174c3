// K4-halo: the bare hop D psi / D^dag psi of one rank's block from its
// halo-extended input; the C entry point over wilson_m_halo.cuh (the
// kernel, its layouts and design notes are there), instantiated with no
// diagonal: 2 daggers x 3 halo forms x 2 link types.

#include "wilson_m_halo.cuh"

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_dslash_hop_halo(const void* psi_ext, const void* U, const void* Ut,
                                     void* out, int Zl, int Yl, int X, int t0, int nrows,
                                     int tstep, int ext, int dagger, int link_bf16,
                                     void* stream) {
  if (ext < 0 || ext > 2 || nrows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{psi_ext, U, Ut, nullptr, out, Zl, Yl, X, t0, nrows, tstep, 0.f,
               static_cast<cudaStream_t>(stream)};
  if (link_bf16) {
    if (dagger) by_ext<true, kHop, __nv_bfloat16>(ext, a);
    else by_ext<false, kHop, __nv_bfloat16>(ext, a);
  } else {
    if (dagger) by_ext<true, kHop, float>(ext, a);
    else by_ext<false, kHop, float>(ext, a);
  }
  return static_cast<int>(cudaGetLastError());
}
