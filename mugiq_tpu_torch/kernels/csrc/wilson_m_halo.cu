// K7a: the C entry point over wilson_m_halo.cuh (the kernel, its layouts
// and design notes are there), M and M^dag, Wilson and clover.

#include "wilson_m_halo.cuh"

namespace {

template <typename LT>
void dispatch(int dagger, int clover, int ext, const Args& a) {
  if (dagger) {
    if (clover) by_ext<true, kClover, LT>(ext, a);
    else by_ext<true, kWilson, LT>(ext, a);
  } else {
    if (clover) by_ext<false, kClover, LT>(ext, a);
    else by_ext<false, kWilson, LT>(ext, a);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_wilson_m_halo(const void* psi_ext, const void* U, const void* Ut,
                                   const void* A, void* out, int Zl, int Yl, int X,
                                   int t0, int nrows, int tstep, int ext, float kappa,
                                   int dagger, int clover, int link_bf16, void* stream) {
  if (ext < 0 || ext > 2 || nrows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{psi_ext, U, Ut, A, out, Zl, Yl, X, t0, nrows, tstep, kappa,
               static_cast<cudaStream_t>(stream)};
  if (link_bf16) dispatch<__nv_bfloat16>(dagger, clover, ext, a);
  else dispatch<float>(dagger, clover, ext, a);
  return static_cast<int>(cudaGetLastError());
}
