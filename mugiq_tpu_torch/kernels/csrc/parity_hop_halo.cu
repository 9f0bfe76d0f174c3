// K7b with f32 spinors and f32 links: the C entry point over
// parity_hop_halo.cuh (the kernel, its layouts and design notes are there).

#include "parity_hop_halo.cuh"

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_parity_hop_halo(
    const void* psi_ext, const void* Uo, const void* Ui, const void* Ut, const void* Apost,
    const void* psi_out, const void* Acomb, void* out, int Zl, int Yl, int Xh, int parity_out,
    int t0, int nrows, int tstep, int ext, int dagger, int mode, float kappa2, void* stream) {
  return parity_hop_halo_entry<float, float>(
      psi_ext, Uo, Ui, Ut, Apost, psi_out, Acomb, out, Zl, Yl, Xh, parity_out, t0, nrows,
      tstep, ext, dagger, mode, kappa2, stream);
}
