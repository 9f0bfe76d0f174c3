// K6, bf16 spinors, two adjacent packed columns a thread (xh even), one
// vector a thread, the batch in grid y: the C entry point over parity_hop.cuh (the kernels;
// the design notes are in parity_hop.cu).

#include "parity_hop.cuh"

// Returns the cudaError_t of the launch (0 = success); mode 0-3 as in
// parity_hop.cu.  psi_in, psi_out and out hold `batch` fields of bf16
// spinors.
extern "C" int mugiq_parity_hop_pair(const void* psi_in, const void* Uo, const void* Ui,
              const void* Apost, const void* psi_out, const void* Acomb,
              void* out, int T, int Z, int Y, int Xh, int parity_out,
              int dagger, int mode, float kappa2, int link_bf16, int batch,
              void* stream) {
  return parity_hop_entry<2, false, __nv_bfloat16>(psi_in, Uo, Ui, Apost, psi_out, Acomb,
                                   out, T, Z, Y, Xh, parity_out, dagger, mode,
                                   kappa2, link_bf16, batch, stream);
}
