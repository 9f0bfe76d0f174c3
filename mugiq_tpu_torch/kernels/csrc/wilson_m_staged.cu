// K1, a batch of f32 spinors in block tiles of four vectors sharing staged
// links, one site a thread: the C entry point over wilson_m.cuh (the kernels;
// the design notes are in wilson_m.cu).

#include "wilson_m.cuh"

// Returns the cudaError_t of the launch (0 = success).  psi and out hold
// `batch` fields of f32 spinors.
extern "C" int mugiq_wilson_m_staged(const void* psi, const void* U, const void* A,
              void* out, int T, int Z, int Y, int X, float kappa,
              int dagger, int clover, int link_bf16, int batch,
              void* stream) {
  return wilson_m_entry<1, true, float>(psi, U, A, out, T, Z, Y, X, kappa,
                                   dagger, clover, link_bf16, batch, stream);
}
