// K4, bf16 spinors, two x-adjacent sites a thread (x even): the C entry
// point over dslash_hop.cuh (the kernel; the design notes are in
// dslash_hop.cu), D and D^dag, f32 and bf16 links and output (8
// instances).

#include "dslash_hop.cuh"

// Returns the cudaError_t of the launch (0 = success); psi_bf16 must be 1.
extern "C" int mugiq_dslash_hop_pair(const void* psi, const void* U, void* out,
                                     int T, int Z, int Y, int X, int dagger,
                                     int psi_bf16, int link_bf16, int out_bf16,
                                     void* stream) {
  return dslash_hop_entry<2>(psi, U, out, T, Z, Y, X, dagger, psi_bf16, link_bf16,
                             out_bf16, stream);
}
