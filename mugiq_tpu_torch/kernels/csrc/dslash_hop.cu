// K4: the bare Wilson hopping term D psi (D^dag psi) on the kernel layout,
// for Hopper.
//
//   D psi(x) = sum_mu (1 - g_mu) U_mu(x) psi(x+mu) + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu)
//   dagger = 1 swaps the two projectors (D^dag = g5 D g5).
//
// No diagonal and no -kappa.  Replaces the TPU kernels
// mugiq_tpu/pallas/dslash_kernel.py dslash_hop_pallas (:436; body
// _make_kernel :265, with or without the project-then-shift ps body, which
// computes the same function) and its grouped-lane tiling
// dslash_hop_pallas_gl (:726), and by function the other TPU tilings of
// the hop (glt :884, yb :1069, dslash_win_kernel.py :210,
// dslash_block_kernel.py :109 / :142).  It is K1's kernel
// (wilson_m.cuh wilson_m_direct_kernel: hop_common.cuh site_k,
// hop8_direct, site_out) with the diagonal and -kappa left out: threads
// of a block run over consecutive sites of the fused Z*Y*X axis,
// neighbours by periodic index arithmetic; t wraps on the phased links.
// No mask is read (K5's runtime mask is not used), so its time compares
// with K1's.  Every operation is rounded explicitly, as in K1.
//
// Types, as the TPU kernel takes them: the spinor PT, the links LT and the
// output OT are each f32 or bf16; loads upcast, arithmetic is f32, a bf16
// output rounds to nearest even (XLA's astype).
//
// What bounds it on the H100: memory.  Per site it reads 24 words of psi
// (its 8 neighbour spinors are other threads' sites, left to L1/L2), 72
// link words (4 local links, 4 neighbour links) and writes 24 words of
// output, for 1320 flop: 480 B at f32, 240 B all-bf16, ~3-6 flop/byte
// against a ridge of ~20 for f32 FMA.  At 32^3x64 that is 0.300 ms (f32)
// and 0.150 ms (all-bf16) at 3.35 TB/s.
//
// The design, K1's (wilson_m.cu).  One site a thread read bf16 two bytes
// at a time: a warp instruction moved 64 B against f32's 128 B, and the
// all-bf16 headline chain sat at 0.41 of its bound.  With bf16 spinors a thread computes two x-adjacent sites (x
// even; dslash_hop_pair.cu): every aligned plane pair (spinor, bf16 link,
// the output) is one 4-byte load or store; the x neighbours of a pair,
// (x+1, x+2) and (x-1, x), are no aligned pair and take two 2-byte loads.
// Where X is odd or a base is not two words aligned, the one-site
// instance runs (this file).  Registers are capped through the launch
// bounds (hop_common.cuh min_blocks); the wrapper (kernels/wilson.py
// launch_plan) picks the instance.
//
// This file: one site a thread, spinor, links and output each f32 or
// bf16, D and D^dag (16 instances).

#include "dslash_hop.cuh"

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_dslash_hop(const void* psi, const void* U, void* out,
                                int T, int Z, int Y, int X, int dagger,
                                int psi_bf16, int link_bf16, int out_bf16,
                                void* stream) {
  return dslash_hop_entry<1>(psi, U, out, T, Z, Y, X, dagger, psi_bf16, link_bf16,
                             out_bf16, stream);
}
