// K6: the packed even-odd parity hop, for Hopper.
//
//   mode 0:  out = H psi_in
//   mode 1:  out = A_post . (H psi_in)                  (Schur pass 1, clover)
//   mode 2:  out = psi_out - kappa2 * H psi_in          (Schur pass 2, Wilson)
//   mode 3:  out = A_comb . psi_out - kappa2 * H psi_in (Schur pass 2, clover)
//
// H is the hopping term D restricted to output-parity sites and reading
// input-parity sites (D_oe or D_eo); dagger = 1 swaps the projectors (D^dag
// = g5 D g5).  A_post / A_comb are chiral 6x6 clover blocks of the output
// parity (A_oo^-1 in pass 1, A_ee in pass 2).  Two passes make the
// preconditioned operator M_pc = A_ee - kappa^2 D_eo A_oo^-1 D_oe.
//
// Replaces the TPU kernel mugiq_tpu/pallas/schur_kernel.py parity_hop_pallas
// (:350; body _make_parity_kernel :110).  The TPU kernel pipelines t-slice
// blocks, feeds a precomputed row-offset mask and the t-1 links as separate
// inputs, and has grouped-lane (by) and project-then-shift (ps) variants for
// the TPU lane layout.  None of that carries over: a thread computes one
// packed output site (or two, below), threads of a block run over
// consecutive sites of the fused Z*Y*Xh axis (every component plane reads
// coalesced), and the kernel computes (t, z, y, xh), the row offset
// oo = (t+z+y+parity_out) & 1 and its eight neighbours itself:
//   packed site (t,z,y,xh) of parity p is x = 2*xh + (t+z+y+p) % 2;
//   x+1 is packed column xh (oo = 0) or xh+1 (oo = 1), x-1 is xh-1 (oo = 0)
//   or xh (oo = 1), both wrapping within the row; y, z, t hops keep xh.
// Forward links come from the output-parity array at the site, backward
// links from the input-parity array at the neighbour (the t-1 link from
// slice (t-1)%T).  The checkerboard needs all four extents even; the
// wrapper raises otherwise.  The projector tables and the tile helpers are
// K1's (hop_common.cuh), the kernels in parity_hop.cuh.  Loads of bf16
// upcast to f32; all arithmetic is f32.
//
// Spinor forms: psi_in, psi_out and out are all f32 or all bf16.  With a
// bf16 Krylov basis the Schur operator's pass 1 writes d_oe in bf16 and
// pass 2 reads it back, as the JAX operator rounds d_oe to psi_in's dtype
// (schur_kernel.py parity_hop_pallas's out_shape); a bf16 store rounds to
// nearest even.  Batch: the three spinors may hold b fields
// [b, T, 24, Z, Y*Xh] in one launch (links and clover shared).
//
// Layouts (packed, S = Z*Y*Xh sites per t-slice):
//   psi_in, psi_out, out [T, 24, Z, Y*Xh]
//   U_out, U_in          [T, 4, 18, Z, Y*Xh]    (f32 or bf16)
//   A_post, A_comb       [T, 144, Z, Y*Xh]      (the links' type)
//
// What bounds it on the H100: memory.  Each input is read once and the
// output written once at least: per f32 output site psi_in 96 B + out 96 B
// + 4 output-parity links 288 B + 4 input-parity links 288 B = 768 B (mode
// 0), + psi_out 96 B (modes 2, 3), + 576 B of clover blocks (modes 1, 3);
// at 32^3x64 (1,048,576 packed sites) 805 MB, 0.24 ms at 3.35 TB/s (mode
// 0).  The arithmetic (1320 flop per site for the hop, 288 per clover
// block) is ~2 flop/byte, far below the f32 ridge.  Neighbour spinor reuse
// is left to L1/L2, as in K1.
//
// The design is K1's (wilson_m.cu says more).  The first port's kernel
// (one thread, one packed site, one vector, the batch in grid y) re-read
// the links for every vector of a batch (a b = 4 launch took 0.92x four single ones, 0.34 of
// its bound) and read bf16 two bytes at a time (the all-bf16 form at 0.42
// of its bound).  Here a batch runs as block tiles of TILE_NV = 4 vectors
// (threadIdx.y) whose rows stage their sites' eight links in shared
// memory once (parity_hop_staged.cu, parity_hop_staged_pair.cu); with
// bf16 spinors a thread computes two adjacent packed columns (xh even;
// parity_hop_pair.cu), each aligned plane pair one 4-byte load or store.
// The pair's x neighbours are columns (xh + oo, xh + 1 + oo) forward and
// (xh - 1 + oo, xh + oo) backward, an aligned pair or not by the row's oo:
// they take two 2-byte loads, so a warp's rows of both offsets run one
// code.  Xh odd or a base not four-byte aligned runs the one-site
// instance (parity_hop_bf16.cu).  Every instance rounds each operation explicitly
// (hop_common.cuh cadd, cfma), so a tile, a pair and a single launch give
// the same vector bit for bit.  Tensor cores do not serve: a 3x3 complex
// link times 3x2 per vector is far below wgmma's 64-row tile, and the
// twins' 2e-5 needs f32, not TF32.
//
// This file: one packed site a thread, f32 spinors, f32 and bf16 links,
// D and D^dag, each of the four passes (16 instances).

#include "hop_common.cuh"
#include "parity_hop.cuh"

// Returns the cudaError_t of the launch (0 = success); mode 0-3 as above.
// psi_in, psi_out and out hold `batch` fields of f32 spinors.
extern "C" int mugiq_parity_hop(const void* psi_in, const void* Uo, const void* Ui,
                                const void* Apost, const void* psi_out,
                                const void* Acomb, void* out, int T, int Z, int Y,
                                int Xh, int parity_out, int dagger, int mode,
                                float kappa2, int link_bf16, int batch, void* stream) {
  return parity_hop_entry<1, false, float>(psi_in, Uo, Ui, Apost, psi_out, Acomb, out, T, Z,
                                           Y, Xh, parity_out, dagger, mode, kappa2,
                                           link_bf16, batch, stream);
}
