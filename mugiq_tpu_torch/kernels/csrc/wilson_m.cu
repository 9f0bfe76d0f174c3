// K1: fused Wilson(-clover) operator on the kernel layout, for Hopper.
//
//   out = A psi - kappa * D psi          (dagger = 0: M)
//   out = A psi - kappa * D^dag psi      (dagger = 1: M^dag)
//   D psi(x) = sum_mu (1 - g_mu) U_mu(x) psi(x+mu) + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu)
//
// Replaces the TPU kernel mugiq_tpu/pallas/dslash_kernel.py wilson_m_pallas
// (:395; body _make_m_kernel :310 -> make_slice_compute :168 -> apply_hop
// :82) and its grouped-lane tiling wilson_m_pallas_gl (:747).  The TPU
// versions exist in two tilings because of the TPU lane layout; here a
// thread computes one site (or two, below), threads of a block run over
// consecutive sites of the fused Z*Y*X axis, so a warp reads consecutive
// words of every component plane of the site-minor layouts:
//   psi, out [T, 24, Z, Y*X]      comp = r*12 + s*3 + c
//   U        [T, 4, 18, Z, Y*X]   comp = r*9 + a*3 + b        (f32 or bf16)
//   A        [T, 144, Z, Y*X]     idx = ((chi*6 + k)*6 + j)*2 + r  (same type as U)
// Each directed hop projects to a half spinor, multiplies by the SU(3)
// link (the adjoint link for backward hops) and reconstructs.  For M^dag
// the two projectors swap (g5 is folded away), as in apply_hop.  Periodic
// neighbours come from explicit (t, z, y, x) index arithmetic: an x-hop at
// x = X-1 wraps within its row.  The backward t-hop reads the t-links of
// slice (t-1)%T straight from U.  Loads of bf16 upcast to f32; all
// arithmetic is f32.  The projector tables and the tile helpers (the
// eight hops of K sites, exact rounding) live in hop_common.cuh, the
// kernels in wilson_m.cuh.
//
// Spinor forms: psi and out are both f32 or both bf16 (the stored vectors
// of a bf16 Krylov basis feed the operator as they are, as the JAX kernel
// takes psi's dtype for its output); a bf16 store rounds to nearest even
// (hop_common.cuh stf).  Batch: psi and out may hold b fields
// [b, T, 24, Z, Y*X] (block Lanczos applies the operator to a block, the
// JAX package through vmap of the Pallas call), one launch.
//
// What bounds it on the H100: memory.  Per site it moves 24 floats of psi
// (plus 8 neighbour spinors, shared with other threads through L1/L2),
// 72 link words (8 hops: 4 local links, 4 neighbour links), 24 floats of
// output and, with clover, 144 more words, for 1320 flop (Wilson hop):
// ~1 flop/byte against a ridge of ~20 for f32 FMA.
//
// The design.  The first port's kernel (one thread, one site, one vector,
// the batch in the grid's y dimension) left two forms well under their
// bound:
//   1. a batch re-read the links.  Blocks issue x-first, so vector 0
//      swept the lattice before vector 1 began, and at 32^3x64 the f32
//      links (604 MB) are twelve times L2 (50 MB): a b = 4 launch took
//      0.98x four single ones, 0.35 of its bound.
//   2. bf16 was read two bytes at a time (a scalar load per plane, not
//      through the read-only path): a warp instruction moved 64 B against
//      f32's 128 B, and the all-bf16 form sat at 0.44 of its bound.
// What this design does about them:
//   1. a batch runs as block tiles (wilson_m_staged.cu): TILE_SITES
//      threads along the sites times TILE_NV = 4 vectors (threadIdx.y).
//      Each vector row loads two of the eight hops' links at its sites
//      once and stores them in shared memory; after one barrier every row
//      reads all eight there.  The links are read from memory once per
//      tile of four vectors.  Holding four vectors' accumulators in one
//      thread instead (96 registers, plus the link) spilled at 255
//      registers in every instance, ran 2.7x slower than the first port's
//      kernel on the H100, and took ptxas up to 168 s: that is why the
//      vector is a thread row.
//   2. with bf16 spinors a thread computes two x-adjacent sites (x even;
//      wilson_m_pair.cu, and wilson_m_staged_pair.cu for a batch): every
//      aligned plane pair (spinor, bf16 link, bf16 clover, the output) is
//      one 4-byte load or store; the x neighbours of a pair, (x+1, x+2)
//      and (x-1, x), are no aligned pair and take two 2-byte loads.
//      Where X is odd or a base is not four-byte aligned, the one-site
//      instance runs (wilson_m_bf16.cu).
// Every instance rounds each operation explicitly (hop_common.cuh cadd,
// cfma: fused multiply-adds in a fixed order), so that a batch, a tile, a
// pair and a single launch give the same vector bit for bit; with the
// compiler free to contract, the first attempt's tiles differed from
// single launches (in K6's A_post pass).  Each kind of kernel caps its
// registers through its launch bounds (hop_common.cuh min_blocks).  The
// wrapper (kernels/wilson.py launch_plan) picks the instance.
//
// What still bounds the tiles: every spinor is read again by its eight
// neighbours' threads through L1/L2 (768 B a site and vector against the
// 192 B the byte bound counts), and the tile saves only the link reads;
// K1's and K6's tiles take the same time per site and vector.  Reuse of
// the neighbour spinors (a shared-memory tile over y and z) is later
// work.
//
// Why not the tensor cores: the per-site product is a 3x3 complex link
// times a 3x2 half spinor per vector (3x2*b for a tile), far below
// wgmma's 64-row tile, and the twins' 2e-5 needs f32 arithmetic, not TF32.
//
// This file: one site a thread, f32 spinors, f32 and bf16 links, M and
// M^dag, Wilson and clover (8 instances).

#include "hop_common.cuh"
#include "wilson_m.cuh"

// Returns the cudaError_t of the launch (0 = success).  psi and out hold
// `batch` fields of f32 spinors.
extern "C" int mugiq_wilson_m(const void* psi, const void* U, const void* A,
                              void* out, int T, int Z, int Y, int X,
                              float kappa, int dagger, int clover,
                              int link_bf16, int batch, void* stream) {
  return wilson_m_entry<1, false, float>(psi, U, A, out, T, Z, Y, X, kappa, dagger,
                                         clover, link_bf16, batch, stream);
}
