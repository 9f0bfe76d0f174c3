// K7a and K4-halo: the halo-extended Wilson(-clover) operator M / M^dag
// and the bare hop D / D^dag of one rank's block, for Hopper.  This header
// holds the kernel and the C entry points' bodies; wilson_m_halo.cu (K7a)
// and dslash_hop_halo.cu (K4's halo forms) instantiate it for f32
// spinors, wilson_m_halo_pair.cu and dslash_hop_halo_pair.cu for bf16
// spinors two sites a thread, wilson_m_halo_psi_bf16.cu and
// dslash_hop_halo_psi_bf16.cu for bf16 spinors one site a thread (an odd
// X, a base not two words aligned), so the parallel build compiles them
// side by side.
//
//   out = A psi - kappa * D psi          (DIAG clover / Wilson, dagger = 0: M)
//   out = A psi - kappa * D^dag psi      (dagger = 1: M^dag)
//   out = D psi, D^dag psi               (DIAG none: K4-halo)
//
// on the output rows t = t0 + k*tstep, k < nrows, of the local block, from
// an input extended by one halo slice per side along t and, where the
// rank grid partitions them, along z (ZEXT) and y (YEXT):
//   psi_ext [Tl+2, 24, Zp, Yp*X]      Zp = Zl + 2*ZEXT, Yp = Yl + 2*YEXT
//   U       [Tl, 4, 18, Zp, Yp*X]     the local links with their z/y halos
//   Ut      [Tl, 18, Zp, Yp*X]        Ut[t] = U_t(global t - 1) (halo rows unread)
//   A       [Tl, 144, Zl, Yl*X]       clover blocks, interior only (clover)
//   out     [Tl, 24, Zl, Yl*X]        rows outside the launch are untouched
// The spinor PT is f32 or bf16 and the output OT takes its type, as the
// TPU kernels' out_shape (psi_ext.dtype); links and clover LT are f32 or
// bf16.  Loads upcast, arithmetic is f32, a bf16 output rounds once to
// nearest even (stf, as XLA's astype).
//
// Replaces the TPU kernels of mugiq_tpu/parallel/shard_dslash.py:
// wilson_m_pallas_ext (:112, t halo), wilson_m_pallas_ext2 (:151, t and z
// halos), _pallas_ext3 (:199, t, z and y halos) and the interior/boundary
// pair _m_interior_call (:314) / _m_boundary_call (:357), each in its
// kappa form (K7a); and, with no diagonal, dslash_hop_pallas_ext (:38),
// dslash_hop_pallas_ext2 (:74) and the kappa=None forms of _pallas_ext3,
// _m_interior_call and _m_boundary_call (K4-halo).  The TPU kernels read
// neighbours with non-modular block index maps and rolled tiles over the
// extended array; here, as in K1, a
// thread computes K output sites and finds their eight neighbours by index
// arithmetic: t, z and y neighbours come from the halo rows of the
// extended input where that axis is extended, and wrap inside the block
// where it is not (then the rank holds the whole axis); x is never
// partitioned and wraps within its row.  The three halo forms are template
// parameters, so the hot loop has no branch on them.  The row set (t0,
// nrows, tstep) gives the single pass (0, Tl, 1), the interior rows that
// read no t halo (1, Tl-2, 1) while the t halos travel, and the two
// boundary rows (0, 2, Tl-1) after; every output site runs the same
// arithmetic in every form, so the split is bit-identical to the single
// pass.  The eight hops of K sites and their output (hop_common.cuh
// hop8_direct, site_out) are K1's and K4's, every operation rounded
// explicitly, so a rank's block equals K1 / K4 on the global field bit
// for bit.
//
// What bounds it on the H100: memory, as K1 (~1 flop/byte against an f32
// ridge of ~20).  Per output site it reads 24 floats of psi, 4 local and
// 4 neighbour links (72 words), with clover 144 words, and writes 24
// floats; the halo rows add (2 + 2*Z-halo + 2*Y-halo) slices of reads.
// bf16 spinors halve the spinor words' bytes (the bf16 Krylov basis under
// --mesh: 456 B a site with f32 links, 276 B all-bf16, against 552 B).
// Neighbour reuse is left to L1/L2, as in K1.
//
// The design, K1's (wilson_m.cu).  One site a thread read bf16 two bytes
// at a time (a warp instruction moved 64 B against f32's 128 B), and the
// all-bf16 forms sat under half their bound.  With bf16 spinors a thread
// computes two x-adjacent sites (x even): every aligned plane pair of the
// extended spinor, the links and t-links, the clover blocks and the
// output is one 4-byte load or store (the extended site offset
// ze*Yp*X + ye*X + x is even, as is every plane stride, since X is); the
// x neighbours of a pair, (x+1, x+2) and (x-1, x), wrap within their row
// and take two 2-byte loads.  A row set of the interior/boundary split
// covers whole rows, so the pairs are those of the single pass.
// Registers are capped through the launch bounds (HALO_MIN_BLOCKS); the
// wrappers (kernels/wilson.py launch_plan) pick the instance.

#pragma once

#include "hop_common.cuh"

namespace {

// Blocks of 128 threads that ptxas must fit on one SM: three (168
// registers) for every instance.  K1's count for pairs with f32 links
// (one block, 255 registers) ran slower here: bf16 spinors with f32 links
// at the 32^3x64 rank-0 block of a 2 1 grid, K7a 0.214 ms against 0.207
// capped, K4-halo 0.222 against 0.199 (clover K7a 0.405 against 0.424;
// PERF.md section 6).
constexpr int HALO_MIN_BLOCKS = 3;

// K sites a thread (K = 2: x even, bf16 spinors), K1's per-site code
// (hop_common.cuh hop8_direct, site_out) on the block's extended slices.
template <bool DAG, int DIAG, int K, bool ZEXT, bool YEXT, typename LT, typename PT,
          typename OT>
__global__ void __launch_bounds__(128, HALO_MIN_BLOCKS)
wilson_m_halo_kernel(const PT* __restrict__ psi, const LT* __restrict__ U,
                     const LT* __restrict__ Ut, const LT* __restrict__ A,
                     OT* __restrict__ out, int Zl, int Yl, int X, int t0,
                     int nrows, int tstep, float kappa) {
  using Ln = Lanes<K>;
  const int Zp = ZEXT ? Zl + 2 : Zl;
  const int Yp = YEXT ? Yl + 2 : Yl;
  const long long YXp = (long long)Yp * X;
  const long long Sp = YXp * Zp;            // sites of an extended t-slice
  const long long YXl = (long long)Yl * X;
  const long long Sl = YXl * Zl;            // sites of an interior t-slice
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (i >= Sl * nrows) return;
  const int k = (int)(i / Sl);
  const int t = t0 + k * tstep;
  const long long zyx = i - (long long)k * Sl;   // interior site
  const int z = (int)(zyx / YXl);
  const int y = (int)((zyx / X) % Yl);
  const int x = (int)(zyx % X);
  // coordinates in the extended slice, and the neighbours
  const int ze = ZEXT ? z + 1 : z;
  const int ye = YEXT ? y + 1 : y;
  const int zp = ZEXT ? ze + 1 : (z + 1 == Zl ? 0 : z + 1);
  const int zm = ZEXT ? ze - 1 : (z == 0 ? Zl - 1 : z - 1);
  const int yp = YEXT ? ye + 1 : (y + 1 == Yl ? 0 : y + 1);
  const int ym = YEXT ? ye - 1 : (y == 0 ? Yl - 1 : y - 1);
  // x neighbours of sites x .. x+K-1 in their row: x+1 .. x+K forward,
  // x-1 .. x+K-2 backward
  const int c1 = x + 1 == X ? 0 : x + 1, c2 = x + 2 >= X ? x + 2 - X : x + 2;
  const int cm = x == 0 ? X - 1 : x - 1;
  const long long zy = (long long)ze * YXp + (long long)ye * X;
  const TileNbr<K> n{Ln::at(zy + x),
                     Ln::at((long long)ze * YXp + (long long)yp * X + x),
                     Ln::at((long long)ze * YXp + (long long)ym * X + x),
                     Ln::at((long long)zp * YXp + (long long)ye * X + x),
                     Ln::at((long long)zm * YXp + (long long)ye * X + x),
                     Ln::xs(zy, c1, c2), Ln::xs(zy, cm, x)};
  const long long ps_t = 24 * Sp;   // psi_ext t-stride
  const long long u_t = 72 * Sp;    // U t-stride
  const PT* pt = psi + (long long)(t + 1) * ps_t;   // extended row of t
  const LT* ut = U + (long long)t * u_t;
  float2 acc[K][4][3];
  // t: the rows t-1 and t+1 of the block are extended rows t and t+2
  hop8_direct<DAG, K>(pt, psi + (long long)(t + 2) * ps_t, psi + (long long)t * ps_t, ut, ut,
                      Ut + (long long)t * 18 * Sp, Sp, n, acc);
  site_out<DIAG, K>(pt, Sp, n.c, out + (long long)t * 24 * Sl,
                    DIAG == kClover ? A + (long long)t * 144 * Sl : nullptr, Sl, Ln::at(zyx),
                    kappa, acc);
}

struct Args {
  const void *psi, *U, *Ut, *A;
  void* out;
  int Zl, Yl, X, t0, nrows, tstep;
  float kappa;
  cudaStream_t st;
};

// PT: the spinor type; the output takes it
template <bool DAG, int DIAG, int K, bool ZEXT, bool YEXT, typename LT, typename PT>
void launch(const Args& a) {
  const long long n = (long long)a.nrows * a.Zl * a.Yl * a.X / K;
  const unsigned grid = (unsigned)((n + 127) / 128);
  wilson_m_halo_kernel<DAG, DIAG, K, ZEXT, YEXT, LT, PT, PT><<<grid, 128, 0, a.st>>>(
      static_cast<const PT*>(a.psi), static_cast<const LT*>(a.U),
      static_cast<const LT*>(a.Ut), static_cast<const LT*>(a.A),
      static_cast<PT*>(a.out), a.Zl, a.Yl, a.X, a.t0, a.nrows, a.tstep, a.kappa);
}

// ext: 0 = t halo only, 1 = t and z, 2 = t, z and y (the JAX 1D/2D/3D forms)
template <bool DAG, int DIAG, int K, typename LT, typename PT>
void by_ext(int ext, const Args& a) {
  if (ext == 0) launch<DAG, DIAG, K, false, false, LT, PT>(a);
  else if (ext == 1) launch<DAG, DIAG, K, true, false, LT, PT>(a);
  else launch<DAG, DIAG, K, true, true, LT, PT>(a);
}

template <int K, typename LT, typename PT>
void m_dispatch(int dagger, int clover, int ext, const Args& a) {
  if (dagger) {
    if (clover) by_ext<true, kClover, K, LT, PT>(ext, a);
    else by_ext<true, kWilson, K, LT, PT>(ext, a);
  } else {
    if (clover) by_ext<false, kClover, K, LT, PT>(ext, a);
    else by_ext<false, kWilson, K, LT, PT>(ext, a);
  }
}

// The launch's operands are legal: a halo form, rows, and for K = 2 an
// even X and every base two words of its type aligned.
template <int K, typename PT>
bool legal(const Args& a, int ext, int link_bf16) {
  const size_t lw = link_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  return ext >= 0 && ext <= 2 && a.nrows > 0 &&
         (K == 1 || (a.X % 2 == 0 && pair_aligned(a.psi, sizeof(PT)) &&
                     pair_aligned(a.out, sizeof(PT)) && pair_aligned(a.U, lw) &&
                     pair_aligned(a.Ut, lw) && pair_aligned(a.A, lw)));
}

// The C entry points' bodies for spinors of type PT, K sites a thread:
// cudaError_t of the launch (0 = success).  K7a: M / M^dag, Wilson or
// clover, 2 x 2 x 3 halo forms x 2 link types.
template <int K, typename PT>
int wilson_m_halo_entry(const void* psi_ext, const void* U, const void* Ut,
                        const void* A, void* out, int Zl, int Yl, int X, int t0,
                        int nrows, int tstep, int ext, float kappa, int dagger,
                        int clover, int link_bf16, void* stream) {
  const Args a{psi_ext, U, Ut, clover ? A : nullptr, out, Zl, Yl, X, t0, nrows, tstep,
               kappa, static_cast<cudaStream_t>(stream)};
  if (!legal<K, PT>(a, ext, link_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (link_bf16) m_dispatch<K, __nv_bfloat16, PT>(dagger, clover, ext, a);
  else m_dispatch<K, float, PT>(dagger, clover, ext, a);
  return static_cast<int>(cudaGetLastError());
}

// K4-halo: D / D^dag with no diagonal, 2 daggers x 3 halo forms x 2 link
// types.
template <int K, typename PT>
int dslash_hop_halo_entry(const void* psi_ext, const void* U, const void* Ut, void* out,
                          int Zl, int Yl, int X, int t0, int nrows, int tstep, int ext,
                          int dagger, int link_bf16, void* stream) {
  const Args a{psi_ext, U, Ut, nullptr, out, Zl, Yl, X, t0, nrows, tstep, 0.f,
               static_cast<cudaStream_t>(stream)};
  if (!legal<K, PT>(a, ext, link_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (link_bf16) {
    if (dagger) by_ext<true, kHop, K, __nv_bfloat16, PT>(ext, a);
    else by_ext<false, kHop, K, __nv_bfloat16, PT>(ext, a);
  } else {
    if (dagger) by_ext<true, kHop, K, float, PT>(ext, a);
    else by_ext<false, kHop, K, float, PT>(ext, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
