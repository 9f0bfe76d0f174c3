// K7b: the halo-extended packed even-odd parity hop of one rank's block,
// for Hopper.
//
//   mode 0:  out = H psi_in
//   mode 1:  out = A_post . (H psi_in)                  (Schur pass 1, clover)
//   mode 2:  out = psi_out - kappa2 * H psi_in          (Schur pass 2, Wilson)
//   mode 3:  out = A_comb . psi_out - kappa2 * H psi_in (Schur pass 2, clover)
//
// K6's four modes (parity_hop.cu) on the output rows t = t0 + k*tstep,
// k < nrows, of the local block, from an input-parity field extended by
// one halo slice per side along t and, where the rank grid partitions
// them, along z (ZEXT) and y (YEXT, one row of Xh packed columns):
//   psi_ext  [Tl+2, 24, Zp, Yp*Xh]    Zp = Zl + 2*ZEXT, Yp = Yl + 2*YEXT
//   U_out    [Tl, 4, 18, Zp, Yp*Xh]   output-parity links with z/y halos
//   U_in     [Tl, 4, 18, Zp, Yp*Xh]   input-parity links with z/y halos
//   Ut       [Tl, 18, Zp, Yp*Xh]      input-parity t-links of global t - 1
//   A_post, A_comb [Tl, 144, Zl, Yl*Xh], psi_out, out [Tl, 24, Zl, Yl*Xh]
// The spinors PT (psi_ext, psi_out and out: the output in psi's dtype, as
// the TPU kernels' out_shape, so pass 1 writes d_o in it) are f32 or
// bf16; links and blocks LT f32 or bf16.  Loads upcast, arithmetic is
// f32, a bf16 output rounds once to nearest even (stf, as XLA's astype).
//
// Replaces the TPU kernels mugiq_tpu/pallas/schur_kernel.py
// parity_hop_pallas_ext (:423, t halo) and parity_hop_pallas_extzy (:486,
// t, z[, y] halos).  As in K6, one thread computes one packed output site
// and finds its neighbours by index arithmetic: the row offset
// oo = (t+z+y+parity_out) & 1 in local coordinates, which equals the
// global one because every block starts at even (t, z, y) (the sharded
// operator requires even local extents); x+1 is packed column xh (oo = 0)
// or xh+1 (oo = 1), x-1 is xh-1 or xh, both wrapping in the row (x is
// never partitioned); y, z and t hops keep the column (the row offset
// flips with the row and the parity together), and read the halo rows of
// the extended input where the axis is extended, or wrap in the block
// where it is not.  The TPU kernels' offset-mask input is not needed.
// The halo forms are template parameters; the row set gives the single
// pass and the interior/boundary split, bit-identical (same per-site
// arithmetic).  Hop and tables: hop_common.cuh.
//
// What bounds it on the H100: memory, as K6 (768 B per packed site and
// pass in mode 0, plus 96 B of psi_out and 576 B of clover blocks per
// site where the mode reads them, against 1320 + 288 flop; bf16 spinors
// halve the spinor words' bytes).
//
// Each spinor type has 48 instances (dagger x mode x halo form x link
// type), which take nvcc about as long as the other sources together, so
// every (spinor, link) type pair builds as a source of its own, compiled
// in parallel: parity_hop_halo.cu (f32 spinors, f32 links),
// parity_hop_halo_bf16.cu (f32 spinors, bf16 links),
// parity_hop_halo_psi_bf16.cu (bf16 spinors, f32 links) and
// parity_hop_halo_all_bf16.cu (bf16 spinors and links), each including
// this file.

#pragma once

#include "hop_common.cuh"

namespace {

template <bool DAG, int MODE, bool ZEXT, bool YEXT, typename LT, typename PT>
__global__ void __launch_bounds__(128)
parity_hop_halo_kernel(const PT* __restrict__ psi_in, const LT* __restrict__ Uo,
                       const LT* __restrict__ Ui, const LT* __restrict__ Ut,
                       const LT* __restrict__ Apost, const PT* __restrict__ psi_out,
                       const LT* __restrict__ Acomb, PT* __restrict__ out, int Zl,
                       int Yl, int Xh, int parity_out, int t0, int nrows, int tstep,
                       float kappa2) {
  const int Zp = ZEXT ? Zl + 2 : Zl;
  const int Yp = YEXT ? Yl + 2 : Yl;
  const long long YXp = (long long)Yp * Xh;
  const long long Sp = YXp * Zp;            // packed sites of an extended t-slice
  const long long YXl = (long long)Yl * Xh;
  const long long Sl = YXl * Zl;            // packed sites of an interior t-slice
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Sl * nrows) return;
  const int k = (int)(i / Sl);
  const int t = t0 + k * tstep;
  const long long zyx = i - (long long)k * Sl;   // interior packed site
  const int z = (int)(zyx / YXl);
  const int y = (int)((zyx / Xh) % Yl);
  const int xh = (int)(zyx % Xh);
  const int oo = (t + z + y + parity_out) & 1;
  const int xhp = oo ? (xh + 1 == Xh ? 0 : xh + 1) : xh;
  const int xhm = oo ? xh : (xh == 0 ? Xh - 1 : xh - 1);
  const int ze = ZEXT ? z + 1 : z;
  const int ye = YEXT ? y + 1 : y;
  const int zp = ZEXT ? ze + 1 : (z + 1 == Zl ? 0 : z + 1);
  const int zm = ZEXT ? ze - 1 : (z == 0 ? Zl - 1 : z - 1);
  const int yp = YEXT ? ye + 1 : (y + 1 == Yl ? 0 : y + 1);
  const int ym = YEXT ? ye - 1 : (y == 0 ? Yl - 1 : y - 1);
  const long long site = (long long)ze * YXp + (long long)ye * Xh + xh;
  const long long ps_t = 24 * Sp;   // spinor t-stride
  const long long u_t = 72 * Sp;    // link t-stride
  const long long u_mu = 18 * Sp;   // link mu-stride
  const PT* pt = psi_in + (long long)(t + 1) * ps_t;   // extended row of t
  const LT* uot = Uo + (long long)t * u_t;
  const LT* uit = Ui + (long long)t * u_t;
  const long long zy = (long long)ze * YXp + (long long)ye * Xh;
  // forward hops use 'fwd' (1 - g) for D and 'bwd' (1 + g) for D^dag
  constexpr int FF = DAG ? 1 : 0;
  constexpr int FB = DAG ? 0 : 1;

  float2 acc[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[s][c] = make_float2(0.f, 0.f);

  {  // x
    const long long fw = zy + xhp, bw = zy + xhm;
    hop<0, FF, false>(pt + fw, uot + 0 * u_mu + site, Sp, acc);
    hop<0, FB, true>(pt + bw, uit + 0 * u_mu + bw, Sp, acc);
  }
  {  // y
    const long long fw = (long long)ze * YXp + (long long)yp * Xh + xh;
    const long long bw = (long long)ze * YXp + (long long)ym * Xh + xh;
    hop<1, FF, false>(pt + fw, uot + 1 * u_mu + site, Sp, acc);
    hop<1, FB, true>(pt + bw, uit + 1 * u_mu + bw, Sp, acc);
  }
  {  // z
    const long long fw = (long long)zp * YXp + (long long)ye * Xh + xh;
    const long long bw = (long long)zm * YXp + (long long)ye * Xh + xh;
    hop<2, FF, false>(pt + fw, uot + 2 * u_mu + site, Sp, acc);
    hop<2, FB, true>(pt + bw, uit + 2 * u_mu + bw, Sp, acc);
  }
  // t: the rows t-1 and t+1 of the block are extended rows t and t+2
  hop<3, FF, false>(psi_in + (long long)(t + 2) * ps_t + site, uot + 3 * u_mu + site, Sp,
                    acc);
  hop<3, FB, true>(psi_in + (long long)t * ps_t + site, Ut + (long long)t * 18 * Sp + site,
                   Sp, acc);

  if constexpr (MODE == 1) {
    // hop -> A_post . hop (the Schur complement's A_oo^-1)
    const LT* ap = Apost + (long long)t * 144 * Sl + zyx;
    float2 h[4][3];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        h[s][c] = clover_row(ap, Sl, s, c, [&](int sj, int cj) { return acc[sj][cj]; });
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[s][c] = h[s][c];
  }

  PT* o = out + (long long)t * 24 * Sl + zyx;
  const PT* pe = MODE >= 2 ? psi_out + (long long)t * 24 * Sl + zyx : nullptr;
  const LT* ac = MODE == 3 ? Acomb + (long long)t * 144 * Sl + zyx : nullptr;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float2 v = acc[s][c];
      if constexpr (MODE >= 2) {
        float2 d;
        if constexpr (MODE == 3)
          d = clover_row(ac, Sl, s, c, [&](int sj, int cj) { return spin(pe, Sl, sj, cj); });
        else
          d = spin(pe, Sl, s, c);
        v = make_float2(d.x - kappa2 * v.x, d.y - kappa2 * v.y);
      }
      stf(o + (long long)(s * 3 + c) * Sl, v.x);
      stf(o + (long long)(12 + s * 3 + c) * Sl, v.y);
    }
  }
}

struct Args {
  const void *psi_in, *Uo, *Ui, *Ut, *Apost, *psi_out, *Acomb;
  void* out;
  int Zl, Yl, Xh, parity_out, t0, nrows, tstep;
  float kappa2;
  cudaStream_t st;
};

template <bool DAG, int MODE, bool ZEXT, bool YEXT, typename LT, typename PT>
void launch(const Args& a) {
  const long long n = (long long)a.nrows * a.Zl * a.Yl * a.Xh;
  const unsigned grid = (unsigned)((n + 127) / 128);
  parity_hop_halo_kernel<DAG, MODE, ZEXT, YEXT, LT, PT><<<grid, 128, 0, a.st>>>(
      static_cast<const PT*>(a.psi_in), static_cast<const LT*>(a.Uo),
      static_cast<const LT*>(a.Ui), static_cast<const LT*>(a.Ut),
      static_cast<const LT*>(a.Apost), static_cast<const PT*>(a.psi_out),
      static_cast<const LT*>(a.Acomb), static_cast<PT*>(a.out), a.Zl, a.Yl, a.Xh,
      a.parity_out, a.t0, a.nrows, a.tstep, a.kappa2);
}

// ext: 0 = t halo only, 1 = t and z, 2 = t, z and y
template <bool DAG, int MODE, typename LT, typename PT>
void by_ext(int ext, const Args& a) {
  if (ext == 0) launch<DAG, MODE, false, false, LT, PT>(a);
  else if (ext == 1) launch<DAG, MODE, true, false, LT, PT>(a);
  else launch<DAG, MODE, true, true, LT, PT>(a);
}

template <bool DAG, typename LT, typename PT>
void by_mode(int mode, int ext, const Args& a) {
  switch (mode) {
    case 0: by_ext<DAG, 0, LT, PT>(ext, a); break;
    case 1: by_ext<DAG, 1, LT, PT>(ext, a); break;
    case 2: by_ext<DAG, 2, LT, PT>(ext, a); break;
    default: by_ext<DAG, 3, LT, PT>(ext, a); break;
  }
}

// The C entry point's body for links of type LT and spinors of type PT:
// cudaError_t of the launch (0 = success); mode 0-3 as above.
template <typename LT, typename PT>
int parity_hop_halo_entry(const void* psi_ext, const void* Uo, const void* Ui,
                          const void* Ut, const void* Apost, const void* psi_out,
                          const void* Acomb, void* out, int Zl, int Yl, int Xh,
                          int parity_out, int t0, int nrows, int tstep, int ext,
                          int dagger, int mode, float kappa2, void* stream) {
  if (mode < 0 || mode > 3 || ext < 0 || ext > 2 || nrows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{psi_ext, Uo, Ui, Ut, Apost, psi_out, Acomb, out, Zl, Yl, Xh,
               parity_out, t0, nrows, tstep, kappa2, static_cast<cudaStream_t>(stream)};
  if (dagger) by_mode<true, LT, PT>(mode, ext, a);
  else by_mode<false, LT, PT>(mode, ext, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
