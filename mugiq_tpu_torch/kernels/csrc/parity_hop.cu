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
// the TPU lane layout.  None of that carries over: one thread computes one
// packed output site, threads of a block run over consecutive sites of the
// fused Z*Y*Xh axis (every component plane reads coalesced), and the kernel
// computes (t, z, y, xh), the row offset oo = (t+z+y+parity_out) & 1 and its
// eight neighbours itself:
//   packed site (t,z,y,xh) of parity p is x = 2*xh + (t+z+y+p) % 2;
//   x+1 is packed column xh (oo = 0) or xh+1 (oo = 1), x-1 is xh-1 (oo = 0)
//   or xh (oo = 1), both wrapping within the row; y, z, t hops keep xh.
// Forward links come from the output-parity array at the site, backward
// links from the input-parity array at the neighbour (the t-1 link from
// slice (t-1)%T).  The checkerboard needs all four extents even; the
// wrapper raises otherwise.  The hop and projector tables are K1's
// (hop_common.cuh).  Loads of bf16 links/clover upcast to f32; all
// arithmetic is f32.
//
// Spinor forms: psi_in, psi_out and out are all f32 or all bf16.  With a
// bf16 Krylov basis the Schur operator's pass 1 writes d_oe in bf16 and
// pass 2 reads it back, as the JAX operator rounds d_oe to psi_in's dtype
// (schur_kernel.py parity_hop_pallas's out_shape); a bf16 store rounds to
// nearest even.  Batch: the three spinors may hold b fields
// [b, T, 24, Z, Y*Xh] in one launch (the batch index in the grid's y
// dimension, a field stride per vector; links and clover shared).
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
// block) is ~2 flop/byte, far below the f32 ridge.  Neighbour spinor and
// link reuse is left to L1/L2, as in K1.

#include "hop_common.cuh"

namespace {

template <bool DAG, int MODE, typename LT, typename PT>
__global__ void __launch_bounds__(128)
parity_hop_kernel(const PT* __restrict__ psi_in, const LT* __restrict__ Uo,
                  const LT* __restrict__ Ui, const LT* __restrict__ Apost,
                  const PT* __restrict__ psi_out, const LT* __restrict__ Acomb,
                  PT* __restrict__ out, int T, int Z, int Y, int Xh,
                  int parity_out, float kappa2) {
  const long long YXh = (long long)Y * Xh;
  const long long S = YXh * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * T) return;
  // vector blockIdx.y of the batch
  const long long field = (long long)blockIdx.y * 24 * S * T;
  psi_in += field;
  out += field;
  if constexpr (MODE >= 2) psi_out += field;
  const int t = (int)(i / S);
  const long long zyx = i - (long long)t * S;
  const int z = (int)(zyx / YXh);
  const int y = (int)((zyx / Xh) % Y);
  const int xh = (int)(zyx % Xh);
  const int oo = (t + z + y + parity_out) & 1;
  const int xhp = oo ? (xh + 1 == Xh ? 0 : xh + 1) : xh;
  const int xhm = oo ? xh : (xh == 0 ? Xh - 1 : xh - 1);
  const int yp = y + 1 == Y ? 0 : y + 1, ym = y == 0 ? Y - 1 : y - 1;
  const int zp = z + 1 == Z ? 0 : z + 1, zm = z == 0 ? Z - 1 : z - 1;
  const int tp = t + 1 == T ? 0 : t + 1, tm = t == 0 ? T - 1 : t - 1;
  const long long ps_t = 24 * S;   // spinor t-stride
  const long long u_t = 72 * S;    // link t-stride
  const long long u_mu = 18 * S;   // link mu-stride
  const PT* pt = psi_in + t * ps_t;
  const LT* uot = Uo + t * u_t;
  const LT* uit = Ui + t * u_t;
  const long long zy = (long long)z * YXh + (long long)y * Xh;
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
    hop<0, FF, false>(pt + fw, uot + 0 * u_mu + zyx, S, acc);
    hop<0, FB, true>(pt + bw, uit + 0 * u_mu + bw, S, acc);
  }
  {  // y
    const long long fw = (long long)z * YXh + (long long)yp * Xh + xh;
    const long long bw = (long long)z * YXh + (long long)ym * Xh + xh;
    hop<1, FF, false>(pt + fw, uot + 1 * u_mu + zyx, S, acc);
    hop<1, FB, true>(pt + bw, uit + 1 * u_mu + bw, S, acc);
  }
  {  // z
    const long long fw = (long long)zp * YXh + (long long)y * Xh + xh;
    const long long bw = (long long)zm * YXh + (long long)y * Xh + xh;
    hop<2, FF, false>(pt + fw, uot + 2 * u_mu + zyx, S, acc);
    hop<2, FB, true>(pt + bw, uit + 2 * u_mu + bw, S, acc);
  }
  // t
  hop<3, FF, false>(psi_in + tp * ps_t + zyx, uot + 3 * u_mu + zyx, S, acc);
  hop<3, FB, true>(psi_in + tm * ps_t + zyx, Ui + tm * u_t + 3 * u_mu + zyx, S, acc);

  if constexpr (MODE == 1) {
    // hop -> A_post . hop (the Schur complement's A_oo^-1)
    const LT* ap = Apost + t * 144 * S + zyx;
    float2 h[4][3];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        h[s][c] = clover_row(ap, S, s, c, [&](int sj, int cj) { return acc[sj][cj]; });
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[s][c] = h[s][c];
  }

  PT* o = out + t * ps_t + zyx;
  const PT* pe = MODE >= 2 ? psi_out + t * ps_t + zyx : nullptr;
  const LT* ac = MODE == 3 ? Acomb + t * 144 * S + zyx : nullptr;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float2 v = acc[s][c];
      if constexpr (MODE >= 2) {
        float2 d;
        if constexpr (MODE == 3)
          d = clover_row(ac, S, s, c, [&](int sj, int cj) { return spin(pe, S, sj, cj); });
        else
          d = spin(pe, S, s, c);
        v = make_float2(d.x - kappa2 * v.x, d.y - kappa2 * v.y);
      }
      stf(o + (long long)(s * 3 + c) * S, v.x);
      stf(o + (long long)(12 + s * 3 + c) * S, v.y);
    }
  }
}

template <bool DAG, int MODE, typename LT, typename PT>
void launch(const void* psi_in, const void* Uo, const void* Ui, const void* Apost,
            const void* psi_out, const void* Acomb, void* out, int T, int Z,
            int Y, int Xh, int parity_out, float kappa2, int batch, cudaStream_t st) {
  const long long V = (long long)T * Z * Y * Xh;
  const dim3 grid((unsigned)((V + 127) / 128), (unsigned)batch);
  parity_hop_kernel<DAG, MODE, LT, PT><<<grid, 128, 0, st>>>(
      static_cast<const PT*>(psi_in), static_cast<const LT*>(Uo),
      static_cast<const LT*>(Ui), static_cast<const LT*>(Apost),
      static_cast<const PT*>(psi_out), static_cast<const LT*>(Acomb),
      static_cast<PT*>(out), T, Z, Y, Xh, parity_out, kappa2);
}

// The arguments every instance takes, passed through the dispatch levels.
struct Args {
  const void *psi_in, *Uo, *Ui, *Apost, *psi_out, *Acomb;
  void* out;
  int T, Z, Y, Xh, parity_out;
  float kappa2;
  int batch;
  cudaStream_t st;
};

template <bool DAG, int MODE, typename LT, typename PT>
void run(const Args& a) {
  launch<DAG, MODE, LT, PT>(a.psi_in, a.Uo, a.Ui, a.Apost, a.psi_out, a.Acomb, a.out,
                            a.T, a.Z, a.Y, a.Xh, a.parity_out, a.kappa2, a.batch, a.st);
}

template <bool DAG, typename LT, typename PT>
void by_mode(int mode, const Args& a) {
  switch (mode) {
    case 0: run<DAG, 0, LT, PT>(a); break;
    case 1: run<DAG, 1, LT, PT>(a); break;
    case 2: run<DAG, 2, LT, PT>(a); break;
    default: run<DAG, 3, LT, PT>(a); break;
  }
}

template <typename LT, typename PT>
void dispatch(int dagger, int mode, const Args& a) {
  if (dagger) by_mode<true, LT, PT>(mode, a);
  else by_mode<false, LT, PT>(mode, a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success); mode 0-3 as above.
// psi_in, psi_out and out hold `batch` fields of the spinor type (bf16 if
// spinor_bf16, else f32).
extern "C" int mugiq_parity_hop(const void* psi_in, const void* Uo, const void* Ui,
                                const void* Apost, const void* psi_out,
                                const void* Acomb, void* out, int T, int Z, int Y,
                                int Xh, int parity_out, int dagger, int mode,
                                float kappa2, int link_bf16, int spinor_bf16,
                                int batch, void* stream) {
  if (mode < 0 || mode > 3 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{psi_in, Uo, Ui, Apost, psi_out, Acomb, out, T, Z, Y, Xh,
               parity_out, kappa2, batch, static_cast<cudaStream_t>(stream)};
  using bf16 = __nv_bfloat16;
  if (link_bf16) {
    if (spinor_bf16) dispatch<bf16, bf16>(dagger, mode, a);
    else dispatch<bf16, float>(dagger, mode, a);
  } else {
    if (spinor_bf16) dispatch<float, bf16>(dagger, mode, a);
    else dispatch<float, float>(dagger, mode, a);
  }
  return static_cast<int>(cudaGetLastError());
}
