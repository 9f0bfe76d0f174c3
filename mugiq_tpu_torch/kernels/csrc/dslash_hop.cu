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
// dslash_block_kernel.py :109 / :142).  It is K1's per-site code
// (hop_common.cuh hop8) with the diagonal and the combine left out: one
// thread computes one site and writes its 24 components, threads of a
// block run over consecutive sites of the fused Z*Y*X axis, neighbours by
// periodic index arithmetic; t wraps on the phased links.  No mask is read
// (K5's runtime mask is not used), so its time compares with K1's.
//
// Types, as the TPU kernel takes them: the spinor PT, the links LT and the
// output OT are each f32 or bf16 (16 instances with dagger); loads upcast,
// arithmetic is f32, a bf16 output rounds to nearest even (XLA's astype).
//
// What bounds it on the H100: memory.  Per site it reads 24 words of psi
// (its 8 neighbour spinors are other threads' sites, left to L1/L2), 72
// link words (4 local links, 4 neighbour links) and writes 24 words of
// output, for 1320 flop: 480 B at f32, 240 B all-bf16, ~3-6 flop/byte
// against a ridge of ~20 for f32 FMA.  At 32^3x64 that is 0.300 ms (f32)
// and 0.150 ms (all-bf16) at 3.35 TB/s.

#include "hop_common.cuh"

namespace {

template <bool DAG, typename PT, typename LT, typename OT>
__global__ void __launch_bounds__(128)
dslash_hop_kernel(const PT* __restrict__ psi, const LT* __restrict__ U,
                  OT* __restrict__ out, int T, int Z, int Y, int X) {
  const long long YX = (long long)Y * X;
  const long long S = YX * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * T) return;
  const int t = (int)(i / S);
  const long long zyx = i - (long long)t * S;
  const int z = (int)(zyx / YX);
  const int y = (int)((zyx / X) % Y);
  const int x = (int)(zyx % X);
  const int xp = x + 1 == X ? 0 : x + 1, xm = x == 0 ? X - 1 : x - 1;
  const int yp = y + 1 == Y ? 0 : y + 1, ym = y == 0 ? Y - 1 : y - 1;
  const int zp = z + 1 == Z ? 0 : z + 1, zm = z == 0 ? Z - 1 : z - 1;
  const int tp = t + 1 == T ? 0 : t + 1, tm = t == 0 ? T - 1 : t - 1;
  const long long ps_t = 24 * S;   // psi t-stride
  const long long u_t = 72 * S;    // U t-stride
  const long long zy = (long long)z * YX + (long long)y * X;
  const Nbr n{zyx, zy + xp, zy + xm,
              (long long)z * YX + (long long)yp * X + x,
              (long long)z * YX + (long long)ym * X + x,
              (long long)zp * YX + (long long)y * X + x,
              (long long)zm * YX + (long long)y * X + x};
  float2 acc[4][3];
  hop8<DAG>(psi + t * ps_t, psi + tp * ps_t, psi + tm * ps_t, U + t * u_t,
            U + tm * u_t + 3 * 18 * S, S, n, acc);

  OT* o = out + t * ps_t + zyx;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      stf(o + (long long)(s * 3 + c) * S, acc[s][c].x);
      stf(o + (long long)(12 + s * 3 + c) * S, acc[s][c].y);
    }
  }
}

template <bool DAG, typename PT, typename LT, typename OT>
void launch(const void* psi, const void* U, void* out, int T, int Z, int Y,
            int X, cudaStream_t st) {
  const long long V = (long long)T * Z * Y * X;
  const unsigned grid = (unsigned)((V + 127) / 128);
  dslash_hop_kernel<DAG, PT, LT, OT><<<grid, 128, 0, st>>>(
      static_cast<const PT*>(psi), static_cast<const LT*>(U),
      static_cast<OT*>(out), T, Z, Y, X);
}

using bf16 = __nv_bfloat16;

template <bool DAG, typename PT, typename LT>
void by_out(int out_bf16, const void* psi, const void* U, void* out, int T,
            int Z, int Y, int X, cudaStream_t st) {
  if (out_bf16) launch<DAG, PT, LT, bf16>(psi, U, out, T, Z, Y, X, st);
  else launch<DAG, PT, LT, float>(psi, U, out, T, Z, Y, X, st);
}

template <bool DAG, typename PT>
void by_link(int link_bf16, int out_bf16, const void* psi, const void* U,
             void* out, int T, int Z, int Y, int X, cudaStream_t st) {
  if (link_bf16) by_out<DAG, PT, bf16>(out_bf16, psi, U, out, T, Z, Y, X, st);
  else by_out<DAG, PT, float>(out_bf16, psi, U, out, T, Z, Y, X, st);
}

template <bool DAG>
void by_psi(int psi_bf16, int link_bf16, int out_bf16, const void* psi,
            const void* U, void* out, int T, int Z, int Y, int X,
            cudaStream_t st) {
  if (psi_bf16) by_link<DAG, bf16>(link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
  else by_link<DAG, float>(link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_dslash_hop(const void* psi, const void* U, void* out,
                                int T, int Z, int Y, int X, int dagger,
                                int psi_bf16, int link_bf16, int out_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dagger) by_psi<true>(psi_bf16, link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
  else by_psi<false>(psi_bf16, link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
  return static_cast<int>(cudaGetLastError());
}
