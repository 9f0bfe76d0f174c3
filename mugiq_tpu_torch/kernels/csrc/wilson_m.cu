// K1: fused Wilson(-clover) operator on the kernel layout, for Hopper.
//
//   out = A psi - kappa * D psi          (dagger = 0: M)
//   out = A psi - kappa * D^dag psi      (dagger = 1: M^dag)
//   D psi(x) = sum_mu (1 - g_mu) U_mu(x) psi(x+mu) + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu)
//
// Replaces the TPU kernel mugiq_tpu/pallas/dslash_kernel.py wilson_m_pallas
// (:395; body _make_m_kernel :310 -> make_slice_compute :168 -> apply_hop
// :82) and its grouped-lane tiling wilson_m_pallas_gl (:747).  The TPU
// versions exist in two tilings because of the TPU lane layout; here one
// thread computes one site, threads of a block run over consecutive sites
// of the fused Z*Y*X axis, so a warp reads 32 consecutive floats of every
// component plane of the site-minor layouts:
//   psi, out [T, 24, Z, Y*X]      comp = r*12 + s*3 + c
//   U        [T, 4, 18, Z, Y*X]   comp = r*9 + a*3 + b        (f32 or bf16)
//   A        [T, 144, Z, Y*X]     idx = ((chi*6 + k)*6 + j)*2 + r  (same type as U)
// Each directed hop projects to a half spinor, multiplies by the SU(3)
// link (the adjoint link for backward hops) and reconstructs.  For M^dag
// the two projectors swap (g5 is folded away), as in apply_hop.  Periodic
// neighbours come from explicit (t, z, y, x) index arithmetic: an x-hop at
// x = X-1 wraps within its row.  The backward t-hop reads the t-links of
// slice (t-1)%T straight from U.  Loads of bf16 links/clover upcast to f32;
// all arithmetic is f32.  The projector tables, the eight hops of a site
// (hop8) and the clover row live in hop_common.cuh; K4 (dslash_hop.cu) is
// the same hop8 with no diagonal and no combine.
//
// What bounds it on the H100: memory.  Per site it moves 24 floats of psi
// (plus 8 neighbour spinors, shared with other threads through L1/L2),
// 72 link words (8 hops: 4 local links, 4 neighbour links), 24 floats of
// output and, with clover, 144 more words, for 1320 flop (Wilson hop):
// ~1 flop/byte against a ridge of ~20 for f32 FMA.  Neighbour psi and link
// reuse is left to L1/L2 in this first version; shared-memory tiling of a
// t-slice block is later work.

#include "hop_common.cuh"

namespace {

template <bool DAG, bool CLOVER, typename LT>
__global__ void __launch_bounds__(128)
wilson_m_kernel(const float* __restrict__ psi, const LT* __restrict__ U,
                const LT* __restrict__ A, float* __restrict__ out,
                int T, int Z, int Y, int X, float kappa) {
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
  const float* pt = psi + t * ps_t;
  const long long zy = (long long)z * YX + (long long)y * X;
  const Nbr n{zyx, zy + xp, zy + xm,
              (long long)z * YX + (long long)yp * X + x,
              (long long)z * YX + (long long)ym * X + x,
              (long long)zp * YX + (long long)y * X + x,
              (long long)zm * YX + (long long)y * X + x};
  float2 acc[4][3];
  hop8<DAG>(pt, psi + tp * ps_t, psi + tm * ps_t, U + t * u_t, U + tm * u_t + 3 * 18 * S, S,
            n, acc);

  const float* pc = pt + zyx;
  float* o = out + t * ps_t + zyx;
  const LT* at = CLOVER ? A + t * 144 * S + zyx : nullptr;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float2 d;
      if constexpr (CLOVER) {
        d = clover_row(at, S, s, c, [&](int sj, int cj) { return spin(pc, S, sj, cj); });
      } else {
        d = spin(pc, S, s, c);
      }
      o[(long long)(s * 3 + c) * S] = d.x - kappa * acc[s][c].x;
      o[(long long)(12 + s * 3 + c) * S] = d.y - kappa * acc[s][c].y;
    }
  }
}

template <bool DAG, bool CLOVER, typename LT>
void launch(const void* psi, const void* U, const void* A, void* out,
            int T, int Z, int Y, int X, float kappa, cudaStream_t st) {
  const long long V = (long long)T * Z * Y * X;
  const unsigned grid = (unsigned)((V + 127) / 128);
  wilson_m_kernel<DAG, CLOVER, LT><<<grid, 128, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const LT*>(U),
      static_cast<const LT*>(A), static_cast<float*>(out), T, Z, Y, X, kappa);
}

template <typename LT>
void dispatch(const void* psi, const void* U, const void* A, void* out, int T,
              int Z, int Y, int X, float kappa, int dagger, int clover,
              cudaStream_t st) {
  if (dagger) {
    if (clover) launch<true, true, LT>(psi, U, A, out, T, Z, Y, X, kappa, st);
    else launch<true, false, LT>(psi, U, A, out, T, Z, Y, X, kappa, st);
  } else {
    if (clover) launch<false, true, LT>(psi, U, A, out, T, Z, Y, X, kappa, st);
    else launch<false, false, LT>(psi, U, A, out, T, Z, Y, X, kappa, st);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_wilson_m(const void* psi, const void* U, const void* A,
                              void* out, int T, int Z, int Y, int X,
                              float kappa, int dagger, int clover,
                              int link_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (link_bf16)
    dispatch<__nv_bfloat16>(psi, U, A, out, T, Z, Y, X, kappa, dagger, clover, st);
  else
    dispatch<float>(psi, U, A, out, T, Z, Y, X, kappa, dagger, clover, st);
  return static_cast<int>(cudaGetLastError());
}
