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
// Spinor forms: psi and out are both f32 or both bf16 (the stored vectors
// of a bf16 Krylov basis feed the operator as they are, as the JAX kernel
// takes psi's dtype for its output); loads upcast, arithmetic is f32, and
// a bf16 store rounds to nearest even (hop_common.cuh stf).  Batch: psi
// and out may hold b fields [b, T, 24, Z, Y*X] (block Lanczos applies the
// operator to a block, the JAX package through vmap of the Pallas call);
// one launch covers them, the batch index in the grid's y dimension and a
// field stride per vector.  The links are read once per vector.
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

template <bool DAG, bool CLOVER, typename LT, typename PT>
__global__ void __launch_bounds__(128)
wilson_m_kernel(const PT* __restrict__ psi, const LT* __restrict__ U,
                const LT* __restrict__ A, PT* __restrict__ out,
                int T, int Z, int Y, int X, float kappa) {
  const long long YX = (long long)Y * X;
  const long long S = YX * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * T) return;
  // vector blockIdx.y of the batch
  psi += (long long)blockIdx.y * 24 * S * T;
  out += (long long)blockIdx.y * 24 * S * T;
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
  const PT* pt = psi + t * ps_t;
  const long long zy = (long long)z * YX + (long long)y * X;
  const Nbr n{zyx, zy + xp, zy + xm,
              (long long)z * YX + (long long)yp * X + x,
              (long long)z * YX + (long long)ym * X + x,
              (long long)zp * YX + (long long)y * X + x,
              (long long)zm * YX + (long long)y * X + x};
  float2 acc[4][3];
  hop8<DAG>(pt, psi + tp * ps_t, psi + tm * ps_t, U + t * u_t, U + tm * u_t + 3 * 18 * S, S,
            n, acc);

  const PT* pc = pt + zyx;
  PT* o = out + t * ps_t + zyx;
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
      stf(o + (long long)(s * 3 + c) * S, d.x - kappa * acc[s][c].x);
      stf(o + (long long)(12 + s * 3 + c) * S, d.y - kappa * acc[s][c].y);
    }
  }
}

template <bool DAG, bool CLOVER, typename LT, typename PT>
void launch(const void* psi, const void* U, const void* A, void* out,
            int T, int Z, int Y, int X, float kappa, int batch, cudaStream_t st) {
  const long long V = (long long)T * Z * Y * X;
  const dim3 grid((unsigned)((V + 127) / 128), (unsigned)batch);
  wilson_m_kernel<DAG, CLOVER, LT, PT><<<grid, 128, 0, st>>>(
      static_cast<const PT*>(psi), static_cast<const LT*>(U),
      static_cast<const LT*>(A), static_cast<PT*>(out), T, Z, Y, X, kappa);
}

template <typename LT, typename PT>
void dispatch(const void* psi, const void* U, const void* A, void* out, int T,
              int Z, int Y, int X, float kappa, int dagger, int clover,
              int batch, cudaStream_t st) {
  if (dagger) {
    if (clover) launch<true, true, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
    else launch<true, false, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
  } else {
    if (clover) launch<false, true, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
    else launch<false, false, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  psi and out hold
// `batch` fields of the spinor type (bf16 if spinor_bf16, else f32).
extern "C" int mugiq_wilson_m(const void* psi, const void* U, const void* A,
                              void* out, int T, int Z, int Y, int X,
                              float kappa, int dagger, int clover,
                              int link_bf16, int spinor_bf16, int batch,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  if (link_bf16) {
    if (spinor_bf16)
      dispatch<bf16, bf16>(psi, U, A, out, T, Z, Y, X, kappa, dagger, clover, batch, st);
    else
      dispatch<bf16, float>(psi, U, A, out, T, Z, Y, X, kappa, dagger, clover, batch, st);
  } else {
    if (spinor_bf16)
      dispatch<float, bf16>(psi, U, A, out, T, Z, Y, X, kappa, dagger, clover, batch, st);
    else
      dispatch<float, float>(psi, U, A, out, T, Z, Y, X, kappa, dagger, clover, batch, st);
  }
  return static_cast<int>(cudaGetLastError());
}
