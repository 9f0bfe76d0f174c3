// K5: the Wilson hopping term restricted to a set of directed hops, on the
// kernel layout, for Hopper.
//
//   out(x) = sum over the hops in `mask` of
//            (1 - g_mu) U_mu(x) psi(x+mu)            bit 2*mu     (forward)
//            (1 + g_mu) U_mu(x-mu)^dag psi(x-mu)     bit 2*mu + 1 (backward)
//   dagger = 1 swaps the two projectors (D^dag = g5 D g5).
//
// No -kappa and no diagonal.  Replaces the TPU kernel
// mugiq_tpu/pallas/dslash_kernel.py dslash_hop_pallas_gl_dir (:736; body
// make_gl_compute :524 with dirs = {(mu, sign)}), the per-direction probe
// of the MG Galerkin build (mugiq_tpu/mg/kernel_mg.py:389).  The TPU
// kernel is one jit per (mu, sign); here the direction set is a runtime
// 8-bit mask, each set bit running one instance of the shared templated
// hop (hop_common.cuh).  The branch is uniform over the grid, so a
// one-bit mask reads only that hop's neighbour spinor and link, and the
// all-ones mask is the full hop D psi (K4's function, dslash_hop_pallas
// :436).  One thread computes one site and writes all 24 components, as
// K1 does (wilson_m.cu): a forward hop reads psi(x+mu) and U_mu(x), a
// backward hop psi(x-mu) and U_mu(x-mu), both at the neighbour; t wraps
// periodically on the phased links.  Links f32 or bf16 (upcast on load),
// arithmetic f32.
//
// What bounds it on the H100: memory.  One directed hop moves 96 B of
// neighbour spinor, 72 B of link (f32) and 96 B of output per site for
// 165 flop, ~0.6 flop/byte against a ridge of ~20; the design reads each
// operand once, coalesced (sites minor).  At 32^3x64 that is 554 MB,
// 0.165 ms at 3.35 TB/s.

#include "hop_common.cuh"

namespace {

template <bool DAG, typename LT>
__global__ void __launch_bounds__(128)
hop_dir_kernel(const float* __restrict__ psi, const LT* __restrict__ U,
               float* __restrict__ out, int T, int Z, int Y, int X,
               unsigned mask) {
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
  const long long u_mu = 18 * S;   // U mu-stride
  const float* pt = psi + t * ps_t;
  const LT* ut = U + t * u_t;
  const long long zy = (long long)z * YX + (long long)y * X;
  constexpr int FF = DAG ? 1 : 0;
  constexpr int FB = DAG ? 0 : 1;

  float2 acc[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[s][c] = make_float2(0.f, 0.f);

  if (mask & 0x01u) hop<0, FF, false>(pt + zy + xp, ut + 0 * u_mu + zyx, S, acc);
  if (mask & 0x02u) hop<0, FB, true>(pt + zy + xm, ut + 0 * u_mu + zy + xm, S, acc);
  if (mask & 0x0cu) {
    const long long fw = (long long)z * YX + (long long)yp * X + x;
    const long long bw = (long long)z * YX + (long long)ym * X + x;
    if (mask & 0x04u) hop<1, FF, false>(pt + fw, ut + 1 * u_mu + zyx, S, acc);
    if (mask & 0x08u) hop<1, FB, true>(pt + bw, ut + 1 * u_mu + bw, S, acc);
  }
  if (mask & 0x30u) {
    const long long fw = (long long)zp * YX + (long long)y * X + x;
    const long long bw = (long long)zm * YX + (long long)y * X + x;
    if (mask & 0x10u) hop<2, FF, false>(pt + fw, ut + 2 * u_mu + zyx, S, acc);
    if (mask & 0x20u) hop<2, FB, true>(pt + bw, ut + 2 * u_mu + bw, S, acc);
  }
  if (mask & 0x40u)
    hop<3, FF, false>(psi + tp * ps_t + zyx, ut + 3 * u_mu + zyx, S, acc);
  if (mask & 0x80u)
    hop<3, FB, true>(psi + tm * ps_t + zyx, U + tm * u_t + 3 * u_mu + zyx, S, acc);

  float* o = out + t * ps_t + zyx;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[(long long)(s * 3 + c) * S] = acc[s][c].x;
      o[(long long)(12 + s * 3 + c) * S] = acc[s][c].y;
    }
  }
}

template <bool DAG, typename LT>
void launch(const void* psi, const void* U, void* out, int T, int Z, int Y,
            int X, unsigned mask, cudaStream_t st) {
  const long long V = (long long)T * Z * Y * X;
  const unsigned grid = (unsigned)((V + 127) / 128);
  hop_dir_kernel<DAG, LT><<<grid, 128, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const LT*>(U),
      static_cast<float*>(out), T, Z, Y, X, mask);
}

template <typename LT>
void dispatch(const void* psi, const void* U, void* out, int T, int Z, int Y,
              int X, unsigned mask, int dagger, cudaStream_t st) {
  if (dagger) launch<true, LT>(psi, U, out, T, Z, Y, X, mask, st);
  else launch<false, LT>(psi, U, out, T, Z, Y, X, mask, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int mugiq_hop_dir(const void* psi, const void* U, void* out,
                             int T, int Z, int Y, int X, int mask,
                             int dagger, int link_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned m = static_cast<unsigned>(mask) & 0xffu;
  if (link_bf16)
    dispatch<__nv_bfloat16>(psi, U, out, T, Z, Y, X, m, dagger, st);
  else
    dispatch<float>(psi, U, out, T, Z, Y, X, m, dagger, st);
  return static_cast<int>(cudaGetLastError());
}
