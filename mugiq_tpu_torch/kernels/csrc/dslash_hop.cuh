// K4's kernel, instantiated by dslash_hop.cu (one site a thread: every
// spinor, link and output type) and dslash_hop_pair.cu (two sites a
// thread: bf16 spinors), one nvcc each, run in parallel.  dslash_hop.cu
// has the notes on the operator, its layouts and this design.

#pragma once

#include "hop_common.cuh"

namespace {

// K sites a thread (K = 2: x even): K1's wilson_m_direct_kernel with no
// diagonal and no -kappa.
template <bool DAG, int K, typename PT, typename LT, typename OT>
__global__ void __launch_bounds__(128, min_blocks<K, false, LT>())
dslash_hop_kernel(const PT* __restrict__ psi, const LT* __restrict__ U,
                  OT* __restrict__ out, int T, int Z, int Y, int X) {
  const long long S = (long long)Y * X * Z;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (i >= S * T) return;
  const SiteK<K> q = site_k<K>(i, T, Z, Y, X);
  const long long ps_t = 24 * S, u_t = 72 * S;
  const LT* ut = U + q.t * u_t;
  float2 acc[K][4][3];
  hop8_direct<DAG, K>(psi + q.t * ps_t, psi + q.tp * ps_t, psi + q.tm * ps_t, ut, ut,
                      U + q.tm * u_t + 3 * 18 * S, S, q.n, acc);
  site_out<kHop, K>(psi, S, q.n.c, out + q.t * ps_t, static_cast<const LT*>(nullptr), S,
                    q.n.c, 0.f, acc);
}

using bf16 = __nv_bfloat16;

template <bool DAG, int K, typename PT, typename LT>
void by_out(int out_bf16, const void* psi, const void* U, void* out, int T, int Z, int Y,
            int X, cudaStream_t st) {
  const long long n = (long long)T * Z * Y * X / K;
  const unsigned grid = (unsigned)((n + 127) / 128);
  const PT* p = static_cast<const PT*>(psi);
  const LT* u = static_cast<const LT*>(U);
  if (out_bf16)
    dslash_hop_kernel<DAG, K, PT, LT, bf16>
        <<<grid, 128, 0, st>>>(p, u, static_cast<bf16*>(out), T, Z, Y, X);
  else
    dslash_hop_kernel<DAG, K, PT, LT, float>
        <<<grid, 128, 0, st>>>(p, u, static_cast<float*>(out), T, Z, Y, X);
}

template <bool DAG, int K, typename PT>
void by_link(int link_bf16, int out_bf16, const void* psi, const void* U, void* out, int T,
             int Z, int Y, int X, cudaStream_t st) {
  if (link_bf16) by_out<DAG, K, PT, bf16>(out_bf16, psi, U, out, T, Z, Y, X, st);
  else by_out<DAG, K, PT, float>(out_bf16, psi, U, out, T, Z, Y, X, st);
}

// The C entry points' body: cudaError_t of the launch (0 = success).  K =
// 1 takes every spinor type; K = 2 bf16 spinors only, X even and every
// operand's base two words aligned.
template <int K>
int dslash_hop_entry(const void* psi, const void* U, void* out, int T, int Z, int Y, int X,
                     int dagger, int psi_bf16, int link_bf16, int out_bf16, void* stream) {
  if (K == 2 && (!psi_bf16 || X % 2 || !pair_aligned(psi, sizeof(bf16)) ||
                 !pair_aligned(U, link_bf16 ? sizeof(bf16) : sizeof(float)) ||
                 !pair_aligned(out, out_bf16 ? sizeof(bf16) : sizeof(float))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (psi_bf16) {
    if (dagger) by_link<true, K, bf16>(link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
    else by_link<false, K, bf16>(link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
  } else if constexpr (K == 1) {
    if (dagger) by_link<true, K, float>(link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
    else by_link<false, K, float>(link_bf16, out_bf16, psi, U, out, T, Z, Y, X, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
