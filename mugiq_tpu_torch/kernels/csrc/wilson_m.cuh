// K1's kernels, instantiated by wilson_m.cu and wilson_m_bf16.cu (one
// site a thread: f32 / bf16 spinors), wilson_m_pair.cu (two sites a thread: bf16 spinors),
// wilson_m_staged.cu and wilson_m_staged_pair.cu (a block tile of four
// vectors sharing staged links: f32 / bf16 spinors), one nvcc each, run in
// parallel.  wilson_m.cu has the notes on the operator, its layouts and
// this design.

#pragma once

#include "hop_common.cuh"

namespace {

// One vector, K sites a thread (K = 2: x even), the batch in grid y.
template <bool DAG, bool CLOVER, int K, typename LT, typename PT>
__global__ void __launch_bounds__(128, min_blocks<K, false, LT>())
wilson_m_direct_kernel(const PT* __restrict__ psi, const LT* __restrict__ U,
                       const LT* __restrict__ A, PT* __restrict__ out, int T, int Z, int Y,
                       int X, float kappa) {
  const long long S = (long long)Y * X * Z;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (i >= S * T) return;
  const long long field = (long long)blockIdx.y * 24 * S * T;
  const SiteK<K> q = site_k<K>(i, T, Z, Y, X);
  const long long ps_t = 24 * S, u_t = 72 * S;
  const PT* p = psi + field;
  const LT* ut = U + q.t * u_t;
  float2 acc[K][4][3];
  hop8_direct<DAG, K>(p + q.t * ps_t, p + q.tp * ps_t, p + q.tm * ps_t, ut, ut,
                      U + q.tm * u_t + 3 * 18 * S, S, q.n, acc);
  site_out<CLOVER ? kClover : kWilson, K>(p + q.t * ps_t, S, q.n.c, out + field + q.t * ps_t,
                                          CLOVER ? A + q.t * 144 * S : nullptr, S, q.n.c,
                                          kappa, acc);
}

// The block tile: TILE_SITES threads along the sites (K sites each) times
// TILE_NV vectors (threadIdx.y); the block stages its sites' eight links
// in shared memory once and every vector row reads them there, so the
// links are read from memory once per tile of TILE_NV vectors.
constexpr int TILE_SITES = 32, TILE_NV = 4;

template <bool DAG, bool CLOVER, int K, typename LT, typename PT>
__global__ void __launch_bounds__(TILE_SITES * TILE_NV, min_blocks<K, true, LT>())
wilson_m_staged_kernel(const PT* __restrict__ psi, const LT* __restrict__ U,
                       const LT* __restrict__ A, PT* __restrict__ out, int T, int Z, int Y,
                       int X, float kappa, int batch) {
  constexpr int BSK = TILE_SITES * K;
  __shared__ float2 sm[8 * 9 * BSK];
  const long long S = (long long)Y * X * Z;
  const long long i = ((long long)blockIdx.x * TILE_SITES + threadIdx.x) * K;
  const bool live = i < S * T;
  const SiteK<K> q = site_k<K>(live ? i : 0, T, Z, Y, X);
  const long long ps_t = 24 * S, u_t = 72 * S;
  const LT* ut = U + q.t * u_t;
  const int j0 = threadIdx.x * K;
  if (live)
    stage_links<K, TILE_NV>(ut, ut, U + q.tm * u_t + 3 * 18 * S, S, q.n, sm, j0, BSK,
                            threadIdx.y);
  __syncthreads();
  const int v = blockIdx.y * TILE_NV + threadIdx.y;
  if (!live || v >= batch) return;
  const long long field = (long long)v * 24 * S * T;
  const PT* p = psi + field;
  float2 acc[K][4][3];
  hop8_staged<DAG, K>(p + q.t * ps_t, p + q.tp * ps_t, p + q.tm * ps_t, S, q.n, sm, j0, BSK,
                      acc);
  site_out<CLOVER ? kClover : kWilson, K>(p + q.t * ps_t, S, q.n.c, out + field + q.t * ps_t,
                                          CLOVER ? A + q.t * 144 * S : nullptr, S, q.n.c,
                                          kappa, acc);
}

template <bool DAG, bool CLOVER, int K, bool STAGED, typename LT, typename PT>
void launch_k1(const void* psi, const void* U, const void* A, void* out, int T, int Z, int Y,
               int X, float kappa, int batch, cudaStream_t st) {
  const long long n = (long long)T * Z * Y * X / K;
  const PT* p = static_cast<const PT*>(psi);
  const LT* u = static_cast<const LT*>(U);
  const LT* a = static_cast<const LT*>(A);
  PT* o = static_cast<PT*>(out);
  if constexpr (STAGED) {
    const dim3 grid((unsigned)((n + TILE_SITES - 1) / TILE_SITES),
                    (unsigned)((batch + TILE_NV - 1) / TILE_NV));
    wilson_m_staged_kernel<DAG, CLOVER, K, LT, PT>
        <<<grid, dim3(TILE_SITES, TILE_NV), 0, st>>>(p, u, a, o, T, Z, Y, X, kappa, batch);
  } else {
    const dim3 grid((unsigned)((n + 127) / 128), (unsigned)batch);
    wilson_m_direct_kernel<DAG, CLOVER, K, LT, PT>
        <<<grid, 128, 0, st>>>(p, u, a, o, T, Z, Y, X, kappa);
  }
}

template <int K, bool STAGED, typename LT, typename PT>
void dispatch_k1(const void* psi, const void* U, const void* A, void* out, int T, int Z, int Y,
                 int X, float kappa, int dagger, int clover, int batch, cudaStream_t st) {
  if (dagger) {
    if (clover)
      launch_k1<true, true, K, STAGED, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
    else
      launch_k1<true, false, K, STAGED, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
  } else {
    if (clover)
      launch_k1<false, true, K, STAGED, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
    else
      launch_k1<false, false, K, STAGED, LT, PT>(psi, U, A, out, T, Z, Y, X, kappa, batch, st);
  }
}

// The C entry points' body for spinors of type PT: cudaError_t of the
// launch (0 = success).  K = 2 needs X even and every operand's base two
// words aligned (the pairs' loads and stores).
template <int K, bool STAGED, typename PT>
int wilson_m_entry(const void* psi, const void* U, const void* A, void* out, int T, int Z,
                   int Y, int X, float kappa, int dagger, int clover, int link_bf16, int batch,
                   void* stream) {
  const int tiles = STAGED ? (batch + TILE_NV - 1) / TILE_NV : batch;
  if (batch < 1 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t lw = link_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (K == 2 && (X % 2 || !pair_aligned(psi, sizeof(PT)) || !pair_aligned(out, sizeof(PT)) ||
                 !pair_aligned(U, lw) || !pair_aligned(clover ? A : nullptr, lw)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (link_bf16)
    dispatch_k1<K, STAGED, __nv_bfloat16, PT>(psi, U, A, out, T, Z, Y, X, kappa, dagger,
                                              clover, batch, st);
  else
    dispatch_k1<K, STAGED, float, PT>(psi, U, A, out, T, Z, Y, X, kappa, dagger, clover,
                                      batch, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
