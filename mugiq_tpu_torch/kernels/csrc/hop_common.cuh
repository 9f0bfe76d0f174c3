// Shared device code of the hopping-term kernels (K1 wilson_m.cu, K4
// dslash_hop.cu, K5 hop_dir.cu, K6 parity_hop.cu, K7 wilson_m_halo.cuh /
// parity_hop_halo.cuh): the half-spinor projector tables, the one-hop
// helper, the eight hops of one site of a full-volume field, and the
// chiral clover-block row.
//
// Field layouts (sites minor; S is the stride between component planes,
// the number of sites of one t-slice):
//   spinor  comp = r*12 + s*3 + c                   (f32, or bf16 for K1, K4, K6)
//   link    comp = r*9 + a*3 + b                    (f32 or bf16)
//   clover  idx  = ((chi*6 + k)*6 + j)*2 + r        (f32 or bf16)
// Loads of bf16 upcast to f32; all arithmetic is f32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

// Half-spinor tables: mugiq_tpu's _projector_decomp (Q [2,4], R [4,2],
// R Q = 1 -/+ g_mu) scaled as Q' = sqrt(2) Q, R' = R / sqrt(2), so every
// nonzero is a unit phase i^k and R' Q' = R Q.  Row h of Q' has two
// nonzeros: h = i^qk[h][0] psi[qs[h][0]] + i^qk[h][1] psi[qs[h][1]];
// row s of R' has one: out[s] += i^rk[s] g[rh[s]].
// f = 0: 'fwd' table (1 - g_mu), f = 1: 'bwd' table (1 + g_mu).
struct ProjTab {
  int qs[2][2];
  int qk[2][2];
  int rh[4];
  int rk[4];
};

__host__ __device__ constexpr ProjTab proj_tab(int mu, int f) {
  if (mu == 0 && f == 0) return ProjTab{{{1, 2}, {0, 3}}, {{0, 3}, {2, 1}}, {1, 0, 0, 1}, {2, 0, 1, 3}};
  if (mu == 0 && f == 1) return ProjTab{{{1, 2}, {0, 3}}, {{0, 1}, {2, 3}}, {1, 0, 0, 1}, {2, 0, 3, 1}};
  if (mu == 1 && f == 0) return ProjTab{{{0, 3}, {1, 2}}, {{2, 2}, {0, 2}}, {0, 1, 1, 0}, {2, 0, 2, 2}};
  if (mu == 1 && f == 1) return ProjTab{{{0, 3}, {1, 2}}, {{2, 0}, {0, 0}}, {0, 1, 1, 0}, {2, 0, 0, 0}};
  if (mu == 2 && f == 0) return ProjTab{{{1, 3}, {0, 2}}, {{0, 1}, {2, 1}}, {1, 0, 1, 0}, {2, 0, 3, 3}};
  if (mu == 2 && f == 1) return ProjTab{{{1, 3}, {0, 2}}, {{0, 3}, {2, 3}}, {1, 0, 1, 0}, {2, 0, 1, 1}};
  if (mu == 3 && f == 0) return ProjTab{{{0, 2}, {1, 3}}, {{2, 0}, {0, 2}}, {0, 1, 0, 1}, {2, 0, 0, 2}};
  return ProjTab{{{0, 2}, {1, 3}}, {{2, 2}, {0, 0}}, {0, 1, 0, 1}, {2, 0, 2, 0}};  // mu 3, f 1
}

// a * i^k (exact: a swap and sign flips)
__device__ __forceinline__ float2 ipow(int k, float2 a) {
  switch (k & 3) {
    case 0: return a;
    case 1: return make_float2(-a.y, a.x);
    case 2: return make_float2(-a.x, -a.y);
    default: return make_float2(a.y, -a.x);
  }
}

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// f32 -> the output type; bf16 rounds to nearest even, as XLA's astype
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// spinor component (s, c) of the site whose comp-0 word is at p
template <typename PT>
__device__ __forceinline__ float2 spin(const PT* __restrict__ p, long long S, int s, int c) {
  return make_float2(ldf(p + (long long)(s * 3 + c) * S),
                     ldf(p + (long long)(12 + s * 3 + c) * S));
}

// One directed hop: acc += R' (U or U^dag) Q' psi_nbr.
// p: neighbour spinor (comp 0); u: link (comp 0) at the link's site.
template <int MU, int F, bool UDAG, typename PT, typename LT>
__device__ __forceinline__ void hop(const PT* __restrict__ p, const LT* __restrict__ u,
                                    long long S, float2 acc[4][3]) {
  constexpr ProjTab P = proj_tab(MU, F);
  float2 h[2][3];
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 a = ipow(P.qk[hs][0], spin(p, S, P.qs[hs][0], c));
      const float2 b = ipow(P.qk[hs][1], spin(p, S, P.qs[hs][1], c));
      h[hs][c] = make_float2(a.x + b.x, a.y + b.y);
    }
  }
  float2 g[2][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float2 ua[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      // U[a][b], or conj(U[b][a]) for the adjoint link
      const int e = UDAG ? (b * 3 + a) : (a * 3 + b);
      const float re = ldf(u + (long long)e * S);
      const float im = ldf(u + (long long)(9 + e) * S);
      ua[b] = make_float2(re, UDAG ? -im : im);
    }
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        s.x += ua[b].x * h[hs][b].x - ua[b].y * h[hs][b].y;
        s.y += ua[b].x * h[hs][b].y + ua[b].y * h[hs][b].x;
      }
      g[hs][a] = s;
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 v = ipow(P.rk[s], g[P.rh[s]][c]);
      acc[s][c].x += v.x;
      acc[s][c].y += v.y;
    }
  }
}

// Offsets, within one t-slice, of a site and of its x/y/z neighbours.
struct Nbr {
  long long c, xp, xm, yp, ym, zp, zm;
};

// D psi at one site (D^dag psi with DAG: the two projectors swap), the
// eight directed hops in K1's order x, y, z, t, forward before backward:
//   (1 - g_mu) U_mu(x) psi(x+mu) + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu).
// pc / pp / pm: comp 0 of the spinor t-slices t, t+1, t-1; uc: comp 0 of
// the links [4][18] of slice t; utm: comp 0 of the t-links [18] of slice
// t-1; S: the plane stride of all of them; n: the site's and its
// neighbours' offsets within a slice.
template <bool DAG, typename PT, typename LT>
__device__ __forceinline__ void hop8(const PT* __restrict__ pc, const PT* __restrict__ pp,
                                     const PT* __restrict__ pm, const LT* __restrict__ uc,
                                     const LT* __restrict__ utm, long long S, const Nbr& n,
                                     float2 acc[4][3]) {
  // forward hops use 'fwd' (1 - g) for D and 'bwd' (1 + g) for D^dag
  constexpr int FF = DAG ? 1 : 0;
  constexpr int FB = DAG ? 0 : 1;
  const long long u_mu = 18 * S;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[s][c] = make_float2(0.f, 0.f);
  hop<0, FF, false>(pc + n.xp, uc + 0 * u_mu + n.c, S, acc);
  hop<0, FB, true>(pc + n.xm, uc + 0 * u_mu + n.xm, S, acc);
  hop<1, FF, false>(pc + n.yp, uc + 1 * u_mu + n.c, S, acc);
  hop<1, FB, true>(pc + n.ym, uc + 1 * u_mu + n.ym, S, acc);
  hop<2, FF, false>(pc + n.zp, uc + 2 * u_mu + n.c, S, acc);
  hop<2, FB, true>(pc + n.zm, uc + 2 * u_mu + n.zm, S, acc);
  hop<3, FF, false>(pp + n.c, uc + 3 * u_mu + n.c, S, acc);
  hop<3, FB, true>(pm + n.c, utm + n.c, S, acc);
}

// Row (s, c) of the chiral 6x6 clover block times a spinor:
// sum_j A[chi][k][j] v(2 chi + j / 3, j % 3), chi = s / 2, k = (s % 2)*3 + c.
// a: the block word idx 0 of the site; v(s, c) -> float2 gives the spinor.
template <typename LT, typename V>
__device__ __forceinline__ float2 clover_row(const LT* __restrict__ a, long long S,
                                             int s, int c, V v) {
  const int chi = s / 2, k = (s % 2) * 3 + c;
  float2 d = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int idx = ((chi * 6 + k) * 6 + j) * 2;
    const float ar = ldf(a + (long long)idx * S);
    const float ai = ldf(a + (long long)(idx + 1) * S);
    const float2 w = v(2 * chi + j / 3, j % 3);
    d.x += ar * w.x - ai * w.y;
    d.y += ar * w.y + ai * w.x;
  }
  return d;
}

}  // namespace
