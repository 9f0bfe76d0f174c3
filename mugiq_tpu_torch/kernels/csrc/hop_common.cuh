// Shared device code of the hopping-term kernels (K1 wilson_m.cuh, K4
// dslash_hop.cuh, K5 hop_dir.cu, K6 parity_hop.cuh, K7a / K4-halo
// wilson_m_halo.cuh, K7b parity_hop_halo.cuh): the half-spinor projector
// tables, the one-hop helper and the chiral clover-block row (K5, K7b);
// and the tile helpers of K1, K4, K6, K7a and K4-halo: K x-adjacent sites
// of one thread, the eight hops of them, their output, and for K1's and
// K6's batches a block tile of vectors sharing each link.
//
// Field layouts (sites minor; S is the stride between component planes,
// the number of sites of one t-slice):
//   spinor  comp = r*12 + s*3 + c                   (f32 or bf16)
//   link    comp = r*9 + a*3 + b                    (f32 or bf16)
//   clover  idx  = ((chi*6 + k)*6 + j)*2 + r        (f32 or bf16)
// Loads of bf16 upcast to f32; all arithmetic is f32.

#pragma once

#include <cstdint>

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
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

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

// ---------------------------------------------------------------------------
// Tile helpers of K1 and K6 (wilson_m.cuh, parity_hop.cuh).  A thread
// computes K x-adjacent sites of one vector (K = 1, or K = 2 with the
// first x even: every aligned plane pair is one load, four bytes of bf16);
// a block tile of vectors shares each link through shared memory.  The
// arithmetic rounds every operation explicitly (cadd, cfma: no
// contraction left to the compiler), so that every instance computes a
// vector bit for bit alike, whatever its K, its staging or its batch.
// ---------------------------------------------------------------------------

// Two consecutive words p[0], p[1] of a plane in one load through the
// read-only path (8 bytes of f32, 4 of bf16; p two-word aligned), as f32.
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// Two words of the output type in one store; bf16 rounds each to nearest
// even, as stf
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Where a thread's K sites sit in a component plane.  One: one site at o.
// Pair2: the aligned pair o, o + 1 (o even), one load.  Split2: two sites
// at o0 and o1 (the x neighbours of a pair, no aligned pair), two loads.
struct One {
  long long o;
};
struct Pair2 {
  long long o;
};
struct Split2 {
  long long o0, o1;
};

template <typename T>
__device__ __forceinline__ void ldk(const T* __restrict__ p, One a, float (&v)[1]) {
  v[0] = ldf(p + a.o);
}
template <typename T>
__device__ __forceinline__ void ldk(const T* __restrict__ p, Pair2 a, float (&v)[2]) {
  const float2 w = ld2(p + a.o);
  v[0] = w.x;
  v[1] = w.y;
}
template <typename T>
__device__ __forceinline__ void ldk(const T* __restrict__ p, Split2 a, float (&v)[2]) {
  v[0] = ldf(p + a.o0);
  v[1] = ldf(p + a.o1);
}
template <typename T>
__device__ __forceinline__ void stk(T* __restrict__ p, One a, const float (&v)[1]) {
  stf(p + a.o, v[0]);
}
template <typename T>
__device__ __forceinline__ void stk(T* __restrict__ p, Pair2 a, const float (&v)[2]) {
  st2(p + a.o, v[0], v[1]);
}

// The placements of K sites: At for the sites themselves and their y, z,
// t neighbours (aligned), Xs for their x neighbours in row zy, at columns
// c0 (site 0) and c1 (site 1).
template <int K>
struct Lanes;
template <>
struct Lanes<1> {
  using At = One;
  using Xs = One;
  static __device__ __forceinline__ At at(long long o) { return One{o}; }
  static __device__ __forceinline__ Xs xs(long long zy, int c0, int) { return One{zy + c0}; }
};
template <>
struct Lanes<2> {
  using At = Pair2;
  using Xs = Split2;
  static __device__ __forceinline__ At at(long long o) { return Pair2{o}; }
  static __device__ __forceinline__ Xs xs(long long zy, int c0, int c1) {
    return Split2{zy + c0, zy + c1};
  }
};

// Where the eight hops of a thread's K sites read: the sites (c) and their
// y and z neighbours, aligned; the x neighbours (forward xf, backward xb)
// for the spinor and for the backward link.
template <int K>
struct TileNbr {
  typename Lanes<K>::At c, yp, ym, zp, zm;
  typename Lanes<K>::Xs xf, xb;
};

// Blocks of 128 threads that ptxas must fit on one SM, which caps its
// registers at 65536 / 128 / blocks, for K1, K4 and K6: the one-site
// kernel 3 (168 registers), a pair 3 with bf16 links and 1 with f32
// links, a block tile 4 (128) with one site a thread and 3 with pairs.
// Left alone, ptxas takes 255 registers (two blocks) and runs slower;
// tighter caps spill (the caps timed against each other: PERF.md
// section 6).  The halo kernel has its own (wilson_m_halo.cuh).
template <int K, bool STAGED, typename LT>
__host__ __device__ constexpr int min_blocks() {
  if (STAGED) return K == 1 ? 4 : 3;
  if (K == 1) return 3;
  return sizeof(LT) == 2 ? 3 : 1;
}

// a + b and acc + u h (complex), each operation rounded once, in order
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 cfma(float2 u, float2 h, float2 acc) {
  return make_float2(__fmaf_rn(-u.y, h.y, __fmaf_rn(u.x, h.x, acc.x)),
                     __fmaf_rn(u.y, h.x, __fmaf_rn(u.x, h.y, acc.y)));
}

// The half spinor Q' psi of one vector at K sites (hop's first step): the
// neighbour spinor at ps, each pair of spin planes added in exact rounding.
template <int MU, int F, int K, typename PT, typename L>
__device__ __forceinline__ void project_k(const PT* __restrict__ p, L ps, long long S,
                                          float2 (&h)[K][2][3]) {
  constexpr ProjTab P = proj_tab(MU, F);
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float ar[K], ai[K], br[K], bi[K];
      ldk(p + (long long)(P.qs[hs][0] * 3 + c) * S, ps, ar);
      ldk(p + (long long)(12 + P.qs[hs][0] * 3 + c) * S, ps, ai);
      ldk(p + (long long)(P.qs[hs][1] * 3 + c) * S, ps, br);
      ldk(p + (long long)(12 + P.qs[hs][1] * 3 + c) * S, ps, bi);
#pragma unroll
      for (int k = 0; k < K; ++k)
        h[k][hs][c] = cadd(ipow(P.qk[hs][0], make_float2(ar[k], ai[k])),
                           ipow(P.qk[hs][1], make_float2(br[k], bi[k])));
    }
  }
}

// Row a of the link times the half spinor, g[hs][a] = sum_b ua_a[b] h[hs][b]
template <int K>
__device__ __forceinline__ void mul_row(const float2 (&ua)[K][3], const float2 (&h)[K][2][3],
                                        int a, float2 (&g)[K][2][3]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int b = 0; b < 3; ++b) s = cfma(ua[k][b], h[k][hs][b], s);
      g[k][hs][a] = s;
    }
  }
}

// acc += R' g, the reconstruction (exact rounding)
template <int MU, int F, int K>
__device__ __forceinline__ void recon_k(const float2 (&g)[K][2][3], float2 (&acc)[K][4][3]) {
  constexpr ProjTab P = proj_tab(MU, F);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[k][s][c] = cadd(acc[k][s][c], ipow(P.rk[s], g[k][P.rh[s]][c]));
}

// Row a of the link of one hop at K sites, U[a][b], or conj(U[b][a]) for
// the adjoint link, as hop reads it.
template <bool UDAG, int K, typename LT, typename L>
__device__ __forceinline__ void link_row_k(const LT* __restrict__ u, L at, long long S, int a,
                                           float2 (&ua)[K][3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int e = UDAG ? (b * 3 + a) : (a * 3 + b);
    float re[K], im[K];
    ldk(u + (long long)e * S, at, re);
    ldk(u + (long long)(9 + e) * S, at, im);
#pragma unroll
    for (int k = 0; k < K; ++k) ua[k][b] = make_float2(re[k], UDAG ? -im[k] : im[k]);
  }
}

// One directed hop of one vector at K sites, acc += R' U Q' psi: the
// neighbour spinor (at ps) projected to a half spinor, multiplied by the
// link row by row (row(a, ua_a) gives row a) and reconstructed, hop's
// steps in exact rounding.
template <int MU, int F, int K, typename PT, typename L, typename R>
__device__ __forceinline__ void apply_k(const PT* __restrict__ p, L ps, long long S, R row,
                                        float2 (&acc)[K][4][3]) {
  float2 h[K][2][3], g[K][2][3];
  project_k<MU, F, K>(p, ps, S, h);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float2 ua[K][3];
    row(a, ua);
    mul_row<K>(ua, h, a, g);
  }
  recon_k<MU, F, K>(g, acc);
}

// Where the link of hop H (0-7: x, y, z, t, forward before backward) is
// read at the thread's K sites, and its row a: from uf at the sites for
// the forward hops, from ub at the neighbours for the backward ones (utm:
// the t-links of slice t-1).
template <int H, int K, typename LT>
__device__ __forceinline__ void hop_link_row(const LT* __restrict__ uf,
                                             const LT* __restrict__ ub,
                                             const LT* __restrict__ utm, long long S,
                                             const TileNbr<K>& n, int a, float2 (&ua)[K][3]) {
  const long long u_mu = 18 * S;
  if constexpr (H == 0) link_row_k<false, K>(uf, n.c, S, a, ua);
  else if constexpr (H == 1) link_row_k<true, K>(ub, n.xb, S, a, ua);
  else if constexpr (H == 2) link_row_k<false, K>(uf + u_mu, n.c, S, a, ua);
  else if constexpr (H == 3) link_row_k<true, K>(ub + u_mu, n.ym, S, a, ua);
  else if constexpr (H == 4) link_row_k<false, K>(uf + 2 * u_mu, n.c, S, a, ua);
  else if constexpr (H == 5) link_row_k<true, K>(ub + 2 * u_mu, n.zm, S, a, ua);
  else if constexpr (H == 6) link_row_k<false, K>(uf + 3 * u_mu, n.c, S, a, ua);
  else link_row_k<true, K>(utm, n.c, S, a, ua);
}

// acc += hop H of one vector at K sites (pc / pp / pm: comp 0 of its
// spinor t-slices t, t+1, t-1), the link's rows from row(a, ua_a); DAG
// swaps the projectors.
template <int H, bool DAG, int K, typename PT, typename R>
__device__ __forceinline__ void hop_apply(const PT* __restrict__ pc, const PT* __restrict__ pp,
                                          const PT* __restrict__ pm, long long S,
                                          const TileNbr<K>& n, R row, float2 (&acc)[K][4][3]) {
  // forward hops use 'fwd' (1 - g) for D and 'bwd' (1 + g) for D^dag
  constexpr int F = (H % 2 == 0) == DAG ? 1 : 0;
  if constexpr (H == 0) apply_k<0, F, K>(pc, n.xf, S, row, acc);
  else if constexpr (H == 1) apply_k<0, F, K>(pc, n.xb, S, row, acc);
  else if constexpr (H == 2) apply_k<1, F, K>(pc, n.yp, S, row, acc);
  else if constexpr (H == 3) apply_k<1, F, K>(pc, n.ym, S, row, acc);
  else if constexpr (H == 4) apply_k<2, F, K>(pc, n.zp, S, row, acc);
  else if constexpr (H == 5) apply_k<2, F, K>(pc, n.zm, S, row, acc);
  else if constexpr (H == 6) apply_k<3, F, K>(pp, n.c, S, row, acc);
  else apply_k<3, F, K>(pm, n.c, S, row, acc);
}

template <int K>
__device__ __forceinline__ void zero_acc(float2 (&acc)[K][4][3]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[k][s][c] = make_float2(0.f, 0.f);
}

// The eight hops of one vector at K sites, each link read from memory
// row by row (one vector per thread, the batch in the grid's y dimension).
template <bool DAG, int K, typename PT, typename LT>
__device__ __forceinline__ void hop8_direct(const PT* __restrict__ pc, const PT* __restrict__ pp,
                                            const PT* __restrict__ pm,
                                            const LT* __restrict__ uf,
                                            const LT* __restrict__ ub,
                                            const LT* __restrict__ utm, long long S,
                                            const TileNbr<K>& n, float2 (&acc)[K][4][3]) {
  zero_acc<K>(acc);
#define MUGIQ_HOP(H)                                                               \
  hop_apply<H, DAG, K>(pc, pp, pm, S, n, [&](int a, float2(&ua)[K][3]) {           \
    hop_link_row<H, K>(uf, ub, utm, S, n, a, ua);                                  \
  }, acc);
  MUGIQ_HOP(0) MUGIQ_HOP(1) MUGIQ_HOP(2) MUGIQ_HOP(3)
  MUGIQ_HOP(4) MUGIQ_HOP(5) MUGIQ_HOP(6) MUGIQ_HOP(7)
#undef MUGIQ_HOP
}

// Shared links of a block tile: float2 sm[8 hops][9 entries][BSK sites],
// entry a*3 + b of the (adjoint, for backward hops) link as hop_link reads
// it.  The thread of vector row ty stages hops ty, ty + NV, ... at its own
// K sites (j0 = its first site in the block); every row then reads all
// eight.
template <int H, int K, typename LT>
__device__ __forceinline__ void stage_one(const LT* __restrict__ uf, const LT* __restrict__ ub,
                                          const LT* __restrict__ utm, long long S,
                                          const TileNbr<K>& n, float2* sm, int j0, int BSK) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float2 ua[K][3];
    hop_link_row<H, K>(uf, ub, utm, S, n, a, ua);
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int k = 0; k < K; ++k) sm[(H * 9 + a * 3 + b) * BSK + j0 + k] = ua[k][b];
  }
}

template <int K, int NV, typename LT>
__device__ __forceinline__ void stage_links(const LT* __restrict__ uf, const LT* __restrict__ ub,
                                            const LT* __restrict__ utm, long long S,
                                            const TileNbr<K>& n, float2* sm, int j0, int BSK,
                                            int ty) {
#pragma unroll
  for (int r = 0; r < 8 / NV; ++r) {
    switch (ty + r * NV) {
      case 0: stage_one<0, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
      case 1: stage_one<1, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
      case 2: stage_one<2, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
      case 3: stage_one<3, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
      case 4: stage_one<4, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
      case 5: stage_one<5, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
      case 6: stage_one<6, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
      default: stage_one<7, K>(uf, ub, utm, S, n, sm, j0, BSK); break;
    }
  }
}

// The eight hops of one vector at K sites with the block's staged links.
template <bool DAG, int K, typename PT>
__device__ __forceinline__ void hop8_staged(const PT* __restrict__ pc, const PT* __restrict__ pp,
                                            const PT* __restrict__ pm, long long S,
                                            const TileNbr<K>& n, const float2* sm, int j0,
                                            int BSK, float2 (&acc)[K][4][3]) {
  zero_acc<K>(acc);
#define MUGIQ_HOP(H)                                                               \
  hop_apply<H, DAG, K>(pc, pp, pm, S, n, [&](int a, float2(&ua)[K][3]) {           \
    _Pragma("unroll") for (int b = 0; b < 3; ++b)                                  \
        _Pragma("unroll") for (int k = 0; k < K; ++k)                              \
            ua[k][b] = sm[(H * 9 + a * 3 + b) * BSK + j0 + k];                     \
  }, acc);
  MUGIQ_HOP(0) MUGIQ_HOP(1) MUGIQ_HOP(2) MUGIQ_HOP(3)
  MUGIQ_HOP(4) MUGIQ_HOP(5) MUGIQ_HOP(6) MUGIQ_HOP(7)
#undef MUGIQ_HOP
}

// Row (s, c) of the chiral clover block at K sites, row[k][j] =
// A[chi][(s % 2)*3 + c][j] (the words clover_row reads).
template <int K, typename LT, typename L>
__device__ __forceinline__ void clover_row_k(const LT* __restrict__ a, L at, long long S, int s,
                                             int c, float2 (&row)[K][6]) {
  const int chi = s / 2, k = (s % 2) * 3 + c;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int idx = ((chi * 6 + k) * 6 + j) * 2;
    float re[K], im[K];
    ldk(a + (long long)idx * S, at, re);
    ldk(a + (long long)(idx + 1) * S, at, im);
#pragma unroll
    for (int q = 0; q < K; ++q) row[q][j] = make_float2(re[q], im[q]);
  }
}

// The six spinor words (2 chi + j / 3, j % 3), chi = s / 2, of one vector
// at K sites: w[k][j].
template <int K, typename PT, typename L>
__device__ __forceinline__ void chiral_k(const PT* __restrict__ p, L at, long long S, int s,
                                         float2 (&w)[K][6]) {
  const int chi = s / 2;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int sc = (2 * chi + j / 3) * 3 + j % 3;
    float re[K], im[K];
    ldk(p + (long long)sc * S, at, re);
    ldk(p + (long long)(12 + sc) * S, at, im);
#pragma unroll
    for (int q = 0; q < K; ++q) w[q][j] = make_float2(re[q], im[q]);
  }
}

// A loaded clover row times six spinor words, sum_j row[j] w[j], in exact
// rounding.
__device__ __forceinline__ float2 row_dot(const float2 (&row)[6], const float2 (&w)[6]) {
  float2 d = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 6; ++j) d = cfma(row[j], w[j], d);
  return d;
}

// The indices of a thread's K sites starting at fused site i (t-major) of
// a full-volume field (K1, K4): t, the sites' neighbours within slice t,
// and t+1 / t-1.
template <int K>
struct SiteK {
  int t, tp, tm;
  TileNbr<K> n;
};

template <int K>
__device__ __forceinline__ SiteK<K> site_k(long long i, int T, int Z, int Y, int X) {
  using Ln = Lanes<K>;
  const long long YX = (long long)Y * X;
  const long long S = YX * Z;
  const int t = (int)(i / S);
  const long long zyx = i - (long long)t * S;
  const int z = (int)(zyx / YX);
  const int y = (int)((zyx / X) % Y);
  const int x = (int)(zyx % X);
  const int yp = y + 1 == Y ? 0 : y + 1, ym = y == 0 ? Y - 1 : y - 1;
  const int zp = z + 1 == Z ? 0 : z + 1, zm = z == 0 ? Z - 1 : z - 1;
  const long long zy = (long long)z * YX + (long long)y * X;
  // x neighbours of sites x .. x+K-1 in their row: x+1 .. x+K forward,
  // x-1 .. x+K-2 backward
  const int c1 = x + 1 == X ? 0 : x + 1, c2 = x + 2 >= X ? x + 2 - X : x + 2;
  const int cm = x == 0 ? X - 1 : x - 1;
  return SiteK<K>{t, t + 1 == T ? 0 : t + 1, t == 0 ? T - 1 : t - 1,
                  TileNbr<K>{Ln::at(zyx),
                             Ln::at((long long)z * YX + (long long)yp * X + x),
                             Ln::at((long long)z * YX + (long long)ym * X + x),
                             Ln::at((long long)zp * YX + (long long)y * X + x),
                             Ln::at((long long)zm * YX + (long long)y * X + x),
                             Ln::xs(zy, c1, c2), Ln::xs(zy, cm, x)}};
}

// The diagonal of an output: none (K4, K4-halo: the bare hop), Wilson
// (psi), clover (the chiral blocks times psi)
enum Diag { kHop = 0, kWilson = 1, kClover = 2 };

// The output of K sites of one vector from their hop sum acc: out = acc
// (kHop), or out = A psi - kappa acc (A = 1 for kWilson), each operation
// rounded once, the store rounding to the output type OT.  psi: comp 0 of
// its t-slice, plane stride Sp, the sites at cp; out and the clover
// blocks: comp 0 of their t-slices, plane stride So, the sites at co (K1
// and K4 read and write one layout; K7a reads a halo-extended psi).
template <int DIAG, int K, typename PT, typename OT, typename LT>
__device__ __forceinline__ void site_out(const PT* __restrict__ pc, long long Sp,
                                         typename Lanes<K>::At cp, OT* __restrict__ o,
                                         const LT* __restrict__ at, long long So,
                                         typename Lanes<K>::At co, float kappa,
                                         const float2 (&acc)[K][4][3]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float re[K], im[K];
      if constexpr (DIAG == kHop) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          re[k] = acc[k][s][c].x;
          im[k] = acc[k][s][c].y;
        }
      } else {
        float2 d[K];
        if constexpr (DIAG == kClover) {
          float2 row[K][6], w[K][6];
          clover_row_k<K>(at, co, So, s, c, row);
          chiral_k<K>(pc, cp, Sp, s, w);
#pragma unroll
          for (int k = 0; k < K; ++k) d[k] = row_dot(row[k], w[k]);
        } else {
          float dr[K], di[K];
          ldk(pc + (long long)(s * 3 + c) * Sp, cp, dr);
          ldk(pc + (long long)(12 + s * 3 + c) * Sp, cp, di);
#pragma unroll
          for (int k = 0; k < K; ++k) d[k] = make_float2(dr[k], di[k]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          re[k] = __fmaf_rn(-kappa, acc[k][s][c].x, d[k].x);
          im[k] = __fmaf_rn(-kappa, acc[k][s][c].y, d[k].y);
        }
      }
      stk(o + (long long)(s * 3 + c) * So, co, re);
      stk(o + (long long)(12 + s * 3 + c) * So, co, im);
    }
  }
}

// K = 2 needs the x extent even and every operand's base two words of its
// type aligned (the pairs' loads and stores)
inline bool pair_aligned(const void* p, size_t word) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % (2 * word) == 0;
}

}  // namespace
