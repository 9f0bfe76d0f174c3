// K6's kernels, instantiated by parity_hop.cu and parity_hop_bf16.cu (one
// packed site a thread: f32 / bf16 spinors), parity_hop_pair.cu (two
// adjacent packed columns a thread: bf16 spinors), parity_hop_staged.cu
// and parity_hop_staged_pair.cu (a block tile of four vectors sharing
// staged links: f32 / bf16 spinors), one nvcc each, run in parallel.
// parity_hop.cu has the notes on the operator, its modes and layouts, and
// this design.  mode = CLOVER + 2 * combine: CLOVER (A_post / A_comb) is
// a template argument, combine (pass 2) too in the f32 one-site kernel and
// a run-time argument in the others.

#pragma once

#include "hop_common.cuh"

namespace {

// The indices of a thread's K packed columns starting at packed site i
// (t-major) of output parity parity_out: t, the neighbours within slice
// t (x+1 of column xh + k is column xh + k + oo, x-1 is xh + k - 1 + oo,
// oo the same for both columns of a pair since Xh is even), t+1 / t-1.
template <int K>
struct PackedK {
  int t, tp, tm;
  TileNbr<K> n;
};

template <int K>
__device__ __forceinline__ PackedK<K> packed_k(long long i, int T, int Z, int Y, int Xh,
                                               int parity_out) {
  using Ln = Lanes<K>;
  const long long YXh = (long long)Y * Xh;
  const long long S = YXh * Z;
  const int t = (int)(i / S);
  const long long zyx = i - (long long)t * S;
  const int z = (int)(zyx / YXh);
  const int y = (int)((zyx / Xh) % Y);
  const int xh = (int)(zyx % Xh);
  const int oo = (t + z + y + parity_out) & 1;
  const int yp = y + 1 == Y ? 0 : y + 1, ym = y == 0 ? Y - 1 : y - 1;
  const int zp = z + 1 == Z ? 0 : z + 1, zm = z == 0 ? Z - 1 : z - 1;
  const long long zy = (long long)z * YXh + (long long)y * Xh;
  auto col = [Xh](int c) { return c >= Xh ? c - Xh : (c < 0 ? c + Xh : c); };
  return PackedK<K>{t, t + 1 == T ? 0 : t + 1, t == 0 ? T - 1 : t - 1,
                    TileNbr<K>{Ln::at(zyx),
                               Ln::at((long long)z * YXh + (long long)yp * Xh + xh),
                               Ln::at((long long)z * YXh + (long long)ym * Xh + xh),
                               Ln::at((long long)zp * YXh + (long long)y * Xh + xh),
                               Ln::at((long long)zm * YXh + (long long)y * Xh + xh),
                               Ln::xs(zy, col(xh + oo), col(xh + 1 + oo)),
                               Ln::xs(zy, col(xh - 1 + oo), col(xh + oo))}};
}

// The pass's output at K sites of one vector from acc = H psi_in: pass 1
// acc (or A_post acc), pass 2 psi_out - kappa2 acc (or A_comb psi_out -
// kappa2 acc).  pe, o: comp 0 of the vector's psi_out / out t-slice; a:
// comp 0 of the clover t-slice (A_post in pass 1, A_comb in pass 2).
template <bool CLOVER, int K, typename PT, typename LT>
__device__ __forceinline__ void parity_out_k(const PT* __restrict__ pe, PT* __restrict__ o,
                                             const LT* __restrict__ a, long long S,
                                             typename Lanes<K>::At c0, bool combine,
                                             float kappa2, const float2 (&acc)[K][4][3]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float re[K], im[K];
      if (!combine) {
        if constexpr (CLOVER) {
          // hop -> A_post . hop (the Schur complement's A_oo^-1)
          float2 row[K][6];
          clover_row_k<K>(a, c0, S, s, c, row);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float2 w[6];
#pragma unroll
            for (int j = 0; j < 6; ++j) w[j] = acc[k][2 * (s / 2) + j / 3][j % 3];
            const float2 d = row_dot(row[k], w);
            re[k] = d.x;
            im[k] = d.y;
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            re[k] = acc[k][s][c].x;
            im[k] = acc[k][s][c].y;
          }
        }
      } else {
        float2 d[K];
        if constexpr (CLOVER) {
          float2 row[K][6], w[K][6];
          clover_row_k<K>(a, c0, S, s, c, row);
          chiral_k<K>(pe, c0, S, s, w);
#pragma unroll
          for (int k = 0; k < K; ++k) d[k] = row_dot(row[k], w[k]);
        } else {
          float dr[K], di[K];
          ldk(pe + (long long)(s * 3 + c) * S, c0, dr);
          ldk(pe + (long long)(12 + s * 3 + c) * S, c0, di);
#pragma unroll
          for (int k = 0; k < K; ++k) d[k] = make_float2(dr[k], di[k]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          re[k] = __fmaf_rn(-kappa2, acc[k][s][c].x, d[k].x);
          im[k] = __fmaf_rn(-kappa2, acc[k][s][c].y, d[k].y);
        }
      }
      stk(o + (long long)(s * 3 + c) * S, c0, re);
      stk(o + (long long)(12 + s * 3 + c) * S, c0, im);
    }
  }
}

// The arguments every instance takes, passed through the dispatch levels.
struct K6Args {
  const void *psi_in, *Uo, *Ui, *A, *psi_out;
  void* out;
  int T, Z, Y, Xh, parity_out, combine;
  float kappa2;
  int batch;
  cudaStream_t st;
};

// One vector, K packed columns a thread (K = 2: xh even), the batch in
// grid y.  PASS 1 or 2 fixes the pass at compile time (the f32 one-site
// instances, the pc operator's main path: a pass decided at run time
// holds both passes' registers and spills under the cap); PASS 0 takes it
// from combine.
template <bool DAG, bool CLOVER, int PASS, int K, typename LT, typename PT>
__global__ void __launch_bounds__(128, min_blocks<K, false, LT>())
parity_hop_direct_kernel(const PT* __restrict__ psi_in, const LT* __restrict__ Uo,
                         const LT* __restrict__ Ui, const LT* __restrict__ A,
                         const PT* __restrict__ psi_out, PT* __restrict__ out, int T, int Z,
                         int Y, int Xh, int parity_out, int combine_rt, float kappa2) {
  const bool combine = PASS == 0 ? combine_rt != 0 : PASS == 2;
  const long long S = (long long)Y * Xh * Z;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (i >= S * T) return;
  const long long field = (long long)blockIdx.y * 24 * S * T;
  const PackedK<K> q = packed_k<K>(i, T, Z, Y, Xh, parity_out);
  const long long ps_t = 24 * S, u_t = 72 * S;
  const PT* p = psi_in + field;
  float2 acc[K][4][3];
  hop8_direct<DAG, K>(p + q.t * ps_t, p + q.tp * ps_t, p + q.tm * ps_t, Uo + q.t * u_t,
                      Ui + q.t * u_t, Ui + q.tm * u_t + 3 * 18 * S, S, q.n, acc);
  parity_out_k<CLOVER, K>(combine ? psi_out + field + q.t * ps_t : nullptr,
                          out + field + q.t * ps_t, CLOVER ? A + q.t * 144 * S : nullptr,
                          S, q.n.c, combine, kappa2, acc);
}

// The block tile: TILE_SITES threads along the packed sites (K each) times
// TILE_NV vectors (threadIdx.y), the eight links of its sites staged in
// shared memory once and read there by every vector row.
constexpr int TILE_SITES = 32, TILE_NV = 4;

template <bool DAG, bool CLOVER, int K, typename LT, typename PT>
__global__ void __launch_bounds__(TILE_SITES * TILE_NV, min_blocks<K, true, LT>())
parity_hop_staged_kernel(const PT* __restrict__ psi_in, const LT* __restrict__ Uo,
                         const LT* __restrict__ Ui, const LT* __restrict__ A,
                         const PT* __restrict__ psi_out, PT* __restrict__ out, int T, int Z,
                         int Y, int Xh, int parity_out, int combine, float kappa2,
                         int batch) {
  constexpr int BSK = TILE_SITES * K;
  __shared__ float2 sm[8 * 9 * BSK];
  const long long S = (long long)Y * Xh * Z;
  const long long i = ((long long)blockIdx.x * TILE_SITES + threadIdx.x) * K;
  const bool live = i < S * T;
  const PackedK<K> q = packed_k<K>(live ? i : 0, T, Z, Y, Xh, parity_out);
  const long long ps_t = 24 * S, u_t = 72 * S;
  const int j0 = threadIdx.x * K;
  if (live)
    stage_links<K, TILE_NV>(Uo + q.t * u_t, Ui + q.t * u_t, Ui + q.tm * u_t + 3 * 18 * S, S,
                            q.n, sm, j0, BSK, threadIdx.y);
  __syncthreads();
  const int v = blockIdx.y * TILE_NV + threadIdx.y;
  if (!live || v >= batch) return;
  const long long field = (long long)v * 24 * S * T;
  const PT* p = psi_in + field;
  float2 acc[K][4][3];
  hop8_staged<DAG, K>(p + q.t * ps_t, p + q.tp * ps_t, p + q.tm * ps_t, S, q.n, sm, j0, BSK,
                      acc);
  parity_out_k<CLOVER, K>(combine ? psi_out + field + q.t * ps_t : nullptr,
                          out + field + q.t * ps_t, CLOVER ? A + q.t * 144 * S : nullptr,
                          S, q.n.c, combine, kappa2, acc);
}

template <bool DAG, bool CLOVER, int PASS, int K, bool STAGED, typename LT, typename PT>
void launch_k6(const K6Args& a) {
  const long long n = (long long)a.T * a.Z * a.Y * a.Xh / K;
  const PT* pin = static_cast<const PT*>(a.psi_in);
  const LT* uo = static_cast<const LT*>(a.Uo);
  const LT* ui = static_cast<const LT*>(a.Ui);
  const LT* cl = static_cast<const LT*>(a.A);
  const PT* pout = static_cast<const PT*>(a.psi_out);
  PT* o = static_cast<PT*>(a.out);
  if constexpr (STAGED) {
    const dim3 grid((unsigned)((n + TILE_SITES - 1) / TILE_SITES),
                    (unsigned)((a.batch + TILE_NV - 1) / TILE_NV));
    parity_hop_staged_kernel<DAG, CLOVER, K, LT, PT><<<grid, dim3(TILE_SITES, TILE_NV), 0, a.st>>>(
        pin, uo, ui, cl, pout, o, a.T, a.Z, a.Y, a.Xh, a.parity_out, a.combine, a.kappa2,
        a.batch);
  } else {
    const dim3 grid((unsigned)((n + 127) / 128), (unsigned)a.batch);
    parity_hop_direct_kernel<DAG, CLOVER, PASS, K, LT, PT><<<grid, 128, 0, a.st>>>(
        pin, uo, ui, cl, pout, o, a.T, a.Z, a.Y, a.Xh, a.parity_out, a.combine, a.kappa2);
  }
}

template <int PASS, int K, bool STAGED, typename LT, typename PT>
void dispatch_k6(int dagger, int clover, const K6Args& a) {
  if (dagger) {
    if (clover) launch_k6<true, true, PASS, K, STAGED, LT, PT>(a);
    else launch_k6<true, false, PASS, K, STAGED, LT, PT>(a);
  } else {
    if (clover) launch_k6<false, true, PASS, K, STAGED, LT, PT>(a);
    else launch_k6<false, false, PASS, K, STAGED, LT, PT>(a);
  }
}

// the pass at compile time for the f32 one-site kernel, else at run time
template <int K, bool STAGED, typename LT, typename PT>
void dispatch_pass(int dagger, int clover, const K6Args& a) {
  if constexpr (K == 1 && !STAGED && sizeof(PT) == 4) {
    if (a.combine) dispatch_k6<2, K, STAGED, LT, PT>(dagger, clover, a);
    else dispatch_k6<1, K, STAGED, LT, PT>(dagger, clover, a);
  } else {
    dispatch_k6<0, K, STAGED, LT, PT>(dagger, clover, a);
  }
}

// The C entry points' body for spinors of type PT: cudaError_t of the
// launch (0 = success); mode 0-3 as in parity_hop.cu.  K = 2 needs Xh even
// and every operand's base two words aligned (the pairs' loads and
// stores).
template <int K, bool STAGED, typename PT>
int parity_hop_entry(const void* psi_in, const void* Uo, const void* Ui, const void* Apost,
                     const void* psi_out, const void* Acomb, void* out, int T, int Z, int Y,
                     int Xh, int parity_out, int dagger, int mode, float kappa2,
                     int link_bf16, int batch, void* stream) {
  const int tiles = STAGED ? (batch + TILE_NV - 1) / TILE_NV : batch;
  if (mode < 0 || mode > 3 || batch < 1 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int clover = mode & 1, combine = mode >> 1;
  const void* A = combine ? Acomb : Apost;
  const size_t lw = link_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (K == 2 && (Xh % 2 || !pair_aligned(psi_in, sizeof(PT)) ||
                 !pair_aligned(psi_out, sizeof(PT)) || !pair_aligned(out, sizeof(PT)) ||
                 !pair_aligned(Uo, lw) || !pair_aligned(Ui, lw) || !pair_aligned(A, lw)))
    return static_cast<int>(cudaErrorInvalidValue);
  const K6Args a{psi_in, Uo, Ui, A, psi_out, out, T, Z, Y, Xh, parity_out, combine,
                 kappa2, batch, static_cast<cudaStream_t>(stream)};
  if (link_bf16) dispatch_pass<K, STAGED, __nv_bfloat16, PT>(dagger, clover, a);
  else dispatch_pass<K, STAGED, float, PT>(dagger, clover, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
