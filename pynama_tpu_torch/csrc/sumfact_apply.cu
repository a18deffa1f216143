// sumfact_apply: y = t @ K_e^T per element for the sum-factorized KLE
// operator K of a mesh whose elements each have their own geometry (the
// gmsh route's element product, ops/sumfact.py apply_sumfact_k), in one
// launch on the caller's stream.
//
// Replaces no Pallas kernel: pynama_tpu/ops/sumfact.py is plain jnp, which
// XLA fuses on the TPU. In eager PyTorch the same product was a chain of
// ~82 launches (two column gathers, four shared matmuls, the pointwise
// geometry as dozens of small multiply-adds, two stacks), and the host
// issuing them set the pace of every CG iteration on an unstructured mesh.
//
// What it computes, per element, is apply_sumfact_k_ref's product:
//   - the reference gradients of both quadrature families, the 1D
//     operators applied axis by axis (Hf, Df at the full points, Hr, Dr at
//     the reduced points: the true sum factorization of the flat tables
//     Df_flat, Dr_flat, which are Kronecker products of these);
//   - full family: s_p[c] = sum_r Gt[r,p] g[c][r];
//   - reduced family: the physical gradient through Jrt, the div and curl
//     penalties weighted by wr, alpha_d and alpha_w, the pull-back through
//     Jrt;
//   - both transposed scatters, summed into y.
// t and y are read and written in the engine's interleaved (node-major)
// layout: the column gathers of the eager chain are index arithmetic here.
// It reads the stored geometric factors Gt, Jrt and wr; nothing is
// recomputed from the corners.
//
// What bounds it on an H100: HBM. At 25^3 ngl=3 (E = 15,625) in f32 it
// reads 323 geometry values and 81 vector values an element and writes 81:
// 30.3 MB, 9.05 us at 3.35 TB/s (benchmark/counts_hex.py counts the four
// flat matmuls' operations, 0.568 GFLOP, 8.5 us at 67 TFLOP/s on FFMA; the
// factorized form does a fraction of them).
//
// Design. One CTA of 256 threads takes EB whole elements (EB from the
// shape: the most that fit 48 KB of shared memory, a power of two, at most
// about two pencils per thread). It stages the group's t, then its Gt, Jrt
// and wr, into shared memory with cp.async (16 bytes a thread where the
// source is 16-byte aligned; each group's factors are one contiguous range
// per array), as two commit groups: the geometry lands while the gradients
// are computed. Every pass of the factorization then runs with the CTA's
// threads over pencils (one 1D line of one tensor of one element), from
// one shared-memory buffer into the other, a __syncthreads between passes:
//   3D: forward axis 2, 1, 0 (2, 3, 3 tensors a family), the pointwise
//       geometry with one thread per quadrature point, in place; backward
//       axis 0, 1, 2 (3, 2 tensors a family, then y).
//   2D: forward axis 1, 0; pointwise; backward axis 0, 1.
// Every intermediate stays in shared memory or registers; y is staged in
// t's buffer and leaves in coalesced 16-byte stores. The 1D tables travel
// in the kernel's parameters (a __grid_constant__ struct); every loop over
// a table index is unrolled, so each table value is a constant-bank operand
// of the FMA that uses it. Templated on the float type, DIM (2, 3) and NGL
// (2-8): one algorithm, the sizes from the shape.
//
// Precision: the config's. f32 is full f32 on FFMA (no TF32, no tensor
// cores); f64 states run the double instantiation. The summation order
// differs from the eager chain's (factorized against flat matmuls).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int NT = 256;
constexpr int SMEM_TARGET = 48 * 1024;
constexpr int MAX_NGL = 8;

constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int pow2floor(int x) { return x < 2 ? 1 : 2 * pow2floor(x / 2); }
constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// T[w, c, d] of elements/kle.py curl_tensor: (curl v)_w = sum T d_d v_c
__host__ __device__ constexpr int curl_t(int dim, int w, int c, int d) {
  return dim == 2 ? (c == 1 && d == 0 ? 1 : (c == 0 && d == 1 ? -1 : 0))
                  : ((w - d) * (d - c) * (c - w)) / 2;
}

// Sizes and the shared-memory plan of one (T, DIM, NGL), in values of T.
template <typename T, int DIM, int N>
struct Shape {
  static constexpr int QF = N, QR = N - 1;
  static constexpr int NN = ipow(N, DIM), NQF = ipow(QF, DIM),
                       NQR = ipow(QR, DIM);
  static constexpr int NV = NN * DIM;  // one element vector
  static constexpr int NG = DIM * DIM * NQF, NJ = DIM * DIM * NQR, NW = NQR;
  // one family's work tensors at the largest pass, per element
  static constexpr int fam(int Q) {
    return DIM == 2 ? cmax(2 * DIM * N * Q, DIM * DIM * Q * Q)
                    : cmax(cmax(2 * DIM * N * N * Q, 3 * DIM * N * Q * Q),
                           DIM * DIM * Q * Q * Q);
  }
  static constexpr int BF = fam(QF), BR = fam(QR), BUF = BF + BR;
  static constexpr int PER = NV + NG + NJ + NW + 2 * BUF;
  static constexpr int EB = pow2floor(cmax(1, cmin(cmin(
      SMEM_TARGET / (PER * (int)sizeof(T)), 64),
      cmax(1, 2 * NT / (DIM * ipow(N, DIM - 1))))));
  static constexpr int VW = 16 / (int)sizeof(T);  // values in 16 bytes
  static constexpr int OU = 0;
  static constexpr int OG = round_up(OU + EB * NV, VW);
  static constexpr int OJ = round_up(OG + EB * NG, VW);
  static constexpr int OW = round_up(OJ + EB * NJ, VW);
  static constexpr int OA = round_up(OW + EB * NW, VW);
  static constexpr int OB = round_up(OA + EB * BUF, VW);
  static constexpr int TOTAL = round_up(OB + EB * BUF, VW);
  static constexpr int SMEM = TOTAL * (int)sizeof(T);
};

// The 1D operators, [q][i]: Lagrange values and derivatives of the Lobatto
// nodes at the full points (Hf, Df) and at the reduced points (Hr, Dr).
template <typename T, int N>
struct Tables {
  T Hf[N][N];
  T Df[N][N];
  T Hr[N - 1][N];
  T Dr[N - 1][N];
};

template <typename T, int N>
struct Params {
  const T* t;
  T* y;
  const T* Gt;
  const T* Jr;
  const T* wr;
  int64_t E;
  T alpha_w;
  T alpha_d;
  Tables<T, N> tab;
};

// Copies n values from global src to shared dst (16-byte aligned) with the
// CTA's threads: 16-byte cp.async where src is 16-byte aligned, one value a
// copy otherwise and for the tail.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  constexpr int VW = 16 / (int)sizeof(T);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / VW;
    for (int i = threadIdx.x; i < nv; i += NT)
      cp_async<16>(dst + i * VW, src + i * VW, 16);
    head = nv * VW;
  }
  for (int i = head + threadIdx.x; i < n; i += NT)
    cp_async<(int)sizeof(T)>(dst + i, src + i, (int)sizeof(T));
}

// Stores n values from shared src (16-byte aligned) to global dst.
template <typename T>
__device__ __forceinline__ void store(T* dst, const T* src, int n) {
  constexpr int VW = 16 / (int)sizeof(T);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = n / VW;
    for (int i = threadIdx.x; i < nv; i += NT)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    head = nv * VW;
  }
  for (int i = head + threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// out[o] = sum_i A[o][i] x[i] (NO outputs, NI inputs)
template <typename T, int NO, int NI, int NR>
__device__ __forceinline__ void fwd(T (&out)[NO], const T (&A)[NR][NI],
                                    const T (&x)[NI]) {
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    T acc = A[o][0] * x[0];
#pragma unroll
    for (int i = 1; i < NI; ++i) acc = fma(A[o][i], x[i], acc);
    out[o] = acc;
  }
}

// out[i] (+)= sum_q A[q][i] x[q] (transposed: NQ inputs, N outputs)
template <bool ADD, typename T, int N, int NQ, int NR>
__device__ __forceinline__ void bwd(T (&out)[N], const T (&A)[NR][N],
                                    const T (&x)[NQ]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc;
    if constexpr (ADD)
      acc = fma(A[0][i], x[0], out[i]);
    else
      acc = A[0][i] * x[0];
#pragma unroll
    for (int q = 1; q < NQ; ++q) acc = fma(A[q][i], x[q], acc);
    out[i] = acc;
  }
}

// --------------------------------------------------------- pointwise pass
// Full family at point q: s[p][c] = sum_r Gt[r,p] g[c][r], in place of
// g (buf[(c*DIM + r)*NQ + q]).
template <typename T, int DIM, int NQ>
__device__ __forceinline__ void point_full(T* buf, const T* G, int q) {
  T g[DIM][DIM], gt[DIM][DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int r = 0; r < DIM; ++r) g[c][r] = buf[(c * DIM + r) * NQ + q];
#pragma unroll
  for (int r = 0; r < DIM; ++r)
#pragma unroll
    for (int s = 0; s < DIM; ++s) gt[r][s] = G[(r * DIM + s) * NQ + q];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int p = 0; p < DIM; ++p) {
      T acc = gt[0][p] * g[c][0];
#pragma unroll
      for (int r = 1; r < DIM; ++r) acc = fma(gt[r][p], g[c][r], acc);
      buf[(c * DIM + p) * NQ + q] = acc;
    }
}

// Reduced family at point q: the physical gradient gp[p][c] = sum_r
// Jr[p,r] g[c][r], the div and curl penalties, the cotangent sp[p][c] =
// alpha_d w div delta_pc + alpha_w sum_w T[w,c,p] w curl_w, and its pull-back
// sr[r][c] = sum_p Jr[p,r] sp[p][c], in place of g.
template <typename T, int DIM, int NQ>
__device__ __forceinline__ void point_reduced(T* buf, const T* J,
                                              const T* Wt, int q,
                                              T alpha_w, T alpha_d) {
  constexpr int NDW = DIM == 2 ? 1 : 3;
  T g[DIM][DIM], jr[DIM][DIM], gp[DIM][DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int r = 0; r < DIM; ++r) g[c][r] = buf[(c * DIM + r) * NQ + q];
#pragma unroll
  for (int p = 0; p < DIM; ++p)
#pragma unroll
    for (int r = 0; r < DIM; ++r) jr[p][r] = J[(p * DIM + r) * NQ + q];
  const T w = Wt[q];
#pragma unroll
  for (int p = 0; p < DIM; ++p)
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      T acc = jr[p][0] * g[c][0];
#pragma unroll
      for (int r = 1; r < DIM; ++r) acc = fma(jr[p][r], g[c][r], acc);
      gp[p][c] = acc;
    }
  T div = gp[0][0];
#pragma unroll
  for (int c = 1; c < DIM; ++c) div += gp[c][c];
  T wc[NDW];
#pragma unroll
  for (int k = 0; k < NDW; ++k) {
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const int tv = curl_t(DIM, k, c, d);
        if (tv > 0) acc += gp[d][c];
        if (tv < 0) acc -= gp[d][c];
      }
    wc[k] = w * acc;
  }
  const T wdiv = alpha_d * (w * div);
  T sp[DIM][DIM];
#pragma unroll
  for (int p = 0; p < DIM; ++p)
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      T acc = c == p ? wdiv : T(0);
#pragma unroll
      for (int k = 0; k < NDW; ++k) {
        const int tv = curl_t(DIM, k, c, p);
        if (tv > 0) acc = fma(alpha_w, wc[k], acc);
        if (tv < 0) acc = fma(-alpha_w, wc[k], acc);
      }
      sp[p][c] = acc;
    }
#pragma unroll
  for (int c = 0; c < DIM; ++c)
#pragma unroll
    for (int r = 0; r < DIM; ++r) {
      T acc = jr[0][r] * sp[0][c];
#pragma unroll
      for (int p = 1; p < DIM; ++p) acc = fma(jr[p][r], sp[p][c], acc);
      buf[(c * DIM + r) * NQ + q] = acc;
    }
}

template <typename T, int DIM, int N>
__device__ __forceinline__ void pointwise(const Params<T, N>& p, T* A,
                                          const T* G, const T* J,
                                          const T* Wt, int ne) {
  using S = Shape<T, DIM, N>;
  constexpr int IT = S::NQF + S::NQR;
  for (int it = threadIdx.x; it < ne * IT; it += NT) {
    const int e = it / IT, k = it % IT;
    if (k < S::NQF)
      point_full<T, DIM, S::NQF>(A + e * S::BUF, G + e * S::NG, k);
    else
      point_reduced<T, DIM, S::NQR>(A + e * S::BUF + S::BF, J + e * S::NJ,
                                    Wt + e * S::NW, k - S::NQF, p.alpha_w,
                                    p.alpha_d);
  }
}

// ------------------------------------------------------------- 3D passes
// Per element and family (Q points an axis) the work tensors are
// [label][c][a0][a1][a2], the axes N or Q as the pass has left them.

// forward axis 2, both families from one pencil (c, i0, i1) of u:
// [H u, D u] as [2][c][i0][i1][q2]
template <typename T, int N, int Q>
__device__ __forceinline__ void f1_put(T* out, int c, int r, const T (&h)[Q],
                                       const T (&d)[Q]) {
  constexpr int L = 3 * N * N * Q;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    out[c * N * N * Q + r * Q + q] = h[q];
    out[L + c * N * N * Q + r * Q + q] = d[q];
  }
}

// forward axis 1, pencil (c, i0, q2) of [aH, aD]: [H aH, D aH, H aD] as
// [3][c][i0][q1][q2]
template <typename T, int N, int Q>
__device__ __forceinline__ void f2(const T* in, T* out, int k,
                                   const T (&H)[Q][N], const T (&D)[Q][N]) {
  const int c = k / (N * Q), i0 = (k / Q) % N, q2 = k % Q;
  constexpr int LI = 3 * N * N * Q, LO = 3 * N * Q * Q;
  T ah[N], ad[N];
  const T* src = in + c * N * N * Q + i0 * N * Q + q2;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ah[i] = src[i * Q];
    ad[i] = src[LI + i * Q];
  }
  T hh[Q], d1[Q], d2[Q];
  fwd(hh, H, ah);
  fwd(d1, D, ah);
  fwd(d2, H, ad);
  T* dst = out + c * N * Q * Q + i0 * Q * Q + q2;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    dst[q * Q] = hh[q];
    dst[LO + q * Q] = d1[q];
    dst[2 * LO + q * Q] = d2[q];
  }
}

// forward axis 0, pencil (c, q1, q2): g_0 = D HH, g_1 = H D1, g_2 = H D2 as
// [c][r][q0][q1][q2]
template <typename T, int N, int Q>
__device__ __forceinline__ void f3(const T* in, T* out, int k,
                                   const T (&H)[Q][N], const T (&D)[Q][N]) {
  const int c = k / (Q * Q), rr = k % (Q * Q);
  constexpr int LI = 3 * N * Q * Q, NQ = Q * Q * Q;
  T x0[N], x1[N], x2[N];
  const T* src = in + c * N * Q * Q + rr;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x0[i] = src[i * Q * Q];
    x1[i] = src[LI + i * Q * Q];
    x2[i] = src[2 * LI + i * Q * Q];
  }
  T g0[Q], g1[Q], g2[Q];
  fwd(g0, D, x0);
  fwd(g1, H, x1);
  fwd(g2, H, x2);
  T* dst = out + c * 3 * NQ + rr;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    dst[q * Q * Q] = g0[q];
    dst[NQ + q * Q * Q] = g1[q];
    dst[2 * NQ + q * Q * Q] = g2[q];
  }
}

// backward axis 0, pencil (c, q1, q2) of s: [D^T s_0, H^T s_1, H^T s_2] as
// [3][c][i0][q1][q2]
template <typename T, int N, int Q>
__device__ __forceinline__ void b1(const T* in, T* out, int k,
                                   const T (&H)[Q][N], const T (&D)[Q][N]) {
  const int c = k / (Q * Q), rr = k % (Q * Q);
  constexpr int NQ = Q * Q * Q, LO = 3 * N * Q * Q;
  T s0[Q], s1[Q], s2[Q];
  const T* src = in + c * 3 * NQ + rr;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    s0[q] = src[q * Q * Q];
    s1[q] = src[NQ + q * Q * Q];
    s2[q] = src[2 * NQ + q * Q * Q];
  }
  T u0[N], u1[N], u2[N];
  bwd<false>(u0, D, s0);
  bwd<false>(u1, H, s1);
  bwd<false>(u2, H, s2);
  T* dst = out + c * N * Q * Q + rr;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    dst[i * Q * Q] = u0[i];
    dst[LO + i * Q * Q] = u1[i];
    dst[2 * LO + i * Q * Q] = u2[i];
  }
}

// backward axis 1, pencil (c, i0, q2): [H^T U0 + D^T U1, H^T U2] as
// [2][c][i0][i1][q2]
template <typename T, int N, int Q>
__device__ __forceinline__ void b2(const T* in, T* out, int k,
                                   const T (&H)[Q][N], const T (&D)[Q][N]) {
  const int c = k / (N * Q), i0 = (k / Q) % N, q2 = k % Q;
  constexpr int LI = 3 * N * Q * Q, LO = 3 * N * N * Q;
  T u0[Q], u1[Q], u2[Q];
  const T* src = in + c * N * Q * Q + i0 * Q * Q + q2;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    u0[q] = src[q * Q];
    u1[q] = src[LI + q * Q];
    u2[q] = src[2 * LI + q * Q];
  }
  T v[N], w[N];
  bwd<false>(v, H, u0);
  bwd<true>(v, D, u1);
  bwd<false>(w, H, u2);
  T* dst = out + c * N * N * Q + i0 * N * Q + q2;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    dst[i * Q] = v[i];
    dst[LO + i * Q] = w[i];
  }
}

// backward axis 2 of one family, pencil (c, i0, i1): H^T V + D^T W
template <bool ADD, typename T, int N, int Q>
__device__ __forceinline__ void b3(T (&y)[N], const T* in, int c, int r,
                                   const T (&H)[Q][N], const T (&D)[Q][N]) {
  constexpr int L = 3 * N * N * Q;
  T v[Q], w[Q];
  const T* src = in + c * N * N * Q + r * Q;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = src[q];
    w[q] = src[L + q];
  }
  T part[N];
  bwd<false>(part, H, v);
  bwd<true>(part, D, w);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (ADD)
      y[i] += part[i];
    else
      y[i] = part[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void run3d(const Params<T, N>& p, T* U, T* A,
                                      T* B, const T* G, const T* J,
                                      const T* Wt, int ne) {
  using S = Shape<T, 3, N>;
  constexpr int QF = S::QF, QR = S::QR, BUF = S::BUF, BF = S::BF, NV = S::NV;
  const auto& tb = p.tab;
  // forward axis 2: pencils (c, i0, i1) of u, both families
  for (int it = threadIdx.x; it < ne * 3 * N * N; it += NT) {
    const int e = it / (3 * N * N), k = it % (3 * N * N);
    const int c = k / (N * N), r = k % (N * N);
    T u[N];
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = U[e * NV + (r * N + i) * 3 + c];
    T hf[QF], df[QF], hr[QR], dr[QR];
    fwd(hf, tb.Hf, u);
    fwd(df, tb.Df, u);
    fwd(hr, tb.Hr, u);
    fwd(dr, tb.Dr, u);
    f1_put<T, N, QF>(A + e * BUF, c, r, hf, df);
    f1_put<T, N, QR>(A + e * BUF + BF, c, r, hr, dr);
  }
  __syncthreads();
  // forward axis 1
  {
    constexpr int IF = 3 * N * QF, IT = IF + 3 * N * QR;
    for (int it = threadIdx.x; it < ne * IT; it += NT) {
      const int e = it / IT, k = it % IT;
      if (k < IF)
        f2<T, N, QF>(A + e * BUF, B + e * BUF, k, tb.Hf, tb.Df);
      else
        f2<T, N, QR>(A + e * BUF + BF, B + e * BUF + BF, k - IF, tb.Hr,
                     tb.Dr);
    }
  }
  __syncthreads();
  // forward axis 0: the gradients, [c][r][q]
  {
    constexpr int IF = 3 * QF * QF, IT = IF + 3 * QR * QR;
    for (int it = threadIdx.x; it < ne * IT; it += NT) {
      const int e = it / IT, k = it % IT;
      if (k < IF)
        f3<T, N, QF>(B + e * BUF, A + e * BUF, k, tb.Hf, tb.Df);
      else
        f3<T, N, QR>(B + e * BUF + BF, A + e * BUF + BF, k - IF, tb.Hr,
                     tb.Dr);
    }
  }
  cp_async_wait<0>();  // the geometry
  __syncthreads();
  pointwise<T, 3, N>(p, A, G, J, Wt, ne);
  __syncthreads();
  // backward axis 0
  {
    constexpr int IF = 3 * QF * QF, IT = IF + 3 * QR * QR;
    for (int it = threadIdx.x; it < ne * IT; it += NT) {
      const int e = it / IT, k = it % IT;
      if (k < IF)
        b1<T, N, QF>(A + e * BUF, B + e * BUF, k, tb.Hf, tb.Df);
      else
        b1<T, N, QR>(A + e * BUF + BF, B + e * BUF + BF, k - IF, tb.Hr,
                     tb.Dr);
    }
  }
  __syncthreads();
  // backward axis 1
  {
    constexpr int IF = 3 * N * QF, IT = IF + 3 * N * QR;
    for (int it = threadIdx.x; it < ne * IT; it += NT) {
      const int e = it / IT, k = it % IT;
      if (k < IF)
        b2<T, N, QF>(B + e * BUF, A + e * BUF, k, tb.Hf, tb.Df);
      else
        b2<T, N, QR>(B + e * BUF + BF, A + e * BUF + BF, k - IF, tb.Hr,
                     tb.Dr);
    }
  }
  __syncthreads();
  // backward axis 2: y = full + reduced, into U in the interleaved layout
  for (int it = threadIdx.x; it < ne * 3 * N * N; it += NT) {
    const int e = it / (3 * N * N), k = it % (3 * N * N);
    const int c = k / (N * N), r = k % (N * N);
    T y[N];
    b3<false, T, N, QF>(y, A + e * BUF, c, r, tb.Hf, tb.Df);
    b3<true, T, N, QR>(y, A + e * BUF + BF, c, r, tb.Hr, tb.Dr);
#pragma unroll
    for (int i = 0; i < N; ++i) U[e * NV + (r * N + i) * 3 + c] = y[i];
  }
}

// ------------------------------------------------------------- 2D passes
// Per element and family: forward axis 1 gives [2][c][i0][q1] ([H u, D u]),
// forward axis 0 the gradients [c][r][q0][q1]; backward axis 0 gives
// [2][c][i0][q1] ([D^T s_0, H^T s_1]), backward axis 1 y.

// forward axis 0, pencil (c, q1): g_0 = D aH, g_1 = H aD
template <typename T, int N, int Q>
__device__ __forceinline__ void f2_2d(const T* in, T* out, int k,
                                      const T (&H)[Q][N],
                                      const T (&D)[Q][N]) {
  const int c = k / Q, q1 = k % Q;
  constexpr int LI = 2 * N * Q, NQ = Q * Q;
  T xh[N], xd[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    xh[i] = in[c * N * Q + i * Q + q1];
    xd[i] = in[LI + c * N * Q + i * Q + q1];
  }
  T g0[Q], g1[Q];
  fwd(g0, D, xh);
  fwd(g1, H, xd);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    out[c * 2 * NQ + q * Q + q1] = g0[q];
    out[c * 2 * NQ + NQ + q * Q + q1] = g1[q];
  }
}

// backward axis 0, pencil (c, q1): [D^T s_0, H^T s_1]
template <typename T, int N, int Q>
__device__ __forceinline__ void b1_2d(const T* in, T* out, int k,
                                      const T (&H)[Q][N],
                                      const T (&D)[Q][N]) {
  const int c = k / Q, q1 = k % Q;
  constexpr int LO = 2 * N * Q, NQ = Q * Q;
  T s0[Q], s1[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    s0[q] = in[c * 2 * NQ + q * Q + q1];
    s1[q] = in[c * 2 * NQ + NQ + q * Q + q1];
  }
  T u0[N], u1[N];
  bwd<false>(u0, D, s0);
  bwd<false>(u1, H, s1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out[c * N * Q + i * Q + q1] = u0[i];
    out[LO + c * N * Q + i * Q + q1] = u1[i];
  }
}

// backward axis 1 of one family, pencil (c, i0): H^T U0 + D^T U1
template <bool ADD, typename T, int N, int Q>
__device__ __forceinline__ void b2_2d(T (&y)[N], const T* in, int c, int i0,
                                      const T (&H)[Q][N],
                                      const T (&D)[Q][N]) {
  constexpr int L = 2 * N * Q;
  T v[Q], w[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = in[c * N * Q + i0 * Q + q];
    w[q] = in[L + c * N * Q + i0 * Q + q];
  }
  T part[N];
  bwd<false>(part, H, v);
  bwd<true>(part, D, w);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (ADD)
      y[i] += part[i];
    else
      y[i] = part[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void run2d(const Params<T, N>& p, T* U, T* A,
                                      T* B, const T* G, const T* J,
                                      const T* Wt, int ne) {
  using S = Shape<T, 2, N>;
  constexpr int QF = S::QF, QR = S::QR, BUF = S::BUF, BF = S::BF, NV = S::NV;
  const auto& tb = p.tab;
  // forward axis 1: pencils (c, i0) of u, both families
  for (int it = threadIdx.x; it < ne * 2 * N; it += NT) {
    const int e = it / (2 * N), k = it % (2 * N);
    const int c = k / N, i0 = k % N;
    T u[N];
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = U[e * NV + (i0 * N + i) * 2 + c];
    T hf[QF], df[QF], hr[QR], dr[QR];
    fwd(hf, tb.Hf, u);
    fwd(df, tb.Df, u);
    fwd(hr, tb.Hr, u);
    fwd(dr, tb.Dr, u);
    T* of = A + e * BUF;
    T* orr = A + e * BUF + BF;
#pragma unroll
    for (int q = 0; q < QF; ++q) {
      of[c * N * QF + i0 * QF + q] = hf[q];
      of[2 * N * QF + c * N * QF + i0 * QF + q] = df[q];
    }
#pragma unroll
    for (int q = 0; q < QR; ++q) {
      orr[c * N * QR + i0 * QR + q] = hr[q];
      orr[2 * N * QR + c * N * QR + i0 * QR + q] = dr[q];
    }
  }
  __syncthreads();
  // forward axis 0: the gradients, into A's other half (B)
  {
    constexpr int IF = 2 * QF, IT = IF + 2 * QR;
    for (int it = threadIdx.x; it < ne * IT; it += NT) {
      const int e = it / IT, k = it % IT;
      if (k < IF)
        f2_2d<T, N, QF>(A + e * BUF, B + e * BUF, k, tb.Hf, tb.Df);
      else
        f2_2d<T, N, QR>(A + e * BUF + BF, B + e * BUF + BF, k - IF, tb.Hr,
                        tb.Dr);
    }
  }
  cp_async_wait<0>();  // the geometry
  __syncthreads();
  pointwise<T, 2, N>(p, B, G, J, Wt, ne);
  __syncthreads();
  // backward axis 0
  {
    constexpr int IF = 2 * QF, IT = IF + 2 * QR;
    for (int it = threadIdx.x; it < ne * IT; it += NT) {
      const int e = it / IT, k = it % IT;
      if (k < IF)
        b1_2d<T, N, QF>(B + e * BUF, A + e * BUF, k, tb.Hf, tb.Df);
      else
        b1_2d<T, N, QR>(B + e * BUF + BF, A + e * BUF + BF, k - IF, tb.Hr,
                        tb.Dr);
    }
  }
  __syncthreads();
  // backward axis 1: y = full + reduced, into U
  for (int it = threadIdx.x; it < ne * 2 * N; it += NT) {
    const int e = it / (2 * N), k = it % (2 * N);
    const int c = k / N, i0 = k % N;
    T y[N];
    b2_2d<false, T, N, QF>(y, A + e * BUF, c, i0, tb.Hf, tb.Df);
    b2_2d<true, T, N, QR>(y, A + e * BUF + BF, c, i0, tb.Hr, tb.Dr);
#pragma unroll
    for (int i = 0; i < N; ++i) U[e * NV + (i0 * N + i) * 2 + c] = y[i];
  }
}

template <typename T, int DIM, int N>
__global__ void __launch_bounds__(NT)
    sumfact_kernel(const __grid_constant__ Params<T, N> p) {
  using S = Shape<T, DIM, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int64_t e0 = (int64_t)blockIdx.x * S::EB;
  const int ne = (int)(p.E - e0 < S::EB ? p.E - e0 : S::EB);
  T* U = sm + S::OU;
  T* G = sm + S::OG;
  T* J = sm + S::OJ;
  T* Wt = sm + S::OW;
  stage(U, p.t + e0 * S::NV, ne * S::NV);
  cp_async_commit();
  stage(G, p.Gt + e0 * S::NG, ne * S::NG);
  stage(J, p.Jr + e0 * S::NJ, ne * S::NJ);
  stage(Wt, p.wr + e0 * S::NW, ne * S::NW);
  cp_async_commit();
  cp_async_wait<1>();  // t
  __syncthreads();
  if constexpr (DIM == 3)
    run3d<T, N>(p, U, sm + S::OA, sm + S::OB, G, J, Wt, ne);
  else
    run2d<T, N>(p, U, sm + S::OA, sm + S::OB, G, J, Wt, ne);
  __syncthreads();
  store(p.y + e0 * S::NV, U, ne * S::NV);
}

// One product's arguments, built once per SumFactK by the host
// (ops/sumfact.py _Args mirrors it field for field); t, y and stream are
// rewritten before each call. tab holds Hf, Df, Hr, Dr row-major, one after
// the other, in float64.
struct Args {
  const void* t;
  void* y;
  const void* Gt;
  const void* Jr;
  const void* wr;
  void* stream;
  int64_t E;
  int dim;
  int ngl;
  int f64;
  int pad;
  double alpha_w;
  double alpha_d;
  double tab[4 * MAX_NGL * MAX_NGL];
};

template <typename T, int DIM, int N>
int launch_as(const Args& a) {
  using S = Shape<T, DIM, N>;
  Params<T, N> p;
  p.t = static_cast<const T*>(a.t);
  p.y = static_cast<T*>(a.y);
  p.Gt = static_cast<const T*>(a.Gt);
  p.Jr = static_cast<const T*>(a.Jr);
  p.wr = static_cast<const T*>(a.wr);
  p.E = a.E;
  p.alpha_w = (T)a.alpha_w;
  p.alpha_d = (T)a.alpha_d;
  const double* src = a.tab;
  for (int q = 0; q < N; ++q)
    for (int i = 0; i < N; ++i) p.tab.Hf[q][i] = (T)*src++;
  for (int q = 0; q < N; ++q)
    for (int i = 0; i < N; ++i) p.tab.Df[q][i] = (T)*src++;
  for (int q = 0; q < N - 1; ++q)
    for (int i = 0; i < N; ++i) p.tab.Hr[q][i] = (T)*src++;
  for (int q = 0; q < N - 1; ++q)
    for (int i = 0; i < N; ++i) p.tab.Dr[q][i] = (T)*src++;
  const int64_t blocks = (a.E + S::EB - 1) / S::EB;
  if (blocks <= 0) return 0;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sumfact_kernel<T, DIM, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  sumfact_kernel<T, DIM, N><<<(unsigned)blocks, NT, S::SMEM,
                              static_cast<cudaStream_t>(a.stream)>>>(p);
  return (int)cudaGetLastError();
}

// F(T, DIM, N) for the (dim, ngl, f64) asked for; false if out of range
template <typename F>
bool dispatch(int dim, int ngl, int f64, F&& f) {
#define PN_SF_NGL(T, D)                                   \
  switch (ngl) {                                          \
    case 2: f.template operator()<T, D, 2>(); return true; \
    case 3: f.template operator()<T, D, 3>(); return true; \
    case 4: f.template operator()<T, D, 4>(); return true; \
    case 5: f.template operator()<T, D, 5>(); return true; \
    case 6: f.template operator()<T, D, 6>(); return true; \
    case 7: f.template operator()<T, D, 7>(); return true; \
    case 8: f.template operator()<T, D, 8>(); return true; \
    default: return false;                                \
  }
  if (dim == 2 && f64) { PN_SF_NGL(double, 2) }
  if (dim == 2 && !f64) { PN_SF_NGL(float, 2) }
  if (dim == 3 && f64) { PN_SF_NGL(double, 3) }
  if (dim == 3 && !f64) { PN_SF_NGL(float, 3) }
#undef PN_SF_NGL
  return false;
}

struct Launch {
  const Args& a;
  int rc;
  template <typename T, int DIM, int N>
  void operator()() { rc = launch_as<T, DIM, N>(a); }
};

}  // namespace

extern "C" {

// One launch of the product on the stream in *args; returns
// cudaGetLastError() (0 = success), cudaErrorInvalidValue for a (dim, ngl)
// it has no instantiation for.
int pn_sumfact_apply(const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  Launch l{a, 0};
  if (!dispatch(a.dim, a.ngl, a.f64, l)) return (int)cudaErrorInvalidValue;
  return l.rc;
}

}  // extern "C"
