// fdm_apply: z = S^-1 r, the fast-diagonalization preconditioner's apply
// on a box mesh's consistent element-local vector (solver/fdm.py
// fdm_apply), in three launches on the caller's stream.
//
// Replaces no Pallas kernel: pynama_tpu/solver/fdm.py's apply is plain jnp,
// which XLA fuses on the TPU. In eager PyTorch the same apply was ~31
// launches (strided copies and a cat per axis each way, a copy before each
// of the 2·dim batched matmuls, the per-mode block as a multiply and a sum,
// the Jacobi leftover term), and the host issuing them set the pace of
// every FDM-preconditioned CG iteration.
//
// What it computes is fdm_apply_ref's product, for each component a:
//   g    = r on the global grid (np0, np1, np2)
//   ẑ_a  = (Q0_a ⊗ Q1_a ⊗ Q2_a)ᵀ g_a                   analysis
//   ẑ'_a = Σ_b binv[a, b] ẑ_b          per mode        the (c × c) block
//   z_a  = (Q0_a ⊗ Q1_a ⊗ Q2_a) ẑ'_a + jleft_a · g_a   synthesis
// split Lynch-Rice-Thomas style into plane, pencil, plane: the axis-0
// analysis, the per-mode block and the axis-0 synthesis all act on one
// axis-0 pencil of every component.
//
//   A  forward plane pass: a CTA takes one axis-0 plane i0, one component
//      and a block of axis-2 modes (all of them where they fit). It reads
//      the plane straight from the element-local r (the node's
//      representative slot: element min(i / (N-1), ne-1), local index
//      i - e (N-1) on each axis), applies Q2ᵀ, then Q1ᵀ, and writes the
//      half-transformed grid (c, np0, np1, np2) to the scratch g.
//   B  pencil pass: a CTA takes a tile of consecutive (i1, i2) pencils, all
//      c components: Q0ᵀ along axis 0, the per-mode (c × c) block of binv,
//      Q0 along axis 0, written back to g in place.
//   C  backward plane pass: a CTA takes one plane, one component and a
//      block of whole elements along axis 2 (their nodes; neighbouring
//      blocks share a column). Q2, then Q1, plus jleft · g0 (g0 re-read
//      from r by pass A's index arithmetic, only where jleft is not zero),
//      held in shared memory, then written to every slot of the plane's
//      element layers in the block's elements, a warp along each row of
//      slots in memory order. Each slot is written once, by the CTA that
//      owns its plane, element and component: no atomics, the same bits
//      on every run.
//
// A 2D mesh runs as a 3D one whose axis 1 is one node wide (np1 = 1, one
// element of local size 1, Q1 = [1]); the passes are then rows.
//
// Every contraction is one CTA-level matrix product (cta_mm; of all c
// components at once in pass B): an operand that comes from global memory
// is staged into shared memory a chunk of the contracted index at a time
// (the whole index where it fits), one held in shared memory already is
// read in place; each of the 256 threads accumulates a 4 × 4 register
// tile of the output, reading its 4 values of A (a broadcast within the
// warp) and of B (consecutive lanes, consecutive 16 bytes) with one
// 16-byte load each a step, and more tiles than threads run in rounds.
// The global reads and writes follow the memory's order where they can:
// the lanes run along a source's contiguous index; the mesh's index maps
// are tables in shared memory. Nothing needs the whole plane in shared
// memory: the plane's columns come in blocks and the contracted index in
// chunks, so any npts runs; make_plan picks the block widths and the
// chunks from the shape and dtype at each launch, beside the shared memory
// each pass takes (fwd_bytes, pencil_bytes, bwd_bytes), and pn_fdm_plan
// reports them.
//
// What bounds it on an H100, at 24^3 ngl=4 f32 (npts 73^3, c = 3): FFMA.
// The six axis contractions are 1.02 GFLOP, ~15 us at 67 TFLOP/s; the
// apply itself needs ~34 MB, ~10 us at 3.35 TB/s: r at its unique nodes
// (4.7 MB), z at every slot (10.6 MB), binv (14.0 MB) and jleft (4.7 MB).
// This design adds the grid out and back twice (18.7 MB) and r's
// uncoalesced reads at the element-local layout's stride.
//
// Precision: the config's. f32 is full f32 on FFMA (no TF32, no tensor
// cores); f64 runs the double instantiation. The summation order differs
// from the eager chain's (cuBLAS).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int TM = 4, TN = 4;  // a thread's tile (ld4 reads a row of it)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// a shared-memory operand's row: whole 16-byte groups (a thread reads its
// tile's 4 values at once), an odd number of them (eight lanes storing
// eight consecutive rows hit distinct banks)
__host__ __device__ constexpr int ldp(int n) { return (cdiv(n, 4) | 1) * 4; }

// Bytes of shared memory pass A takes: two int64 slot tables per node of
// axes 1 and 2, then a k-chunk of both operands and the first product's
// (np1 × w) result, its rows padded as a staged operand's (the second
// product reads it in place, tiles running into the padding).
__host__ __device__ inline int64_t fwd_bytes(int esize, int k, int np1,
                                             int np2, int w) {
  return 16 * (int64_t)(np1 + np2) +
         (int64_t)esize *
             ((int64_t)k * ldp(np1) + (int64_t)(k + np1) * ldp(w));
}

// Bytes of shared memory pass B takes: the operands' k-chunks and the
// modes of every component (np0 × p, rows padded).
__host__ __device__ inline int64_t pencil_bytes(int esize, int c, int k,
                                                int np0, int p) {
  return (int64_t)esize * c *
         ((int64_t)k * ldp(np0) + (int64_t)(k + np0) * ldp(p));
}

// Bytes of shared memory pass C takes for blocks of eb elements of n2
// nodes along axis 2 (w = eb (n2-1) + 1 columns): the slot tables of axes
// 1 and 2, the write table (16 bytes a node of an element row), the
// operands' k-chunks, the first product (rows padded) and the result
// (rows of w).
__host__ __device__ inline int64_t bwd_bytes(int esize, int k, int np1,
                                             int np2, int eb, int n2) {
  const int w = eb * (n2 - 1) + 1;
  return 16 * (int64_t)(np1 + np2) + 16 * (int64_t)eb * n2 +
         (int64_t)esize * ((int64_t)k * ldp(np1) +
                           (int64_t)(k + np1) * ldp(w) + (int64_t)np1 * w);
}

// The box mesh's element-local layout: the slot of node (i0, i1, i2) in
// element (e0, e1, e2) at local (l0, l1, l2) is
// sum_d e_d se[d] + l_d sl[d], and its value of component a sits at
// slot * c + a.
struct Geo {
  int np[3];
  int ne[3];
  int nl[3];
  int64_t se[3];
  int64_t sl[3];
};

// The slot offsets of global index i along axis d: the first, and the
// second on an interior element boundary (else -1). The representative
// slot (the element fdm_apply_ref's _merge_axis picks) is the second where
// there is one.
__device__ __forceinline__ void slots(const Geo& g, int d, int i,
                                      int64_t& first, int64_t& second) {
  const int s = g.nl[d] - 1;
  second = -1;
  if (s == 0) {
    first = 0;
  } else if (i % s == 0 && i > 0 && i < g.np[d] - 1) {
    const int e = i / s;
    first = (e - 1) * g.se[d] + (int64_t)s * g.sl[d];
    second = e * g.se[d];
  } else {
    const int e = min(i / s, g.ne[d] - 1);
    first = e * g.se[d] + (int64_t)(i - e * s) * g.sl[d];
  }
}

__device__ __forceinline__ int64_t rep(int64_t first, int64_t second) {
  return second >= 0 ? second : first;
}

// Fills the slot tables of axis d, indices i0 .. i0+n-1, by the CTA.
__device__ __forceinline__ void fill_slots(const Geo& g, int d, int i0,
                                           int n, int64_t* first,
                                           int64_t* second) {
  for (int i = threadIdx.x; i < n; i += NT)
    slots(g, d, i0 + i, first[i], second[i]);
}

// s[b][k][x] = *f(b, x, k) for b < NB, k < kn, x < n (row length ld, kc
// rows a component), the lanes along the source's contiguous index:
// ORD 0 along x (8, 16 or 32 lanes a row of k, as n takes them); ORD 1 8
// lanes along k times 4 along x.
template <int ORD, int NB, typename T, class F>
__device__ __forceinline__ void stage(T* s, int kn, int n, int ld, int kc,
                                      F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = 0; b < NB; ++b) {
    T* sb = s + (int64_t)b * kc * ld;
    if (ORD == 0) {
      const int lanes = n > 16 ? 32 : (n > 8 ? 16 : 8), per = 32 / lanes;
      for (int k = warp * per + lane / lanes; k < kn; k += NW * per)
        for (int x = lane % lanes; x < n; x += lanes)
          sb[k * ld + x] = *f(b, x, k);
    } else {
      for (int x = warp * 4 + (lane >> 3); x < n; x += NW * 4)
        for (int k = lane & 7; k < kn; k += 8) sb[k * ld + x] = *f(b, x, k);
    }
  }
}

// v = p[0..3], p 16-byte aligned
template <typename T>
__device__ __forceinline__ void ld4(const T* p, T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const double2 q = reinterpret_cast<const double2*>(p)[0];
    const double2 u = reinterpret_cast<const double2*>(p)[1];
    v[0] = q.x, v[1] = q.y, v[2] = u.x, v[3] = u.y;
  }
}

// The CTA's product C_b[m][n] = sum_k A(b, m, k) B(b, k, n) for NB
// components b, m < M, n < N, k < K; ep(b, m, n, value) takes each
// result once; fa and fb give the global address of an operand's value.
// A is staged kc values of k at a time into sA [NB][kc][ldp(M)] (staging
// order OA); B likewise into sB (OB), or, with Bd given, read in place
// from shared memory at Bd[b bs + k ld + n]. A single chunk is staged once
// for every round. Every thread holds a TM × TN tile of one b; more tiles
// than threads run in rounds; with SYNC (one round only) the CTA
// synchronizes once more between the products and their epilogue, which
// may then overwrite the operands. Every thread of the CTA must call it
// (it synchronizes before it stages, and after).
template <int OA, int OB, int NB, bool SYNC = false, typename T, class FA,
          class FB, class EP>
__device__ __forceinline__ void cta_mm(int M, int N, int K, int kc, T* sA,
                                       T* sB, const T* Bd, int ld,
                                       int64_t bs, FA fa, FB fb, EP ep) {
  const int nrt = cdiv(M, TM), nct = cdiv(N, TN);
  const int lda = ldp(M), ldb = Bd ? ld : ldp(N);
  const int64_t sa = (int64_t)kc * lda, sbs = Bd ? bs : (int64_t)kc * ldb;
  const int ntiles = NB * nrt * nct;
  const bool one = K <= kc;
  auto load = [&](int k0) {
    const int kn = min(kc, K - k0);
    __syncthreads();
    stage<OA, NB>(sA, kn, M, lda, kc,
                 [&](int b, int m, int k) { return fa(b, m, k0 + k); });
    if (!Bd)
      stage<OB, NB>(sB, kn, N, ldb, kc,
                   [&](int b, int n, int k) { return fb(b, k0 + k, n); });
    __syncthreads();
  };
  if (one) load(0);
  for (int t0 = 0; t0 < ntiles; t0 += NT) {
    const int t = t0 + (int)threadIdx.x;
    const bool on = t < ntiles;
    const int b = on ? t / (nrt * nct) : 0;
    const int tm = on ? (t / nct) % nrt : 0;
    const int tn = on ? t % nct : 0;
    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
    for (int k0 = 0; k0 < K; k0 += kc) {
      if (!one) load(k0);
      if (on) {
        const int kn = min(kc, K - k0);
        const T* a = sA + b * sa + tm * TM;
        const T* bv =
            (Bd ? Bd + (int64_t)k0 * ldb : sB) + b * sbs + tn * TN;
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          T x[TM], y[TN];
          ld4(a + k * lda, x);
          ld4(bv + k * ldb, y);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fma(x[i], y[j], acc[i][j]);
        }
      }
    }
    if (SYNC) __syncthreads();
    if (on) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int m = tm * TM + i, n = tn * TN + j;
          if (m < M && n < N) ep(b, m, n, acc[i][j]);
        }
    }
  }
}

template <typename T>
struct Params {
  const T* r;
  T* out;
  T* g;
  const T* q0;
  const T* q1;  // [1] a component where axis 1 is one node wide (2D)
  const T* q2;
  const T* binv;
  const T* jleft;  // null where every coefficient is zero
  Geo geo;
  int wa, ka;  // pass A: modes and k-chunk a CTA
  int pb, kb;  // pass B: pencils and k-chunk a CTA
  int ec, kc;  // pass C: elements along axis 2 and k-chunk a CTA
};

// A: g[a][i0][j1][j2] = sum_{i1, i2} Q1[a][i1][j1] Q2[a][i2][j2] r(i0, i1,
//    i2, a); a CTA a (plane, block of axis-2 modes, component)
template <typename T, int C>
__global__ void __launch_bounds__(NT)
    fdm_plane_fwd(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geo& G = p.geo;
  const int np0 = G.np[0], np1 = G.np[1], np2 = G.np[2];
  const int nblk = cdiv(np2, p.wa);
  const int a = blockIdx.x % C;
  const int j0 = blockIdx.x / C % nblk * p.wa;
  const int i0 = blockIdx.x / C / nblk;
  const int wn = min(p.wa, np2 - j0);
  const int lu = ldp(p.wa);
  int64_t* f1 = reinterpret_cast<int64_t*>(smem_raw);
  int64_t* s1 = f1 + np1;
  int64_t* f2 = s1 + np1;
  int64_t* s2 = f2 + np2;
  T* sA = reinterpret_cast<T*>(s2 + np2);
  T* sB = sA + (int64_t)p.ka * ldp(np1);
  T* U = sB + (int64_t)p.ka * lu;  // [np1][lu]
  fill_slots(G, 1, 0, np1, f1, s1);
  fill_slots(G, 2, 0, np2, f2, s2);
  int64_t x0, y0;
  slots(G, 0, i0, x0, y0);
  const T* r = p.r + rep(x0, y0) * C + a;
  const T* q1 = p.q1 + (int64_t)a * np1 * np1;
  const T* q2 = p.q2 + (int64_t)a * np2 * np2 + j0;
  // U[i1][j] = sum_i2 r(i0, i1, i2, a) Q2[a][i2][j0+j]
  cta_mm<1, 0, 1>(
      np1, wn, np2, p.ka, sA, sB, (const T*)nullptr, 0, 0,
      [&](int, int i1, int i2) {
        return r + (rep(f1[i1], s1[i1]) + rep(f2[i2], s2[i2])) * C;
      },
      [&](int, int i2, int j) { return q2 + (int64_t)i2 * np2 + j; },
      [&](int, int i1, int j, T v) { U[i1 * lu + j] = v; });
  // g[a][i0][j1][j0+j] = sum_i1 Q1[a][i1][j1] U[i1][j]
  T* g = p.g + ((int64_t)a * np0 + i0) * np1 * np2 + j0;
  cta_mm<0, 0, 1>(
      np1, wn, np1, p.ka, sA, sB, U, lu, 0,
      [&](int, int j1, int i1) { return q1 + (int64_t)i1 * np1 + j1; },
      [&](int, int, int) { return (const T*)nullptr; },
      [&](int, int j1, int j, T v) { g[(int64_t)j1 * np2 + j] = v; });
}

// B: on each pencil (all components) Q0ᵀ, the per-mode block, Q0; in place
template <typename T, int C>
__global__ void __launch_bounds__(NT)
    fdm_pencil(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geo& G = p.geo;
  const int np0 = G.np[0];
  const int64_t npl = (int64_t)G.np[1] * G.np[2];
  const int64_t p0 = (int64_t)blockIdx.x * p.pb;
  const int pn = (int)min((int64_t)p.pb, npl - p0);
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sB = sA + (int64_t)C * p.kb * ldp(np0);
  T* Y = sB + (int64_t)C * p.kb * ldp(p.pb);  // [C][np0][ly]
  const int ly = ldp(p.pb);
  const int64_t ys = (int64_t)np0 * ly;
  const T* q0 = p.q0;
  T* g = p.g + p0;
  // Y[b][m][q] = sum_n Q0[b][n][m] g[b][n][p0+q]
  cta_mm<0, 0, C>(
      np0, pn, np0, p.kb, sA, sB, (const T*)nullptr, 0, 0,
      [&](int b, int m, int n) {
        return q0 + ((int64_t)b * np0 + n) * np0 + m;
      },
      [&](int b, int n, int q) { return g + ((int64_t)b * np0 + n) * npl + q; },
      [&](int b, int m, int q, T v) { Y[b * ys + m * ly + q] = v; });
  __syncthreads();
  // the per-mode blocks: the lanes along the pencils, as many modes a warp
  // as its lanes cover
  const T* binv = p.binv + p0;
  const int64_t bs = (int64_t)np0 * npl;  // binv's stride between (a, b)
  const int lanes = pn > 16 ? 32 : (pn > 8 ? 16 : 8), per = 32 / lanes;
  const int lane = threadIdx.x & 31;
  for (int m = (threadIdx.x >> 5) * per + lane / lanes; m < np0;
       m += NW * per)
    for (int q = lane % lanes; q < pn; q += lanes) {
      T y[C], z[C];
      const int64_t at = (int64_t)m * npl + q;
#pragma unroll
      for (int b = 0; b < C; ++b) y[b] = Y[b * ys + m * ly + q];
#pragma unroll
      for (int a = 0; a < C; ++a) {
        T s = T(0);
#pragma unroll
        for (int b = 0; b < C; ++b)
          s = fma(binv[(a * C + b) * bs + at], y[b], s);
        z[a] = s;
      }
#pragma unroll
      for (int a = 0; a < C; ++a) Y[a * ys + m * ly + q] = z[a];
    }
  // g[b][n][p0+q] = sum_m Q0[b][n][m] Y[b][m][q]; in one round the
  // results go back into Y, then out a row (b, n) of pn values at a time
  auto fa = [&](int b, int n, int m) {
    return q0 + ((int64_t)b * np0 + n) * np0 + m;
  };
  auto fb = [&](int, int, int) { return (const T*)nullptr; };
  if (C * cdiv(np0, TM) * cdiv(pn, TN) > NT) {
    cta_mm<1, 0, C>(np0, pn, np0, p.kb, sA, sB, Y, ly, ys, fa, fb,
                    [&](int b, int n, int q, T v) {
                      g[((int64_t)b * np0 + n) * npl + q] = v;
                    });
    return;
  }
  cta_mm<1, 0, C, true>(
      np0, pn, np0, p.kb, sA, sB, Y, ly, ys, fa, fb,
      [&](int b, int n, int q, T v) { Y[b * ys + n * ly + q] = v; });
  __syncthreads();
  for (int row = (threadIdx.x >> 5) * per + lane / lanes; row < C * np0;
       row += NW * per)
    for (int q = lane % lanes; q < pn; q += lanes)
      g[row * npl + q] = Y[row * ly + q];
}

// C: z(i0, i1, i2, a) = sum_{j1, j2} Q1[a][i1][j1] Q2[a][i2][j2]
//    g[a][i0][j1][j2] + jleft[node][a] r(i0, i1, i2, a), into every slot
//    of the plane's element layers in a block of elements along axis 2; a
//    CTA a (plane, element block, component)
template <typename T, int C>
__global__ void __launch_bounds__(NT)
    fdm_plane_bwd(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geo& G = p.geo;
  const int np0 = G.np[0], np1 = G.np[1], np2 = G.np[2];
  const int n1 = G.nl[1], n2 = G.nl[2], ne1 = G.ne[1], ne2 = G.ne[2];
  const int nblk = cdiv(ne2, p.ec);
  const int a = blockIdx.x % C;
  const int e2lo = blockIdx.x / C % nblk * p.ec;
  const int i0 = blockIdx.x / C / nblk;
  const int neb = min(p.ec, ne2 - e2lo);  // elements in the block
  const int j0 = e2lo * (n2 - 1), wn = neb * (n2 - 1) + 1;
  const int lz = p.ec * (n2 - 1) + 1, lv = ldp(lz);
  const int L = neb * n2;  // nodes of one element row of the block
  int64_t* f1 = reinterpret_cast<int64_t*>(smem_raw);
  int64_t* s1 = f1 + np1;
  int64_t* f2 = s1 + np1;
  int64_t* s2 = f2 + np2;
  int64_t* woff = s2 + np2;  // write table: value offset in the row,
  int* wcol = reinterpret_cast<int*>(woff + p.ec * n2);  // its column
  T* sA = reinterpret_cast<T*>(woff + 2 * p.ec * n2);
  T* sB = sA + (int64_t)p.kc * ldp(np1);
  T* V = sB + (int64_t)p.kc * lv;  // [np1][lv]
  T* Z = V + (int64_t)np1 * lv;    // [np1][lz]
  fill_slots(G, 1, 0, np1, f1, s1);
  fill_slots(G, 2, j0, wn, f2, s2);
  for (int t = threadIdx.x; t < L; t += NT) {
    const int e = t / n2, l2 = t - e * n2;
    woff[t] = ((e2lo + e) * G.se[2] + l2 * G.sl[2]) * C + a;
    wcol[t] = e * (n2 - 1) + l2;
  }
  int64_t x0[2];
  slots(G, 0, i0, x0[0], x0[1]);
  const int n0 = x0[1] >= 0 ? 2 : 1;
  const T* q1 = p.q1 + (int64_t)a * np1 * np1;
  const T* q2 = p.q2 + ((int64_t)a * np2 + j0) * np2;
  const T* g = p.g + ((int64_t)a * np0 + i0) * np1 * np2;
  // V[j1][i] = sum_j2 g[a][i0][j1][j2] Q2[a][j0+i][j2]
  cta_mm<1, 1, 1>(
      np1, wn, np2, p.kc, sA, sB, (const T*)nullptr, 0, 0,
      [&](int, int j1, int j2) { return g + (int64_t)j1 * np2 + j2; },
      [&](int, int j2, int i) { return q2 + (int64_t)i * np2 + j2; },
      [&](int, int j1, int i, T v) { V[j1 * lv + i] = v; });
  const T* r = p.r + rep(x0[0], x0[1]) * C + a;
  const T* jleft = p.jleft;
  // Z[i1][i] = sum_j1 Q1[a][i1][j1] V[j1][i] (+ jleft g0)
  cta_mm<1, 0, 1>(
      np1, wn, np1, p.kc, sA, sB, V, lv, 0,
      [&](int, int i1, int j1) { return q1 + (int64_t)i1 * np1 + j1; },
      [&](int, int, int) { return (const T*)nullptr; },
      [&](int, int i1, int i, T v) {
        if (jleft) {
          const T jl =
              jleft[(((int64_t)i0 * np1 + i1) * np2 + j0 + i) * C + a];
          if (jl != T(0))
            v = fma(jl, r[(rep(f1[i1], s1[i1]) + rep(f2[i], s2[i])) * C], v);
        }
        Z[i1 * lz + i] = v;
      });
  __syncthreads();
  // every slot of the block's elements in the plane's element layers: a
  // warp a row (layer, e1, l1), its lanes along the row's slots
  T* out = p.out;
  const int rows = n0 * ne1 * n1;
  for (int row = threadIdx.x >> 5; row < rows; row += NW) {
    const int x = row / (ne1 * n1), e1 = row / n1 % ne1, l1 = row % n1;
    const int64_t at = (x0[x] + e1 * G.se[1] + l1 * G.sl[1]) * C;
    const T* z = Z + (e1 * (n1 - 1) + l1) * lz;
    for (int t = threadIdx.x & 31; t < L; t += 32)
      out[at + woff[t]] = z[wcol[t]];
  }
}

// One FDMOps' arguments, built once per FDMOps and box shape by the host
// (solver/fdm.py _Args mirrors it field for field); r, out, g and stream
// are rewritten before each call. Axis 1 is one node wide in 2D.
struct Args {
  const void* r;
  void* out;
  void* g;
  const void* q0;
  const void* q1;
  const void* q2;
  const void* binv;
  const void* jleft;
  void* stream;
  int f64;
  int c;
  int np[3];
  int ne[3];
  int nl[3];
  int pad;
};

// BEGIN plan (the tiles of the three passes)
// The k-chunk a pass stages where the whole contracted index does not fit,
// and the least it cuts to before it narrows the blocks; the shared memory
// a pass aims at (three CTAs an SM), and the most one CTA of an H100 may
// take.
constexpr int KCHUNK = 32, KMIN = 16;
constexpr int64_t SMEM_AIM = 74 * 1024, SMEM_MAX = 227 * 1024;

struct Plan {
  int wa, ka;      // pass A: modes and k-chunk a CTA
  int pb, kb;      // pass B: pencils and k-chunk a CTA
  int ec, kc;      // pass C: elements along axis 2 and k-chunk a CTA
  int64_t sa, sb, sc;  // the shared memory of each pass, bytes
};

// Cuts the k-chunk to KCHUNK and on to KMIN, then halves the width, then
// the chunk, until bytes(k, w) is within SMEM_AIM; false if past SMEM_MAX.
template <typename B>
bool fit(B bytes, int& w, int& k) {
  while (bytes(k, w) > SMEM_AIM) {
    if (k > KMIN)
      k = k > KCHUNK ? KCHUNK : k / 2;
    else if (w > 1)
      w = cdiv(w, 2);
    else if (k > 1)
      k /= 2;
    else
      break;
  }
  return bytes(k, w) <= SMEM_MAX;
}

// The block size that splits n into the fewest blocks of at most `most`,
// evenly.
inline int even(int n, int most) { return cdiv(n, cdiv(n, most)); }

// The tiles for the box of a in elements of esize bytes. A CTA of pass A
// takes one component and every axis-2 mode of a plane; one of pass C one
// component and the widest block of whole axis-2 elements whose thread
// tiles fill one round of NT threads; one of pass B all c components of
// the most pencils that fill one round; the blocks split evenly, and each
// pass stages the whole contracted index at once where it fits. Then the
// chunks and widths shrink until the shared memory is within SMEM_AIM.
// More tiles than threads run in rounds. False where the box is not one
// the kernels take or a pass does not fit one CTA's shared memory.
inline bool make_plan(const Args& a, int esize, Plan& p) {
  const int np0 = a.np[0], np1 = a.np[1], np2 = a.np[2], n2 = a.nl[2];
  const int c = a.c;
  if (n2 < 2 || c < 1 || np0 < 1 || np1 < 1 || np2 < 1 || a.ne[2] < 1)
    return false;
  const int kk = np1 > np2 ? np1 : np2;
  p.wa = np2;
  p.ka = kk;
  bool ok = fit([&](int k, int w) { return fwd_bytes(esize, k, np1, np2, w); },
                p.wa, p.ka);
  p.wa = even(np2, p.wa);
  const int rows = NT / cdiv(np1, TM);
  const int cols = (rows > 1 ? rows : 1) * TN;
  const int eb = (cols - 1) / (n2 - 1);
  p.ec = even(a.ne[2], eb > 1 ? eb : 1);
  p.kc = kk;
  ok = ok && fit([&](int k, int e) {
         return bwd_bytes(esize, k, np1, np2, e, n2);
       }, p.ec, p.kc);
  p.ec = even(a.ne[2], p.ec);
  const int per = NT / (c * cdiv(np0, TM));
  const int64_t pen = (int64_t)(per > 1 ? per : 1) * TN;
  const int64_t npl = (int64_t)np1 * np2;
  p.pb = (int)(pen < npl ? pen : npl);
  p.kb = np0;
  ok = ok && fit([&](int k, int q) {
         return pencil_bytes(esize, c, k, np0, q);
       }, p.pb, p.kb);
  p.sa = fwd_bytes(esize, p.ka, np1, np2, p.wa);
  p.sb = pencil_bytes(esize, c, p.kb, np0, p.pb);
  p.sc = bwd_bytes(esize, p.kc, np1, np2, p.ec, n2);
  return ok;
}
// END plan

// Raises a kernel's dynamic shared-memory ceiling where a pass needs more
// than the default 48 KB (once for each larger size).
template <typename K>
cudaError_t allow_smem(K kernel, int64_t bytes, int64_t& set) {
  if (bytes <= 48 * 1024 || bytes <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set = bytes;
  return err;
}

template <typename T, int C>
int launch_as(const Args& a) {
  Plan pl;
  if (!make_plan(a, (int)sizeof(T), pl)) return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.r = static_cast<const T*>(a.r);
  p.out = static_cast<T*>(a.out);
  p.g = static_cast<T*>(a.g);
  p.q0 = static_cast<const T*>(a.q0);
  p.q1 = static_cast<const T*>(a.q1);
  p.q2 = static_cast<const T*>(a.q2);
  p.binv = static_cast<const T*>(a.binv);
  p.jleft = static_cast<const T*>(a.jleft);
  Geo& G = p.geo;
  for (int d = 0; d < 3; ++d) {
    G.np[d] = a.np[d];
    G.ne[d] = a.ne[d];
    G.nl[d] = a.nl[d];
  }
  const int64_t nn = (int64_t)a.nl[0] * a.nl[1] * a.nl[2];
  G.sl[2] = 1;
  G.sl[1] = a.nl[2];
  G.sl[0] = (int64_t)a.nl[1] * a.nl[2];
  G.se[2] = nn;
  G.se[1] = (int64_t)a.ne[2] * nn;
  G.se[0] = (int64_t)a.ne[1] * a.ne[2] * nn;
  p.wa = pl.wa;
  p.ka = pl.ka;
  p.pb = pl.pb;
  p.kb = pl.kb;
  p.ec = pl.ec;
  p.kc = pl.kc;
  const int64_t sa = pl.sa, sb = pl.sb, sc = pl.sc;
  static int64_t set_a = 0, set_b = 0, set_c = 0;
  cudaError_t err = allow_smem(fdm_plane_fwd<T, C>, sa, set_a);
  if (err == cudaSuccess) err = allow_smem(fdm_pencil<T, C>, sb, set_b);
  if (err == cudaSuccess) err = allow_smem(fdm_plane_bwd<T, C>, sc, set_c);
  if (err != cudaSuccess) return (int)err;
  const int64_t npl = (int64_t)a.np[1] * a.np[2];
  const int64_t ga = (int64_t)a.np[0] * cdiv(a.np[2], pl.wa) * C;
  const int64_t gb = (npl + pl.pb - 1) / pl.pb;
  const int64_t gc = (int64_t)a.np[0] * cdiv(a.ne[2], pl.ec) * C;
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  fdm_plane_fwd<T, C><<<(unsigned)ga, NT, (size_t)sa, s>>>(p);
  fdm_pencil<T, C><<<(unsigned)gb, NT, (size_t)sb, s>>>(p);
  fdm_plane_bwd<T, C><<<(unsigned)gc, NT, (size_t)sc, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The three launches of one apply on the stream in *args; returns
// cudaGetLastError() (0 = success), cudaErrorInvalidValue for arguments
// out of range.
int pn_fdm_apply(const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.c == 2) return a.f64 ? launch_as<double, 2>(a) : launch_as<float, 2>(a);
  if (a.c == 3) return a.f64 ? launch_as<double, 3>(a) : launch_as<float, 3>(a);
  return (int)cudaErrorInvalidValue;
}

// The tiles pn_fdm_apply takes for the box in *args (its f64, c, np, ne
// and nl; the pointers are not read): out[0..5] = wa, ka, pb, kb, ec, kc,
// out[6..8] = the shared memory of passes A, B and C in bytes. Returns 0,
// or cudaErrorInvalidValue where the kernels do not take the box or a pass
// does not fit one CTA's shared memory. Launches nothing.
int pn_fdm_plan(const void* args, int* out) {
  const Args& a = *static_cast<const Args*>(args);
  Plan p;
  if (!make_plan(a, a.f64 ? 8 : 4, p)) return (int)cudaErrorInvalidValue;
  const int64_t v[9] = {p.wa, p.ka, p.pb, p.kb, p.ec, p.kc, p.sa, p.sb, p.sc};
  for (int i = 0; i < 9; ++i) out[i] = (int)v[i];
  return 0;
}

}  // extern "C"
