// Shared pieces of the box-mesh apply kernels: the FFMA GEMM, the mesh
// shape, and the index-arithmetic DSS. fused_apply.cu (K1), decomp.cu (K3,
// K4) and fused3x.cu (K2) include this header, so every kernel that runs
// "the GEMM" or "the DSS" runs the same code, and a difference between two
// of them in a decomposition is the part that differs, not a copy.
//
// Layout. t is (E, nnc_in), matT (nnc_in, nnc_out), u and y (E, nnc_out),
// all row-major. Elements are numbered row-major over nelem (axis 0
// slowest); column = node * ncomp + comp with node = a_0 N^{dim-1} + ... +
// a_{dim-1} (axis 0 slowest), N = ngl.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows (elements) per GEMM tile
constexpr int BN = 64;   // output columns per GEMM tile
constexpr int BK = 16;   // K-loop depth per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256

// C = A @ B: a tiled FFMA GEMM with shared-memory tiles and a K-loop;
// ragged edges masked; B is streamed in BK-row tiles, never held whole in
// shared memory. No tensor cores and no TF32: the KLE operator needs full
// f32 products (DESIGN §3, lambda_min/||K|| = 6e-4).
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            T* __restrict__ C, int64_t M, int K, int N) {
  __shared__ T As[BK][BM];
  __shared__ T Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // 0..15: output columns tx + 16 j
  const int ty = tid / (BN / TN);   // 0..15: output rows ty + 16 i
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK), stored transposed; consecutive threads walk k
    for (int idx = tid; idx < BM * BK; idx += GEMM_THREADS) {
      const int mm = idx / BK, kk = idx % BK;
      const int64_t gm = m0 + mm;
      const int gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[gm * K + gk] : T(0);
    }
    // B tile (BK x BN); consecutive threads walk n
    for (int idx = tid; idx < BK * BN; idx += GEMM_THREADS) {
      const int kk = idx / BN, nn = idx % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? B[(int64_t)gk * N + gn] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch_gemm(const T* A, const T* B, T* C, int64_t M, int K, int N,
                cudaStream_t stream) {
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  gemm_kernel<T><<<grid, GEMM_THREADS, 0, stream>>>(A, B, C, M, K, N);
  return (int)cudaGetLastError();
}

// Element and node indices fit in 32 bits (the wrappers check E < 2^31);
// only offsets into u/y are 64-bit. 32-bit decoding matters: a 64-bit
// integer division is a long software sequence on the GPU, and an earlier
// 1-D form that decoded a flat 64-bit index per slot made the DSS pass as
// slow as the GEMM.
struct MeshShape {
  int dim;
  int ngl;
  int ncomp;
  int nnc;          // ngl^dim * ncomp
  int ne[3];        // elements per axis (unused entries 1)
  int estride[3];   // element-row stride per axis (row-major)
  int nstride[3];   // local-node stride per axis (axis 0 slowest)
};

inline MeshShape make_mesh_shape(int ngl, int ncomp_out, int dim,
                                 const int nelem[3]) {
  MeshShape s;
  s.dim = dim;
  s.ngl = ngl;
  s.ncomp = ncomp_out;
  int nn = 1;
  for (int d = 0; d < dim; ++d) nn *= ngl;
  s.nnc = nn * ncomp_out;
  for (int d = 0; d < 3; ++d) s.ne[d] = d < dim ? nelem[d] : 1;
  int es = 1;
  int ns = 1;
  for (int d = 2; d >= 0; --d) {
    if (d >= dim) {
      s.estride[d] = 1;
      s.nstride[d] = 1;
      continue;
    }
    s.estride[d] = es;
    es *= s.ne[d];
    s.nstride[d] = ns;
    ns *= ngl;
  }
  return s;
}

// Sum of the copies of slot (e, col) over the axes d >= first_axis, in the
// canonical order: pairs along the lowest axis innermost, lower element
// first in each pair. `u` is (E, nnc).
template <typename T>
__device__ __forceinline__ T slot_sum(const T* __restrict__ u,
                                      const MeshShape& s, int e, int col,
                                      int first_axis) {
  const int node = col / s.ncomp;
  const int comp = col - node * s.ncomp;
  // per axis: offset (in entries of u) of the lower and the higher copy;
  // both equal the slot's own position where the axis has no partner
  int64_t lo[3], hi[3];
  bool shared[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = 0;
    hi[d] = 0;
    shared[d] = false;
    if (d >= s.dim) continue;
    const int e_d = (e / s.estride[d]) % s.ne[d];
    const int a_d = (node / s.nstride[d]) % s.ngl;
    const int64_t elem_step = (int64_t)s.estride[d] * s.nnc;
    const int64_t node_step = (int64_t)s.nstride[d] * s.ncomp;
    const int64_t own = e_d * elem_step + a_d * node_step;
    lo[d] = own;
    hi[d] = own;
    if (d < first_axis) continue;
    if (a_d == 0 && e_d > 0) {
      // partner: element e_d - 1 at a_d = N-1 (the lower copy)
      shared[d] = true;
      lo[d] = (e_d - 1) * elem_step + (int64_t)(s.ngl - 1) * node_step;
    } else if (a_d == s.ngl - 1 && e_d < s.ne[d] - 1) {
      // partner: element e_d + 1 at a_d = 0 (the higher copy)
      shared[d] = true;
      hi[d] = (e_d + 1) * elem_step;
    }
  }
  // v[m]: the copy that takes the higher element along every axis d whose
  // bit is set in m (only shared axes may be set)
  T v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    bool valid = true;
    int64_t off = comp;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const bool bit = (m >> d) & 1;
      if (bit && !shared[d]) valid = false;
      off += bit ? hi[d] : lo[d];
    }
    v[m] = valid ? u[off] : T(0);
  }
  // reduce: axis-0 pairs first, then axis 1, then axis 2
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (!shared[d]) continue;
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (!((m >> d) & 1)) v[m] = v[m] + v[m | (1 << d)];
  }
  return v[0];
}

// y = DSS(u): one block per element row; threads walk its columns. The
// copies of a node are summed in one canonical order that does not depend
// on which slot computes the sum (pairs along axis 0 first, then pairs of
// those along axis 1, then axis 2; lower element first in each pair). That
// is the order the axis-by-axis plain DSS produces, and every duplicate
// slot gets a bitwise-identical value.
template <typename T>
__global__ void dss_kernel(const T* __restrict__ u, T* __restrict__ y,
                           MeshShape s) {
  const int e = blockIdx.x;
  T* __restrict__ row = y + (int64_t)e * s.nnc;
  for (int col = threadIdx.x; col < s.nnc; col += blockDim.x)
    row[col] = slot_sum(u, s, e, col, 0);
}

// threads per block for a row of n columns: whole warps, at most 256
inline int row_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 256 ? t : 256;
}

template <typename T>
int launch_dss(const T* u, T* y, int64_t E, const MeshShape& s,
               cudaStream_t stream) {
  dss_kernel<T><<<(unsigned)E, row_threads(s.nnc), 0, stream>>>(u, y, s);
  return (int)cudaGetLastError();
}

}  // namespace
