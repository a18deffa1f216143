// fused_apply: y = DSS(t @ matT) on the canonical element-local layout of a
// box mesh, plus the raw axis-0 boundary planes `bnd`.
//
// Replaces the Pallas kernel pynama_tpu/ops/fused.py::_fused_kernel (launched
// by fused_apply). It computes what that kernel computes; it is not a
// block-by-block copy of it (the TPU kernel pipelines axis-0 blocks through a
// sequential grid, which has no counterpart on Hopper).
//
// Layout. t is (E, nnc_in), matT (nnc_in, nnc_out), y (E, nnc_out), all
// row-major. Elements are numbered row-major over nelem (axis 0 slowest);
// column = node * ncomp + comp with node = a_0 N^{dim-1} + ... + a_{dim-1}
// (axis 0 slowest), N = ngl.
//
// Three launches on the caller's stream:
//   1. gemm_kernel: u = t @ matT, a tiled FFMA GEMM with shared-memory tiles
//      and a K-loop; ragged edges masked; matT is streamed in BK-row tiles,
//      never held whole in shared memory. No tensor cores and no TF32: the
//      KLE operator needs full f32 products (DESIGN §3, lambda_min/||K|| =
//      6e-4).
//   2. dss_kernel (one block per element row): y[e, col] = sum of u over the
//      up to 2^dim slots that hold (e, col)'s global node, found by index
//      arithmetic (no gather table).
//      The copies are summed in one canonical order that does not depend on
//      which slot computes the sum (pairs along axis 0 first, then pairs of
//      those along axis 1, then axis 2; lower element first in each pair).
//      That is the order the axis-by-axis plain DSS produces, and every
//      duplicate slot gets a bitwise-identical value.
//   3. bnd_kernel: bnd[0] = element row (0, r), columns [:plane]; bnd[1] =
//      element row (ne0-1, r), columns [nnc-plane:]; both summed over axes
//      1..dim-1 only (the cross-slab adds of a sharded run).
//
// What bounds it on an H100: at 24^3 ngl=4 the (192, 192) apply is about
// 1.0 GFLOP of FFMA against about 21 MB of HBM traffic (t, u, y, each
// 10.6 MB, with matT cached), so a simple kernel is bound by memory traffic
// and launch overhead, not by the 67 TFLOP/s of FP32. The two-pass form
// writes and re-reads u once; fusing the passes (a CTA per axis-0 tile with
// recomputed halo planes) removes that round trip and is later work.
//
// All element/slot offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows (elements) per GEMM tile
constexpr int BN = 64;   // output columns per GEMM tile
constexpr int BK = 16;   // K-loop depth per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256

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

// Element and node indices fit in 32 bits (the wrapper checks E < 2^31);
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

// one block per element row; threads walk its columns
template <typename T>
__global__ void dss_kernel(const T* __restrict__ u, T* __restrict__ y,
                           MeshShape s) {
  const int e = blockIdx.x;
  T* __restrict__ row = y + (int64_t)e * s.nnc;
  for (int col = threadIdx.x; col < s.nnc; col += blockDim.x)
    row[col] = slot_sum(u, s, e, col, 0);
}

// block (r, side): bnd[side, r, :], the raw axis-0 boundary plane of
// element row (0, r) (side 0, first plane) or (ne0-1, r) (side 1, last)
template <typename T>
__global__ void bnd_kernel(const T* __restrict__ u, T* __restrict__ bnd,
                           MeshShape s, int R, int plane) {
  const int r = blockIdx.x;
  const int side = blockIdx.y;
  const int e = side == 0 ? r : (s.ne[0] - 1) * R + r;
  const int col0 = side == 0 ? 0 : s.nnc - plane;
  T* __restrict__ out = bnd + ((int64_t)side * R + r) * plane;
  for (int j = threadIdx.x; j < plane; j += blockDim.x)
    out[j] = slot_sum(u, s, e, col0 + j, 1);
}

// threads per block for a row of n columns: whole warps, at most 256
inline int row_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 256 ? t : 256;
}

template <typename T>
int launch(const T* t, const T* matT, T* u, T* y, T* bnd, int64_t E,
           int nnc_in, int ngl, int ncomp_out, int dim, const int nelem[3],
           cudaStream_t stream) {
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
  const int nnc_out = s.nnc;

  dim3 ggrid((unsigned)((E + BM - 1) / BM),
             (unsigned)((nnc_out + BN - 1) / BN));
  gemm_kernel<T><<<ggrid, GEMM_THREADS, 0, stream>>>(t, matT, u, E, nnc_in,
                                                      nnc_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dss_kernel<T><<<(unsigned)E, row_threads(nnc_out), 0, stream>>>(u, y, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int R = (int)(E / s.ne[0]);
  const int plane = s.nnc / ngl;
  bnd_kernel<T><<<dim3((unsigned)R, 2), row_threads(plane), 0, stream>>>(
      u, bnd, s, R, plane);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launches (0 = success).
int pn_fused_apply_f32(const void* t, const void* matT, void* u, void* y,
                       void* bnd, int64_t E, int nnc_in, int ngl,
                       int ncomp_out, int dim, int ne0, int ne1, int ne2,
                       void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  return launch<float>((const float*)t, (const float*)matT, (float*)u,
                       (float*)y, (float*)bnd, E, nnc_in, ngl, ncomp_out, dim,
                       nelem, (cudaStream_t)stream);
}

int pn_fused_apply_f64(const void* t, const void* matT, void* u, void* y,
                       void* bnd, int64_t E, int nnc_in, int ngl,
                       int ncomp_out, int dim, int ne0, int ne1, int ne2,
                       void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  return launch<double>((const double*)t, (const double*)matT, (double*)u,
                        (double*)y, (double*)bnd, E, nnc_in, ngl, ncomp_out,
                        dim, nelem, (cudaStream_t)stream);
}

}  // extern "C"
