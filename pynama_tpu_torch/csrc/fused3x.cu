// fused3x_apply: y = DSS(mm3x(t, matT)), float32, where mm3x is the 3-pass
// split-bf16 product on the tensor cores:
//   a_hi = bf16_rn(a), a_lo = bf16_rn(a - a_hi), likewise m_hi, m_lo;
//   u = a_hi m_hi + a_hi m_lo + a_lo m_hi      (bf16 inputs, f32 accumulate)
//
// Replaces the Pallas kernel exp/mm3x.py::_kernel3x (launched by
// fused3x_apply, split at exp/mm3x.py:30-38). On the TPU it asked whether an
// explicit 3-pass split beats Precision.HIGHEST on the MXU. Here it asks
// whether a tensor-core split GEMM keeps the accuracy the KLE operator needs
// (about 16 mantissa bits, where TF32's 10 are ruled out: DESIGN §3), and
// what it costs against K1's FFMA GEMM.
//
// Two launches on the caller's stream:
//   1. gemm3x_kernel: u = mm3x(t, matT), nvcuda::wmma m16n16k16 bf16
//      fragments with f32 accumulators. A 128-thread block computes a 64x64
//      tile of u; each of its 4 warps a 32x32 quarter (2x2 fragments). Per
//      32-deep k stage the block loads the A (64x32) and B (32x64) f32 tiles
//      once, splits each value into its hi and lo bf16 halves while storing
//      them to shared memory (zero-padded past the ragged edges: widths 9,
//      18, 27, 1029, 2058 are not multiples of 16), and runs three MMAs per
//      fragment pair and 16-deep k step, in the order hi*hi, hi*lo, lo*hi,
//      into ONE stage accumulator that starts from zero; the stage's sum is
//      then added to the running f32 sum with ordinary (round-to-nearest)
//      adds. JAX sums three separate products as (hh + hl) + lh; one
//      accumulator changes only the rounding order. Each bf16 x bf16
//      product is exact in f32, but the tensor cores round their own
//      accumulation, and over one chain of K/16 * 3 MMAs that error grew
//      about linearly in K (8.0e-6 of max|y| against the plain version at
//      ngl=7, K = 1029-2058, on an H100); the per-stage chain is 6 MMAs
//      long. The 64x64 result goes through shared memory and out with a
//      masked copy.
//   2. dss_kernel (fused_common.cuh): K1's block-free DSS, so y's duplicate
//      slots are bitwise equal as in K1. The TPU kernel's `block` only
//      changes the order of its additions and is not a parameter here.
//
// What bounds it on an H100: at 24^3 ngl=4 192->192 the three products are
// 3.06 GFLOP of bf16 MMA against the same ~21 MB as K1, so it is bound by
// memory traffic and by the f32 -> bf16 split done in the load loop, not by
// the 989 TFLOP/s of the tensor cores. wgmma, TMA and a pipelined load are
// later work; this form is the simple one.
//
// Shared-memory strides: bf16 rows of 40 and 72 values and f32 rows of 68
// keep every fragment pointer 32-byte aligned and every ldm a multiple of 8
// (bf16) or 4 (f32), as load_matrix_sync/store_matrix_sync require.

#include <cuda_bf16.h>
#include <mma.h>

#include "fused_common.cuh"

namespace {

using namespace nvcuda;

constexpr int X_BM = 64;                  // rows of u per block
constexpr int X_BN = 64;                  // columns of u per block
constexpr int X_BK = 32;                  // k depth per shared-memory stage
constexpr int X_THREADS = 128;            // 4 warps, 2 x 2 over the tile
constexpr int A_LD = X_BK + 8;            // bf16 stride of an A row (40)
constexpr int B_LD = X_BN + 8;            // bf16 stride of a B row (72)
constexpr int C_LD = X_BN + 4;            // f32 stride of a u row (68)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void split_store(float v, __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

__global__ void __launch_bounds__(X_THREADS)
gemm3x_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int64_t M, int K, int N) {
  __shared__ __align__(128) __nv_bfloat16 a_hi[X_BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 a_lo[X_BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 b_hi[X_BK * B_LD];
  __shared__ __align__(128) __nv_bfloat16 b_lo[X_BK * B_LD];
  __shared__ __align__(128) float c_s[X_BM * C_LD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // rows 32 wm .. 32 wm + 31 of the tile
  const int wn = warp % 2;   // columns 32 wn .. 32 wn + 31
  const int64_t m0 = (int64_t)blockIdx.x * X_BM;
  const int n0 = blockIdx.y * X_BN;

  // acc: the running sums, kept with f32 adds (round to nearest); part: one
  // stage's products, accumulated by the tensor cores from zero
  FragC acc[2][2], part[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += X_BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.0f);
    // A tile (X_BM x X_BK); consecutive threads walk k
    for (int idx = tid; idx < X_BM * X_BK; idx += X_THREADS) {
      const int mm = idx / X_BK, kk = idx % X_BK;
      const int64_t gm = m0 + mm;
      const int gk = k0 + kk;
      const float v = (gm < M && gk < K) ? A[gm * K + gk] : 0.0f;
      split_store(v, &a_hi[mm * A_LD + kk], &a_lo[mm * A_LD + kk]);
    }
    // B tile (X_BK x X_BN); consecutive threads walk n
    for (int idx = tid; idx < X_BK * X_BN; idx += X_THREADS) {
      const int kk = idx / X_BN, nn = idx % X_BN;
      const int gk = k0 + kk, gn = n0 + nn;
      const float v = (gk < K && gn < N) ? B[(int64_t)gk * N + gn] : 0.0f;
      split_store(v, &b_hi[kk * B_LD + nn], &b_lo[kk * B_LD + nn]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < X_BK; kk += 16) {
      FragA ah[2], al[2];
      FragB bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = (32 * wm + 16 * i) * A_LD + kk;
        wmma::load_matrix_sync(ah[i], a_hi + off, A_LD);
        wmma::load_matrix_sync(al[i], a_lo + off, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = kk * B_LD + 32 * wn + 16 * j;
        wmma::load_matrix_sync(bh[j], b_hi + off, B_LD);
        wmma::load_matrix_sync(bl[j], b_lo + off, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(part[i][j], ah[i], bh[j], part[i][j]);
          wmma::mma_sync(part[i][j], ah[i], bl[j], part[i][j]);
          wmma::mma_sync(part[i][j], al[i], bh[j], part[i][j]);
        }
    }
    // fragments of one type map elements to threads alike, so the stage
    // adds element by element
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < part[i][j].num_elements; ++e)
          acc[i][j].x[e] += part[i][j].x[e];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          c_s + (32 * wm + 16 * i) * C_LD + 32 * wn + 16 * j, acc[i][j],
          C_LD, wmma::mem_row_major);
  __syncthreads();
  // masked copy out; consecutive threads walk n
  for (int idx = tid; idx < X_BM * X_BN; idx += X_THREADS) {
    const int mm = idx / X_BN, nn = idx % X_BN;
    const int64_t gm = m0 + mm;
    const int gn = n0 + nn;
    if (gm < M && gn < N) C[gm * N + gn] = c_s[mm * C_LD + nn];
  }
}

}  // namespace

extern "C" {

// u: (E, nnc_out) scratch. Returns cudaGetLastError() after the launches.
int pn_fused3x_f32(const void* t, const void* matT, void* u, void* y,
                   int64_t E, int nnc_in, int ngl, int ncomp_out, int dim,
                   int ne0, int ne1, int ne2, void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  const MeshShape s = make_mesh_shape(ngl, ncomp_out, dim, nelem);
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)((E + X_BM - 1) / X_BM),
            (unsigned)((s.nnc + X_BN - 1) / X_BN));
  gemm3x_kernel<<<grid, X_THREADS, 0, st>>>(
      (const float*)t, (const float*)matT, (float*)u, E, nnc_in, s.nnc);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_dss<float>((const float*)u, (float*)y, nullptr, s, st);
}

}  // extern "C"
