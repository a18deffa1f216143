// The decomposition kernels of fused_apply: K4 plainmm (the GEMM alone) and
// K3 variant_apply (the GEMM with the DSS, or with the axis-0 block-seam
// adds only).
//
// Replaces the Pallas kernels exp/fused_decomp.py::_plainmm_kernel
// (launched by plainmm_apply) and exp/fused_decomp.py::_variant_kernel
// (launched by variant_apply). On the TPU they split the fused kernel's time
// into its roll chain, its cross-block finalize and its matmul. Here they
// split K1's time the same way, with K1's own pieces:
//
//   plainmm          gemm_kernel alone (fused_common.cuh), y = t @ matT.
//                    The TPU's `block` (rows per grid step) has no Hopper
//                    meaning: the GEMM's tile is chosen by launch_gemm.
//   variant, rolls   gemm_kernel + dss_kernel, K1 without the bnd planes; y
//                    is bitwise K1's y.
//   variant, no rolls gemm_kernel into y, then seam_kernel: at each interior
//                    block seam s*blk (s = 1..nblk-1) and each r < R, the
//                    last axis-0 plane of element row (s*blk-1)*R + r and
//                    the first plane of row s*blk*R + r both become the sum
//                    of the two raw values. That is what the TPU kernel's
//                    cross-block finalize leaves when the roll chain is
//                    skipped: nothing is added inside a block or along axes
//                    1..dim-1.
//
// What bounds them on an H100. plainmm is the GEMM, bound by FFMA issue in
// f32 and by DMMA and HBM in f64; its design is in fused_common.cuh's head.
// K1, K3 and K4 run that one GEMM, so the decomposition's plainmm - torch_mm
// line reads it against cuBLAS directly.
//
// seam_kernel moves 2 planes per seam pair (at 24^3 ngl=4 block 1, 23 * 576
// pairs of 48 values, ~10 MB read and written), so it is bound by HBM (3 us
// at 3.35 TB/s). One flat grid of 256-thread blocks covers every (seam, r,
// column) triple, and each thread moves one 16-byte vector of the pair (a
// float4 or double2) where the plane and the row length allow, one value
// otherwise (a 2D plane is 3 * ncomp values). It runs in place on y: each
// thread reads both raw vectors before it writes the one sum to both slots,
// and no other thread touches either (plane <= nnc/2, so the first and last
// planes of a row are disjoint); both slots hold bitwise the same sum.

#include "fused_common.cuh"

namespace {

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ double2 vadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ double vadd(double a, double b) { return a + b; }

// thread i: vector j of pair (s - 1) * R + r, i = ((s - 1) * R + r) * plane
// + j; nnc and plane count vectors of V. I is uint32_t unless n overflows it.
template <typename V, typename I>
__global__ void __launch_bounds__(256)
seam_kernel(V* __restrict__ y, I n, int nnc, int plane, int R, int blk) {
  const I i = (I)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const I pair = i / plane;
  const int j = (int)(i - pair * plane);
  const int s = (int)(pair / R) + 1;
  const int r = (int)(pair - (I)(s - 1) * R);
  V* lo = y + ((int64_t)(s * blk - 1) * R + r) * nnc + (nnc - plane) + j;
  V* hi = y + ((int64_t)s * blk * R + r) * nnc + j;
  const V v = vadd(*lo, *hi);
  *lo = v;
  *hi = v;
}

template <typename T, typename V>
int launch_seams_as(T* y, int64_t pairs, int nnc, int plane, int R, int blk,
                    cudaStream_t stream) {
  constexpr int W = sizeof(V) / sizeof(T);
  const int64_t n = pairs * (plane / W);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (n <= INT32_MAX)
    seam_kernel<V, uint32_t><<<blocks, 256, 0, stream>>>(
        (V*)y, (uint32_t)n, nnc / W, plane / W, R, blk);
  else
    seam_kernel<V, int64_t><<<blocks, 256, 0, stream>>>(
        (V*)y, n, nnc / W, plane / W, R, blk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_seams(T* y, int64_t pairs, int nnc, int plane, int R, int blk,
                 cudaStream_t stream) {
  using V = std::conditional_t<std::is_same_v<T, float>, float4, double2>;
  constexpr int W = sizeof(V) / sizeof(T);
  if (plane % W == 0 && nnc % W == 0 && ((uintptr_t)y & 15) == 0)
    return launch_seams_as<T, V>(y, pairs, nnc, plane, R, blk, stream);
  return launch_seams_as<T, T>(y, pairs, nnc, plane, R, blk, stream);
}

template <typename T>
int launch_variant(const T* t, const T* matT, T* u, T* y, int64_t E,
                   int nnc_in, int ngl, int ncomp_out, int dim,
                   const int nelem[3], int blk, int do_rolls,
                   cudaStream_t stream) {
  const MeshShape s = make_mesh_shape(ngl, ncomp_out, dim, nelem);
  if (do_rolls) {
    const int err = launch_gemm<T>(t, matT, u, E, nnc_in, s.nnc, stream);
    if (err != 0) return err;
    return launch_dss<T>(u, y, nullptr, s, stream);
  }
  const int err = launch_gemm<T>(t, matT, y, E, nnc_in, s.nnc, stream);
  if (err != 0) return err;
  const int nblk = s.ne[0] / blk;
  if (nblk < 2) return 0;
  const int R = (int)(E / s.ne[0]);
  return launch_seams<T>(y, (int64_t)(nblk - 1) * R, s.nnc, s.nnc / ngl, R,
                         blk, stream);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = success).
int pn_plainmm_f32(const void* t, const void* matT, void* y, int64_t M,
                   int K, int N, void* stream) {
  return launch_gemm<float>((const float*)t, (const float*)matT, (float*)y,
                            M, K, N, (cudaStream_t)stream);
}

int pn_plainmm_f64(const void* t, const void* matT, void* y, int64_t M,
                   int K, int N, void* stream) {
  return launch_gemm<double>((const double*)t, (const double*)matT,
                             (double*)y, M, K, N, (cudaStream_t)stream);
}

// The plan launch_gemm follows for these operands: out[0] = bytes per
// cp.async (16, or the element size for the narrow loader), out[1..2] = the
// CTA tile (rows, columns). elem_bytes is 4 or 8; returns 0, or
// cudaErrorInvalidValue for another size. Launches nothing.
int pn_gemm_plan(const void* t, const void* matT, const void* y, int K,
                 int N, int elem_bytes, int* out) {
  auto tile = [&](auto cfg) {
    out[1] = decltype(cfg)::BM;
    out[2] = decltype(cfg)::BN;
    return 0;
  };
  if (elem_bytes == 4) {
    out[0] = gemm_loader_bytes((const float*)t, (const float*)matT,
                               (const float*)y, K, N);
    return with_gemm_tile<float>(N, tile);
  }
  if (elem_bytes == 8) {
    out[0] = gemm_loader_bytes((const double*)t, (const double*)matT,
                               (const double*)y, K, N);
    return with_gemm_tile<double>(N, tile);
  }
  return (int)cudaErrorInvalidValue;
}

// u: (E, nnc_out) scratch, read only when do_rolls != 0
int pn_variant_apply_f32(const void* t, const void* matT, void* u, void* y,
                         int64_t E, int nnc_in, int ngl, int ncomp_out,
                         int dim, int ne0, int ne1, int ne2, int block,
                         int do_rolls, void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  return launch_variant<float>((const float*)t, (const float*)matT,
                               (float*)u, (float*)y, E, nnc_in, ngl,
                               ncomp_out, dim, nelem, block, do_rolls,
                               (cudaStream_t)stream);
}

int pn_variant_apply_f64(const void* t, const void* matT, void* u, void* y,
                         int64_t E, int nnc_in, int ngl, int ncomp_out,
                         int dim, int ne0, int ne1, int ne2, int block,
                         int do_rolls, void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  return launch_variant<double>((const double*)t, (const double*)matT,
                                (double*)u, (double*)y, E, nnc_in, ngl,
                                ncomp_out, dim, nelem, block, do_rolls,
                                (cudaStream_t)stream);
}

}  // extern "C"
