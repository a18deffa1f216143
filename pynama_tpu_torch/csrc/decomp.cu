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
//                    meaning: the GEMM tiles are 64x64x16 whatever it is.
//   variant, rolls   gemm_kernel + dss_kernel, K1 without bnd_kernel; y is
//                    bitwise K1's y.
//   variant, no rolls gemm_kernel into y, then seam_kernel: at each interior
//                    block seam s*blk (s = 1..nblk-1) and each r < R, the
//                    last axis-0 plane of element row (s*blk-1)*R + r and
//                    the first plane of row s*blk*R + r both become the sum
//                    of the two raw values. That is what the TPU kernel's
//                    cross-block finalize leaves when the roll chain is
//                    skipped: nothing is added inside a block or along axes
//                    1..dim-1.
//
// What bounds them on an H100: plainmm is K1's FFMA GEMM (about 1.0 GFLOP
// against 21 MB at 24^3 ngl=4 192->192), far from both the 67 TFLOP/s FP32
// and the 3.35 TB/s roofs; it is kept as it is because the decomposition
// must time K1's GEMM, not a better one. seam_kernel touches 2 planes per
// seam (at 24^3 ngl=4 block 1, 23 * 576 pairs of 48 values, ~10 MB read and
// written), a memory-bound pass of one thread per slot pair. It runs in
// place on y: each thread reads both raw values before it writes the one
// sum to both slots, and no other thread touches either slot (plane <=
// nnc/2, so the first and last planes of a row are disjoint).

#include "fused_common.cuh"

namespace {

// block b = (s - 1) * R + r, for seam s in 1..nblk-1 and r < R; threads
// walk the plane's columns j
template <typename T>
__global__ void seam_kernel(T* __restrict__ y, int nnc, int plane, int R,
                            int blk) {
  const int s = blockIdx.x / R + 1;
  const int r = blockIdx.x - (s - 1) * R;
  T* lo = y + ((int64_t)(s * blk - 1) * R + r) * nnc + (nnc - plane);
  T* hi = y + ((int64_t)s * blk * R + r) * nnc;
  for (int j = threadIdx.x; j < plane; j += blockDim.x) {
    const T v = lo[j] + hi[j];
    lo[j] = v;
    hi[j] = v;
  }
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
    return launch_dss<T>(u, y, E, s, stream);
  }
  const int err = launch_gemm<T>(t, matT, y, E, nnc_in, s.nnc, stream);
  if (err != 0) return err;
  const int nblk = s.ne[0] / blk;
  if (nblk < 2) return 0;
  const int R = (int)(E / s.ne[0]);
  const int plane = s.nnc / ngl;
  seam_kernel<T><<<(unsigned)((nblk - 1) * R), row_threads(plane), 0,
                   stream>>>(y, s.nnc, plane, R, blk);
  return (int)cudaGetLastError();
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
