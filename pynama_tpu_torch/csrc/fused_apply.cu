// fused_apply: y = DSS(t @ matT) on the canonical element-local layout of a
// box mesh, plus the raw axis-0 boundary planes `bnd`.
//
// Replaces the Pallas kernel pynama_tpu/ops/fused.py::_fused_kernel (launched
// by fused_apply). It computes what that kernel computes; it is not a
// block-by-block copy of it (the TPU kernel pipelines axis-0 blocks through a
// sequential grid, which has no counterpart on Hopper).
//
// Three launches on the caller's stream (the first two from
// fused_common.cuh, shared with the decomposition kernels K2-K4):
//   1. gemm_kernel: u = t @ matT; f32 on FFMA (64x64 or 64x128 CTA tiles,
//      8x4 outputs per thread, a cp.async ring), f64 on the FP64 tensor
//      cores (DMMA m16n8k16).
//   2. dss_kernel (one block per element row): y[e, col] = sum of u over the
//      up to 2^dim slots that hold (e, col)'s global node, found by index
//      arithmetic (no gather table), in one canonical order so that every
//      duplicate slot gets bitwise the same value.
//   3. bnd_kernel: bnd[0] = element row (0, r), columns [:plane]; bnd[1] =
//      element row (ne0-1, r), columns [nnc-plane:]; both summed over axes
//      1..dim-1 only (the cross-slab adds of a sharded run).
//
// What bounds it on an H100: at 24^3 ngl=4 the (192, 192) apply is about
// 1.0 GFLOP against about 42 MB of HBM traffic (the GEMM reads t and writes
// u, the DSS reads u and writes y, 10.6 MB each; matT stays in L2). The
// GEMM is bound by FFMA issue in f32 and by DMMA issue and HBM in f64 (its
// design is in fused_common.cuh's head); the DSS pass moves its 21 MB at
// ~0.36 TB/s, far below the 3.35 TB/s roof, and is now the larger part of
// the apply.
// The two-pass form writes and re-reads u once; fusing the passes (a CTA per
// axis-0 tile with recomputed halo planes) removes that round trip and is
// later work.
//
// All element/slot offsets are 64-bit.

#include "fused_common.cuh"

namespace {

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

template <typename T>
int launch(const T* t, const T* matT, T* u, T* y, T* bnd, int64_t E,
           int nnc_in, int ngl, int ncomp_out, int dim, const int nelem[3],
           cudaStream_t stream) {
  const MeshShape s = make_mesh_shape(ngl, ncomp_out, dim, nelem);
  int err = launch_gemm<T>(t, matT, u, E, nnc_in, s.nnc, stream);
  if (err != 0) return err;
  err = launch_dss<T>(u, y, E, s, stream);
  if (err != 0) return err;

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
