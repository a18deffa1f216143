// fused_apply: y = DSS(t @ matT) on the canonical element-local layout of a
// box mesh, plus the raw axis-0 boundary planes `bnd`.
//
// Replaces the Pallas kernel pynama_tpu/ops/fused.py::_fused_kernel (launched
// by fused_apply). It computes what that kernel computes; it is not a
// block-by-block copy of it. The TPU kernel pipelines axis-0 blocks through a
// sequential grid, rolls u inside VMEM and carries the cross-block plane in a
// ping-pong scratch; none of that has a counterpart on Hopper.
//
// Two launches on the caller's stream, both from fused_common.cuh and shared
// with the decomposition kernels K2-K4:
//   1. gemm_kernel: u = t @ matT; f32 on FFMA (64x64 or 64x128 CTA tiles,
//      8x4 outputs per thread, a cp.async ring), f64 on the FP64 tensor
//      cores (DMMA m16n8k16).
//   2. dss_kernel: y = DSS(u) from a shared-memory tile per chunk of an
//      axis-2 element row, in one canonical order so that every duplicate
//      slot gets bitwise the same value; the CTAs on the first and last
//      axis-0 slice also write bnd[0] = element row (0, r), columns
//      [:plane], and bnd[1] = element row (ne0-1, r), columns
//      [nnc-plane:], both summed over axes 1..dim-1 only (the cross-slab
//      adds of a sharded run).
//
// What bounds it on an H100: at 24^3 ngl=4 the (192, 192) apply is about
// 1.0 GFLOP against about 42 MB of HBM traffic (the GEMM reads t and writes
// u, the DSS reads u and writes y, 10.6 MB each; matT stays in L2). The
// GEMM is bound by FFMA issue in f32 and by DMMA issue and HBM in f64; the
// DSS pass by HBM (its designs are in fused_common.cuh). The two-pass form
// writes and re-reads u once; fusing the passes (the GEMM's output tile
// written into the DSS tile) removes that round trip and is later work.

#include "fused_common.cuh"

namespace {

template <typename T>
int launch(const T* t, const T* matT, T* u, T* y, T* bnd, int64_t E,
           int nnc_in, int ngl, int ncomp_out, int dim, const int nelem[3],
           cudaStream_t stream) {
  const MeshShape s = make_mesh_shape(ngl, ncomp_out, dim, nelem);
  const int err = launch_gemm<T>(t, matT, u, E, nnc_in, s.nnc, stream);
  if (err != 0) return err;
  return launch_dss<T>(u, y, bnd, s, stream);
}

}  // namespace

extern "C" {

const char* pn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each returns cudaGetLastError() after its launches (0 = success).
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

// K1's DSS pass alone on a given u: y = DSS(u) and bnd; chunk > 0 forces
// the chunk length (0: the rule of make_dss_plan).
int pn_dss_f32(const void* u, void* y, void* bnd, int ngl, int ncomp,
               int dim, int ne0, int ne1, int ne2, int chunk, void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  return launch_dss<float>((const float*)u, (float*)y, (float*)bnd,
                           make_mesh_shape(ngl, ncomp, dim, nelem),
                           (cudaStream_t)stream, chunk);
}

int pn_dss_f64(const void* u, void* y, void* bnd, int ngl, int ncomp,
               int dim, int ne0, int ne1, int ne2, int chunk, void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  return launch_dss<double>((const double*)u, (double*)y, (double*)bnd,
                            make_mesh_shape(ngl, ncomp, dim, nelem),
                            (cudaStream_t)stream, chunk);
}

// The plan the DSS pass follows for a shape and element size: out[0] = C
// (elements per chunk), out[1] = chunks per row, out[2] = threads per CTA,
// out[3] = tile bytes, out[4] = bytes per cp.async for an aligned u (16 or
// elem_bytes). elem_bytes is 4 or 8; returns 0, or cudaErrorInvalidValue
// for another size. Launches nothing.
int pn_dss_plan(int ngl, int ncomp, int dim, int ne0, int ne1, int ne2,
                int elem_bytes, int chunk, int* out) {
  if (elem_bytes != 4 && elem_bytes != 8) return (int)cudaErrorInvalidValue;
  const int nelem[3] = {ne0, ne1, ne2};
  const int vec = ngl * ncomp % (16 / elem_bytes) == 0 ? 16 / elem_bytes : 1;
  const DssPlan p = make_dss_plan(make_mesh_shape(ngl, ncomp, dim, nelem),
                                  elem_bytes, vec, chunk);
  out[0] = p.C;
  out[1] = p.nch;
  out[2] = p.threads;
  out[3] = p.tile * elem_bytes;
  out[4] = vec * elem_bytes;
  return 0;
}

}  // extern "C"
