// The CG loop's epilogue: the vector work and the scalar updates of one
// preconditioned-CG iteration between one operator application and the
// next, with every CG scalar kept on the card.
//
// Replaces no TPU kernel. On the TPU the whole loop is one `lax.while_loop`
// that XLA fuses (pynama_tpu/solver/cg.py); in eager PyTorch the same work
// is some 36 launches an iteration (dots, `where`s, axpys, scalar divides),
// and the host issuing them sets the pace of every CG cell. Here it is three
// launches after the operator (four where the preconditioner is not
// pointwise and stays an eager call between cg_xr and cg_rz):
//
//   cg_pap  Ap = free * y in place of y (the operator's output mask),
//           pAp = sum p Ap inv_mult; alpha = run && pAp > 0 ? gamma/pAp : 0
//   cg_xr   x += alpha p, r -= alpha Ap; with a Jacobi divisor dmask also
//           z = r / dmask in registers, sum r z inv_mult and r r inv_mult,
//           and the step's scalars (below)
//   cg_rz   (non-pointwise preconditioner) sum r z inv_mult, r r inv_mult of
//           the eager z, and the step's scalars
//   cg_p    p = z + beta p; with dmask, z = r / dmask again (never stored)
//
// The step's scalars are solver/cg.py pcg's, `where` freezes included:
// beta = run ? gamma_new / gamma : 0; gamma, rr take the new values only
// while run; k += run; run = rr > tol2 && k < maxiter && gamma > 0 && live.
// They live in two small device arrays, the float state sf (the vectors'
// type) and the int64 state si; the host reads si[RUN] only at pcg's stop
// checks.
//
// Reductions: every thread accumulates in double (at least the vectors'
// precision), each block reduces its threads in a fixed tree and writes its
// partial sums; the last block to finish (an atomic ticket on an integer
// counter, which that block resets) adds the partials in block order and
// writes the scalars. The grid depends on n alone, so two runs give bitwise
// the same iterates.
//
// What bounds them on an H100: HBM. At 24^3 ngl=4 (n = 2,654,208) one
// Jacobi iteration moves 17 vector passes (cg_pap 5, cg_xr 8, cg_p 4), 180
// MB in f32: 54 us at 3.35 TB/s, against ~30 passes of the eager loop. Each
// thread moves 16-byte packs (a float4 or double2) where every pointer is
// 16-byte aligned, one value otherwise; the grid is at most 8 blocks of 256
// threads an SM, striding over the vector.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// slots of sf (the vectors' type) and of si (int64); ops/cg_epilogue.py
// names the same slots
enum { GAMMA = 0, RR = 1, PAP = 2, ALPHA = 3, BETA = 4, TOL2 = 5 };
enum { K = 0, RUN = 1, LIVE = 2 };

// One solve's launch arguments, built once per solve by the host and
// passed by pointer (ops/cg_epilogue.py _Args mirrors it field for field).
// ap is the operator's output (cg_pap, cg_xr); z is the eager
// preconditioner's output (cg_rz, cg_p), null in cg_p for z = r / dmask;
// dmask is null where the preconditioner is not pointwise.
struct Args {
  void* x;
  void* r;
  void* p;
  void* ap;
  const void* z;
  const void* free;
  const void* inv;
  const void* dmask;
  void* sf;
  int64_t* si;
  double* partials;  // 2 * blocks
  unsigned int* counter;
  void* stream;
  int64_t n;
  int64_t maxiter;
  int blocks;
  int vec;  // every pointer 16-byte aligned: 16-byte packs
  int f64;
  int pad;
};

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Pack<T, W> ld(const void* a, int64_t i) {
  return reinterpret_cast<const Pack<T, W>*>(a)[i];
}

template <typename T, int W>
__device__ __forceinline__ void st(void* a, int64_t i, const Pack<T, W>& v) {
  reinterpret_cast<Pack<T, W>*>(a)[i] = v;
}

// Sums each of NV values over the block's threads in a fixed tree; the
// sums are valid in thread 0.
template <int NV>
__device__ __forceinline__ void block_sum(double (&s)[NV]) {
  __shared__ double sh[NV][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
    if (lane == 0) sh[k][warp] = s[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      s[k] = lane < THREADS / 32 ? sh[k][lane] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
    }
  }
  __syncthreads();
}

// Sums each of NV per-thread values over the grid. Every block writes its
// sums to partials; the last block to take a ticket adds them in block
// order, whichever block that is, resets the counter for the next launch
// and returns true, with the totals in its thread 0. Other blocks return
// false.
template <int NV>
__device__ bool grid_sum(double (&s)[NV], double* partials,
                         unsigned int* counter) {
  __shared__ bool last;
  const int G = gridDim.x;
  block_sum<NV>(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) partials[k * G + blockIdx.x] = s[k];
    __threadfence();
    last = atomicAdd(counter, 1u) == (unsigned int)(G - 1);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double t = 0.0;
    for (int i = threadIdx.x; i < G; i += THREADS)
      t += __ldcg(partials + k * G + i);
    s[k] = t;
  }
  block_sum<NV>(s);
  if (threadIdx.x == 0) *counter = 0u;
  return true;
}

// beta, gamma, rr, k and run from this step's r.z and r.r (thread 0 of the
// last block of cg_xr or cg_rz)
template <typename T>
__device__ void step_scalars(const Args& a, double rz, double rr2) {
  T* sf = static_cast<T*>(a.sf);
  int64_t* si = a.si;
  const T gamma_new = (T)rz, rr_new = (T)rr2;
  const bool run = si[RUN] != 0;
  T gamma = sf[GAMMA], rr = sf[RR];
  sf[BETA] = run ? gamma_new / gamma : T(0);
  if (run) {
    gamma = gamma_new;
    rr = rr_new;
  }
  const int64_t k = si[K] + (run ? 1 : 0);
  sf[GAMMA] = gamma;
  sf[RR] = rr;
  si[K] = k;
  si[RUN] = (rr > sf[TOL2] && k < a.maxiter && gamma > T(0) &&
             si[LIVE] != 0) ? 1 : 0;
}

// ------------------------------------------------------------- cg_pap
template <typename T>
__device__ __forceinline__ void pap_one(T& y, T fr, T p, T inv, double& s) {
  y = y * fr;
  s += (double)p * (double)y * (double)inv;
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) pap_kernel(const Args a) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nv = a.n / W;
  double s[1] = {0.0};
  for (int64_t i = g; i < nv; i += stride) {
    Pack<T, W> y = ld<T, W>(a.ap, i);
    const Pack<T, W> f = ld<T, W>(a.free, i), p = ld<T, W>(a.p, i),
                     m = ld<T, W>(a.inv, i);
#pragma unroll
    for (int l = 0; l < W; ++l) pap_one(y.v[l], f.v[l], p.v[l], m.v[l], s[0]);
    st<T, W>(a.ap, i, y);
  }
  for (int64_t j = nv * W + g; j < a.n; j += stride)
    pap_one(static_cast<T*>(a.ap)[j], static_cast<const T*>(a.free)[j],
            static_cast<const T*>(a.p)[j], static_cast<const T*>(a.inv)[j],
            s[0]);
  if (grid_sum<1>(s, a.partials, a.counter) && threadIdx.x == 0) {
    T* sf = static_cast<T*>(a.sf);
    const T pap = (T)s[0];
    const bool ok = a.si[RUN] != 0 && pap > T(0);
    sf[PAP] = pap;
    sf[ALPHA] = ok ? sf[GAMMA] / pap : T(0);
  }
}

// -------------------------------------------------------------- cg_xr
template <typename T, bool JAC>
__device__ __forceinline__ void xr_one(T& x, T& r, T p, T ap, T d, T inv,
                                       T alpha, double (&s)[2]) {
  x += alpha * p;
  r -= alpha * ap;
  if (JAC) {
    const T z = r / d;
    s[0] += (double)r * (double)z * (double)inv;
    s[1] += (double)r * (double)r * (double)inv;
  }
}

template <typename T, int W, bool JAC>
__global__ void __launch_bounds__(THREADS) xr_kernel(const Args a) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nv = a.n / W;
  const T alpha = static_cast<const T*>(a.sf)[ALPHA];
  double s[2] = {0.0, 0.0};
  for (int64_t i = g; i < nv; i += stride) {
    Pack<T, W> x = ld<T, W>(a.x, i), r = ld<T, W>(a.r, i);
    const Pack<T, W> p = ld<T, W>(a.p, i), ap = ld<T, W>(a.ap, i);
    Pack<T, W> d{}, m{};
    if (JAC) {
      d = ld<T, W>(a.dmask, i);
      m = ld<T, W>(a.inv, i);
    }
#pragma unroll
    for (int l = 0; l < W; ++l)
      xr_one<T, JAC>(x.v[l], r.v[l], p.v[l], ap.v[l], JAC ? d.v[l] : T(1),
                     JAC ? m.v[l] : T(0), alpha, s);
    st<T, W>(a.x, i, x);
    st<T, W>(a.r, i, r);
  }
  for (int64_t j = nv * W + g; j < a.n; j += stride)
    xr_one<T, JAC>(static_cast<T*>(a.x)[j], static_cast<T*>(a.r)[j],
                   static_cast<const T*>(a.p)[j],
                   static_cast<const T*>(a.ap)[j],
                   JAC ? static_cast<const T*>(a.dmask)[j] : T(1),
                   JAC ? static_cast<const T*>(a.inv)[j] : T(0), alpha, s);
  if (JAC && grid_sum<2>(s, a.partials, a.counter) && threadIdx.x == 0)
    step_scalars<T>(a, s[0], s[1]);
}

// -------------------------------------------------------------- cg_rz
template <typename T>
__device__ __forceinline__ void rz_one(T r, T z, T inv, double (&s)[2]) {
  s[0] += (double)r * (double)z * (double)inv;
  s[1] += (double)r * (double)r * (double)inv;
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS) rz_kernel(const Args a) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nv = a.n / W;
  double s[2] = {0.0, 0.0};
  for (int64_t i = g; i < nv; i += stride) {
    const Pack<T, W> r = ld<T, W>(a.r, i), z = ld<T, W>(a.z, i),
                     m = ld<T, W>(a.inv, i);
#pragma unroll
    for (int l = 0; l < W; ++l) rz_one(r.v[l], z.v[l], m.v[l], s);
  }
  for (int64_t j = nv * W + g; j < a.n; j += stride)
    rz_one(static_cast<const T*>(a.r)[j], static_cast<const T*>(a.z)[j],
           static_cast<const T*>(a.inv)[j], s);
  if (grid_sum<2>(s, a.partials, a.counter) && threadIdx.x == 0)
    step_scalars<T>(a, s[0], s[1]);
}

// --------------------------------------------------------------- cg_p
// JAC: z = r / dmask (a.z is null); else z read from a.z
template <typename T, int W, bool JAC>
__global__ void __launch_bounds__(THREADS) p_kernel(const Args a) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nv = a.n / W;
  const T beta = static_cast<const T*>(a.sf)[BETA];
  const void* zsrc = JAC ? static_cast<const void*>(a.r) : a.z;
  for (int64_t i = g; i < nv; i += stride) {
    Pack<T, W> p = ld<T, W>(a.p, i);
    Pack<T, W> z = ld<T, W>(zsrc, i);
    if (JAC) {
      const Pack<T, W> d = ld<T, W>(a.dmask, i);
#pragma unroll
      for (int l = 0; l < W; ++l) z.v[l] = z.v[l] / d.v[l];
    }
#pragma unroll
    for (int l = 0; l < W; ++l) p.v[l] = z.v[l] + beta * p.v[l];
    st<T, W>(a.p, i, p);
  }
  for (int64_t j = nv * W + g; j < a.n; j += stride) {
    T z = static_cast<const T*>(zsrc)[j];
    if (JAC) z = z / static_cast<const T*>(a.dmask)[j];
    T& p = static_cast<T*>(a.p)[j];
    p = z + beta * p;
  }
}

// ------------------------------------------------------------ launches
enum Which { L_PAP, L_XR, L_RZ, L_P };

template <typename T, int W>
void launch_as(const Args& a, Which w) {
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  const bool jac = a.dmask != nullptr;
  switch (w) {
    case L_PAP:
      pap_kernel<T, W><<<a.blocks, THREADS, 0, s>>>(a);
      break;
    case L_XR:
      if (jac) xr_kernel<T, W, true><<<a.blocks, THREADS, 0, s>>>(a);
      else xr_kernel<T, W, false><<<a.blocks, THREADS, 0, s>>>(a);
      break;
    case L_RZ:
      rz_kernel<T, W><<<a.blocks, THREADS, 0, s>>>(a);
      break;
    case L_P:
      if (a.z == nullptr) p_kernel<T, W, true><<<a.blocks, THREADS, 0, s>>>(a);
      else p_kernel<T, W, false><<<a.blocks, THREADS, 0, s>>>(a);
      break;
  }
}

int launch(const void* args, Which w) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.f64) {
    if (a.vec) launch_as<double, 2>(a, w);
    else launch_as<double, 1>(a, w);
  } else {
    if (a.vec) launch_as<float, 4>(a, w);
    else launch_as<float, 1>(a, w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches one kernel on the stream in *args and returns
// cudaGetLastError() (0 = success).
int pn_cg_pap(const void* args) { return launch(args, L_PAP); }

int pn_cg_xr(const void* args) { return launch(args, L_XR); }

int pn_cg_rz(const void* args) { return launch(args, L_RZ); }

int pn_cg_p(const void* args) { return launch(args, L_P); }

}  // extern "C"
