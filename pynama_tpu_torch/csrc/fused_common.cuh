// Shared pieces of the box-mesh apply kernels: the GEMM, the mesh shape, and
// the index-arithmetic DSS. fused_apply.cu (K1), decomp.cu (K3, K4) and
// fused3x.cu (K2) include this header, so every kernel that runs "the GEMM"
// or "the DSS" runs the same code, and a difference between two of them in a
// decomposition is the part that differs, not a copy.
//
// Layout. t is (E, nnc_in), matT (nnc_in, nnc_out), u and y (E, nnc_out),
// all row-major. Elements are numbered row-major over nelem (axis 0
// slowest); column = node * ncomp + comp with node = a_0 N^{dim-1} + ... +
// a_{dim-1} (axis 0 slowest), N = ngl.
//
// The GEMM (launch_gemm, C = A @ B) is the element matmul t @ matT of the
// Pallas kernels pynama_tpu/ops/fused.py::_fused_kernel (K1),
// exp/fused_decomp.py::_variant_kernel (K3) and ::_plainmm_kernel (K4).
//
// What bounds it on an H100. At 24^3 ngl=4 192->192 the product is 1.02
// GFLOP against ~21 MB of HBM traffic (t read, the output written; matT,
// 147 KB, stays in L2): 15 us at the 67 TFLOP/s FP32 FFMA peak, 6 us at
// 3.35 TB/s. So float32 is bound by FFMA issue, and the design keeps the
// FFMA pipe fed:
//   - float32 runs on the CUDA cores in full f32 (FFMA; no TF32 and no
//     tensor cores: the KLE operator needs full f32 products, DESIGN §3,
//     lambda_min/||K|| = 6e-4). A CTA of 4 warps computes a 64x64 tile,
//     each warp 32x32 and each thread 8x4 outputs (rows lr + 4i of its warp
//     tile, 4 adjacent columns). Per 4-deep k step a thread makes 8 LDS.128
//     of A (4 k of one row each) and 4 of B (4 columns of one k row each)
//     for 128 FFMAs, 10.7 FFMAs per 16-byte load. The tile is held to 96
//     registers (ptxas spills 20 bytes) so that 5 CTAs fit on an SM; a
//     16-deep k-tile is then 634 instructions, 512 of them FFMAs. When N is
//     a multiple of 128 the tile is 64x128 (3 CTAs per SM, half the tiles).
//   - float64 runs on the FP64 tensor cores (DMMA: mma.sync m16n8k16 f64,
//     IEEE double FMAs, so not a precision trade), 4 warps of 32x32 per
//     64x64 tile, 16-deep stages. Bound by DMMA issue and by HBM (42 MB,
//     12.6 us at 3.35 TB/s; 15 us at 67 TFLOP/s).
//   - Loads overlap the math: a ring of 3 (f32) or 4 (f64) shared-memory
//     stages filled by cp.async (ptx.cuh), so the next k-tiles load while
//     the current one multiplies; one __syncthreads per k-tile. The f64
//     ring (66 KB) is above the 48 KB default, so its launcher opts in.
//   - Few instructions besides the math. Each thread's copies sit at fixed
//     rows and columns of every stage, so GemmLoader works out its source
//     pointers, bounds and shared offsets once and advances the pointers by
//     one k-tile per stage; the ring is walked by offsets, not by a modulo.
//     (Recomputing them per copy was ~85 of the 670 instructions of an f32
//     k-tile, and held the f32 tile at 122 registers, 4 CTAs per SM.)
//   - Shared memory without bank conflicts. An A stage row holds 64 (f32)
//     or 128 (f64) bytes in 16-byte chunks; chunk c of row r is stored at
//     c ^ a_swz(r), with a_swz(r) = 2 ((r >> 1) & 1) for 64-byte rows and
//     2 (r & 3) for longer ones. The copies write whole 128-byte lines, and
//     the fragment reads (4 consecutive rows per float LDS.128; 4 rows x 32
//     bytes per half-warp of a double LDS.64) fall on distinct banks. B rows
//     are read whole by a warp in f32; in f64 they are padded by 4 doubles
//     so the 4 k rows a half-warp reads fall 32 bytes apart. a_swz depends
//     on r % 4 only, so a thread computes it once for all its rows and every
//     fragment load is a base register plus an immediate offset.
//   - Shapes: the 16-byte loader copies 16-byte chunks and stores float4 /
//     double2, and needs A, B, C 16-byte aligned and K, N multiples of
//     16 / sizeof(T). Every other shape (widths 9, 18, 27, 1029, 2058, a
//     misaligned view) takes the narrow loader, one element per cp.async
//     and scalar stores: the same kernel template, chosen on the host
//     (gemm_loader_bytes). Ragged edges are zero-filled by the copies and
//     masked at the store.
//   - In f32 each output is one FFMA chain along k in ascending order; in
//     f64 the 16-deep DMMA atoms are applied in ascending k.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

// A GEMM tile: BM x BN outputs per CTA, computed by WARPS_M x WARPS_N warps
// (each a (BM / WARPS_M) x (BN / WARPS_N) warp tile); STAGES shared-memory
// stages of ROWB-byte A rows (k depth ROWB / sizeof(T)); MINB CTAs per SM
// asked of the register allocator.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_,
          int MINB_, int ROWB_>
struct GemmCfg {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int ROWB = ROWB_;
};

// shared-memory geometry, in elements of T: each stage holds its A tile
// (BM x BK) and then its B tile (BK x LDB)
template <typename T, class Cfg>
struct GemmSmem {
  static constexpr int BK = Cfg::ROWB / (int)sizeof(T);   // k of a stage
  static constexpr int LDB = Cfg::BN + (sizeof(T) == 8 ? 4 : 0);
  static constexpr int A_STAGE = Cfg::BM * BK;
  static constexpr int STAGE = A_STAGE + BK * LDB;
  static constexpr int BYTES = Cfg::STAGES * STAGE * (int)sizeof(T);
};

// An A stage has ROWB-byte rows of 16-byte chunks; chunk c of row r is
// stored at c ^ a_swz(r) (see the head). a_swz(r) depends only on r % 4, so
// rows r + 4i share it: the fragment loads hoist it once per thread.
template <int ROWB>
__device__ __forceinline__ int a_swz(int row) {
  return ROWB >= 128 ? 2 * (row & 3) : 2 * ((row >> 1) & 1);
}

// offset of A(row, k) in an A stage
template <typename T, int ROWB>
__device__ __forceinline__ int a_off(int row, int k) {
  constexpr int BK = ROWB / (int)sizeof(T);
  constexpr int CH = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  return row * BK + (((k / CH) ^ a_swz<ROWB>(row)) * CH) + k % CH;
}

// Fills the stages of one CTA with its k-tiles in order, VEC elements per
// cp.async; out-of-range elements are zero-filled. VEC > 1 requires K and N
// multiples of VEC and aligned bases. A thread copies A_N chunks of one
// column of the A tile, A_STEP rows apart, and B_N chunks of one column of
// the B tile, B_STEP rows apart, at the same places in every stage.
template <typename T, class Cfg, int VEC>
struct GemmLoader {
  using S = GemmSmem<T, Cfg>;
  static constexpr int BYTES = VEC * (int)sizeof(T);
  static constexpr int A_ROW = S::BK / VEC;       // copies per A row
  static constexpr int A_STEP = Cfg::THREADS / A_ROW;
  static constexpr int A_N = Cfg::BM / A_STEP;
  static constexpr int B_ROW = Cfg::BN / VEC;     // copies per B row
  static constexpr int B_STEP = Cfg::THREADS / B_ROW;
  static constexpr int B_N = S::BK / B_STEP;
  // A_STEP % 4 == 0: all of a thread's A rows share one swizzle; A_N <= 32:
  // their row bits fit a_rows
  static_assert(Cfg::THREADS % A_ROW == 0 && Cfg::BM % A_STEP == 0 &&
                A_STEP % 4 == 0 && A_N <= 32 && Cfg::THREADS % B_ROW == 0 &&
                S::BK % B_STEP == 0, "tile vs threads");
  const T* a;   // this thread's first A chunk of the next k-tile
  const T* b;   // and its first B chunk
  int64_t a_step, b_step;   // A_STEP rows of A, B_STEP rows of B
  int ka, kb;   // K less the k of those chunks: in range while > 0
  unsigned a_rows;   // bit i: A row of chunk i is < M
  bool b_col;        // the B column is < N
  int a_dst, b_dst;  // offsets of chunk 0 in a stage

  __device__ __forceinline__ GemmLoader(const T* A, const T* B, int64_t m0,
                                        int n0, int64_t M, int K, int N,
                                        int tid) {
    const int ar = tid / A_ROW, ak = (tid % A_ROW) * VEC;
    a = A + (m0 + ar) * K + ak;
    a_step = (int64_t)A_STEP * K;
    ka = K - ak;
    a_rows = 0;
#pragma unroll
    for (int i = 0; i < A_N; ++i)
      if (m0 + ar + i * A_STEP < M) a_rows |= 1u << i;
    a_dst = a_off<T, Cfg::ROWB>(ar, ak);
    const int br = tid / B_ROW, bn = (tid % B_ROW) * VEC;
    b = B + (int64_t)br * N + n0 + bn;
    b_step = (int64_t)B_STEP * N;
    kb = K - br;
    b_col = n0 + bn < N;
    b_dst = S::A_STAGE + br * S::LDB + bn;
  }

  // copy the next k-tile into stage `st`; A and B are the operands' bases,
  // the source of a zero-filling copy
  __device__ __forceinline__ void next(T* st, const T* A, const T* B) {
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const bool ok = ka > 0 && ((a_rows >> i) & 1);
      cp_async<BYTES>(st + a_dst + i * A_STEP * S::BK,
                      ok ? a + i * a_step : A, ok ? BYTES : 0);
    }
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      const bool ok = b_col && kb > i * B_STEP;
      cp_async<BYTES>(st + b_dst + i * B_STEP * S::LDB,
                      ok ? b + i * b_step : B, ok ? BYTES : 0);
    }
    a += S::BK;
    b += (S::BK / B_STEP) * b_step;
    ka -= S::BK;
    kb -= S::BK;
  }
};

// float32: FFMA on the CUDA cores. Thread (lr, lc) = (lane % 4, lane / 4)
// of its warp holds rows row0 + 4 i (i < TM) and columns col0 + 32 g + j
// (g < NG, j < 4) of the CTA tile.
template <class Cfg>
struct FfmaTile {
  static constexpr int WTM = Cfg::BM / Cfg::WARPS_M;
  static constexpr int WTN = Cfg::BN / Cfg::WARPS_N;
  static constexpr int TM = WTM / 4;
  static constexpr int NG = WTN / 32;
  static_assert(WTM % 4 == 0 && WTN % 32 == 0, "f32 warp tile");
  static constexpr int BK = GemmSmem<float, Cfg>::BK;
  float acc[TM][NG][4];
  int row0, col0;
  int arow, aswz;   // row0 * BK and a_swz(row0), shared by rows row0 + 4i

  __device__ __forceinline__ FfmaTile(int warp, int lane) {
    row0 = (warp / Cfg::WARPS_N) * WTM + lane % 4;
    col0 = (warp % Cfg::WARPS_N) * WTN + (lane / 4) * 4;
    arow = row0 * BK;
    aswz = a_swz<Cfg::ROWB>(row0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g][j] = 0.0f;
  }

  __device__ __forceinline__ void fma4(float a, const float4& b, int i,
                                       int g) {
    acc[i][g][0] = fmaf(a, b.x, acc[i][g][0]);
    acc[i][g][1] = fmaf(a, b.y, acc[i][g][1]);
    acc[i][g][2] = fmaf(a, b.z, acc[i][g][2]);
    acc[i][g][3] = fmaf(a, b.w, acc[i][g][3]);
  }

  // k = kq .. kq+3: the 4 x 4 NG B values are held while the TM A float4s
  // stream through (each A load feeds 16 NG FFMAs, each B load TM * 4)
  __device__ __forceinline__ void step(const float* As, const float* Bs,
                                       int kq) {
    using S = GemmSmem<float, Cfg>;
    // A(row0 + 4 i, kq .. kq+3) is the float4 at ap + 4 i BK
    const float* ap = As + arow + ((kq / 4) ^ aswz) * 4;
    float4 b[4][NG];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        b[kk][g] = *reinterpret_cast<const float4*>(
            Bs + (kq + kk) * S::LDB + col0 + 32 * g);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a4 = *reinterpret_cast<const float4*>(ap + 4 * i * BK);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < NG; ++g) fma4(a[kk], b[kk][g], i, g);
    }
  }

  __device__ __forceinline__ void stage(const float* As, const float* Bs) {
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) step(As, Bs, kq);
  }

  template <int VEC>
  __device__ __forceinline__ void store(float* __restrict__ C, int64_t m0,
                                        int n0, int64_t M, int N) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + row0 + 4 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int gn = n0 + col0 + 32 * g;
        float* p = C + gm * N + gn;
        if constexpr (VEC > 1) {
          if (gn < N)
            *reinterpret_cast<float4*>(p) = make_float4(
                acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) p[j] = acc[i][g][j];
        }
      }
    }
  }
};

// float64: DMMA. The warp tile is MI x NI m16n8k16 atoms. Fragment layouts
// are in ptx.cuh.
template <class Cfg>
struct DmmaTile {
  static constexpr int WTM = Cfg::BM / Cfg::WARPS_M;
  static constexpr int WTN = Cfg::BN / Cfg::WARPS_N;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "f64 warp tile");
  static constexpr int BK = GemmSmem<double, Cfg>::BK;
  double acc[MI][NI][4];
  int wm0, wn0, g, t;
  int arow, aswz;   // (wm0 + g) * BK + t and a_swz(g), as in FfmaTile

  __device__ __forceinline__ DmmaTile(int warp, int lane) {
    wm0 = (warp / Cfg::WARPS_N) * WTM;
    wn0 = (warp % Cfg::WARPS_N) * WTN;
    g = lane / 4;
    t = lane % 4;
    arow = (wm0 + g) * BK + t;
    aswz = a_swz<Cfg::ROWB>(g);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0;
  }

  __device__ __forceinline__ void stage(const double* As,
                                        const double* Bs) {
    using S = GemmSmem<double, Cfg>;
#pragma unroll
    for (int ks = 0; ks < S::BK; ks += 16) {
      double a[MI][8], b[NI][4];
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
        // A(wm0 + g + r, ks + 4 ki + t) = ap[r * BK]: the 2-double chunk
        // (ks + 4 ki) / 2 + t / 2 of the row, with an even swizzle
        const double* ap = As + arow + (((ks + 4 * ki) / 2) ^ aswz) * 2;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int mj = 0; mj < 2; ++mj)
            a[mi][2 * ki + mj] = ap[(16 * mi + 8 * mj) * BK];
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int ki = 0; ki < 4; ++ki)
          b[ni][ki] = Bs[(ks + 4 * ki + t) * S::LDB + wn0 + 8 * ni + g];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_m16n8k16_f64(acc[mi][ni], a[mi], b[ni]);
    }
  }

  template <int VEC>
  __device__ __forceinline__ void store(double* __restrict__ C, int64_t m0,
                                        int n0, int64_t M, int N) const {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int mj = 0; mj < 2; ++mj) {
        const int64_t gm = m0 + wm0 + 16 * mi + 8 * mj + g;
        if (gm >= M) continue;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int gn = n0 + wn0 + ni * 8 + 2 * t;
          const double v0 = acc[mi][ni][mj * 2];
          const double v1 = acc[mi][ni][mj * 2 + 1];
          double* p = C + gm * N + gn;
          if constexpr (VEC > 1) {
            if (gn < N)
              *reinterpret_cast<double2*>(p) = make_double2(v0, v1);
          } else {
            if (gn < N) p[0] = v0;
            if (gn + 1 < N) p[1] = v1;
          }
        }
      }
  }
};

template <typename T, class Cfg>
using GemmMath = std::conditional_t<std::is_same_v<T, float>,
                                    FfmaTile<Cfg>, DmmaTile<Cfg>>;

// C = A @ B, one BM x BN tile per CTA; tiles numbered row-major (the
// column tiles of one row block are neighbours, so they share A in L2)
template <typename T, class Cfg, int VEC>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MINB)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            T* __restrict__ C, int64_t M, int K, int N) {
  using S = GemmSmem<T, Cfg>;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  T* sm = reinterpret_cast<T*>(gemm_smem);
  const int tid = threadIdx.x;
  const int ntn = (N + Cfg::BN - 1) / Cfg::BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntn) * Cfg::BM;
  const int n0 = (int)(blockIdx.x % ntn) * Cfg::BN;
  GemmMath<T, Cfg> math(tid / 32, tid % 32);
  GemmLoader<T, Cfg, VEC> load(A, B, m0, n0, M, K, N, tid);

  const int nk = (K + S::BK - 1) / S::BK;
#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < nk) load.next(sm + s * S::STAGE, A, B);
    cp_async_commit();
  }
  // offsets of the stage read now and of the stage the prefetch fills
  constexpr int LAST = (Cfg::STAGES - 1) * S::STAGE;
  int rd = 0, wr = LAST;
  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed (this thread's copies; the barrier makes everyone's
    // visible), and every thread is done with tile kt - 1, whose stage the
    // prefetch below refills
    cp_async_wait<Cfg::STAGES - 2>();
    __syncthreads();
    if (kt + Cfg::STAGES - 1 < nk) load.next(sm + wr, A, B);
    cp_async_commit();
    math.stage(sm + rd, sm + rd + S::A_STAGE);
    rd = rd == LAST ? 0 : rd + S::STAGE;
    wr = wr == LAST ? 0 : wr + S::STAGE;
  }
  math.template store<VEC>(C, m0, n0, M, N);
}

// The tiles, chosen by a sweep on an H100 at 24^3 ngl=4 (PERF.md): 4 warps
// of 32x32 each. f32 takes 64x64 at 5 CTAs per SM, or 64x128 when N is a
// multiple of 128 (fewer, wider tiles: 192->384 in 47 us against 53); f64
// takes 64x64 with 16-deep stages, 4 of them (3 CTAs per SM).
using GemmCfgF32 = GemmCfg<64, 64, 2, 2, 3, 5, 64>;
using GemmCfgF32N128 = GemmCfg<64, 128, 2, 2, 4, 2, 64>;
using GemmCfgF64 = GemmCfg<64, 64, 2, 2, 4, 3, 128>;

// f(Cfg{}) with the tile a product with N columns takes (launch_gemm and
// pn_gemm_plan both ask here)
template <typename T, class F>
inline int with_gemm_tile(int N, F&& f) {
  if constexpr (std::is_same_v<T, float>) {
    if (N % 128 == 0) return f(GemmCfgF32N128{});
    return f(GemmCfgF32{});
  } else {
    return f(GemmCfgF64{});
  }
}

// Which loader a product takes: 16 (bytes per copy) when A, B and C are
// 16-byte aligned and K and N are multiples of 16 / sizeof(T), else
// sizeof(T).
template <typename T>
inline int gemm_loader_bytes(const T* A, const T* B, const T* C, int K,
                             int N) {
  constexpr int CH = 16 / (int)sizeof(T);
  const uintptr_t bits = (uintptr_t)A | (uintptr_t)B | (uintptr_t)C;
  return (bits & 15) == 0 && K % CH == 0 && N % CH == 0 ? 16
                                                        : (int)sizeof(T);
}

template <typename T, class Cfg, int VEC>
int launch_gemm_cfg(const T* A, const T* B, T* C, int64_t M, int K, int N,
                    cudaStream_t stream) {
  using S = GemmSmem<T, Cfg>;
  auto kernel = gemm_kernel<T, Cfg, VEC>;
  if constexpr (S::BYTES > 48 * 1024) {
    // above 48 KB a kernel must opt in, once per device
    static bool opted[64] = {};
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err != 0) return err;
    if (dev >= 64 || !opted[dev]) {
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
      if (err != 0) return err;
      if (dev < 64) opted[dev] = true;
    }
  }
  const int64_t blocks =
      (M + Cfg::BM - 1) / Cfg::BM * ((N + Cfg::BN - 1) / Cfg::BN);
  kernel<<<(unsigned)blocks, Cfg::THREADS, S::BYTES, stream>>>(A, B, C, M,
                                                                K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gemm(const T* A, const T* B, T* C, int64_t M, int K, int N,
                cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const bool wide = gemm_loader_bytes(A, B, C, K, N) == 16;
  return with_gemm_tile<T>(N, [&](auto cfg) {
    using Cfg = decltype(cfg);
    if (wide)
      return launch_gemm_cfg<T, Cfg, 16 / sizeof(T)>(A, B, C, M, K, N,
                                                    stream);
    return launch_gemm_cfg<T, Cfg, 1>(A, B, C, M, K, N, stream);
  });
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
