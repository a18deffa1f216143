// Shared pieces of the box-mesh apply kernels: the GEMM, the mesh shape, and
// the tiled DSS pass. fused_apply.cu (K1), decomp.cu (K3, K4) and
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

// Above 48 KB of dynamic shared memory a kernel must opt in, on each device;
// opted[dev] holds the most this kernel has been allowed there so far (the
// caller keeps one array per kernel).
template <class K>
inline int allow_smem(K kernel, int bytes, int (&opted)[64]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 64 && opted[dev] >= bytes) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0 && dev < 64) opted[dev] = bytes;
  return err;
}

template <typename T, class Cfg, int VEC>
int launch_gemm_cfg(const T* A, const T* B, T* C, int64_t M, int K, int N,
                    cudaStream_t stream) {
  using S = GemmSmem<T, Cfg>;
  auto kernel = gemm_kernel<T, Cfg, VEC>;
  static int opted[64] = {};
  const int err = allow_smem(kernel, S::BYTES, opted);
  if (err != 0) return err;
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

// ------------------------------------------------------------------ the DSS
//
// y = DSS(u): every slot gets the sum of the up to 2^dim copies of its
// global node, in one canonical order that does not depend on which slot
// computes it: pairs along axis 0 first, then pairs of those along axis 1,
// then axis 2, the lower element first in each pair. That is the order of
// the axis-by-axis plain DSS (ops/local.py::dss_box), so every duplicate
// slot is bitwise equal and y is bitwise the plain DSS of the same u. bnd,
// when asked for, holds the first plane along the mesh's axis 0 of the first
// axis-0 slice and the last plane of the last slice, summed over axes
// 1..dim-1 only (the raw planes the sharded path exchanges).
//
// What bounds it on an H100: it reads u once and writes y once (at 24^3
// ngl=4 f32 with 192 columns, 10.6 MB each way: 6.3 us at 3.35 TB/s), with
// a few adds per slot. A thread per slot that decodes its element and node
// and gathers its copies from global memory is bound by instructions and
// latency instead (0.36 TB/s). This pass works on a tile in shared memory:
//   - The mesh is viewed as 3D with axis 2 fastest; a 2D mesh gets a
//     leading axis of one element with one node. A CTA owns a chunk of C
//     consecutive elements along axis 2 at fixed (e0, e1), whose rows of u
//     are contiguous.
//   - It stages with cp.async (16 bytes a copy where a line of nn2 * ncomp
//     entries is a multiple of 16 bytes and u, y, bnd are aligned) the 9
//     slabs of its neighbourhood (e0 + i0, e1 + i1), each for the elements
//     c0 - 1 .. c0 + C (a halo element at each end), and of each element
//     only the nodes it shares with the chunk: all of them in the own slab,
//     the facing a0 face in slabs i0 != 0, the facing a1 face in slabs
//     i1 != 0, the edge in the diagonal ones. The neighbour slabs are other
//     CTAs' own rows, so they are L2 hits.
//   - It then sums in the tile, one axis per pass, a barrier between: axis
//     0 (the own a0 faces add slabs (+-1, 0), and the a0 faces of slabs
//     (0, +-1) add the diagonal ones), axis 1 (the own a1 faces add slabs
//     (0, +-1)), axis 2 (each pair of a2 faces of neighbouring elements).
//     Each pass adds the partner's value, which already holds the sums of
//     the earlier axes, so a slot ends with the canonical tree. An entry is
//     in at most one pair per pass: no races.
//   - A pass is one loop over (element, face entry) in which a thread keeps
//     its face entry and steps over elements (dss_loop), with the thread
//     mapping and divisors computed on the host: an add is two loads, an
//     add and a store. (Gathering each slot's 8 possible copies from the
//     tile with predicated loads costs ~60 instructions a slot, and
//     runtime divisions per loop cost more than the adds.)
//   - y is the own slab's chunk rows, copied out with 16-byte stores. A node
//     of the mesh's first (last) axis-0 plane has no axis-0 partner, so its
//     y is its bnd: the CTAs on those slices copy bnd from the same tile,
//     and bnd costs no launch of its own.

// Element and node indices fit in 32 bits (the wrappers check E < 2^31);
// only offsets into u, y and bnd are 64-bit.
struct MeshShape {
  int dim;
  int ngl;
  int ncomp;
  int nnc;      // ngl^dim * ncomp
  int ne[3];    // elements per axis (unused entries 1)
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
  return s;
}

// A CTA has a thread per column, whole warps, at least 64 and at most
// DSS_MAX_THREADS. The chunk is the longest run of a row whose tile leaves
// room for DSS_SM_THREADS threads per SM (the SM's DSS_SM_SMEM bytes of
// shared memory, less 1 KB per CTA, over the tile). Measured on an H100
// (chip_smoke.py's DSS sweep): fewer resident threads leave the passes'
// latency exposed, and shorter chunks stage more halo.
constexpr int DSS_SM_SMEM = 228 * 1024;
constexpr int DSS_MAX_TILE = 227 * 1024;
constexpr int DSS_SM_THREADS = 768;
constexpr int DSS_MAX_THREADS = 512;

// x / d for 0 <= x with x d < 2^32, as umulhi(x, m), m = floor((2^32 - 1)
// / d) + 1 (m = 0 stands for d = 1): the divisors of the DSS pass are
// known on the host, and a runtime division is ~20 instructions.
struct DssDiv {
  int d;
  unsigned m;
};

inline DssDiv make_dss_div(int d) {
  return {d, d <= 1 ? 0u : 0xFFFFFFFFu / (unsigned)d + 1u};
}

__device__ __forceinline__ int dss_div(int x, DssDiv v) {
  return v.m ? (int)__umulhi((unsigned)x, v.m) : x;
}

// A loop over (element, entry j < F) of one pass (dss_loop): a thread takes
// j = tid % F and every per-th element from tid / F, per = threads / F (0
// when F > threads). F = 0: the pass has nothing to do.
struct DssLoop {
  DssDiv F;
  int per;
};

inline DssLoop make_dss_loop(int F, int threads) {
  return {make_dss_div(F), F > 0 && F <= threads ? threads / F : 0};
}

// How the DSS pass covers one mesh shape (ops/fused.py::dss_tile_plan
// mirrors it). Slab 3 (i0 + 1) + (i1 + 1) holds C + 2 elements of sz[]
// entries each, from base[] on; an element of a slab is its lines (fixed
// a0, a1; `line` entries over a2 and comp) with a0 slowest.
struct DssPlan {
  int ne[3], nn[3];    // the 3D view: elements, nodes per element, per axis
  int nc, nnc, line;   // components; entries per element; per line
  int fa;              // view axis of the mesh's axis 0
  int R, plane;        // bnd: rows per axis-0 slice, entries per plane
  int C, nch;          // elements per chunk; chunks per row
  int sz[9], base[9];
  int tile;            // entries of the tile
  int threads;
  // the loops: staging of the neighbour slabs, the axis passes, bnd
  DssLoop stage, pass0, pass1, pass2, bndl;
  DssDiv line_d, nc_d, cpr_d;   // by line, by ncomp, by line / vec
};

// vec: entries per copy; chunk > 0 forces the chunk length (a measurement
// knob), 0 takes the rule
inline DssPlan make_dss_plan(const MeshShape& s, int elem_bytes, int vec,
                             int chunk) {
  DssPlan p;
  const int lead = 3 - s.dim;
  for (int d = 0; d < 3; ++d) {
    p.ne[d] = d < lead ? 1 : s.ne[d - lead];
    p.nn[d] = d < lead ? 1 : s.ngl;
  }
  p.nc = s.ncomp;
  p.nnc = s.nnc;
  p.line = s.ngl * s.ncomp;
  p.fa = lead;
  p.R = (lead == 0 ? p.ne[1] : 1) * p.ne[2];
  p.plane = s.nnc / s.ngl;
  int per_elem = 0;
  for (int i0 = -1; i0 <= 1; ++i0)
    for (int i1 = -1; i1 <= 1; ++i1) {
      // a slab whose neighbour no CTA has takes no room
      const bool some = (i0 == 0 || p.ne[0] > 1) && (i1 == 0 || p.ne[1] > 1);
      const int n = some ? (i0 ? 1 : p.nn[0]) * (i1 ? 1 : p.nn[1]) * p.line
                         : 0;
      p.sz[3 * (i0 + 1) + (i1 + 1)] = n;
      per_elem += n;
    }
  const int t = (s.nnc + 31) / 32 * 32;
  p.threads = t < 64 ? 64 : (t < DSS_MAX_THREADS ? t : DSS_MAX_THREADS);
  const int ne2 = p.ne[2];
  // too long: the tile does not fit, or leaves too few threads per SM
  auto too_long = [&](int c) {
    const int64_t bytes = (int64_t)(c + 2) * per_elem * elem_bytes;
    return bytes > DSS_MAX_TILE ||
           DSS_SM_SMEM / (bytes + 1024) * p.threads < DSS_SM_THREADS;
  };
  int C = ne2;
  if (chunk > 0) {
    C = chunk < ne2 ? chunk : ne2;
  } else {
    int nch = 1;
    while (C > 1 && too_long(C)) {
      ++nch;
      C = (ne2 + nch - 1) / nch;
    }
  }
  p.C = C;
  p.nch = (ne2 + C - 1) / C;
  int off = 0;
  for (int i = 0; i < 9; ++i) {
    p.base[i] = off;
    off += (C + 2) * p.sz[i];
  }
  p.tile = off;
  int stage = 0;
  for (int i = 0; i < 9; ++i) stage += i == 4 ? 0 : p.sz[i] / vec;
  const int F0 = p.nn[1] * p.line, F1 = p.nn[0] * p.line;
  const bool two0 = p.ne[0] > 1, two1 = p.ne[1] > 1;
  p.stage = make_dss_loop(stage, p.threads);
  p.pass0 = make_dss_loop(two0 ? 2 * F0 + (two1 ? 4 * p.line : 0) : 0,
                          p.threads);
  p.pass1 = make_dss_loop(two1 ? 2 * F1 : 0, p.threads);
  p.pass2 = make_dss_loop(p.nn[0] * p.nn[1] * p.nc, p.threads);
  p.bndl = make_dss_loop(p.plane / vec, p.threads);
  p.line_d = make_dss_div(p.line);
  p.nc_d = make_dss_div(p.nc);
  p.cpr_d = make_dss_div(p.line / vec);
  return p;
}

// Visits the entries (kk, j), kk in [k0, k1), j < F, of a pass: a thread
// takes one j and every per-th element (DssLoop), so prep(j), which decodes
// j, runs once per thread and fn(kk, prep(j)) is a few adds. With F >
// threads a thread takes j = tid, tid + threads, ... of every element.
template <class Prep, class Fn>
__device__ __forceinline__ void dss_loop(const DssLoop& L, int k0, int k1,
                                         Prep prep, Fn fn) {
  const int B = blockDim.x, tid = threadIdx.x, F = L.F.d;
  if (L.per > 0) {
    const int kk0 = dss_div(tid, L.F);
    if (kk0 >= L.per) return;
    const auto st = prep(tid - kk0 * F);
    for (int kk = k0 + kk0; kk < k1; kk += L.per) fn(kk, st);
  } else {
    for (int j = tid; j < F; j += B) {
      const auto st = prep(j);
      for (int kk = k0; kk < k1; ++kk) fn(kk, st);
    }
  }
}

template <typename T, int VEC>
using DssVec = std::conditional_t<
    VEC == 1, T,
    std::conditional_t<std::is_same_v<T, float>, float4, double2>>;

// a copy of the staging: VEC entries from u[src + kk nnc] to tile[dst + kk
// dstep], where ok
struct DssCopy {
  int dst, dstep;
  int64_t src;
  bool ok;
};

// an add of a pass: tile[a + kk as] += tile[b + kk bs], where ok
struct DssAdd {
  int a, as, b, bs;
  bool ok;
};

// One CTA per chunk: blockIdx.x = (e0 ne1 + e1) nch + chunk. Slab element
// kk is mesh element c0 - 1 + kk of its row (chunk element kk - 1). VEC
// entries per cp.async and per store.
template <typename T, int VEC>
__global__ void __launch_bounds__(DSS_MAX_THREADS)
dss_kernel(const T* __restrict__ u, T* __restrict__ y, T* __restrict__ bnd,
           const DssPlan p) {
  constexpr int BYTES = VEC * (int)sizeof(T);
  using V = DssVec<T, VEC>;
  extern __shared__ __align__(16) unsigned char dss_smem[];
  T* tile = reinterpret_cast<T*>(dss_smem);
  const int tid = threadIdx.x;
  const int row = blockIdx.x / p.nch;   // e0 ne1 + e1
  const int c0 = (blockIdx.x - row * p.nch) * p.C;
  const int e0 = row / p.ne[1], e1 = row - e0 * p.ne[1];
  const int C = p.C < p.ne[2] - c0 ? p.C : p.ne[2] - c0;
  const int nnc = p.nnc, line = p.line, nn0 = p.nn[0], nn1 = p.nn[1];
  const int F0 = nn1 * line, F1 = nn0 * line;   // an a0 plane; an a1 plane
  const int own = p.base[4];
  // the slab elements that exist, and the neighbours along axes 0 and 1
  const int klo = c0 == 0 ? 1 : 0;
  const int khi = C + 2 < p.ne[2] - c0 + 1 ? C + 2 : p.ne[2] - c0 + 1;
  const bool lo0 = e0 > 0, hi0 = e0 < p.ne[0] - 1;
  const bool lo1 = e1 > 0, hi1 = e1 < p.ne[1] - 1;
  // entry of u where element 0 of the own slab would start
  const int64_t first = ((int64_t)row * p.ne[2] + c0 - 1) * nnc;
  auto add = [&](int kk, const DssAdd& d) {
    if (!d.ok) return;
    T* x = tile + d.a + kk * d.as;
    *x = *x + tile[d.b + kk * d.bs];
  };

  // 1. stage: the own rows, one contiguous run; then the other slabs in one
  // loop, slab by slab, in VEC-entry chunks of their elements
  {
    const T* src = u + (first + (int64_t)klo * nnc);
    T* dst = tile + own + klo * nnc;
    const int n = (khi - klo) * nnc / VEC;
    for (int i = tid; i < n; i += blockDim.x)
      cp_async<BYTES>(dst + i * VEC, src + i * VEC, BYTES);
  }
  dss_loop(
      p.stage, klo, khi,
      [&](int j) {
        int slab = 0;
        for (int n = p.sz[0] / VEC; j >= n; n = p.sz[slab] / VEC) {
          j -= n;
          slab += slab == 3 ? 2 : 1;
        }
        const int i0 = slab / 3 - 1, i1 = slab % 3 - 1;
        // an element of the slab: nn0 runs of a line, F0 apart in u, in
        // slabs (0, +-1); one run of its sz entries in the others; from
        // the facing a0 plane (i0 != 0) and a1 line (i1 != 0) on
        const int len = i1 ? line : p.sz[slab];
        const int r = i1 ? dss_div(j, p.cpr_d) : 0;
        const int q = j * VEC - r * len;
        return DssCopy{
            p.base[slab] + r * len + q, p.sz[slab],
            first + ((int64_t)i0 * p.ne[1] + i1) * p.ne[2] * nnc +
                (i0 < 0 ? (nn0 - 1) * F0 : 0) +
                (i1 < 0 ? (nn1 - 1) * line : 0) + r * F0 + q,
            (i0 == 0 || (i0 < 0 ? lo0 : hi0)) &&
                (i1 == 0 || (i1 < 0 ? lo1 : hi1))};
      },
      [&](int kk, const DssCopy& c) {
        if (c.ok)
          cp_async<BYTES>(tile + c.dst + kk * c.dstep,
                          u + (c.src + (int64_t)kk * nnc), BYTES);
      });
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. axis 0: the own a0 faces add slabs (-1, 0) and (+1, 0); the a0 faces
  // of slabs (0, +-1) add the diagonal slabs (their axis-1 partners' pairs)
  dss_loop(
      p.pass0, klo, khi,
      [&](int j) {
        if (j < 2 * F0) {
          const bool up = j >= F0;
          const int jj = j - (up ? F0 : 0);
          return DssAdd{own + (up ? nn0 - 1 : 0) * F0 + jj, nnc,
                        p.base[up ? 7 : 1] + jj, F0, up ? hi0 : lo0};
        }
        const int seg = dss_div(j - 2 * F0, p.line_d);   // 2 up1 + up0
        const int jj = j - 2 * F0 - seg * line;
        const bool up0 = seg & 1, up1 = seg >> 1;
        return DssAdd{p.base[up1 ? 5 : 3] + (up0 ? nn0 - 1 : 0) * line + jj,
                      F1, p.base[(up0 ? 6 : 0) + (up1 ? 2 : 0)] + jj, line,
                      (up0 ? hi0 : lo0) && (up1 ? hi1 : lo1)};
      },
      add);
  __syncthreads();

  // 3. axis 1: the own a1 faces add slabs (0, -1) and (0, +1)
  dss_loop(
      p.pass1, klo, khi,
      [&](int j) {
        const bool up = j >= F1;
        const int jj = j - (up ? F1 : 0);
        const int a0 = dss_div(jj, p.line_d);
        return DssAdd{own + (a0 * nn1 + (up ? nn1 - 1 : 0)) * line + jj -
                          a0 * line,
                      nnc, p.base[up ? 5 : 3] + jj, F1, up ? hi1 : lo1};
      },
      add);
  __syncthreads();

  // 4. axis 2: the pair (element kk - 1 at a2 = nn2 - 1, element kk at a2 =
  // 0) of every two staged elements, its sum written to the chunk's own
  const int flip = (p.nn[2] - 1) * p.nc;
  dss_loop(
      p.pass2, klo + 1, khi,
      [&](int j) {
        const int a = dss_div(j, p.nc_d);
        return a * line + (j - a * p.nc);
      },
      [&](int kk, int o) {
        T* hi = tile + own + kk * nnc + o;
        T* lo = hi - nnc + flip;
        const T s = *lo + *hi;
        if (kk > 1) *lo = s;
        if (kk <= C) *hi = s;
      });
  __syncthreads();

  // 5. y = the chunk's rows of the own slab. A node of the mesh's first
  // (last) axis-0 plane has no axis-0 partner, so its y is its bnd.
  const T* t0 = tile + own + nnc;
  V* yc = reinterpret_cast<V*>(y + (first + nnc));
  const int n = C * nnc / VEC;
  for (int i = tid; i < n; i += blockDim.x)
    yc[i] = reinterpret_cast<const V*>(t0)[i];
  if (bnd == nullptr) return;
  const int ef = p.fa == 0 ? e0 : e1;
  const int r0 = (p.fa == 0 ? e1 * p.ne[2] : 0) + c0;
  const int pv = p.plane / VEC;
  for (int side = 0; side < 2; ++side) {
    if (ef != (side ? p.ne[p.fa] - 1 : 0)) continue;
    const T* src = t0 + (side ? nnc - p.plane : 0);
    V* dst = reinterpret_cast<V*>(bnd + ((int64_t)side * p.R + r0) * p.plane);
    dss_loop(p.bndl, 0, C, [](int j) { return j; }, [&](int k, int j) {
      dst[k * pv + j] = reinterpret_cast<const V*>(src + k * nnc)[j];
    });
  }
}

template <typename T, int VEC>
int launch_dss_as(const T* u, T* y, T* bnd, const DssPlan& p,
                  cudaStream_t stream) {
  auto kernel = dss_kernel<T, VEC>;
  const int bytes = p.tile * (int)sizeof(T);
  static int opted[64] = {};
  const int err = allow_smem(kernel, bytes, opted);
  if (err != 0) return err;
  const int64_t blocks = (int64_t)p.ne[0] * p.ne[1] * p.nch;
  kernel<<<(unsigned)blocks, p.threads, bytes, stream>>>(u, y, bnd, p);
  return (int)cudaGetLastError();
}

// y = DSS(u) and, unless bnd is null, the raw boundary planes; `chunk` as in
// make_dss_plan
template <typename T>
int launch_dss(const T* u, T* y, T* bnd, const MeshShape& s,
               cudaStream_t stream, int chunk = 0) {
  constexpr int W = 16 / (int)sizeof(T);
  const uintptr_t bits = (uintptr_t)u | (uintptr_t)y | (uintptr_t)bnd;
  if (s.ngl * s.ncomp % W == 0 && (bits & 15) == 0)
    return launch_dss_as<T, W>(
        u, y, bnd, make_dss_plan(s, (int)sizeof(T), W, chunk), stream);
  return launch_dss_as<T, 1>(u, y, bnd,
                             make_dss_plan(s, (int)sizeof(T), 1, chunk),
                             stream);
}

}  // namespace
