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
// What bounds it on an H100. At 24^3 ngl=4 192->192 the three products are
// 3.06 GFLOP of bf16 MMA (3.1 us at 989 TFLOP/s) against ~21 MB of HBM
// traffic (t read, u written: 6.3 us at 3.35 TB/s), so the GEMM is bound by
// bytes, and everything else it does has to hide under the copies: the
// f32 -> bf16 splits (two converts and a subtract per value), the MMAs, the
// stores. The design therefore does each of them once:
//   - matT is split once per call, by split_kernel, into a scratch tensor
//     that already has the layout the tensor cores read (below), zero-padded
//     to whole tiles. The GEMM copies it with 16-byte cp.async and never
//     converts a value of it.
//   - The MMA is wgmma m64nNk16 (bf16 x bf16 -> f32), the warpgroup path. B
//     (the halves of matT) is read from shared memory through descriptors.
//     A comes from registers: a thread reads its f32 pairs of the t tile
//     from shared memory in the wgmma A-fragment layout, splits them into
//     packed hi and lo bf16 pairs and starts the three products from there,
//     so the halves of t never go to shared memory.
//   - A CTA is two warpgroups on one 64-row tile of t, side by side along N
//     (2 x 96 columns, or 2 x 16 for the narrow operators, N <= 32), so a
//     CTA tile is as wide as N up to 192 and t is read from HBM once. Wider
//     N takes column tiles, blockIdx.y; their CTAs find t in L2.
//   - A CTA is persistent: it keeps one column tile and walks the row tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ... (gridDim.x * gridDim.y <= the
//     SM count). Where both halves of its K x BN slab of matT fit beside the
//     ring (K <= 192 at BN = 192) they are `resident`: they arrive once,
//     stage by stage with the first tile's stages of t, and stay. Else (K =
//     384, 1029, 2058) every ring stage carries its 32-deep slab of them
//     from L2. (Keeping K = 384 resident at half the width, 96 columns,
//     measured slower, 32 us against 26: twice the tiles, each re-reading t.)
//   - t streams through a ring of 32-deep stages (7 resident, 5 streamed)
//     filled by cp.async, 16 bytes a copy where t is 16-byte aligned and K a
//     multiple of 4, else one element a copy (K = 9, 27, 1029, a misaligned
//     view). The ring runs over (row tile, k stage) pairs without a break,
//     so the next tile's copies are in flight while this one's accumulators
//     are stored. One __syncthreads per stage.
//   - The wgmmas of a stage run while the warpgroup waits for the next
//     stage, passes the barrier, starts the copies that refill the ring and
//     splits the next stage's fragments into a second set of registers;
//     only then does it wait for them (wgmma_wait) and add their sums.
//   - The f32 stage of t has 128-byte rows of 16-byte chunks, chunk c of row
//     r stored at c ^ 2 (r & 3) (a_swz of the shared GEMM): the copies write
//     whole lines, and the 8-byte fragment reads of a half-warp (4 rows x 32
//     bytes) fall on distinct banks.
//   - The accumulators go from registers straight to u with 8-byte stores
//     (each warp store fills whole 32-byte sectors); one element a store
//     where N is odd or u misaligned. Ragged edges: the copies zero-fill
//     rows past M and k past K, the scratch is zero past K and N, and the
//     stores are masked.
//
// B in shared memory and in the scratch: "core matrices" of 8 columns (n) x
// 8 k values, 16 bytes per column, 128 bytes each, K-major, no swizzle. The
// scratch is S[(2 kg + h) np + n], one 16-byte chunk per (k group kg = k /
// 8, half h, column n): the 8 bf16 values k = 8 kg .. 8 kg + 7 of column n,
// lower k first. A stage or the resident slab holds the chunks of its k
// groups and the CTA's BN columns in the same order, so for one k16 step the
// descriptor's leading byte offset (between the two k groups) is 2 BN 16 and
// its stride byte offset (between groups of 8 columns) is 128.
//
// Accuracy. Each bf16 x bf16 product is exact in f32, but the tensor cores
// round their own accumulation, and over one long chain that error grows
// about linearly in K (8.0e-6 of max|y| against the plain version at ngl=7,
// K = 1029-2058, when the wmma form of this kernel used one chain). So a
// chain is one 32-deep stage: 6 wgmmas (hi*hi, hi*lo, lo*hi per k16 step)
// into a stage accumulator that starts from zero (scale-d = 0 on the
// first), which is then added to the running f32 sums with ordinary adds.
// Splitting N over the two warpgroups keeps both accumulator sets at 96
// registers a thread (ptxas: 222 in all, no spills). JAX sums three separate products as (hh + hl) + lh;
// this changes only the rounding order.
//
// Where its time goes (H100, 24^3 ngl=4 192->192, clock64 stamps): a CTA's
// first stage is split 2.3 us after it starts (each SM draws 147 KB of
// matT's halves from L2 beside its 48 KB of t); a stage then takes about
// 1200 cycles, of which the tensor cores are busy 576 (wait for the copies
// and the barrier ~250, issuing the refill 170-440, split 240, adds 150),
// and storing a tile stalls ~2200 cycles because every CTA stores at once.
// 216 tiles on 132 CTAs are two rounds. Handing the copies to a producer
// that signals each stage through mbarriers (cp.async.mbarrier.arrive) was
// tried and measured slower on the same card, 13.7 us against 23.3 with one
// producer warp and 17.5 with a producer warpgroup on 56 registers
// (setmaxnreg): 16-byte cp.async copies cost an instruction each, and 256
// threads start them faster than 32 or 128. What is left to try: bulk (TMA)
// copies, which need the hardware's own swizzle for the f32 stage, a store
// through shared memory, and clusters that share one copy of matT's halves.
//
// The second launch is launch_dss of fused_common.cuh: K1's DSS pass, so
// y's duplicate slots are bitwise equal as in K1. u still goes to HBM and
// back between the two launches. The TPU kernel's `block` only changes the
// order of its additions and is not a parameter here.

#include "fused_common.cuh"

namespace {

constexpr int X_BM = 64;            // rows of a CTA tile: the wgmma M
constexpr int X_BK = 32;            // k depth of a ring stage and of a chain
constexpr int X_THREADS = 256;      // two warpgroups, side by side along N
constexpr int X_STAGES_RES = 7;     // ring stages, matT's halves resident
constexpr int X_STAGES_STR = 5;     // ring stages, each with its slab of them
constexpr int X_A_STAGE = X_BM * X_BK * 4;   // bytes of t in a stage
constexpr int X_SMEM_MAX = 227 * 1024;
constexpr int X_ROWB = X_BK * 4;    // bytes of a row of t in a stage

// How the GEMM covers one product (exp/mm3x.py::gemm3x_plan mirrors it).
struct Gemm3xPlan {
  int bn;          // columns of a CTA tile: 32 or 192
  int kp, np;      // K padded to X_BK, N padded to bn: the scratch's extents
  int ncol;        // column tiles, gridDim.y
  int resident;    // 1: a CTA keeps both halves of its kp x bn slab of matT
  int stages;
  int a_bytes;     // bytes per copy of t: 16 or 4
  int smem;        // dynamic shared memory, bytes
  int gx;          // CTAs per column tile, gridDim.x
};

// bytes of both halves of a k-deep, bn-wide slab of matT
__host__ __device__ inline int64_t x_slab_bytes(int k, int bn) {
  return (int64_t)4 * k * bn;
}

// a16: t is 16-byte aligned; sms: the card's SM count
inline Gemm3xPlan make_gemm3x_plan(int64_t M, int K, int N, bool a16,
                                   int sms) {
  Gemm3xPlan p;
  p.kp = (K + X_BK - 1) / X_BK * X_BK;
  // 32 columns cover the narrow operators (N = 9 .. 27), else 192; matT's
  // halves stay in shared memory where they fit beside the ring
  p.bn = N <= 32 ? 32 : 192;
  p.resident =
      x_slab_bytes(p.kp, p.bn) + X_STAGES_RES * X_A_STAGE <= X_SMEM_MAX;
  p.np = (N + p.bn - 1) / p.bn * p.bn;
  p.ncol = p.np / p.bn;
  p.stages = p.resident ? X_STAGES_RES : X_STAGES_STR;
  p.a_bytes = a16 && K % 4 == 0 ? 16 : 4;
  p.smem = p.resident
               ? (int)x_slab_bytes(p.kp, p.bn) + p.stages * X_A_STAGE
               : p.stages * ((int)x_slab_bytes(X_BK, p.bn) + X_A_STAGE);
  const int64_t tiles = (M + X_BM - 1) / X_BM;
  const int per = sms / p.ncol > 1 ? sms / p.ncol : 1;
  p.gx = (int)(tiles < per ? tiles : per);
  return p;
}

// the two bf16 halves of a pair of floats, packed, x in the lower half
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = cvt_bf16x2(x, y);
  lo = cvt_bf16x2(x - __uint_as_float(hi << 16),
                  y - __uint_as_float(hi & 0xffff0000u));
}

// matT (K, N) -> S: chunk (2 kg + h) np + n holds half h of matT[8 kg .. 8
// kg + 7][n], zero past K and N. One thread per (kg, n).
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ B, uint4* __restrict__ S, int K,
             int N, int kp, int np) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= kp / 8 * np) return;
  const int kg = idx / np, n = idx - kg * np;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 8 * kg + 2 * i;
    const float x = k < K && n < N ? B[(int64_t)k * N + n] : 0.0f;
    const float y = k + 1 < K && n < N ? B[(int64_t)(k + 1) * N + n] : 0.0f;
    split_pair(x, y, hi[i], lo[i]);
  }
  S[(int64_t)(2 * kg) * np + n] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  S[(int64_t)(2 * kg + 1) * np + n] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// The wgmma descriptor of a K-major, unswizzled B operand at shared address
// `addr` (bytes): bits 0-13 the address, 16-29 the leading byte offset
// (between the two k groups of a k16 step), 32-45 the stride byte offset
// (between groups of 8 columns), each in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// C = mm3x(A, B) from A (M, K) and the split S of B (K, N). BNW: columns
// per warpgroup (96 or 16); the CTA tile is 64 x 2 BNW. Shared memory: the
// B region (the resident slab, or a 32-deep slab per stage), then the ring
// of t.
template <int BNW>
__global__ void __launch_bounds__(X_THREADS, 1)
gemm3x_kernel(const float* __restrict__ A, const uint4* __restrict__ S,
              float* __restrict__ C, int64_t M, int K, int N,
              const Gemm3xPlan p) {
  constexpr int BN = 2 * BNW;
  constexpr int ND = BNW / 2;             // accumulators per thread
  constexpr int KG = 2 * BN * 16;         // bytes of one k group in the B region
  constexpr int SLAB = X_BK / 8 * KG;     // and of a 32-deep slab
  extern __shared__ __align__(128) unsigned char x_smem[];
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nk = p.kp / X_BK;
  const int n0 = blockIdx.y * BN;
  const int64_t tiles = (M + X_BM - 1) / X_BM;
  // this CTA's row tiles blockIdx.x + i gridDim.x, as (tile, k stage) items
  const int64_t items =
      (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nk;
  const bool res = p.resident != 0;
  uint4* const b_sm = reinterpret_cast<uint4*>(x_smem);
  float* const a_sm = reinterpret_cast<float*>(
      x_smem + (res ? (int)x_slab_bytes(p.kp, BN) : p.stages * SLAB));
  const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(x_smem);
  const bool c2 = N % 2 == 0 && ((uintptr_t)C & 7) == 0;

  // the loader's next item: its row tile's first row and its k stage. An
  // item is the 32-deep slab of t and, unless it is already there, the slab
  // of matT's halves: every item when streamed, the first tile's when
  // resident (so a resident slab arrives stage by stage, behind the
  // stages of t that need it)
  int64_t l_m0 = (int64_t)blockIdx.x * X_BM;
  int l_kt = 0;
  bool l_b = true;
  auto load = [&](int stage) {
    float* as = a_sm + stage * (X_A_STAGE / 4);
    const int k0 = l_kt * X_BK;
    if (p.a_bytes == 16) {
#pragma unroll
      for (int i = 0; i < X_BM * 8 / X_THREADS; ++i) {
        const int c = tid + i * X_THREADS;
        const int row = c / 8, ch = c % 8;
        const bool ok = l_m0 + row < M && k0 + 4 * ch < K;
        cp_async<16>(as + row * X_BK + (ch ^ a_swz<X_ROWB>(row)) * 4,
                     ok ? A + (l_m0 + row) * K + k0 + 4 * ch : A,
                     ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < X_BM * X_BK / X_THREADS; ++i) {
        const int e = tid + i * X_THREADS;
        const int row = e / X_BK, k = e % X_BK;
        const bool ok = l_m0 + row < M && k0 + k < K;
        cp_async<4>(as + a_off<float, X_ROWB>(row, k),
                    ok ? A + (l_m0 + row) * K + k0 + k : A, ok ? 4 : 0);
      }
    }
    if (l_b) {
      uint4* bs = b_sm + (res ? l_kt : stage) * (SLAB / 16);
      const uint4* src = S + (int64_t)(k0 / 8 * 2) * p.np + n0;
#pragma unroll
      for (int i = 0; i < 8 * BN / X_THREADS; ++i) {
        const int c = tid + i * X_THREADS;
        const int q = c / BN, n = c - q * BN;
        cp_async<16>(bs + c, src + (int64_t)q * p.np + n, 16);
      }
    }
    if (++l_kt == nk) {
      l_kt = 0;
      l_m0 += (int64_t)gridDim.x * X_BM;
      l_b = !res;
    }
  };

  // stages - 1 items ahead: the copies started in iteration w, for item w +
  // stages - 1, refill the stage of item w - 1
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < items) load(s);
    cp_async_commit();
  }

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.0f;
  const uint32_t b_wg = b_addr + wg * BNW * 16;   // the warpgroup's columns
  int64_t c_m0 = (int64_t)blockIdx.x * X_BM;      // the tile acc is summing
  // acc[4 j + 2 r + i] is u[c_m0 + 16 warp + g + 8 r][n0 + wg BNW + 8 j +
  // 2 t4 + i]
  auto store_tile = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t gm = c_m0 + 16 * warp + g + 8 * r;
      float* crow = C + gm * N;
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j) {
        const int gn = n0 + wg * BNW + 8 * j + 2 * t4;
        const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (gm >= M) continue;
        if (c2) {
          if (gn < N)
            *reinterpret_cast<float2*>(crow + gn) = make_float2(v0, v1);
        } else {
          if (gn < N) crow[gn] = v0;
          if (gn + 1 < N) crow[gn + 1] = v1;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.0f;
    c_m0 += (int64_t)gridDim.x * X_BM;
  };

  // Waits until the next item has landed (this thread's copies; the barrier
  // makes everyone's visible, and the fence shows a stage that brought a
  // slab of matT to the wgmmas), refills the stage of the item before the
  // one whose wgmmas are running, and splits the new stage's fragments of t:
  // rows 16 warp + g and + 8, whose swizzles agree.
  const int a_row = (16 * warp + g) * X_BK;
  const int a_sw = a_swz<X_ROWB>(g);
  int rd = 0, wr = p.stages - 1;   // the stage to split next, to refill next
  int64_t landed = 0;              // items split so far
  auto next_item = [&](uint32_t (&a_hi)[2][4], uint32_t (&a_lo)[2][4]) {
    if (res) cp_async_wait<X_STAGES_RES - 3>();
    else cp_async_wait<X_STAGES_STR - 3>();
    if (!res || landed < nk) fence_proxy_async();
    __syncthreads();
    if (landed > 0) {   // the first call follows the prologue's copies
      if (landed + p.stages - 2 < items) load(wr);
      cp_async_commit();
      wr = wr == p.stages - 1 ? 0 : wr + 1;
    }
    const float* as = a_sm + rd * (X_A_STAGE / 4) + a_row;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A(row, 16 ks + 8 h + 2 t4 .. + 1): chunk 4 ks + 2 h + t4 / 2
        const float* ap =
            as + ((4 * ks + 2 * h + t4 / 2) ^ a_sw) * 4 + t4 % 2 * 2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v =
              *reinterpret_cast<const float2*>(ap + 8 * r * X_BK);
          split_pair(v.x, v.y, a_hi[ks][2 * h + r], a_lo[ks][2 * h + r]);
        }
      }
    rd = rd == p.stages - 1 ? 0 : rd + 1;
    ++landed;
  };

  uint32_t a_hi[2][4], a_lo[2][4];
  next_item(a_hi, a_lo);
  int c_kt = 0, mm = 0;   // item w's k stage, and its stage of the ring
  for (int64_t w = 0; w < items; ++w) {
    // the stage's chain: 6 wgmmas into part, from zero
    float part[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) part[i] = 0.0f;
    const uint32_t bk = b_wg + (res ? c_kt : mm) * SLAB;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t m_hi = b_desc(bk + 2 * ks * KG, KG, 128);
      const uint64_t m_lo = b_desc(bk + 2 * ks * KG + BN * 16, KG, 128);
      wgmma_m64k16_bf16(part, a_hi[ks], m_hi, ks);
      wgmma_m64k16_bf16(part, a_hi[ks], m_lo, 1);
      wgmma_m64k16_bf16(part, a_lo[ks], m_hi, 1);
    }
    wgmma_commit();
    // while they run: the next item's copies, barrier and split
    uint32_t n_hi[2][4], n_lo[2][4];
    if (w + 1 < items) next_item(n_hi, n_lo);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      wgmma_pin(part[i]);
      acc[i] += part[i];
    }
    if (++c_kt == nk) {
      c_kt = 0;
      store_tile();
    }
    mm = mm == p.stages - 1 ? 0 : mm + 1;
    if (w + 1 < items) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a_hi[ks][i] = n_hi[ks][i];
          a_lo[ks][i] = n_lo[ks][i];
        }
    }
  }
}

template <int BNW>
int launch_gemm3x_as(const float* A, const uint4* S, float* C, int64_t M,
                     int K, int N, const Gemm3xPlan& p, cudaStream_t st) {
  auto kernel = gemm3x_kernel<BNW>;
  static int opted[64] = {};
  const int err = allow_smem(kernel, p.smem, opted);
  if (err != 0) return err;
  kernel<<<dim3(p.gx, p.ncol), X_THREADS, p.smem, st>>>(A, S, C, M, K, N, p);
  return (int)cudaGetLastError();
}

// the SM count of the current device
inline int sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0 && dev < 64) cached[dev] = *sms;
  return err;
}

inline int gemm3x_plan_for(const void* A, int64_t M, int K, int N,
                           Gemm3xPlan* p) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  *p = make_gemm3x_plan(M, K, N, ((uintptr_t)A & 15) == 0, sms);
  return 0;
}

// C = mm3x(A, B): split B into S (split_bytes of scratch), then the GEMM
int launch_gemm3x(const float* A, const float* B, void* S,
                  int64_t split_bytes, float* C, int64_t M, int K, int N,
                  cudaStream_t st) {
  if (M == 0 || N == 0) return 0;
  Gemm3xPlan p;
  int err = gemm3x_plan_for(A, M, K, N, &p);
  if (err != 0) return err;
  if (split_bytes < x_slab_bytes(p.kp, p.np) || ((uintptr_t)S & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = p.kp / 8 * p.np;
  split_kernel<<<(chunks + 255) / 256, 256, 0, st>>>(B, (uint4*)S, K, N,
                                                      p.kp, p.np);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (p.bn == 32)
    return launch_gemm3x_as<16>(A, (const uint4*)S, C, M, K, N, p, st);
  return launch_gemm3x_as<96>(A, (const uint4*)S, C, M, K, N, p, st);
}

}  // namespace

extern "C" {

// u = mm3x(t, matT), t (M, K), matT (K, N). split: scratch of split_bytes
// >= 4 kp np bytes (pn_gemm3x_plan), 16-byte aligned. Returns
// cudaGetLastError() after the launches.
int pn_gemm3x_f32(const void* t, const void* matT, void* split,
                  int64_t split_bytes, void* u, int64_t M, int K, int N,
                  void* stream) {
  return launch_gemm3x((const float*)t, (const float*)matT, split,
                       split_bytes, (float*)u, M, K, N,
                       (cudaStream_t)stream);
}

// u: (E, nnc_out) scratch; split as in pn_gemm3x_f32
int pn_fused3x_f32(const void* t, const void* matT, void* split,
                   int64_t split_bytes, void* u, void* y, int64_t E,
                   int nnc_in, int ngl, int ncomp_out, int dim, int ne0,
                   int ne1, int ne2, void* stream) {
  const int nelem[3] = {ne0, ne1, ne2};
  const MeshShape s = make_mesh_shape(ngl, ncomp_out, dim, nelem);
  const cudaStream_t st = (cudaStream_t)stream;
  const int err =
      launch_gemm3x((const float*)t, (const float*)matT, split, split_bytes,
                    (float*)u, E, nnc_in, s.nnc, st);
  if (err != 0) return err;
  return launch_dss<float>((const float*)u, (float*)y, nullptr, s, st);
}

// out[0..8] = tile columns, kp, np, column tiles, resident, stages, bytes per
// copy of t, shared-memory bytes, gridDim.x of the GEMM of t (M, K) at `t`
// with a (K, N) matT on the current device. Launches nothing.
int pn_gemm3x_plan(const void* t, int64_t M, int K, int N, int* out) {
  Gemm3xPlan p;
  const int err = gemm3x_plan_for(t, M, K, N, &p);
  if (err != 0) return err;
  out[0] = p.bn;
  out[1] = p.kp;
  out[2] = p.np;
  out[3] = p.ncol;
  out[4] = p.resident;
  out[5] = p.stages;
  out[6] = p.a_bytes;
  out[7] = p.smem;
  out[8] = p.gx;
  return 0;
}

}  // extern "C"
