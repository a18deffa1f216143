// The inline PTX of the kernels, and nothing else: cp.async copies from
// global into shared memory, the FP64 tensor-core MMA, and the warpgroup
// bf16 MMA (wgmma) with its fences and the f32 -> bf16 pair conversion.
// Every asm statement in csrc/ lives here, in a small helper, so a host
// rehearsal of the kernels can put functional versions of exactly these
// functions in place of this file.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Copy BYTES (16, 8 or 4) from global `src` to shared `dst`: the first
// `src_bytes` of them (BYTES or 0) are read, the rest are zero-filled, so
// src_bytes = 0 reads nothing and writes zeros. 16-byte copies bypass L1
// (.cg); 4- and 8-byte copies may only use .ca.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

// close the copies issued since the last commit into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a b on the FP64 tensor cores, one m16n8k16 tile per warp (IEEE
// double fused multiply-adds). Fragments, with g = lane / 4, t = lane % 4:
//   a[2 ki + mj] = A[g + 8 mj][t + 4 ki]   (ki < 4, mj < 2)
//   b[ki]        = B[t + 4 ki][g]
//   d[2 mj + i]  = D[g + 8 mj][2 t + i]
__device__ __forceinline__ void mma_m16n8k16_f64(double (&d)[4],
                                                 const double (&a)[8],
                                                 const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// ------------------------------------------------------------------ wgmma
//
// The warpgroup MMA of sm_90a: the 128 threads of a warpgroup (4 warps, the
// first a multiple of 4) together compute D (64 x N, f32) = A (64 x 16,
// bf16) B (16 x N, bf16) + D, asynchronously. Here A comes from registers
// and B from shared memory through a matrix descriptor. With w = warp % 4,
// g = lane / 4, t = lane % 4 a thread holds
//   a[2 h + r]     = A[16 w + g + 8 r][8 h + 2 t .. + 1]   (r, h < 2)
//   d[4 j + 2 r + i] = D[16 w + g + 8 r][8 j + 2 t + i]    (j < N / 8)
// two bf16 to a register, the lower k in the lower half.

// two floats rounded to nearest-even bf16, `lo` in the lower half
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Orders the warpgroup's register and shared-memory accesses before the
// wgmmas that follow: needed before the first one and whenever ordinary
// code wrote the registers a wgmma reads (the A halves, the accumulators).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// close the wgmmas started since the last commit into one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins `x` at this point of the program: the compiler neither reads an
// accumulator ahead of the wgmma_wait that completes it nor moves its
// writes behind a wgmma that still reads it. Emits nothing.
__device__ __forceinline__ void wgmma_pin(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}

// Makes this thread's earlier shared-memory writes (stores, landed
// cp.async copies) visible to the asynchronous proxy through which wgmma
// reads its B operand; follow it with the barrier that hands the tile over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = a b + (scale_d ? d : 0) for N = 16 and 96 (d of N / 2 registers).
// `b` describes B in shared memory, K-major, not transposed.
__device__ __forceinline__ void wgmma_m64k16_bf16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64k16_bf16(float (&d)[48],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace
