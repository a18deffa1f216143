// The inline PTX of the kernels, and nothing else: cp.async copies from
// global into shared memory, and the FP64 tensor-core MMA. Every asm
// statement in csrc/ lives here, in a small helper, so a host rehearsal of
// the kernels can put functional versions of exactly these functions in
// place of this file.
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

}  // namespace
