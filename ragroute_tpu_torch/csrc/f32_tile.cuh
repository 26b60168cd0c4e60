// f32 product tiles on the CUDA cores, in full f32 FMA (no TF32: the plain
// versions form f32 gains in f32, and TF32 would change the answers): shared
// by fused_topk.cu's f32 scan (f32_topk_kernel) and grouped_gains.cu's f32
// route (grouped_f32_kernel).
//
// A thread keeps an 8 x 8 block of f32 accumulators over chunks of BK = 32
// of the contraction, and the inner loop reads shared memory only by
// 16-byte loads that a warp serves without bank conflicts:
//
//   * fma_nt: both operands k-contiguous ([rows, D] queries and docs), as
//     TMA boxes of 128-byte rows land them in the 128-byte swizzle: a row's
//     four k in one load, 8 + 8 loads for 256 FMA a thread;
//   * fma_nn: the first operand a k-contiguous tile padded to LDK = BK + 4
//     floats a row (two rows one apart land 16 bytes apart in the banks),
//     the second N-contiguous ([BK, 128] of a [D, S] slab), four
//     neighbouring columns in one load, the thread's 8 columns at 4 tx and
//     64 + 4 tx, 8 + 8 loads for 256 FMA; both reach shared memory by
//     cp.async (16 bytes a copy, zero-filled past the matrix) into a ring of
//     stages: each thread issues its own copies `stages - 1` chunks ahead,
//     waits for its group of the current chunk, and one barrier of the
//     block makes every thread's copies visible.
//
// What bounds both: f32 FMA at 67 TFLOP/s (an H100 SXM at 700 W); the
// loads are a sixteenth of the FMAs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32tile {

constexpr int BK = 32;        // contraction chunk (floats)
constexpr int LDK = BK + 4;   // row stride of a k-contiguous tile (floats)

// 16 bytes from global to shared memory, asynchronously; zeros (and no read
// of src) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes, as above (grouped_gains.cu's raw int8 / int4 slab rows)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 to 7) of this thread's newest groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// One chunk of a [ROWS x BK] k-contiguous tile (row stride LDK) by THREADS
// threads: row r's 16-byte piece p holds columns k0 + 4 p ..; row_at(r) is
// the row's first float, or null for a row that reads zeros; columns at or
// past D read zeros (D % 4 == 0).
template <int ROWS, int THREADS, class RowAt>
__device__ __forceinline__ void load_k_rows(float* dst, RowAt row_at, int k0,
                                            int D, const float* any,
                                            int tid) {
  constexpr int PIECES = ROWS * (BK / 4);
#pragma unroll
  for (int j = 0; j < PIECES / THREADS; ++j) {
    const int v = tid + THREADS * j, r = v / (BK / 4), p = v % (BK / 4);
    const int col = k0 + 4 * p;
    const float* row = row_at(r);
    const bool valid = row != nullptr && col < D;
    cp_async16(dst + r * LDK + 4 * p, valid ? row + col : any, valid);
  }
}

// acc[i][j] += sum over the chunk's k of A[a0 + AS i][k] * B[b0 + BS j][k]
// (i < TM, j < 8), the k in ascending order, A and B [rows x 32] f32 tiles
// as a TMA box lands them in the 128-byte swizzle (fused_topk.cu's f32
// scan): row r's floats k .. k + 3 (k % 4 == 0) sit at r * 32 + 4 ((k / 4)
// ^ (r % 8)). The thread's rows a0 + AS i (AS % 8 == 0) share r % 8, so one
// XOR a step serves all of them; a warp's 16 doc rows one apart read 8
// different 16-byte columns. The loop is not unrolled: unrolled twice, it
// spilled at the f32 scan's 288 threads and was slower (PERF.md).
template <int TM, int AS, int BS>
__device__ __forceinline__ void fma_nt(float (&acc)[TM][8], const float* sA,
                                       const float* sB, int a0, int b0) {
  static_assert(BK == 32 && AS % 8 == 0 && BS % 8 == 0, "one swizzle a row");
  const int xa = a0 & 7, xb = b0 & 7;
#pragma unroll 1
  for (int kq = 0; kq < BK; kq += 4) {
    const int ca = ((kq >> 2) ^ xa) << 2, cb = ((kq >> 2) ^ xb) << 2;
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(sA + (a0 + AS * i) * BK + ca);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(sB + (b0 + BS * j) * BK + cb);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum over the chunk's k of A[a0 + AS i][k] * B[k][c(j)], A a
// k-contiguous tile (row stride LDK), B an N-contiguous [BK x ldb] tile, c(j)
// = b0 + j for j < 4 and 64 + b0 + j - 4 past it; the k in ascending order.
template <int AS>
__device__ __forceinline__ void fma_nn(float (&acc)[8][8], const float* sA,
                                       const float* sB, int ldb, int a0,
                                       int b0) {
#pragma unroll 2
  for (int kq = 0; kq < BK; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(sA + (a0 + AS * i) * LDK + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* row = sB + (kq + kk) * ldb + b0;
      const float4 b0v = *reinterpret_cast<const float4*>(row);
      const float4 b1v = *reinterpret_cast<const float4*>(row + 64);
      const float bv[8] = {b0v.x, b0v.y, b0v.z, b0v.w,
                           b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                       : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

}  // namespace f32tile
