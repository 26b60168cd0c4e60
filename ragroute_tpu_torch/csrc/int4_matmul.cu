// int4 weight-only matmul with group-wise scales, for Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/int4_matmul.py::int4_matmul (body
// _kernel). It computes
//
//     y[M, OUT] f32 = sum over groups g of scale[g, :] * (x[:, rows(g)] @ codes[rows(g), :])
//
// where codes [IN, OUT] are int4 values in [-8, 7] packed two to a byte as w
// [IN/2, OUT] int8: byte row i holds code row i in its low nibble and code
// row i + IN/2 in its high nibble. scale is f32 [IN/group, OUT] with the
// groups over code rows in natural order (the low half's groups first); a
// group never straddles the two halves because group divides IN/2. Each
// group's partial product is multiplied by its scale (one rounding), then
// added to the running f32 sum (a second rounding): the scale is never folded
// into an operand, so the arithmetic is the TPU kernel's.
//
// x is bf16 (the serving path) or f32. bf16 takes the tensor cores: both
// nibbles of a packed byte are unpacked by arithmetic shifts into bf16 (exact,
// |code| <= 8) and multiplied by mma.sync m16n8k16 with f32 accumulation. f32
// takes plain FMA in full f32 (no TF32).
//
// What bounds it on an H100 SXM: at decode (M = batch <= 16) each packed byte
// is used for at most 2 * 16 products, far below the ~295 operations a byte
// the card needs before the tensor cores bind, so the packed weights' bytes
// bound it (Qwen3-8B: about 4.1 GB of packed codes and 0.26 GB of scales a
// decode step, 1.3 ms at 3.35 TB/s). The design keeps that stream at one
// read: one M tile covers the whole batch, so every packed byte crosses HBM
// once; byte tiles of [64 rows x 128 columns] go to shared memory by cp.async
// (16-byte copies, double buffered); when the column blocks alone cannot fill
// the card (OUT = 1024 at decode gives 8), the packed rows are cut into splits
// whose partial sums a second small kernel adds up in split order.
//
// At prefill (M = B * P in the thousands) it is bound by its operations
// (Qwen3-8B gate/up, 8,192 x 4,096 x 12,288: 0.83 ms at the bf16 peak), and
// a second kernel takes those shapes (int4_mm_wgmma_kernel, chosen by
// ops/int4_matmul.py::_plan from M and the operands' types and alignment):
//   * one producer warp keeps a ring of 8 stages in flight by TMA, each the
//     [128 tokens x 64] bf16 tile of one half's activations (128-byte
//     swizzle) and the [64 packed rows x 128 columns] byte tile;
//   * two consumer warp groups, 64 output columns each, run wgmma
//     m64n128k16 with the weights as the A operand from registers: each
//     thread turns its 16-bit words of packed bytes into bf16 codes (a
//     nibble ^ 8 under a bf16 exponent of 128, minus 136: exact), so the
//     unpacked codes never go through shared memory, and the activations
//     are the B operand read by the tensor cores from the ring;
//   * the ring walks each group twice, low nibbles with the low half's
//     activations, then high nibbles with the high half's, so that one f32
//     partial (64 registers) is live at a time: at each (group, half) end it
//     is multiplied by the group's column scales and added to the f32
//     accumulator, low group g before high group g;
//   * each block's 128 tokens reuse every unpacked code; a stage's unpack
//     overlaps the previous stage's products; blocks walk the output in
//     bands of 8 token blocks, so that those in flight share their tiles in
//     L2.
// What bounds it now: one stage's products in flight a group (the A
// fragments of the next stage are written while they run, and a second
// stage in flight makes ptxas serialise the wgmmas), the partial's scale
// and add at each group's end, and the 168 registers a thread of a
// 384-thread block has, which leave no room for a second partial.

// At decode (M < 64 rows of bf16 activations) a third kernel takes the call
// (int4_mm_decode_kernel, chosen by _plan from M and the same operand
// checks as the prefill kernel). It is bound by the packed bytes, so its
// design keeps as many of them in flight as it can and reads each once:
//   * the prefill kernel's roles: two consumer warp groups of 64 output
//     columns each run wgmma with the weights as A unpacked from registers
//     (wg_unpack); the M tokens, rounded up to N = 8, 16, 32 or 64, are B
//     (wgmma m64nNk16), read from the ring;
//   * one producer warp keeps a ring of 4 stages in flight by TMA, each one
//     packed tile of [64 rows x 128 columns] for BOTH halves (its low
//     nibbles meet the low half's activation chunk, its high nibbles the
//     high half's: each packed byte crosses HBM once, unlike the prefill
//     ring, which walks a tile once a half), the two N x 64 activation
//     chunks (from L2: the activations are a few hundred KB), and, in a
//     group's first stage, the group's 2 x 128 column scales, so no strided
//     scale load sits in the mainloop;
//   * N = 16 needs 8 accumulators a thread a partial, so two blocks share
//     an SM up to 16 tokens (8 stages each, 128 KB of codes in flight an
//     SM); one block an SM past 16 tokens;
//   * a stage's bytes are unpacked while the stage before it is still in
//     the tensor cores (two sets of A fragments in turn); the consumers
//     wait for all of a group's products only at its last stage. At 8 and
//     16 tokens ptxas serialises the products for want of registers under
//     two blocks an SM (its C7512 note); one block an SM keeps them
//     asynchronous but measured slower (PERF.md). What bounds it: the
//     consumers' instructions a packed byte (the unpack and the products'
//     issue), not the ring, which alone streams the packed bytes faster;
//   * a low and a high partial a group (each the N / 2 registers of a
//     wgmma), multiplied by their scales and added low before high at the
//     group's end: the plain version's two roundings, in its order;
//   * where the column blocks leave SMs idle, blocks take splits of whole
//     groups (_plan: one wave of block slots); each writes its partial to a
//     workspace, then the last block of a column tile to finish (a counter
//     a column tile: every partial fenced before one atomic a block, the
//     counter reset by that block for the next launch, so no launch zeroes
//     it and the blocks' order does not matter) adds the partials in split
//     order, as reduce_splits_kernel does. One launch a call; the wrapper
//     keeps the workspace a device and stream.

// Fragment bookkeeping of the first kernel: a warp owns 16 rows x 32
// columns as four n8 tiles. Tile j's mma column n stands for output column
// 4 * n + j of the warp's 32, so each lane reads one 32-bit word of four
// neighbouring bytes from shared memory and gets one B element of each of
// the four tiles from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"

namespace {

constexpr int TK = 64;        // packed rows a tile (64 code rows of each half)
constexpr int BN = 128;       // output columns a block
constexpr int LDW = BN + 16;  // packed tile row stride (bytes; 16-byte rows)
constexpr int LDXH = TK + 8;  // bf16 x tile row stride (elements)
constexpr int LDXF = TK + 4;  // f32 x tile row stride (elements)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// sign-extended low / high nibble of byte b of a 32-bit word
__device__ __forceinline__ int lo_nib(uint32_t w, int b) {
  return (int)(w << (28 - 8 * b)) >> 28;
}
__device__ __forceinline__ int hi_nib(uint32_t w, int b) {
  return (int)(w << (24 - 8 * b)) >> 28;
}

__device__ __forceinline__ uint32_t pack2(int a, int b) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)a, (float)b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One tile of packed rows [k0, k0 + TK) x columns [n0, n0 + BN) into shared
// memory, plus the matching x columns of both halves. VEC: 16-byte cp.async
// copies (OUT % 16 == 0, H % 8 == 0 for bf16 x, H % 4 == 0 for f32 x, aligned
// bases); otherwise element loads. Out-of-range bytes and x entries are 0.
template <typename XT, bool VEC>
__device__ __forceinline__ void load_tile(
    const int8_t* __restrict__ w, const XT* __restrict__ x, unsigned char* sw,
    XT* sxl, XT* sxh, int M, int H, int OUT, int m0, int BM, int k0, int n0,
    int tid, int nthreads) {
  constexpr int LDX = sizeof(XT) == 2 ? LDXH : LDXF;
  if constexpr (VEC) {
    for (int v = tid; v < TK * (BN / 16); v += nthreads) {
      const int r = v / (BN / 16), c = (v % (BN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + c;
      unsigned char* dst = sw + r * LDW + c;
      if (gk < H && gn < OUT)
        cp_async16(dst, w + (size_t)gk * OUT + gn);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    constexpr int EPV = 16 / sizeof(XT);  // x elements a 16-byte copy
    for (int v = tid; v < 2 * BM * (TK / EPV); v += nthreads) {
      const int half = v / (BM * (TK / EPV)), rem = v % (BM * (TK / EPV));
      const int r = rem / (TK / EPV), c = (rem % (TK / EPV)) * EPV;
      const int gm = m0 + r, gk = k0 + c;
      XT* dst = (half ? sxh : sxl) + r * LDX + c;
      if (gm < M && gk < H)
        cp_async16(dst, x + (size_t)gm * (2 * H) + (half ? H : 0) + gk);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int v = tid; v < TK * BN; v += nthreads) {
      const int r = v / BN, c = v % BN;
      const int gk = k0 + r, gn = n0 + c;
      sw[r * LDW + c] =
          (gk < H && gn < OUT) ? (unsigned char)w[(size_t)gk * OUT + gn] : 0;
    }
    for (int v = tid; v < 2 * BM * TK; v += nthreads) {
      const int half = v / (BM * TK), rem = v % (BM * TK);
      const int r = rem / TK, c = rem % TK;
      const int gm = m0 + r, gk = k0 + c;
      XT val;
      if (gm < M && gk < H)
        val = x[(size_t)gm * (2 * H) + (half ? H : 0) + gk];
      else
        val = XT(0.0f);
      (half ? sxh : sxl)[r * LDX + c] = val;
    }
  }
}

// ---- bf16 x on the tensor cores ----------------------------------------------

// Partial sums of the current group: pl (low half), ph (high half), four
// n8 tiles of four floats each; flushed into acc with the group's scales.
__device__ __forceinline__ void flush(float (*acc)[4], float (*pl)[4],
                                      float (*ph)[4],
                                      const float* __restrict__ scale, int g,
                                      int ng_half, int OUT, int col0, int tig) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 4 * (2 * tig + e) + j;
      const bool in = col < OUT;
      const float sl = in ? scale[(size_t)g * OUT + col] : 0.0f;
      const float sh = in ? scale[(size_t)(ng_half + g) * OUT + col] : 0.0f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 2 * rr + e;  // c0, c1 row gid; c2, c3 row gid + 8
        acc[j][i] = __fadd_rn(acc[j][i], __fmul_rn(pl[j][i], sl));
        acc[j][i] = __fadd_rn(acc[j][i], __fmul_rn(ph[j][i], sh));
        pl[j][i] = 0.0f;
        ph[j][i] = 0.0f;
      }
    }
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(BM * 8) int4_mm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int M, int H,
    int OUT, int group, int rows_per_split) {
  constexpr int NT = BM * 8;  // (BM / 16) x 4 warps
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int STAGE = TK * LDW + 2 * BM * LDXH * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int row_begin = blockIdx.z * rows_per_split;
  const int row_end = min(H, row_begin + rows_per_split);
  const int ng_half = H / group;
  const int col0 = n0 + wn * 32;

  float acc[4][4], pl[4][4], ph[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = pl[j][i] = ph[j][i] = 0.0f;

  auto stage_ptrs = [&](int s, unsigned char*& sw, __nv_bfloat16*& sxl,
                        __nv_bfloat16*& sxh) {
    sw = smem + s * STAGE;
    sxl = reinterpret_cast<__nv_bfloat16*>(sw + TK * LDW);
    sxh = sxl + BM * LDXH;
  };

  const int n_tiles = (row_end - row_begin + TK - 1) / TK;
  {
    unsigned char* sw; __nv_bfloat16 *sxl, *sxh;
    stage_ptrs(0, sw, sxl, sxh);
    load_tile<__nv_bfloat16, VEC>(w, x, sw, sxl, sxh, M, H, OUT, m0, BM,
                                  row_begin, n0, tid, NT);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      unsigned char* sw; __nv_bfloat16 *sxl, *sxh;
      stage_ptrs((t + 1) & 1, sw, sxl, sxh);
      load_tile<__nv_bfloat16, VEC>(w, x, sw, sxl, sxh, M, H, OUT, m0, BM,
                                    row_begin + (t + 1) * TK, n0, tid, NT);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    unsigned char* sw; __nv_bfloat16 *sxl, *sxh;
    stage_ptrs(t & 1, sw, sxl, sxh);
    const int k0 = row_begin + t * TK;
    for (int ks = 0; ks < TK; ks += 16) {
      const int kg = k0 + ks;  // first packed row of this k-step
      if (kg >= row_end) break;
      // x fragments of both halves (rows wm*16 + gid, + 8)
      uint32_t al[4], ah[4];
      {
        const int r0 = (wm * 16 + gid) * LDXH + ks + 2 * tig;
        const int r1 = r0 + 8 * LDXH;
        al[0] = *reinterpret_cast<const uint32_t*>(sxl + r0);
        al[1] = *reinterpret_cast<const uint32_t*>(sxl + r1);
        al[2] = *reinterpret_cast<const uint32_t*>(sxl + r0 + 8);
        al[3] = *reinterpret_cast<const uint32_t*>(sxl + r1 + 8);
        ah[0] = *reinterpret_cast<const uint32_t*>(sxh + r0);
        ah[1] = *reinterpret_cast<const uint32_t*>(sxh + r1);
        ah[2] = *reinterpret_cast<const uint32_t*>(sxh + r0 + 8);
        ah[3] = *reinterpret_cast<const uint32_t*>(sxh + r1 + 8);
      }
      // the four packed rows this lane feeds: 2 tig, 2 tig + 1, + 8, + 9
      const unsigned char* wb = sw + wn * 32 + 4 * gid;
      uint32_t wr[4];
      wr[0] = *reinterpret_cast<const uint32_t*>(wb + (ks + 2 * tig) * LDW);
      wr[1] = *reinterpret_cast<const uint32_t*>(wb + (ks + 2 * tig + 1) * LDW);
      wr[2] = *reinterpret_cast<const uint32_t*>(wb + (ks + 2 * tig + 8) * LDW);
      wr[3] = *reinterpret_cast<const uint32_t*>(wb + (ks + 2 * tig + 9) * LDW);
      const int kend = min(kg + 16, row_end);
      // segments of this k-step that belong to one group each (one segment
      // when group % 16 == 0)
      for (int s0 = kg; s0 < kend;) {
        const int g = s0 / group;
        const int s1 = min((g + 1) * group, kend);
        // rows of the k-step outside [s0, s1) contribute zero
        const int rk[4] = {2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9};
        uint32_t m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = kg + rk[q];
          m[q] = (k >= s0 && k < s1) ? wr[q] : 0u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bl0 = pack2(lo_nib(m[0], j), lo_nib(m[1], j));
          const uint32_t bl1 = pack2(lo_nib(m[2], j), lo_nib(m[3], j));
          const uint32_t bh0 = pack2(hi_nib(m[0], j), hi_nib(m[1], j));
          const uint32_t bh1 = pack2(hi_nib(m[2], j), hi_nib(m[3], j));
          mma16816(pl[j], al, bl0, bl1);
          mma16816(ph[j], ah, bh0, bh1);
        }
        if (s1 == (g + 1) * group || s1 == row_end)
          flush(acc, pl, ph, scale, g, ng_half, OUT, col0, tig);
        s0 = s1;
      }
    }
    __syncthreads();
  }
  cp_async_wait_0();

  float* o = out + (size_t)blockIdx.z * M * OUT;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm * 16 + gid + (i >= 2 ? 8 : 0);
      const int col = col0 + 4 * (2 * tig + (i & 1)) + j;
      if (row < M && col < OUT) o[(size_t)row * OUT + col] = acc[j][i];
    }
}

// ---- f32 x, plain FMA ------------------------------------------------------

constexpr int FBM = 16;  // rows a block; one output column a thread

template <bool VEC>
__global__ void __launch_bounds__(BN) int4_mm_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int M, int H,
    int OUT, int group, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int STAGE = TK * LDW + 2 * FBM * LDXF * 4;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * FBM;
  const int row_begin = blockIdx.z * rows_per_split;
  const int row_end = min(H, row_begin + rows_per_split);
  const int ng_half = H / group;
  const int col = n0 + tid;
  float acc[FBM], pl[FBM], ph[FBM];
#pragma unroll
  for (int i = 0; i < FBM; ++i) acc[i] = pl[i] = ph[i] = 0.0f;

  const int n_tiles = (row_end - row_begin + TK - 1) / TK;
  load_tile<float, VEC>(w, x, smem, reinterpret_cast<float*>(smem + TK * LDW),
                        reinterpret_cast<float*>(smem + TK * LDW) + FBM * LDXF,
                        M, H, OUT, m0, FBM, row_begin, n0, tid, BN);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      unsigned char* sw = smem + ((t + 1) & 1) * STAGE;
      float* sxl = reinterpret_cast<float*>(sw + TK * LDW);
      load_tile<float, VEC>(w, x, sw, sxl, sxl + FBM * LDXF, M, H, OUT, m0,
                            FBM, row_begin + (t + 1) * TK, n0, tid, BN);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const unsigned char* sw = smem + (t & 1) * STAGE;
    const float* sxl = reinterpret_cast<const float*>(sw + TK * LDW);
    const float* sxh = sxl + FBM * LDXF;
    const int k0 = row_begin + t * TK;
    const int kn = min(TK, row_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const int b = (int)(int8_t)sw[kk * LDW + tid];
      const float lo = (float)((int)((unsigned)b << 28) >> 28);
      const float hi = (float)(b >> 4);
#pragma unroll
      for (int i = 0; i < FBM; ++i) {
        pl[i] = fmaf(sxl[i * LDXF + kk], lo, pl[i]);
        ph[i] = fmaf(sxh[i * LDXF + kk], hi, ph[i]);
      }
      const int k = k0 + kk;
      if ((k + 1) % group == 0 || k + 1 == row_end) {
        const int g = k / group;
        const bool in = col < OUT;
        const float sl = in ? scale[(size_t)g * OUT + col] : 0.0f;
        const float sh = in ? scale[(size_t)(ng_half + g) * OUT + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < FBM; ++i) {
          acc[i] = __fadd_rn(acc[i], __fmul_rn(pl[i], sl));
          acc[i] = __fadd_rn(acc[i], __fmul_rn(ph[i], sh));
          pl[i] = ph[i] = 0.0f;
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_0();
  float* o = out + (size_t)blockIdx.z * M * OUT;
  if (col < OUT)
#pragma unroll
    for (int i = 0; i < FBM; ++i)
      if (m0 + i < M) o[(size_t)(m0 + i) * OUT + col] = acc[i];
}

// y = sum of the splits' partial sums, in split order
__global__ void reduce_splits_kernel(const float* __restrict__ ws,
                                     float* __restrict__ y, long long n,
                                     int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, ws[(size_t)p * n + i]);
    y[i] = s;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int BM, bool VEC>
cudaError_t launch_bf16(const void* x, const void* w, const float* scale,
                        float* out, int M, int H, int OUT, int group,
                        int splits, int rows_per_split, cudaStream_t st) {
  constexpr int smem = 2 * (TK * LDW + 2 * BM * LDXH * 2);
  cudaError_t e = set_smem(int4_mm_bf16_kernel<BM, VEC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((OUT + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int4_mm_bf16_kernel<BM, VEC><<<grid, BM * 8, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      scale, out, M, H, OUT, group, rows_per_split);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_f32(const void* x, const void* w, const float* scale,
                       float* out, int M, int H, int OUT, int group,
                       int splits, int rows_per_split, cudaStream_t st) {
  constexpr int smem = 2 * (TK * LDW + 2 * FBM * LDXF * 4);
  cudaError_t e = set_smem(int4_mm_f32_kernel<VEC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((OUT + BN - 1) / BN, (M + FBM - 1) / FBM, splits);
  int4_mm_f32_kernel<VEC><<<grid, BN, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w), scale, out,
      M, H, OUT, group, rows_per_split);
  return cudaGetLastError();
}

// ---- prefill: wgmma fed by a TMA ring ---------------------------------------

constexpr int WG_BM = 128;                   // tokens a block (wgmma N)
constexpr int WG_BN = 128;                   // output columns a block
constexpr int WG_TK = 64;                    // packed rows a stage
constexpr int WG_STAGES = 8;
constexpr int WG_X_TILE = WG_BM * 128;       // bytes: 128 tokens x 64 bf16
constexpr int WG_W_TILE = WG_TK * WG_BN;     // bytes: 64 rows x 128 columns
constexpr int WG_STAGE = WG_X_TILE + WG_W_TILE;
constexpr int WG_THREADS = 384;              // 2 consumer groups + producer
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8 + 1024;
// blocks walk the output in bands of this many token blocks, the column
// blocks of a band in turn, so that the blocks in flight share their
// activation rows and packed columns in L2
constexpr int WG_BAND = 8;

// byte (r, c) of a [rows x 128] byte tile in the 128-byte swizzle
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

using codes::nibbles_bf16x2;  // (nibble ^ 8) under 128, minus 136: exact

// The A fragments of one stage (four k16 steps) from its byte tile: this
// thread's rows are output columns c and c + 1 of the block (neighbouring
// bytes), its k the fragment's 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9.
__device__ __forceinline__ void wg_unpack(uint32_t (&a)[4][4],
                                          const unsigned char* wt, int half,
                                          int c, int tig) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = 16 * kk + 2 * tig;
    const uint32_t u0 = *reinterpret_cast<const uint16_t*>(wt + swz128(r, c));
    const uint32_t u1 = *reinterpret_cast<const uint16_t*>(wt + swz128(r + 1, c));
    const uint32_t u2 = *reinterpret_cast<const uint16_t*>(wt + swz128(r + 8, c));
    const uint32_t u3 = *reinterpret_cast<const uint16_t*>(wt + swz128(r + 9, c));
    // byte 0: column c (row gid), byte 1: column c + 1 (row gid + 8); row
    // k in the low 16 bits, k + 1 in the high
    const uint32_t w01 = (u0 | (u1 << 16)) >> (4 * half);
    const uint32_t w89 = (u2 | (u3 << 16)) >> (4 * half);
    a[kk][0] = nibbles_bf16x2(w01);
    a[kk][1] = nibbles_bf16x2(w01 >> 8);
    a[kk][2] = nibbles_bf16x2(w89);
    a[kk][3] = nibbles_bf16x2(w89 >> 8);
  }
}

// Stages [rel, upto) are complete: their slots go back to the ring (one
// arrival a consumer warp).
__device__ __forceinline__ void wg_release(int& rel, int upto,
                                           uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int j = rel; j < upto; ++j) hopper::mbar_arrive(&empty[j % WG_STAGES]);
  rel = max(rel, upto);
}

// A complete (group, half) partial times the group's column scales `sc`,
// added to the accumulator (two roundings, as the plain version).
__device__ __forceinline__ void wg_flush(const float (&part)[64],
                                         float (&acc)[64], float2 sc) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j + 0] = __fadd_rn(acc[4 * j + 0], __fmul_rn(part[4 * j + 0], sc.x));
    acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1], __fmul_rn(part[4 * j + 1], sc.x));
    acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2], __fmul_rn(part[4 * j + 2], sc.y));
    acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], __fmul_rn(part[4 * j + 3], sc.y));
  }
}

// Stage i: its bytes are unpacked while stage i - 1's products run; then,
// i - 1 done, its slot goes back to the ring and, at the start of a (group,
// half), the last one's partial is scaled and added and the new group's
// column scales are loaded (a stage or more before their use); then i's
// products are issued.
__device__ __forceinline__ void wg_step(
    int i, uint32_t (&a)[4][4], float (&part)[64], float (&acc)[64],
    float2& sc, int& rel, unsigned char* smem, uint64_t* full,
    uint64_t* empty, const float* __restrict__ scale, int c, int col,
    int tig, int OUT, int ng, int tpg) {
  const int s = i % WG_STAGES;
  const unsigned char* st = smem + s * WG_STAGE;
  hopper::mbar_wait(&full[s], (i / WG_STAGES) & 1);
  wg_unpack(a, st + WG_X_TILE, (i / tpg) & 1, c, tig);
  hopper::wgmma_wait<0>();
  hopper::fence_accumulators<64>(part);
  wg_release(rel, i, empty);
  const bool cont = i % tpg > 0;
  if (!cont && i > 0) wg_flush(part, acc, sc);
  if (!cont && col < OUT) {
    const int gg = ((i / tpg) & 1) * ng + i / (2 * tpg);
    sc = __ldg(reinterpret_cast<const float2*>(scale + (size_t)gg * OUT + col));
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_m64n128k16_rs(part, a[kk], hopper::desc_sw128(st + 32 * kk),
                                cont || kk > 0);
  hopper::wgmma_commit();
}

// One block a (column block, token block), in bands (WG_BAND); block =
// consumer warp groups 0 and 1 (output columns n0 + 64 wg .. + 64) and a
// producer warp whose first thread issues the TMA loads. The ring's sequence: for each group g of a
// half, for the low half then the high half, the group's stages of 64 packed
// rows.
__global__ void __launch_bounds__(WG_THREADS, 1) int4_mm_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
    float* __restrict__ out, int M, int H, int OUT, int group) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring on a 1024-byte boundary, as an offset from the shared array
  // (so that the compiler keeps shared-memory loads and stores)
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * WG_STAGE);
  uint64_t* empty = full + WG_STAGES;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // block -> (column block, token block), band by band
  const int n_cols = (OUT + WG_BN - 1) / WG_BN, n_toks = (M + WG_BM - 1) / WG_BM;
  const int band = blockIdx.x / (WG_BAND * n_cols);
  const int band_rows = min(WG_BAND, n_toks - band * WG_BAND);
  const int in_band = blockIdx.x - band * WG_BAND * n_cols;
  const int n0 = (in_band / band_rows) * WG_BN;
  const int m0 = (band * WG_BAND + in_band % band_rows) * WG_BM;
  const int tpg = group / WG_TK;             // stages of one (group, half)
  const int total = 2 * (H / WG_TK);         // stages of the block

  if (wg == 2) {  // ---- producer ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::prefetch_tmap(&xmap);
      hopper::prefetch_tmap(&wmap);
      for (int i = 0; i < total; ++i) {
        const int s = i % WG_STAGES;
        const uint32_t ph = (i / WG_STAGES) & 1;
        const int t = i % tpg, half = (i / tpg) & 1, g = i / (2 * tpg);
        const int krow = g * group + t * WG_TK;
        unsigned char* st = smem + s * WG_STAGE;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], WG_STAGE);
        hopper::tma_load_2d(st, &xmap, &full[s], half * H + krow, m0);
        hopper::tma_load_2d(st + WG_X_TILE, &wmap, &full[s], n0, krow);
      }
    }
  } else {  // ---- consumers ----
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    // A row 16 warp + gid (+ 8) of this group's m64 tile is output column
    // c (c + 1) of the block: each thread's two rows are neighbouring bytes
    const int c = 64 * wg + 16 * warp + 2 * gid;
    const int col = n0 + c;
    const int ng = H / group;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;   // part: the first
    // product of each (group, half) overwrites it
    uint32_t a0[4][4], a1[4][4];   // two stages' A fragments, in turn
    float2 sc = make_float2(0.0f, 0.0f);   // the current group's scales
    int rel = 0;                           // stages not yet released
    for (int i = 0; i < total; i += 2) {   // total is even
      wg_step(i, a0, part, acc, sc, rel, smem, full, empty, scale, c, col,
              tig, OUT, ng, tpg);
      wg_step(i + 1, a1, part, acc, sc, rel, smem, full, empty, scale, c,
              col, tig, OUT, ng, tpg);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_accumulators<64>(part);
    wg_release(rel, total, empty);
    wg_flush(part, acc, sc);

    // accumulator j: token 8 (j / 4) + 2 tig + (j & 1), column c + (j & 2) / 2
    if (col < OUT) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int tok = m0 + 8 * j + 2 * tig;
        if (tok < M)
          *reinterpret_cast<float2*>(out + (size_t)tok * OUT + col) =
              make_float2(acc[4 * j + 0], acc[4 * j + 2]);
        if (tok + 1 < M)
          *reinterpret_cast<float2*>(out + (size_t)(tok + 1) * OUT + col) =
              make_float2(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
}

cudaError_t launch_wgmma(const void* x, const void* w, const float* scale,
                         float* out, int M, int H, int OUT, int group,
                         cudaStream_t st) {
  CUtensorMap xmap, wmap;
  cudaError_t e = hopper_host::make_tmap_2d(
      &xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, 2 * H, 2 * H, WG_BM,
      64);
  if (e != cudaSuccess) return e;
  e = hopper_host::make_tmap_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, H,
                                OUT, OUT, WG_TK, WG_BN);
  if (e != cudaSuccess) return e;
  e = set_smem(int4_mm_wgmma_kernel, WG_SMEM);
  if (e != cudaSuccess) return e;
  const int grid = ((OUT + WG_BN - 1) / WG_BN) * ((M + WG_BM - 1) / WG_BM);
  int4_mm_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(xmap, wmap, scale,
                                                          out, M, H, OUT,
                                                          group);
  return cudaGetLastError();
}

// ---- decode: wgmma fed by a TMA ring, splits summed in the launch ---------

constexpr int DC_BN = 128;                  // output columns a block
constexpr int DC_TK = 64;                   // packed rows a stage
constexpr int DC_STAGES = 8;
constexpr int DC_W_TILE = DC_TK * DC_BN;    // bytes: 64 packed rows x 128 columns
constexpr int DC_S_TILE = 2 * DC_BN * 4;    // a group's low and high column scales
constexpr int DC_THREADS = 288;             // 2 consumer groups + a producer warp

// bytes of one half's activation chunk: N tokens x 64 bf16 (128-byte rows)
__host__ __device__ constexpr int dc_x_tile(int n) { return n * 128; }
// a stage: the packed tile, the low and the high half's activation chunks
// and, in a group's first stage, its scales; every part 1024-aligned
__host__ __device__ constexpr int dc_stage(int n) {
  return DC_W_TILE + 2 * dc_x_tile(n) + DC_S_TILE;
}
__host__ __device__ constexpr int dc_smem(int n) {
  return DC_STAGES * dc_stage(n) + 2 * DC_STAGES * 8 + 1024;
}

// Each (group, half) partial times its column scales (sl: low, sh: high;
// .x column c, .y column c + 1), added to the accumulator low before high
// (two roundings each, as the plain version).
template <int NA>
__device__ __forceinline__ void dc_flush(float (&acc)[NA], const float (&plo)[NA],
                                         const float (&phi)[NA], float2 sl,
                                         float2 sh) {
#pragma unroll
  for (int e = 0; e < NA; ++e) {
    const bool hi_col = e & 2;
    acc[e] = __fadd_rn(acc[e], __fmul_rn(plo[e], hi_col ? sl.y : sl.x));
    acc[e] = __fadd_rn(acc[e], __fmul_rn(phi[e], hi_col ? sh.y : sh.x));
  }
}

// The A fragments of one decode stage, both halves, from its packed tile: a
// thread's bytes are the column pair c, c + 1 (one 16-bit word) at rows 16
// kk + 2 tig + {0, 1, 8, 9}; in the 128-byte swizzle the rows of one parity
// share their chunk, so two base pointers and immediate offsets reach all
// 16 words, and each pair of words feeds the low and the high half.
__device__ __forceinline__ void dc_unpack(uint32_t (&alo)[4][4],
                                          uint32_t (&ahi)[4][4],
                                          const unsigned char* even,
                                          const unsigned char* odd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t u0 = *reinterpret_cast<const uint16_t*>(even + 2048 * kk);
    const uint32_t u1 = *reinterpret_cast<const uint16_t*>(odd + 2048 * kk);
    const uint32_t u2 = *reinterpret_cast<const uint16_t*>(even + 2048 * kk + 1024);
    const uint32_t u3 = *reinterpret_cast<const uint16_t*>(odd + 2048 * kk + 1024);
    // byte 0: column c (row gid), byte 1: column c + 1 (row gid + 8); row
    // k in the low 16 bits, k + 1 in the high
    const uint32_t w01 = __byte_perm(u0, u1, 0x5410);
    const uint32_t w89 = __byte_perm(u2, u3, 0x5410);
    alo[kk][0] = nibbles_bf16x2(w01);
    alo[kk][1] = nibbles_bf16x2(w01 >> 8);
    alo[kk][2] = nibbles_bf16x2(w89);
    alo[kk][3] = nibbles_bf16x2(w89 >> 8);
    ahi[kk][0] = nibbles_bf16x2(w01 >> 4);
    ahi[kk][1] = nibbles_bf16x2(w01 >> 12);
    ahi[kk][2] = nibbles_bf16x2(w89 >> 4);
    ahi[kk][3] = nibbles_bf16x2(w89 >> 12);
  }
}

// The decode kernel: grid (column blocks of 128, splits of rows_per_split
// packed rows, whole groups each). Consumer warp groups 0 and 1 own output
// columns n0 + 64 wg .. + 64 as wgmma's M (the weights, A, unpacked from
// registers as the prefill kernel does); the N tokens are B, read from the
// ring. A stage carries one packed tile for both halves: its low nibbles
// meet the low half's activations and its high nibbles the high half's, so
// each packed byte crosses device memory once. With splits, each block
// writes its partial to ws and the last block of a column tile to finish
// (a counter a column tile, reset by that block) sums the partials in split
// order into y, in the same launch.
template <int N>
__global__ void __launch_bounds__(DC_THREADS, N <= 16 ? 2 : 1)
    int4_mm_decode_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap smap,
                          float* __restrict__ out, float* __restrict__ ws,
                          unsigned* __restrict__ counters, int M, int H,
                          int OUT, int group, int rows_per_split) {
  constexpr int XT = dc_x_tile(N), STAGE = dc_stage(N), NA = N / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int is_last;
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DC_STAGES * STAGE);
  uint64_t* empty = full + DC_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DC_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int n0 = blockIdx.x * DC_BN, splits = gridDim.y;
  const int row_begin = blockIdx.y * rows_per_split;
  const int total = (min(H, row_begin + rows_per_split) - row_begin) / DC_TK;
  const int ng = H / group;

  if (threadIdx.x >= 256) {  // ---- producer warp ----
    if (threadIdx.x == 256) {
      hopper::prefetch_tmap(&xmap);
      hopper::prefetch_tmap(&wmap);
      hopper::prefetch_tmap(&smap);
      for (int i = 0; i < total; ++i) {
        const int s = i % DC_STAGES, krow = row_begin + i * DC_TK;
        const bool first = krow % group == 0;
        unsigned char* st = smem + s * STAGE;
        hopper::mbar_wait(&empty[s], ((i / DC_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(
            &full[s], DC_W_TILE + 2 * XT + (first ? DC_S_TILE : 0));
        hopper::tma_load_2d(st, &wmap, &full[s], n0, krow);
        hopper::tma_load_2d(st + DC_W_TILE, &xmap, &full[s], krow, 0);
        hopper::tma_load_2d(st + DC_W_TILE + XT, &xmap, &full[s], H + krow, 0);
        if (first) {
          const int g = krow / group;
          float* sc = reinterpret_cast<float*>(st + DC_W_TILE + 2 * XT);
          hopper::tma_load_2d(sc, &smap, &full[s], n0, g);
          hopper::tma_load_2d(sc + DC_BN, &smap, &full[s], n0, ng + g);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // A row 16 warp + gid (+ 8) of this group's m64 tile is output column c
  // (c + 1) of the block; accumulator 4 j + v holds token 8 j + 2 tig + (v
  // & 1) of column c + (v >> 1)
  const int c = 64 * wg + 16 * warp + 2 * gid;
  const int col = n0 + c;
  // this thread's bytes of a packed tile, rows 2 tig (+ 8, + 16 kk) and
  // 2 tig + 1 (+ 8, + 16 kk)
  const int even = 256 * tig + ((((c >> 4) ^ (2 * tig)) & 7) << 4) + (c & 15);
  const int odd = 256 * tig + 128 + ((((c >> 4) ^ (2 * tig + 1)) & 7) << 4) + (c & 15);
  float acc[NA], plo[NA], phi[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = plo[e] = phi[e] = 0.0f;
  float2 sl = make_float2(0.0f, 0.0f), sh = sl;
  // Stage i: its bytes are unpacked (low and high nibbles) while stage i -
  // 1's products run; its products are issued, low and high in turn; at a
  // group's last stage the partials are complete (wait for all) and are
  // scaled and added, otherwise only stage i - 1 must be done (its slot
  // goes back to the ring, its fragments may be written again).
  int rel = 0;   // stages not yet released
  auto release = [&](int upto) {
    __syncwarp();
    if (lane == 0)
      for (int j = rel; j < upto; ++j) hopper::mbar_arrive(&empty[j % DC_STAGES]);
    rel = upto;
  };
  auto step = [&](int i, uint32_t (&alo)[4][4], uint32_t (&ahi)[4][4]) {
    const int s = i % DC_STAGES, krow = row_begin + i * DC_TK;
    const bool cont = krow % group != 0;
    const unsigned char* st = smem + s * STAGE;
    hopper::mbar_wait(&full[s], (i / DC_STAGES) & 1);
    dc_unpack(alo, ahi, st + even, st + odd);
    if (!cont) {  // the group's scales ride in its first stage
      const float* sc = reinterpret_cast<const float*>(st + DC_W_TILE + 2 * XT);
      sl = *reinterpret_cast<const float2*>(sc + c);
      sh = *reinterpret_cast<const float2*>(sc + DC_BN + c);
    }
    // the k16 steps' descriptors: 32 bytes (2 in the address field) apart
    const uint64_t dlo = hopper::desc_sw128(st + DC_W_TILE);
    const uint64_t dhi = hopper::desc_sw128(st + DC_W_TILE + XT);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_m64nk16_rs<N>(plo, alo[kk], dlo + 2 * kk, cont || kk > 0);
      hopper::wgmma_m64nk16_rs<N>(phi, ahi[kk], dhi + 2 * kk, cont || kk > 0);
    }
    hopper::wgmma_commit();
    if ((krow + DC_TK) % group == 0) {
      hopper::wgmma_wait<0>();
      hopper::fence_accumulators<NA>(plo);
      hopper::fence_accumulators<NA>(phi);
      release(i + 1);
      dc_flush<NA>(acc, plo, phi, sl, sh);
    } else {
      hopper::wgmma_wait<1>();
      release(i);
    }
  };
  uint32_t alo0[4][4], ahi0[4][4], alo1[4][4], ahi1[4][4];
  for (int i = 0; i < total; i += 2) {
    step(i, alo0, ahi0);
    if (i + 1 < total) step(i + 1, alo1, ahi1);
  }
  // (every group ended in a full wait; this one, on every path, lets ptxas
  // see that no product is in flight in the code below, whose branches
  // diverge, and so keep the products above asynchronous)
  hopper::wgmma_wait<0>();
  hopper::fence_accumulators<NA>(acc);

  float* dst = splits > 1 ? ws + (size_t)blockIdx.y * M * OUT : out;
  if (col < OUT) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int tok = 8 * j + 2 * tig;
      if (tok < M)
        *reinterpret_cast<float2*>(dst + (size_t)tok * OUT + col) =
            make_float2(acc[4 * j + 0], acc[4 * j + 2]);
      if (tok + 1 < M)
        *reinterpret_cast<float2*>(dst + (size_t)(tok + 1) * OUT + col) =
            make_float2(acc[4 * j + 1], acc[4 * j + 3]);
    }
  }
  if (splits == 1) return;
  // the split sum: the block's partial stored (a barrier), then one fenced
  // arrival a block (the fence is cumulative over what the barrier
  // ordered); the last block of the column tile adds the partials in split
  // order (the order of reduce_splits_kernel), reading them from L2, and
  // resets the counter for the next launch. The blocks' order does not
  // matter.
  hopper::named_barrier(1, 256);
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(&counters[blockIdx.x], 1u) == (unsigned)splits - 1;
    if (is_last) __threadfence();
  }
  hopper::named_barrier(1, 256);
  if (!is_last) return;
  // four columns a thread, the partials of 8 splits loaded at once
  const size_t plane = (size_t)M * OUT;
  for (int u = threadIdx.x; u < M * (DC_BN / 4); u += 256) {
    const int tok = u / (DC_BN / 4), cc = n0 + 4 * (u % (DC_BN / 4));
    if (cc >= OUT) continue;
    const float* src = ws + (size_t)tok * OUT + cc;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(src));
    for (int p0 = 1; p0 < splits; p0 += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (p0 + j < splits)
          v[j] = __ldcg(reinterpret_cast<const float4*>(src + (p0 + j) * plane));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (p0 + j < splits) {
          sum.x = __fadd_rn(sum.x, v[j].x);
          sum.y = __fadd_rn(sum.y, v[j].y);
          sum.z = __fadd_rn(sum.z, v[j].z);
          sum.w = __fadd_rn(sum.w, v[j].w);
        }
    }
    *reinterpret_cast<float4*>(out + (size_t)tok * OUT + cc) = sum;
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0u;
}

template <int N>
cudaError_t launch_decode(const void* x, const void* w, const float* scale,
                          float* out, float* ws, unsigned* counters, int M,
                          int H, int OUT, int group, int splits,
                          int rows_per_split, cudaStream_t st) {
  CUtensorMap xmap, wmap, smap;
  cudaError_t e = hopper_host::make_tmap_2d(
      &xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, 2 * H, 2 * H, N, 64);
  if (e != cudaSuccess) return e;
  e = hopper_host::make_tmap_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, H,
                                OUT, OUT, DC_TK, DC_BN);
  if (e != cudaSuccess) return e;
  e = hopper_host::make_tmap_2d(&smap, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                4, 2 * H / group, OUT, OUT, 1, DC_BN, false);
  if (e != cudaSuccess) return e;
  e = set_smem(int4_mm_decode_kernel<N>, dc_smem(N));
  if (e != cudaSuccess) return e;
  const dim3 grid((OUT + DC_BN - 1) / DC_BN, splits);
  int4_mm_decode_kernel<N><<<grid, DC_THREADS, dc_smem(N), st>>>(
      xmap, wmap, smap, out, ws, counters, M, H, OUT, group, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. x [M, IN] (bf16 when x_is_bf16, else f32); w [IN/2,
// OUT] int8; scale [IN/group, OUT] f32; y [M, OUT] f32. With splits > 1, ws
// is f32 [splits, M, OUT] scratch for the partial sums of rows_per_split
// packed rows each (a multiple of 64); vec asks for 16-byte copies (the
// caller has checked alignment). Returns the CUDA error code (0 on success).
extern "C" int int4_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* y, void* ws, int M,
                                  int IN, int OUT, int group, int splits,
                                  int rows_per_split, int x_is_bf16, int vec,
                                  void* stream) {
  const int H = IN / 2;
  if (M < 1 || IN < 2 || IN % 2 || OUT < 1 || group < 1 || H % group ||
      splits < 1 || rows_per_split < TK || rows_per_split % TK ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(splits > 1 ? ws : y);
  cudaError_t e;
  if (x_is_bf16) {
    if (M <= 16)
      e = vec ? launch_bf16<16, true>(x, w, s, o, M, H, OUT, group, splits, rows_per_split, st)
              : launch_bf16<16, false>(x, w, s, o, M, H, OUT, group, splits, rows_per_split, st);
    else
      e = vec ? launch_bf16<64, true>(x, w, s, o, M, H, OUT, group, splits, rows_per_split, st)
              : launch_bf16<64, false>(x, w, s, o, M, H, OUT, group, splits, rows_per_split, st);
  } else {
    e = vec ? launch_f32<true>(x, w, s, o, M, H, OUT, group, splits, rows_per_split, st)
            : launch_f32<false>(x, w, s, o, M, H, OUT, group, splits, rows_per_split, st);
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n = (long long)M * OUT;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                               static_cast<float*>(y), n,
                                               splits);
  return (int)cudaGetLastError();
}

// The prefill kernel (int4_mm_wgmma_kernel): bf16 x [M, IN], w [IN/2, OUT]
// int8, scale [IN/group, OUT] f32, y [M, OUT] f32; needs OUT % 16 == 0,
// group % 64 == 0 and 16-byte aligned x and w (ops/int4_matmul.py::_plan
// sends only such shapes). Returns the CUDA error code (0 on success).
extern "C" int int4_matmul_wgmma_launch(const void* x, const void* w,
                                        const void* scale, void* y, int M,
                                        int IN, int OUT, int group,
                                        void* stream) {
  const int H = IN / 2;
  if (M < 1 || IN < 2 || IN % 2 || OUT < 16 || OUT % 16 || group < WG_TK ||
      group % WG_TK || H % group ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma(x, w, static_cast<const float*>(scale),
                           static_cast<float*>(y), M, H, OUT, group,
                           static_cast<cudaStream_t>(stream));
}

// The decode kernel (int4_mm_decode_kernel): bf16 x [M, IN] with M < 64, w
// [IN/2, OUT] int8, scale [IN/group, OUT] f32, y [M, OUT] f32; needs OUT %
// 16 == 0, group % 64 == 0 and 16-byte aligned x, w and scale
// (ops/int4_matmul.py::_plan sends only such shapes). splits of
// rows_per_split packed rows (whole groups); with splits > 1, ws is f32
// [splits, M, OUT] scratch and counters holds one zero a column block of
// 128 (the launch leaves them zero). One launch. Returns the CUDA error
// code (0 on success).
extern "C" int int4_matmul_decode_launch(const void* x, const void* w,
                                         const void* scale, void* y, void* ws,
                                         void* counters, int M, int IN,
                                         int OUT, int group, int splits,
                                         int rows_per_split, void* stream) {
  const int H = IN / 2;
  if (M < 1 || M >= 64 || IN < 2 || IN % 2 || OUT < 16 || OUT % 16 ||
      group < DC_TK || group % DC_TK || H % group || splits < 1 ||
      splits > 65535 || rows_per_split < group || rows_per_split % group ||
      (long long)(splits - 1) * rows_per_split >= H ||
      (long long)splits * rows_per_split < H ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(y);
  float* wsp = static_cast<float*>(ws);
  unsigned* cnt = static_cast<unsigned*>(counters);
#define RAGROUTE_DECODE(N)                                                   \
  launch_decode<N>(x, w, s, o, wsp, cnt, M, H, OUT, group, splits,           \
                   rows_per_split, st)
  cudaError_t e;
  if (M <= 8) e = RAGROUTE_DECODE(8);
  else if (M <= 16) e = RAGROUTE_DECODE(16);
  else if (M <= 32) e = RAGROUTE_DECODE(32);
  else e = RAGROUTE_DECODE(64);
#undef RAGROUTE_DECODE
  return (int)e;
}
