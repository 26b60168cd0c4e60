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
// whose partial sums a second small kernel adds up in split order. At prefill
// (M = B * P in the thousands) the same kernel runs 64-row M tiles and is
// bound by its operations; it is plain mma.sync from shared memory, with no
// wgmma, TMA or warp specialisation.
//
// Fragment bookkeeping: a warp owns 16 rows x 32 columns as four n8 tiles.
// Tile j's mma column n stands for output column 4 * n + j of the warp's 32,
// so each lane reads one 32-bit word of four neighbouring bytes from shared
// memory and gets one B element of each of the four tiles from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
