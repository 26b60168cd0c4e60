// One-token grouped-query attention over one layer of a folded KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/decode_attention.py::
// decode_attention (body _kernel). For batch row b and query head
// hq = hk * G + g (G = H / Hkv query heads share kv head hk):
//
//     att[s] = (q[b, hq] . k[li, b, s, hk]) (* k_scale[li, b, s, hk]) * 1/sqrt(Dh)
//     att[s] = finfo(f32).min where ok[b, s] == 0
//     w = softmax(att) (* v_scale[li, b, s, hk])
//     out[b, hq] = sum_s w[s] * v[li, b, s, hk]
//
// k and v are the cache planes [L, B, S, Hkv * Dh] (the engines'
// [L, B, S, Hkv, Dh] cache seen without a copy) in f32, bf16 or int8; an
// int8 cache comes with per-(position, head) f32 scales, applied to the
// scores and to the weights, never to the operands, as the engines' einsum
// path (llm/model.py::_attend) does. Every step is f32. A row with no valid
// key sets every score to the same finfo(f32).min and so averages every
// position, as _attend does.
//
// What bounds it on an H100 SXM: bytes, the layer's K and V planes of the
// batch read once (Qwen3-8B at B = 16, S = 2,080, bf16: 136.9 MB, 41 us at
// 3.35 TB/s). The arithmetic is 2 * G flops a cache element a plane, about
// 13 TFLOP/s at full bandwidth for G = 4: within the f32 FMA rate, so no
// tensor cores (they would round the f32 queries). The first design read a
// split in two passes with one synchronous 16-byte load in flight a thread
// and reached about 0.6 TB/s. This one (flash-decoding) makes one pass:
//
//   * A block of 128 threads owns one (batch row, kv head, position split)
//     and walks the split in tiles of 32 positions. The K and V rows of a
//     tile reach shared memory by 16-byte cp.async.cg into a ring of 3
//     stages, so two tiles (32 KB at bf16 Dh = 128) are in flight while one
//     is used; with about 4 blocks an SM that is over 100 KB in flight an SM,
//     above the ~18 KB that Little's law asks at 3.35 TB/s. Rows are padded
//     by 16 bytes in shared memory, so 32 lanes reading one 16-byte column
//     of 32 rows hit distinct banks.
//   * Scores: warp w takes query heads w and w + 4, lane p position p of the
//     tile; the lane's dot product runs over its row in shared memory against
//     the queries (f32, broadcast from shared memory), int8 codes converted
//     in registers. The mask and the position's scales are read from global
//     memory a tile ahead, so their latency hides behind a tile of work.
//   * Online softmax a query head: the running max m (one warp max a tile),
//     each lane's share of l, and the weights exp(score - m) (* v_scale) for
//     the tile in shared memory. The split's scores are never stored, so
//     shared memory holds the ring, not the split.
//   * Context: thread (position stripe, dq) keeps 4 dims (4 dq to 4 dq + 3)
//     of G f32 sums, rescaled by exp(m_old - m_new) a tile, and adds weight
//     * V from the tile in shared memory: one vector load of V and two of
//     the position's G weights feed 4 G FMAs. The stripes' sums meet in
//     shared memory at the end.
//   * A split writes its unnormalised context o and (m, l); a second kernel
//     merges the splits: out = sum_j e^(m_j - M) o_j / sum_j e^(m_j - M) l_j
//     with M the largest m_j. A row that is one split writes o / l itself.
// Rows that are not a whole number of 16-byte chunks (Dh * sizeof(T) % 16 !=
// 0) are copied element by element with plain loads: correct, not fast.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py kernels,
// torch.profiler device time), Qwen3-8B decode (B = 16, S = 2,080): bf16
// cache 0.066 ms (bound 0.041; the first design 0.229), int8 0.063 (bound
// 0.021; first 0.237). What is left is arithmetic and shared-memory traffic,
// not bytes: the int8 cache, half the bytes, takes as long as bf16, since
// the score phase converts each K row once for every query head of the
// group (int8 codes by a byte permute and an add, not the quarter-rate I2F).

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;                    // query heads a kv head
constexpr int HEADS_A_WARP = GMAX / WARPS;  // in the score phase
constexpr int TP = 32;                     // positions a tile: a lane each
constexpr int STAGES = 3;                  // tiles in the cp.async ring
constexpr int DMAX = 256;                  // head dim at most: 2 a thread

enum KvType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t v) { return (float)v; }

// four int8 codes of a 32-bit word as f32, exactly, without I2F (a quarter-
// rate instruction): each byte offset to unsigned sits in the mantissa of
// 2^23 and the float subtracts 2^23 + 128
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
  const uint32_t x = w ^ 0x80808080u;
  out[0] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.0f;
  out[1] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.0f;
  out[2] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.0f;
  out[3] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.0f;
}
// the four elements held in 32-bit words w[0..] (in registers) as f32
template <typename T>
__device__ __forceinline__ void words4(const uint32_t* w, float* out);
template <>
__device__ __forceinline__ void words4<float>(const uint32_t* w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
}
template <>
__device__ __forceinline__ void words4<__nv_bfloat16>(const uint32_t* w,
                                                      float* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void words4<int8_t>(const uint32_t* w, float* out) {
  i8x4_to_f32(w[0], out);
}

// four consecutive cache elements at p (aligned to their 16, 8 or 4 bytes)
// as f32
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* p, float* out) {
  if constexpr (sizeof(T) == 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    words4<T>(reinterpret_cast<const uint32_t*>(&w), out);
  } else if constexpr (sizeof(T) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    words4<T>(reinterpret_cast<const uint32_t*>(&w), out);
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    words4<T>(&w, out);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// bytes of one cached row's Dh slice in shared memory: whole 16-byte chunks
// and one more, so that the rows' 16-byte columns fall in distinct banks
__host__ __device__ __forceinline__ int row_bytes(int dh, int size) {
  return (dh * size + 15) / 16 * 16 + 16;
}

// the ring (which also holds the stripes' context sums at the end, at most
// 4 * THREADS * G floats) and, after it, the weights, the softmax terms and
// the queries
__host__ __device__ __forceinline__ long long split_smem(int G, int dh,
                                                         int size) {
  const long long ring = (long long)STAGES * 2 * TP * row_bytes(dh, size);
  const long long sums = 16LL * THREADS * G;
  return (ring > sums ? ring : sums) + 4LL * (TP * GMAX + 2 * GMAX + G * dh);
}

// One split of one (batch row, kv head): grid (Hkv, B, splits). ASYNC: the
// rows are whole 16-byte chunks (cp.async and 16-byte shared loads).
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(THREADS) decode_attention_split(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ ok,
    const float* __restrict__ ks, const float* __restrict__ vs,
    float* __restrict__ ws_o, float* __restrict__ ws_ml,
    float* __restrict__ out, int B, int H, int Hkv, int Dh, int S, int li,
    int chunk, float inv_sqrt_dh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / Hkv;
  const int s_begin = sp * chunk;
  const int n = min(chunk, S - s_begin);  // >= 1: the host makes no empty split
  const int ntiles = (n + TP - 1) / TP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = row_bytes(Dh, (int)sizeof(T));
  const int stage_bytes = 2 * TP * rb;
  unsigned char* ring = smem;
  // after the ring: the tile's weights [TP][GMAX] (a position's G weights
  // side by side), exp(m_old - m_new) and the split's sums a head, queries
  const int ring_bytes = max(STAGES * stage_bytes, 16 * THREADS * G);
  float* wts = reinterpret_cast<float*>(smem + ring_bytes);
  float* alpha_s = wts + TP * GMAX;  // [GMAX]
  float* l_s = alpha_s + GMAX;       // [GMAX]
  float* qs = l_s + GMAX;            // [G][Dh]

  const size_t row0 = ((size_t)li * B + b) * S + s_begin;  // (li, b, s_begin)
  const int HD = Hkv * Dh;
  const T* kh = k + row0 * HD + (size_t)hk * Dh;
  const T* vh = v + row0 * HD + (size_t)hk * Dh;
  const float* ksh = ks ? ks + row0 * Hkv + hk : nullptr;
  const float* vsh = vs ? vs + row0 * Hkv + hk : nullptr;
  const uint8_t* okb = ok + (size_t)b * S + s_begin;

  // K and V rows of tile t into its stage of the ring
  auto issue = [&](int t) {
    unsigned char* st = ring + (t % STAGES) * stage_bytes;
    const int p0 = t * TP, rows = min(TP, n - p0);
    if constexpr (ASYNC) {
      const int cpr = Dh * (int)sizeof(T) / 16;  // 16-byte chunks a row
      for (int i = tid; i < rows * cpr; i += THREADS) {
        const int r = i / cpr, c = i - r * cpr;
        const size_t off = (size_t)(p0 + r) * HD;
        cp_async16(st + r * rb + c * 16,
                   reinterpret_cast<const unsigned char*>(kh + off) + c * 16);
        cp_async16(st + (TP + r) * rb + c * 16,
                   reinterpret_cast<const unsigned char*>(vh + off) + c * 16);
      }
    } else {
      for (int i = tid; i < rows * Dh; i += THREADS) {
        const int r = i / Dh, d = i - r * Dh;
        const size_t off = (size_t)(p0 + r) * HD + d;
        reinterpret_cast<T*>(st + r * rb)[d] = kh[off];
        reinterpret_cast<T*>(st + (TP + r) * rb)[d] = vh[off];
      }
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
  }
  for (int i = tid; i < G * Dh; i += THREADS)
    qs[i] = q[((size_t)b * H + hk * G) * Dh + i];

  float m_run[HEADS_A_WARP], l_lane[HEADS_A_WARP];
#pragma unroll
  for (int j = 0; j < HEADS_A_WARP; ++j) {
    m_run[j] = -INFINITY;
    l_lane[j] = 0.0f;
  }
  // context: thread (stripe, dq) owns NV dims of every query head, 4 dq to
  // 4 dq + 3 (rows of whole 16-byte chunks, Dh % 4 == 0), else dq and dq +
  // THREADS; the stripes split the tile's positions
  constexpr int NV = ASYNC ? 4 : DMAX / THREADS;
  const int row_threads = ASYNC ? Dh / 4 : min(Dh, THREADS);
  const int ns = THREADS / row_threads;
  const int dq = tid % row_threads, stripe = tid / row_threads;
  auto dim = [&](int j) { return ASYNC ? 4 * dq + j : dq + j * THREADS; };
  float acc[GMAX][NV];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[g][j] = 0.0f;

  // the mask and scales of tile t's position `lane`, loaded a tile ahead
  auto meta = [&](int t, bool& okv, float& kv, float& vv) {
    const int s = t * TP + lane;
    okv = false;
    kv = vv = 1.0f;
    if (t < ntiles && s < n) {
      okv = okb[s] != 0;
      if (ksh) {
        kv = ksh[(size_t)s * Hkv];
        vv = vsh[(size_t)s * Hkv];
      }
    }
  };
  bool next_ok;
  float next_ks, next_vs;
  meta(0, next_ok, next_ks, next_vs);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; everyone is done with tile t - 1
    if (t + STAGES - 1 < ntiles) issue(t + STAGES - 1);
    cp_async_commit();
    const unsigned char* kt = ring + (t % STAGES) * stage_bytes;
    const unsigned char* vt = kt + TP * rb;
    const int rows = min(TP, n - t * TP);
    const bool valid = next_ok;
    const float kscale = next_ks, vscale = next_vs;
    meta(t + 1, next_ok, next_ks, next_vs);

    // ---- scores and the online softmax: lane = position, warp = heads
    const bool in = lane < rows;
#pragma unroll
    for (int j = 0; j < HEADS_A_WARP; ++j) {
      const int g = warp + j * WARPS;
      if (g >= G) break;  // warp-uniform
      float dot = 0.0f;
      if (in) {
        const float* qg = qs + g * Dh;
        const unsigned char* kr = kt + lane * rb;
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;  // 4 FMA chains
        if constexpr (ASYNC) {
          constexpr int E = 16 / sizeof(T);
#pragma unroll 4
          for (int c = 0; c < Dh / E; ++c) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 16);
#pragma unroll
            for (int i = 0; i < E; i += 4) {
              float kv[4];
              words4<T>(reinterpret_cast<const uint32_t*>(&raw) +
                            i * (int)sizeof(T) / 4, kv);
              const float4 qq = *reinterpret_cast<const float4*>(qg + c * E + i);
              d0 = fmaf(qq.x, kv[0], d0);
              d1 = fmaf(qq.y, kv[1], d1);
              d2 = fmaf(qq.z, kv[2], d2);
              d3 = fmaf(qq.w, kv[3], d3);
            }
          }
        } else {
          const T* kr_t = reinterpret_cast<const T*>(kr);
          int d = 0;
          for (; d + 4 <= Dh; d += 4) {
            d0 = fmaf(qg[d], to_f<T>(kr_t[d]), d0);
            d1 = fmaf(qg[d + 1], to_f<T>(kr_t[d + 1]), d1);
            d2 = fmaf(qg[d + 2], to_f<T>(kr_t[d + 2]), d2);
            d3 = fmaf(qg[d + 3], to_f<T>(kr_t[d + 3]), d3);
          }
          for (; d < Dh; ++d) d0 = fmaf(qg[d], to_f<T>(kr_t[d]), d0);
        }
        dot = (d0 + d1) + (d2 + d3);
      }
      float a = -INFINITY;  // a position past the split weighs nothing
      if (in) {
        if (ksh) dot = __fmul_rn(dot, kscale);
        a = valid ? __fmul_rn(dot, inv_sqrt_dh) : -FLT_MAX;
      }
      const float m_new = fmaxf(m_run[j], warp_max(a));  // lane 0 is in
      const float alpha = expf(m_run[j] - m_new);
      const float e = expf(a - m_new);
      l_lane[j] = fmaf(l_lane[j], alpha, e);
      wts[lane * GMAX + g] = ksh ? __fmul_rn(e, vscale) : e;
      if (lane == 0) alpha_s[g] = alpha;
      m_run[j] = m_new;
    }
    __syncthreads();

    // ---- context: rescale, then weight * V over the tile's positions
    if (stripe < ns) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float al = alpha_s[g];
#pragma unroll
          for (int j = 0; j < NV; ++j) acc[g][j] *= al;
        }
      }
#pragma unroll 2
      for (int p = stripe; p < rows; p += ns) {
        float vv[NV];
        if constexpr (ASYNC) {
          load4<T>(vt + p * rb + dq * 4 * (int)sizeof(T), vv);
        } else {
          const T* vr = reinterpret_cast<const T*>(vt + p * rb);
#pragma unroll
          for (int j = 0; j < NV; ++j) vv[j] = dim(j) < Dh ? to_f<T>(vr[dim(j)]) : 0.0f;
        }
        const float4 wa = *reinterpret_cast<const float4*>(wts + p * GMAX);
        const float4 wb = *reinterpret_cast<const float4*>(wts + p * GMAX + 4);
        const float w[GMAX] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G)
#pragma unroll
            for (int j = 0; j < NV; ++j) acc[g][j] = fmaf(w[g], vv[j], acc[g][j]);
      }
    }
  }
  cp_async_wait<0>();

  // ---- the split's (m, l), and its context summed over the stripes
#pragma unroll
  for (int j = 0; j < HEADS_A_WARP; ++j) {
    const int g = warp + j * WARPS;
    if (g >= G) break;
    const float l = warp_sum(l_lane[j]);
    if (lane == 0) {
      l_s[g] = l;
      if (splits > 1) {
        float* ml = ws_ml + (((size_t)b * Hkv + hk) * splits + sp) * G * 2;
        ml[2 * g] = m_run[j];
        ml[2 * g + 1] = l;
      }
    }
  }
  __syncthreads();  // l_s written; every thread is past the ring
  // the split's context: o / l with one split, o and (m, l) with several
  float* o = splits > 1
                 ? ws_o + (((size_t)b * Hkv + hk) * splits + sp) * G * Dh
                 : out + ((size_t)b * H + hk * G) * Dh;
  auto put = [&](int g, int d, float c) {
    o[g * Dh + d] = splits > 1 ? c : __fdiv_rn(c, l_s[g]);
  };
  if (ns == 1) {  // one stripe: thread dq writes its own dims
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (g < G && dim(j) < Dh) put(g, dim(j), acc[g][j]);
  } else {        // sum the position stripes
    float* part = reinterpret_cast<float*>(ring);  // [ns][G][Dh]
    if (stripe < ns)
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          if (g < G && dim(j) < Dh) part[(stripe * G + g) * Dh + dim(j)] = acc[g][j];
    __syncthreads();
    for (int i = tid; i < G * Dh; i += THREADS) {
      float c = 0.0f;
      for (int st = 0; st < ns; ++st) c += part[st * G * Dh + i];
      put(i / Dh, i % Dh, c);
    }
  }
}

// out[b, hq] = sum_j e^(m_j - M) o_j / sum_j e^(m_j - M) l_j over the splits
// of (b, hk = hq / G): grid (B * H), Dh threads.
__global__ void decode_attention_merge(const float* __restrict__ ws_o,
                                       const float* __restrict__ ws_ml,
                                       float* __restrict__ out, int H, int Hkv,
                                       int Dh, int splits) {
  const int bh = blockIdx.x, b = bh / H, hq = bh % H;
  const int G = H / Hkv, hk = hq / G, g = hq % G;
  const size_t base = ((size_t)b * Hkv + hk) * splits;
  float mx = -FLT_MAX;
  for (int j = 0; j < splits; ++j)
    mx = fmaxf(mx, ws_ml[((base + j) * G + g) * 2]);
  float l = 0.0f, o = 0.0f;
  const int d = threadIdx.x;
  for (int j = 0; j < splits; ++j) {
    const float* ml = ws_ml + ((base + j) * G + g) * 2;
    const float w = expf(ml[0] - mx);
    l = fmaf(w, ml[1], l);
    o = fmaf(w, ws_o[((base + j) * G + g) * Dh + d], o);
  }
  out[((size_t)b * H + hq) * Dh + d] = __fdiv_rn(o, l);
}

// Raise an instantiation's dynamic shared-memory limit once per device (and
// again only for a larger size), not on every launch.
template <typename T, bool ASYNC>
cudaError_t allow_smem(size_t smem) {
  static int allowed[64] = {0};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (int)smem <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_attention_split<T, ASYNC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 64) allowed[dev] = (int)smem;
  return e;
}

template <typename T, bool ASYNC>
cudaError_t launch_split(const dim3& grid, size_t smem, cudaStream_t st,
                         const float* q, const void* k, const void* v,
                         const uint8_t* ok, const float* ks, const float* vs,
                         float* ws_o, float* ws_ml, float* out, int B, int H,
                         int Hkv, int Dh, int S, int li, int chunk) {
  cudaError_t e = allow_smem<T, ASYNC>(smem);
  if (e != cudaSuccess) return e;
  decode_attention_split<T, ASYNC><<<grid, THREADS, smem, st>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ok, ks, vs,
      ws_o, ws_ml, out, B, H, Hkv, Dh, S, li, chunk,
      1.0f / sqrtf((float)Dh));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const uint8_t* ok, const float* ks, const float* vs,
                   float* ws_o, float* ws_ml, float* out, int B, int H,
                   int Hkv, int Dh, int S, int li, int splits, int chunk,
                   size_t smem, cudaStream_t st) {
  const dim3 grid(Hkv, B, splits);
  cudaError_t e =
      (Dh * (int)sizeof(T)) % 16 == 0
          ? launch_split<T, true>(grid, smem, st, q, k, v, ok, ks, vs, ws_o,
                                  ws_ml, out, B, H, Hkv, Dh, S, li, chunk)
          : launch_split<T, false>(grid, smem, st, q, k, v, ok, ks, vs, ws_o,
                                   ws_ml, out, B, H, Hkv, Dh, S, li, chunk);
  if (e != cudaSuccess || splits == 1) return e;
  decode_attention_merge<<<B * H, Dh, 0, st>>>(ws_o, ws_ml, out, H, Hkv, Dh,
                                                splits);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q [B, H, Dh] f32; k, v [L, B, S, Hkv * Dh] (kv_type 0
// f32, 1 bf16, 2 int8); ok [B, S] uint8 (nonzero: a valid key); ks, vs
// [L, B, S, Hkv] f32 or null (both or neither); out [B, H, Dh] f32. The
// positions go in `splits` runs of `chunk` (a multiple of 32; the last may
// be shorter, none empty); with splits > 1, ws_o [B, Hkv, splits, G, Dh]
// and ws_ml [B, Hkv, splits, G, 2] are f32 scratch (null otherwise). `smem`
// is one split block's dynamic shared memory, split_smem(G, Dh, size)
// bytes. Returns the CUDA error code (0 on
// success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ok,
    const void* ks, const void* vs, void* ws_o, void* ws_ml, void* out, int B,
    int H, int Hkv, int Dh, int S, int L, int li, int kv_type, int splits,
    int chunk, long long smem, void* stream) {
  const int size = kv_type == kF32 ? 4 : kv_type == kBF16 ? 2 : 1;
  if (B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || H % Hkv ||
      H / Hkv > GMAX || Dh < 1 || Dh > DMAX || S < 1 || li < 0 || li >= L ||
      splits < 1 || splits > 65535 || chunk < 1 || chunk % TP ||
      (long long)(splits - 1) * chunk >= S || (long long)splits * chunk < S ||
      (ks == nullptr) != (vs == nullptr) ||
      (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)) ||
      kv_type < kF32 || kv_type > kI8 || smem != split_smem(H / Hkv, Dh, size))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const uint8_t* okp = static_cast<const uint8_t*>(ok);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  float* o = static_cast<float*>(out);
  const size_t sm = (size_t)smem;
  switch (kv_type) {
    case kF32: return (int)launch<float>(qf, k, v, okp, ksf, vsf, wo, wml, o, B, H, Hkv, Dh, S, li, splits, chunk, sm, st);
    case kBF16: return (int)launch<__nv_bfloat16>(qf, k, v, okp, ksf, vsf, wo, wml, o, B, H, Hkv, Dh, S, li, splits, chunk, sm, st);
    default: return (int)launch<int8_t>(qf, k, v, okp, ksf, vsf, wo, wml, o, B, H, Hkv, Dh, S, li, splits, chunk, sm, st);
  }
}
