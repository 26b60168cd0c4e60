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
// What bounds it on an H100 SXM: the layer's K and V planes of the batch
// (Qwen3-8B at B = 16, S = 2,080, bf16: 136 MB, 41 us at 3.35 TB/s); the
// arithmetic is 2 * G flops a cache element, far below what the card can do
// per byte. Design (simple first): the positions of a (batch row, kv head)
// are cut into splits so that the card holds several blocks an SM (one block
// per (row, head) alone leaves each SM one block whose loads wait on each
// other). A block of 256 threads reads its split's [L, Dh] slices of K and V
// once each. Scores: a few lanes a position (16-byte loads, int8 converted
// in registers, G dot products against the queries in shared memory,
// shuffle sums), kept in shared memory. Then, one warp a query head, the
// split's maximum m and sum l of exp(score - m); the weights exp(score - m)
// (* v_scale) take V: threads over (position stripe, dim), G sums a thread,
// summed over the stripes through shared memory. A second kernel merges the
// splits: out = sum_j e^(m_j - M) o_j / sum_j e^(m_j - M) l_j with M the
// largest m_j, which is the softmax over all positions. No cp.async, no
// tensor cores.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;  // query heads a kv head

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

// VEC elements starting at p (16 bytes when VEC * sizeof(T) == 16)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(p[i]);
  }
}

// One split of one (batch row, kv head): grid (Hkv, B, splits). Writes the
// split's unnormalised context o [G, Dh] and (m, l) [G, 2] to the workspace
// at ((b * Hkv + hk) * splits + split).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) decode_attention_split(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ ok,
    const float* __restrict__ ks, const float* __restrict__ vs,
    float* __restrict__ ws_o, float* __restrict__ ws_ml, int B, int H,
    int Hkv, int Dh, int S, int li, int chunk, int lanes_per_pos,
    float inv_sqrt_dh) {
  extern __shared__ __align__(16) float smem[];
  const int hk = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = H / Hkv;
  const int s_begin = sp * chunk, s_end = min(S, s_begin + chunk);
  const int n = s_end - s_begin;  // >= 1: the host makes no empty split
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* qs = smem;                      // [G][Dh]
  float* sc = qs + G * Dh;               // [G][chunk] scores, then weights
  float* part = sc + (size_t)G * chunk;  // [THREADS][GMAX] context sums

  for (int i = tid; i < G * Dh; i += THREADS)
    qs[i] = q[((size_t)b * H + hk * G) * Dh + i];
  __syncthreads();

  const size_t row0 = ((size_t)li * B + b) * S + s_begin;  // (li, b, s_begin)
  const int HD = Hkv * Dh;
  const T* kh = k + row0 * HD + (size_t)hk * Dh;
  const T* vh = v + row0 * HD + (size_t)hk * Dh;
  const float* ksh = ks ? ks + row0 * Hkv + hk : nullptr;
  const float* vsh = vs ? vs + row0 * Hkv + hk : nullptr;
  const uint8_t* okb = ok + (size_t)b * S + s_begin;

  // ---- scores: lanes_per_pos lanes a position, positions_per_warp at once
  const int lp = lanes_per_pos, sub = lane % lp, ppw = 32 / lp;
  for (int s0 = warp * ppw; s0 < n; s0 += WARPS * ppw) {
    const int s = s0 + lane / lp;
    float dot[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) dot[g] = 0.0f;
    if (s < n) {
      const T* kr = kh + (size_t)s * HD;
      for (int d0 = sub * VEC; d0 < Dh; d0 += lp * VEC) {
        float kv[VEC];
        load_vec<T, VEC>(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot[g] = fmaf(qs[g * Dh + d0 + e], kv[e], dot[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G)
        for (int off = lp >> 1; off > 0; off >>= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
    if (s < n && sub == 0) {
      const bool valid = okb[s] != 0;
      const float kscale = ksh ? ksh[(size_t)s * Hkv] : 1.0f;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          float a = dot[g];
          if (ksh) a = __fmul_rn(a, kscale);
          a = __fmul_rn(a, inv_sqrt_dh);
          sc[(size_t)g * chunk + s] = valid ? a : -FLT_MAX;
        }
      }
    }
  }
  __syncthreads();

  // ---- the split's max and sum, one warp a query head; then the weights
  float* ml = ws_ml + (((size_t)b * Hkv + hk) * gridDim.z + sp) * G * 2;
  for (int g = warp; g < G; g += WARPS) {
    float* row = sc + (size_t)g * chunk;
    float m = -FLT_MAX;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, row[s]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(row[s] - m);
      sum += e;
      row[s] = vsh ? __fmul_rn(e, vsh[(size_t)s * Hkv]) : e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[2 * g] = m;
      ml[2 * g + 1] = sum;
    }
  }
  __syncthreads();

  // ---- context: thread (stripe, d) sums positions stripe, stripe + nsp, ...
  const int nsp = THREADS / Dh;
  const int d = tid % Dh, stripe = tid / Dh;
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.0f;
  if (stripe < nsp) {
#pragma unroll 4
    for (int s = stripe; s < n; s += nsp) {
      const float vv = to_f<T>(vh[(size_t)s * HD + d]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] = fmaf(sc[(size_t)g * chunk + s], vv, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) part[tid * GMAX + g] = acc[g];
  __syncthreads();
  float* o = ws_o + (((size_t)b * Hkv + hk) * gridDim.z + sp) * G * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) {
    const int g = i / Dh, dd = i % Dh;
    float c = 0.0f;
    for (int p = 0; p < nsp; ++p) c += part[(p * Dh + dd) * GMAX + g];
    o[i] = c;
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

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const uint8_t* ok, const float* ks, const float* vs,
                   float* ws_o, float* ws_ml, float* out, int B, int H,
                   int Hkv, int Dh, int S, int li, int splits, int chunk,
                   size_t smem, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const float inv = 1.0f / sqrtf((float)Dh);
  const dim3 grid(Hkv, B, splits);
  cudaError_t e;
  if (Dh % VEC == 0) {
    int lp = 1;  // lanes a position: a power of two, at most Dh / VEC
    while (lp * 2 <= 32 && lp * 2 * VEC <= Dh) lp *= 2;
    e = cudaFuncSetAttribute(decode_attention_split<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    decode_attention_split<T, VEC><<<grid, THREADS, smem, st>>>(
        q, static_cast<const T*>(k), static_cast<const T*>(v), ok, ks, vs,
        ws_o, ws_ml, B, H, Hkv, Dh, S, li, chunk, lp, inv);
  } else {
    int lp = 1;
    while (lp * 2 <= 32 && lp * 2 <= Dh) lp *= 2;
    e = cudaFuncSetAttribute(decode_attention_split<T, 1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    decode_attention_split<T, 1><<<grid, THREADS, smem, st>>>(
        q, static_cast<const T*>(k), static_cast<const T*>(v), ok, ks, vs,
        ws_o, ws_ml, B, H, Hkv, Dh, S, li, chunk, lp, inv);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_attention_merge<<<B * H, Dh, 0, st>>>(ws_o, ws_ml, out, H, Hkv, Dh,
                                                splits);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q [B, H, Dh] f32; k, v [L, B, S, Hkv * Dh] (kv_type 0
// f32, 1 bf16, 2 int8); ok [B, S] uint8; ks, vs [L, B, S, Hkv] f32 or null
// (both or neither); out [B, H, Dh] f32. The positions go in `splits` runs of
// `chunk` (the last may be shorter, none empty); ws_o [B, Hkv, splits, G, Dh]
// and ws_ml [B, Hkv, splits, G, 2] are f32 scratch; `smem` is one split
// block's dynamic shared memory, 4 * (G * Dh + G * chunk + 256 * 8) bytes.
// Returns the CUDA error code (0 on success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ok,
    const void* ks, const void* vs, void* ws_o, void* ws_ml, void* out, int B,
    int H, int Hkv, int Dh, int S, int L, int li, int kv_type, int splits,
    int chunk, long long smem, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || H / Hkv > GMAX || Dh < 1 ||
      Dh > THREADS || S < 1 || li < 0 || li >= L || splits < 1 ||
      chunk < 1 || (long long)(splits - 1) * chunk >= S ||
      (long long)splits * chunk < S || (ks == nullptr) != (vs == nullptr) ||
      smem != 4LL * ((H / Hkv) * (Dh + chunk) + THREADS * GMAX))
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
    case kI8: return (int)launch<int8_t>(qf, k, v, okp, ksf, vsf, wo, wml, o, B, H, Hkv, Dh, S, li, splits, chunk, sm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
