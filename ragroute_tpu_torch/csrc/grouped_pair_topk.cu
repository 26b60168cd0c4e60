// Grouped GEMM of cluster-aligned (query, probed cluster) pair blocks with a
// rank-capped top extraction fused in, for Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/grouped_topk.py::_grouped_pair_topk
// (body _grouped_topk_kernel). The pairs of a batch are laid out in blocks of
// 256 rows, every block belonging to one cluster; block i scores its rows
// against the int8 coarse slab of cluster blk_cluster[i]:
//
//     gain[r, s] = (q[row(i, r)] . docs[c, :, s]) * scale[c, s] + bias[c, s]
//
// docs is [C, R, S] int8 (contraction on the middle axis, S contiguous), q is
// bf16, the product sums in f32, and the scale multiply and the bias add are
// two separately rounded operations, in that order. bias carries -inf on empty
// slots. The gains are never written to device memory. Instead the slot axis
// is cut into tiles of `tds` slots (a multiple of 64); per (row, tile) the
// `ranks` largest gains, ties to the lowest slot, are offered best first to
// the row's sorted list of kw = ranks * ceil(S / tds) entries, tiles in
// ascending order. An offer lands after the entries equal to it; -inf never
// enters. The list can hold every offer, so what comes out is the stable
// descending sort of the offers; unfilled entries read (-inf, 0).
//
// row(i, r) is rows[i * 256 + r] when a row table is given (the kernel gathers
// the query rows itself), else i * 256 + r. When n_real is given, blocks at or
// past *n_real (the padding up to the static bound on the block count) return
// at once and leave their output rows unwritten; nothing collects those rows.
//
// What bounds it on an H100 SXM: at the serving shape (B = 512, 512 probes of
// 4,096 clusters, R = 128, S = 1,584) every probed slab read once is about
// 0.83 GB (0.25 ms at 3.35 TB/s); the product over the blocks' rows is 0.11
// TFLOP when the blocks are full and 0.43 TFLOP (0.43 ms at 989 TFLOP/s) when
// every cluster holds one block a quarter full, as evenly spread probes leave
// them. Bytes and operations are within a factor of two of each other.
//
// Three launches (ops/grouped_topk.py::_plan picks one from the shape):
//
// pair_wgmma_kernel, for ranks <= 8 and kw <= 16 (the serving caps: kappa
// 8 or 16 over two tiles, up to 8 over one) over slabs of depth R <= 128.
// The TPU kernel holds a [256, 1024] f32 gain tile in its 1 MB of VMEM; an
// SM has 227 KB, so the gains stay in registers. One block of five warp
// groups a pair block: the 256 query rows (gathered through the row table:
// TMA cannot gather rows) stay in shared memory as wgmma's A for the whole
// slab; the producer group reads the slab in chunks of 64 slots with plain
// 8-byte loads (S is a multiple of 8, not of 16, so TMA's row stride does
// not always hold) and writes each chunk transposed into bf16 K-major tiles
// of a ring (int8 codes are exact in bf16); four consumer groups of 64 rows
// run wgmma m64n64k16, form each gain (scale, then bias, each rounded) and
// keep, per thread and row, a sorted list of the best of the 16 slots a
// chunk it holds, in registers; a gain is tested against the list's last
// entry and the row's threshold (the best last entry of the row's four
// lanes) for 8 gains at once with no branch, and only the few that pass
// are inserted. At each tile's end the four lanes' lists of a row merge to
// the tile's `ranks` best, offered to the row's running list in shared
// memory. A first version that buffered candidates and merged them by
// rank, as K1's fold does, lost to the first design (8.1 against 7.1 ms): a
// tile of 1,024 slots restarts each row's threshold, so candidates never
// thin out as they do over K1's splits; inserting per gain under a branch
// (3.1 ms) ran the insert whenever one lane of 32 needed it.

// grouped_pair_topk_kernel, the first design, for 16 < ranks <= RMAX = 160
// and deeper slabs: one block of 256 threads a pair block walks the slab in
// sub-tiles of 64 slots: its eight warps build a [256 x 64] gain sub-tile on
// the tensor cores (WMMA m16n16k16, int8 codes cast to bf16 on the load path,
// which is exact) and store it column-major in shared memory; then thread t
// scans row t of the sub-tile in ascending slot order, applies scale and
// bias, and keeps the tile's `ranks` best so far (registers up to 16 ranks,
// local memory past that), offered at a tile's end to its running list.
// The query rows stay in shared memory for the whole slab when the depth
// fits one chunk of 128; deeper slabs reload them per sub-tile. At the
// serving shape it took 7.2 ms on an H100 80GB HBM3 at 700 W: one block of
// eight warps an SM (155 KB of shared memory), WMMA from shared memory
// without cp.async or TMA, three barriers a sub-tile, a scalar scan of every
// gain.
//
// Deeper per-tile lists (ranks > RMAX: ranks = ceil(kappa / n_tiles) is
// uncapped in the TPU kernel, and an open cap, kappa >= k', asks for 256 and
// more) do not fit a thread. For those, grouped_pair_topk_deep_launch
// writes the sub-tiles' scaled and biased gains of a chunk of pair blocks to
// device memory (pair_gains_kernel, the same products and roundings), and
// deep_topk.cuh selects each (row, tile)'s `ranks` best by radix select and
// a bitonic sort in shared memory and merges a row's tiles to kw, the plain
// version's order (gain descending, slot ascending).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "codes.cuh"
#include "deep_topk.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int TE = 256;       // pair rows per block (the layout's group size)
constexpr int TS = 64;        // slab columns per sub-tile
constexpr int BK = 128;       // contraction chunk (elements)
constexpr int THREADS = 256;  // eight warps; thread t owns pair row t
constexpr int LDA = BK + 8;   // bf16 query tile row stride
constexpr int LDB = TS + 8;   // bf16 slab tile row stride
constexpr int LDG = TE + 4;   // gain sub-tile column stride (floats)
constexpr int SMEM_A = TE * LDA * 2;
constexpr int SMEM_B = BK * LDB * 2;
constexpr int SMEM_G = TS * LDG * 4;
constexpr int SMEM = SMEM_A + SMEM_B + SMEM_G + 2 * TS * 4;
constexpr int RREG = 16;      // deepest per-tile list kept in registers
constexpr int RMAX = 160;     // deepest per-tile list (local memory past RREG)

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Insert (x, slot) into the sorted list (tg, ti) after every entry >= x; the
// last entry falls off. The caller has checked that x beats the last entry.
// Lists of up to RREG entries are fully unrolled, so they stay in registers;
// deeper ones (RT == RMAX, `len` entries in use) shift in local memory.
template <int RT>
__device__ __forceinline__ void tile_insert(float (&tg)[RT], int (&ti)[RT], float x,
                                            int slot, int len) {
  if constexpr (RT <= RREG) {
    bool ins = false;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      if (ins || x > tg[j]) {
        const float og = tg[j];
        const int oi = ti[j];
        tg[j] = x;
        ti[j] = slot;
        x = og;
        slot = oi;
        ins = true;
      }
    }
  } else {
    int pos = len - 1;
    while (pos > 0 && tg[pos - 1] < x) {
      tg[pos] = tg[pos - 1];
      ti[pos] = ti[pos - 1];
      --pos;
    }
    tg[pos] = x;
    ti[pos] = slot;
  }
}

// The [TE x TS] gain sub-tile of slots [s0, s0 + TS) of the block's slab
// (before scale and bias) into sg column-major (sg[col * LDG + row]), and
// the sub-tile's bias and scale into sbias / sscale. The query rows are
// loaded at the first sub-tile and, when the depth takes more than one
// chunk, again for every sub-tile. Ends with a barrier.
__device__ __forceinline__ void gain_subtile(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ slab,
    const float* __restrict__ brow, const float* __restrict__ srow,
    const int* __restrict__ rows, int e0, int R, int S, int s0,
    unsigned char* smem, int tid, int warp) {
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_A);
  float* sg = reinterpret_cast<float*>(smem + SMEM_A + SMEM_B);
  float* sbias = sg + TS * LDG;
  float* sscale = sbias + TS;
  const int n_k = (R + BK - 1) / BK;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int kc = 0; kc < n_k; ++kc) {
    const int k0 = kc * BK;
    const int kmax = min(BK, R - k0);  // a multiple of 16
    if (n_k > 1 || s0 == 0) {
      // query rows [TE, BK], 8 bf16 a vector
      for (int v = tid; v < TE * (BK / 8); v += THREADS) {
        const int r = v / (BK / 8), cc = (v % (BK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (cc < kmax) {
          const int row = rows ? rows[e0 + r] : e0 + r;
          val = *reinterpret_cast<const uint4*>(q + (size_t)row * R + k0 + cc);
        }
        *reinterpret_cast<uint4*>(sa + r * LDA + cc) = val;
      }
    }
    // slab rows [BK, TS] int8 -> bf16, 8 columns a vector; S % 8 == 0 keeps
    // a vector inside the row and aligned
    for (int v = tid; v < BK * (TS / 8); v += THREADS) {
      const int kk = v / (TS / 8), cc = (v % (TS / 8)) * 8;
      const int col = s0 + cc;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kk < kmax && col < S) {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(slab + (size_t)(k0 + kk) * S + col);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        val = make_uint4(pack_bf16((float)b[0], (float)b[1]),
                         pack_bf16((float)b[2], (float)b[3]),
                         pack_bf16((float)b[4], (float)b[5]),
                         pack_bf16((float)b[6], (float)b[7]));
      }
      *reinterpret_cast<uint4*>(sb + kk * LDB + cc) = val;
    }
    if (kc == 0 && tid < TS) {
      const int col = s0 + tid;
      sbias[tid] = col < S ? brow[col] : neg_inf();
      sscale[tid] = col < S ? srow[col] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kmax; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (warp * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], sb + kk * LDB + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next chunk (or sub-tile) overwrites sa / sb
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sg + (j * 16) * LDG + warp * 32 + i * 16, acc[i][j],
                              LDG, wmma::mem_col_major);
  __syncthreads();
}

template <int RT>
__global__ void __launch_bounds__(THREADS) grouped_pair_topk_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ out_g,
    int* __restrict__ out_i, int C, int R, int S, int tds, int ranks, int kw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = blockIdx.x;
  if (n_real && blk >= *n_real) return;  // block-uniform
  const float* sg = reinterpret_cast<const float*>(smem + SMEM_A + SMEM_B);
  const float* sbias = sg + TS * LDG;
  const float* sscale = sbias + TS;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int e0 = blk * TE;
  const int c = min(max(blk_cluster[blk], 0), C - 1);
  const int8_t* slab = docs + (size_t)c * R * S;
  const float* brow = bias + (size_t)c * S;
  const float* srow = scale + (size_t)c * S;

  // the row's running list lives in its output entries
  float* lg = out_g + (size_t)(e0 + tid) * kw;
  int* li = out_i + (size_t)(e0 + tid) * kw;
  for (int j = 0; j < kw; ++j) {
    lg[j] = neg_inf();
    li[j] = 0;
  }
  int filled = 0;
  float tg[RT];
  int ti[RT];
  const int len = RT <= RREG ? RT : ranks;  // list entries in use
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    tg[j] = neg_inf();
    ti[j] = 0;
  }

  for (int s0 = 0; s0 < S; s0 += TS) {
    gain_subtile(q, slab, brow, srow, rows, e0, R, S, s0, smem, tid, warp);

    // thread t scans row t in ascending slot order: scale, then bias, each
    // rounded on its own
    const int ncols = min(TS, S - s0);
    for (int cc = 0; cc < ncols; ++cc) {
      float x = __fmul_rn(sg[cc * LDG + tid], sscale[cc]);
      x = __fadd_rn(x, sbias[cc]);
      if (x > tg[len - 1]) tile_insert<RT>(tg, ti, x, s0 + cc, len);
    }
    if ((s0 + TS) % tds == 0 || s0 + TS >= S) {
      // the tile's end: offer its winners, best first, to the running list
      auto offer = [&](int j) {
        const float x = tg[j];
        if (j < ranks && x > neg_inf() && filled < kw) {
          int pos = filled;
          while (pos > 0 && lg[pos - 1] < x) {
            lg[pos] = lg[pos - 1];
            li[pos] = li[pos - 1];
            --pos;
          }
          lg[pos] = x;
          li[pos] = ti[j];
          ++filled;
        }
        tg[j] = neg_inf();
        ti[j] = 0;
      };
      if constexpr (RT <= RREG) {
#pragma unroll
        for (int j = 0; j < RT; ++j) offer(j);
      } else {
        for (int j = 0; j < len; ++j) offer(j);
      }
    }
    __syncthreads();  // the next sub-tile overwrites sg / sbias / sscale
  }
}

// ---- ranks <= PW_MAX_RANKS, R <= PW_MAX_R: wgmma from a converted ring -------

constexpr int PW_GROUPS = 4;                  // consumer groups, 64 rows each
constexpr int PW_THREADS = 128 * (PW_GROUPS + 1);
constexpr int PW_N = 64;                      // slots a chunk (the wgmma's N)
constexpr int PW_NACC = PW_N / 2;             // accumulators a thread
constexpr int PW_A_CHUNK = TE * 128;          // 256 rows x 64 bf16 of depth
constexpr int PW_B_CHUNK = PW_N * 128;        // 64 slots x 64 bf16 of depth
constexpr int PW_MAX_R = 128;                 // depth kept resident
constexpr int PW_MAX_RANKS = 8;               // deepest per-tile list
constexpr int PW_MAX_KW = 16;                 // longest running list
constexpr int PW_MAX_STAGES = 4;
// 16-byte copies a thread makes of the block's query rows (at R = 128)
constexpr int PW_GATHER = (TE * (PW_MAX_R / 8) + PW_THREADS - 1) / PW_THREADS;

// Shared memory at depth R, `stages` ring stages and lane lists of RT: the
// block's query rows (K-major, 128-byte swizzle, 64 of depth a chunk), the
// ring's bf16 slab chunks, each stage's 64 slots' bias and scale, the lane
// lists a tile's end gathers (256 rows x 4 lanes x RT), the rows' running
// lists (256 x PW_MAX_KW), the barriers; plus 1024 bytes to align the
// operands.
__host__ __device__ constexpr int pw_smem_bytes(int R, int stages, int RT) {
  return ((R + 63) / 64) * (PW_A_CHUNK + stages * PW_B_CHUNK) +
         stages * 2 * PW_N * 4 + TE * 4 * RT * 8 + TE * PW_MAX_KW * 8 +
         2 * stages * 8 + 1024;
}

// One block a pair block (blocks at or past *n_real return at once). All
// threads gather the block's 256 query rows through the row table into
// shared memory once (wgmma's A, resident for the whole slab). The producer
// warp group walks the slab in chunks of 64 slots: each thread reads an 8 x 8
// byte square of int8 codes (8 slots x 8 of depth, 8-byte loads: S is a
// multiple of 8, not always of 16; two chunks' squares in flight) and writes
// it transposed as bf16 into the stage's K-major slab chunk (codes.cuh:
// exact), a thread in 64 stages the chunk's bias and scale (-inf / 1 past S,
// loaded with the codes); then each fences and arrives. Consumer group wg
// owns pair rows 64 wg .. + 64: per chunk wgmma m64n64k16 over the depth
// into f32 registers, then each gain is formed in registers (x scale, +
// bias, each rounded) and compared with the last entry of the thread's own
// sorted list for its row and with the row's threshold (a thread holds rows
// r0 and r0 + 8 at 16 of each chunk's slots, in ascending slot order, so its
// list of RT >= ranks keeps the best of those slots, ties to the lower slot,
// and -inf never enters); the stage goes back to the ring after the fold (it
// holds the bias and scale the fold reads). At a tile's end the four lanes
// of each row put their lists in shared memory, and lanes 0..15 merge their
// row's four lists to the tile's `ranks` best and offer them, best first, to
// the row's running list of kw <= PW_MAX_KW in shared memory (an offer lands
// after the entries equal to it); the lists start again empty for the next
// tile, and the running lists are written out after the last.
template <int RT>
__global__ void __launch_bounds__(PW_THREADS, 1) pair_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ out_g,
    int* __restrict__ out_i, int C, int R, int S, int tds, int ranks, int kw,
    int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int blk = blockIdx.x;
  if (n_real && blk >= *n_real) return;  // block-uniform
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int kcs = (R + 63) / 64;             // 64-deep chunks of the depth
  const int stage_bytes = kcs * PW_B_CHUNK;
  unsigned char* sa = smem;
  unsigned char* ring = sa + kcs * PW_A_CHUNK;
  float* side = reinterpret_cast<float*>(ring + stages * stage_bytes);
  float* lane_g = side + stages * 2 * PW_N;          // [256 rows][4][RT]
  int* lane_i = reinterpret_cast<int*>(lane_g + TE * 4 * RT);
  float* run_g = reinterpret_cast<float*>(lane_i + TE * 4 * RT);  // [256][kw]
  int* run_i = reinterpret_cast<int*>(run_g + TE * PW_MAX_KW);
  uint64_t* full = reinterpret_cast<uint64_t*>(run_i + TE * PW_MAX_KW);
  uint64_t* empty = full + stages;
  const int e0 = blk * TE;
  const int c = min(max(blk_cluster[blk], 0), C - 1);
  const int8_t* slab = docs + (size_t)c * R * S;
  const float* brow = bias + (size_t)c * S;
  const float* srow = scale + (size_t)c * S;
  const int n_chunks = (S + PW_N - 1) / PW_N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 128);                 // every producer thread
      hopper::mbar_init(&empty[s], 4 * PW_GROUPS);      // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  // the query rows, 16 bytes (8 of depth) a copy, into the swizzle: every
  // row index, then every copy, then every store, so that the loads of a
  // thread are in flight together
  {
    const int vpr = R / 8;
    int qrow[PW_GATHER];
    uint4 val[PW_GATHER];
#pragma unroll
    for (int j = 0; j < PW_GATHER; ++j) {
      const int v = threadIdx.x + PW_THREADS * j, r = v / vpr;
      qrow[j] = v >= TE * vpr ? -1 : rows ? __ldg(rows + e0 + r) : e0 + r;
    }
#pragma unroll
    for (int j = 0; j < PW_GATHER; ++j) {
      const int v = threadIdx.x + PW_THREADS * j;
      val[j] = qrow[j] < 0 ? make_uint4(0u, 0u, 0u, 0u)
                           : __ldg(reinterpret_cast<const uint4*>(
                                 q + (size_t)qrow[j] * R + 8 * (v % vpr)));
    }
#pragma unroll
    for (int j = 0; j < PW_GATHER; ++j) {
      const int v = threadIdx.x + PW_THREADS * j, r = v / vpr, c16 = v % vpr;
      if (qrow[j] >= 0)
        *reinterpret_cast<uint4*>(sa + (c16 >> 3) * PW_A_CHUNK + r * 128 +
                                  (((c16 & 7) ^ (r & 7)) << 4)) = val[j];
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == PW_GROUPS) {  // ---- producer: the slab, converted ----
    const int ptid = threadIdx.x - 128 * PW_GROUPS;
    const int kg = R / 8;                       // depth groups of 8
    const int a = ptid / kg, b = ptid - a * kg;  // slots 8 a .., depth 8 b ..
    const bool active = a < PW_N / 8;
    // a chunk's codes and, for threads 0..63, its slot's bias and scale
    // (-inf / 1 past S)
    auto load = [&](uint2 (&w)[8], float2& bsc, int i) {
      const bool in = active && i < n_chunks && i * PW_N + 8 * a < S;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = in ? __ldg(reinterpret_cast<const uint2*>(
                        slab + (size_t)(8 * b + j) * S + i * PW_N + 8 * a))
                  : make_uint2(0u, 0u);
      const int slot = i * PW_N + ptid;
      const bool own = ptid < PW_N && i < n_chunks && slot < S;
      bsc = make_float2(own ? __ldg(brow + slot) : neg_inf(),
                        own ? __ldg(srow + slot) : 1.0f);
    };
    auto convert = [&](uint2 (&w)[8], const float2& bsc, int i) {
      const int s = i % stages, n0 = i * PW_N;
      hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      unsigned char* st = ring + s * stage_bytes;
      if (active) {
        unsigned char* tile = st + (b >> 3) * PW_B_CHUNK;
        // codes + 128 in every byte, for codes::biased_byte_f32
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          w[j].x ^= 0x80808080u;
          w[j].y ^= 0x80808080u;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // slot 8 a + e: its depth 8 b .. + 8
          uint32_t o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t lo = e < 4 ? w[2 * j].x : w[2 * j].y;
            const uint32_t hi = e < 4 ? w[2 * j + 1].x : w[2 * j + 1].y;
            o[j] = codes::pack_bf16x2(codes::biased_byte_f32(lo, e & 3),
                                      codes::biased_byte_f32(hi, e & 3));
          }
          // row 8 a + e of the chunk: its 16-byte piece b % 8 lands at
          // piece (b % 8) ^ e (the row's swizzle, row % 8 == e)
          *reinterpret_cast<uint4*>(tile + (8 * a + e) * 128 +
                                    (((b & 7) ^ e) << 4)) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
      if (ptid < PW_N) {
        side[s * 2 * PW_N + ptid] = bsc.x;
        side[s * 2 * PW_N + PW_N + ptid] = bsc.y;
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&full[s]);
    };
    // two chunks in flight: a buffer is loaded again as soon as converted
    uint2 w0[8], w1[8];
    float2 b0, b1;
    load(w0, b0, 0);
    load(w1, b1, 1);
    for (int i = 0; i < n_chunks; i += 2) {
      convert(w0, b0, i);
      load(w0, b0, i + 2);
      if (i + 1 < n_chunks) {
        convert(w1, b1, i + 1);
        load(w1, b1, i + 3);
      }
    }
    return;
  }

  // ---- consumers ----
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // accumulator 4c + v holds row r0 + 8 (v >> 1), slot 8c + 2 tig + (v & 1)
  // of the chunk; this warp's rows are wr .. wr + 16 of the block's
  const int wr = 64 * wg + 16 * warp, r0 = wr + gid;
  float tg[2][RT];
  int ti[2][RT];
  float row_thr[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < RT; ++e) {
      tg[h][e] = neg_inf();
      ti[h][e] = 0;
    }
  // lanes 0..15 keep row wr + lane's running list
  float* lg = run_g + (wr + (lane & 15)) * PW_MAX_KW;
  int* li = run_i + (wr + (lane & 15)) * PW_MAX_KW;
  int filled = 0;
  float acc[PW_NACC];
  const unsigned char* a_rows = sa + wg * (64 * 128);

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % stages, n0 = i * PW_N;
    const unsigned char* st = ring + s * stage_bytes;
    hopper::mbar_wait(&full[s], (i / stages) & 1);
    hopper::wgmma_fence();
    for (int kk = 0; kk < R / 16; ++kk) {
      const int at = (kk >> 2), off = 32 * (kk & 3);
      hopper::wgmma_m64n64k16_ss(
          acc, hopper::desc_sw128(a_rows + at * PW_A_CHUNK + off),
          hopper::desc_sw128(st + at * PW_B_CHUNK + off), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_accumulators<PW_NACC>(acc);

    // the fold: this thread's 16 slots of each of its rows, 8 gains a step
    // in ascending slot order; a gain enters its list if it beats the
    // list's last entry and reaches the row's threshold (the best of the
    // four lanes' last entries, agreed after every step: the row holds RT
    // >= ranks gains at least that good), tested for all 8 at once with no
    // branch
    const float* tb = side + s * 2 * PW_N;
#pragma unroll
    for (int step = 0; step < PW_N / 16; ++step) {
      float x[8];
      unsigned m0 = 0, m1 = 0;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int jt = 16 * step + 8 * cc + 2 * tig;
        const float2 bs = *reinterpret_cast<const float2*>(tb + jt);
        const float2 sc = *reinterpret_cast<const float2*>(tb + PW_N + jt);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // separate roundings, as the plain version computes them
          float g = __fmul_rn(acc[8 * step + 4 * cc + v], v & 1 ? sc.y : sc.x);
          g = __fadd_rn(g, v & 1 ? bs.y : bs.x);
          const int u = 4 * cc + v, h = v >> 1;
          x[u] = g;
          const bool pass = g > tg[h][RT - 1] && g >= row_thr[h];
          if (h) m1 |= pass ? 1u << u : 0u; else m0 |= pass ? 1u << u : 0u;
        }
      }
      // the few that pass, in ascending slot order (x is picked by a select
      // chain, not a runtime index, to stay in registers)
      for (; m0; m0 &= m0 - 1) {
        const int u = __ffs(m0) - 1;
        float g = x[0];
#pragma unroll
        for (int w = 1; w < 8; ++w) g = u == w ? x[w] : g;
        if (g > tg[0][RT - 1])
          tile_insert<RT>(tg[0], ti[0], g,
                          n0 + 16 * step + 8 * (u >> 2) + 2 * tig + (u & 1), RT);
      }
      for (; m1; m1 &= m1 - 1) {
        const int u = __ffs(m1) - 1;
        float g = x[0];
#pragma unroll
        for (int w = 1; w < 8; ++w) g = u == w ? x[w] : g;
        if (g > tg[1][RT - 1])
          tile_insert<RT>(tg[1], ti[1], g,
                          n0 + 16 * step + 8 * (u >> 2) + 2 * tig + (u & 1), RT);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the row's four lanes agree
        float t = tg[h][RT - 1];
        t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
        row_thr[h] = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // the fold read its side

    if ((n0 + PW_N) % tds == 0 || i == n_chunks - 1) {  // the tile's end
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = ((r0 + 8 * h) * 4 + tig) * RT;
#pragma unroll
        for (int e = 0; e < RT; ++e) {
          lane_g[at + e] = tg[h][e];
          lane_i[at + e] = ti[h][e];
          tg[h][e] = neg_inf();
          ti[h][e] = 0;
        }
        row_thr[h] = neg_inf();
      }
      __syncwarp();
      if (lane < 16) {
        // the row's four sorted lane lists merged, best first, to the
        // tile's `ranks` best (gain desc, slot asc), each offered in turn
        const float* rg = lane_g + (wr + lane) * 4 * RT;
        const int* ri = lane_i + (wr + lane) * 4 * RT;
        int head[4] = {0, 0, 0, 0};
        for (int n = 0; n < ranks; ++n) {
          float x = neg_inf();
          int slot = 0, from = -1;
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            if (head[l] < RT) {
              const float y = rg[l * RT + head[l]];
              const int ys = ri[l * RT + head[l]];
              if (y > neg_inf() && (from < 0 || y > x || (y == x && ys < slot))) {
                x = y;
                slot = ys;
                from = l;
              }
            }
          }
          if (from < 0) break;  // every list is down to -inf
#pragma unroll
          for (int l = 0; l < 4; ++l) head[l] += l == from;
          int pos = filled;
          while (pos > 0 && lg[pos - 1] < x) {
            lg[pos] = lg[pos - 1];
            li[pos] = li[pos - 1];
            --pos;
          }
          lg[pos] = x;
          li[pos] = slot;
          ++filled;
        }
      }
      __syncwarp();
    }
  }
  if (lane < 16) {
    float* og = out_g + (size_t)(e0 + wr + lane) * kw;
    int* oi = out_i + (size_t)(e0 + wr + lane) * kw;
    for (int j = 0; j < kw; ++j) {
      og[j] = j < filled ? lg[j] : neg_inf();
      oi[j] = j < filled ? li[j] : 0;
    }
  }
}

// Deep ranks (ranks > RMAX): one block a pair block of the chunk that starts
// at block b0 writes its rows' scaled and biased gains, each rounded on its
// own as above, to ws[(blockIdx.x * TE + row) * S + slot].
__global__ void __launch_bounds__(THREADS) pair_gains_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ ws, int C, int R,
    int S, int b0) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = b0 + blockIdx.x;
  if (n_real && blk >= *n_real) return;  // block-uniform
  const float* sg = reinterpret_cast<const float*>(smem + SMEM_A + SMEM_B);
  const float* sbias = sg + TS * LDG;
  const float* sscale = sbias + TS;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c = min(max(blk_cluster[blk], 0), C - 1);
  const int8_t* slab = docs + (size_t)c * R * S;
  float* out = ws + (size_t)blockIdx.x * TE * S;
  for (int s0 = 0; s0 < S; s0 += TS) {
    gain_subtile(q, slab, bias + (size_t)c * S, scale + (size_t)c * S, rows,
                 blk * TE, R, S, s0, smem, tid, warp);
    // consecutive threads on consecutive slots of a row: coalesced stores
    const int ncols = min(TS, S - s0);
    for (int e = tid; e < TE * TS; e += THREADS) {
      const int r = e / TS, cc = e - r * TS;
      if (cc < ncols) {
        float x = __fmul_rn(sg[cc * LDG + r], sscale[cc]);
        x = __fadd_rn(x, sbias[cc]);
        out[(size_t)r * S + s0 + cc] = x;
      }
    }
    __syncthreads();  // the next sub-tile overwrites sg / sbias / sscale
  }
}

template <int RT>
cudaError_t launch(const __nv_bfloat16* q, const int8_t* docs, const float* bias,
                   const float* scale, const int* blk_cluster, const int* rows,
                   const int* n_real, float* out_g, int* out_i, int G, int C, int R,
                   int S, int tds, int ranks, int kw, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(grouped_pair_topk_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  grouped_pair_topk_kernel<RT><<<dim3((unsigned)G), THREADS, SMEM, stream>>>(
      q, docs, bias, scale, blk_cluster, rows, n_real, out_g, out_i, C, R, S, tds,
      ranks, kw);
  return cudaGetLastError();
}

template <int RT>
cudaError_t launch_pair_wgmma(const void* q, const void* docs, const void* bias,
                              const void* scale, const void* blk_cluster,
                              const void* rows, const void* n_real, void* out_g,
                              void* out_i, int G, int C, int R, int S, int tds,
                              int ranks, int kw, int optin, cudaStream_t stream) {
  int stages = PW_MAX_STAGES;
  while (stages > 2 && pw_smem_bytes(R, stages, RT) > optin) --stages;
  const int smem = pw_smem_bytes(R, stages, RT);
  if (smem > optin) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_wgmma_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pair_wgmma_kernel<RT><<<dim3((unsigned)G), PW_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(docs),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const int*>(blk_cluster), static_cast<const int*>(rows),
      static_cast<const int*>(n_real), static_cast<float*>(out_g),
      static_cast<int*>(out_i), C, R, S, tds, ranks, kw, stages);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q is [*, R] bf16; docs [C, R, S] int8; bias and scale
// [C, S] f32; blk_cluster [G] i32; rows [G * 256] i32 or null; n_real a device
// i32 or null; out_g [G * 256, kw] f32 and out_i [G * 256, kw] i32. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int grouped_pair_topk_launch(const void* q, const void* docs,
                                        const void* bias, const void* scale,
                                        const void* blk_cluster, const void* rows,
                                        const void* n_real, void* out_g, void* out_i,
                                        int G, int C, int R, int S, int tds, int ranks,
                                        int kw, void* stream) {
  if (G < 1 || C < 1 || R < 16 || R % 16 != 0 || S < 8 || S % 8 != 0 ||
      tds < TS || tds % TS != 0 || ranks < 1 || ranks > RMAX ||
      kw != ranks * ((S + tds - 1) / tds) || q == nullptr || docs == nullptr ||
      bias == nullptr || scale == nullptr || blk_cluster == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const int8_t* dd = static_cast<const int8_t*>(docs);
  const float* bb = static_cast<const float*>(bias);
  const float* ss = static_cast<const float*>(scale);
  const int* bc = static_cast<const int*>(blk_cluster);
  const int* rw = static_cast<const int*>(rows);
  const int* nr = static_cast<const int*>(n_real);
  float* og = static_cast<float*>(out_g);
  int* oi = static_cast<int*>(out_i);
#define GPT_LAUNCH(RT) \
  return (int)launch<RT>(qq, dd, bb, ss, bc, rw, nr, og, oi, G, C, R, S, tds, ranks, kw, st)
  if (ranks <= 1) GPT_LAUNCH(1);
  if (ranks <= 2) GPT_LAUNCH(2);
  if (ranks <= 4) GPT_LAUNCH(4);
  if (ranks <= 8) GPT_LAUNCH(8);
  if (ranks <= RREG) GPT_LAUNCH(RREG);
  GPT_LAUNCH(RMAX);
#undef GPT_LAUNCH
}

// ranks <= 8 and kw <= 16 over slabs of depth R <= 128 through
// pair_wgmma_kernel
// (ops/grouped_topk.py::_plan); q 16-byte aligned. Arguments and results as
// grouped_pair_topk_launch.
extern "C" int grouped_pair_topk_wgmma_launch(
    const void* q, const void* docs, const void* bias, const void* scale,
    const void* blk_cluster, const void* rows, const void* n_real, void* out_g,
    void* out_i, int G, int C, int R, int S, int tds, int ranks, int kw,
    void* stream) {
  if (G < 1 || C < 1 || R < 16 || R % 16 != 0 || R > PW_MAX_R || S < 8 ||
      S % 8 != 0 || tds < PW_N || tds % PW_N != 0 || ranks < 1 ||
      ranks > PW_MAX_RANKS || kw != ranks * ((S + tds - 1) / tds) ||
      kw > PW_MAX_KW ||
      q == nullptr || docs == nullptr || bias == nullptr || scale == nullptr ||
      blk_cluster == nullptr || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(docs) % 8)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PW_LAUNCH(RT) \
  return (int)launch_pair_wgmma<RT>(q, docs, bias, scale, blk_cluster, rows, \
                                    n_real, out_g, out_i, G, C, R, S, tds,   \
                                    ranks, kw, optin, st)
  if (ranks <= 1) PW_LAUNCH(1);
  if (ranks <= 2) PW_LAUNCH(2);
  if (ranks <= 4) PW_LAUNCH(4);
  PW_LAUNCH(8);
#undef PW_LAUNCH
}

// Deep ranks: any ranks (the launch above stops at RMAX). Pair blocks go in
// chunks of chunk_blocks: pair_gains_kernel writes a chunk's gains to ws_g
// [chunk_blocks * 256, S]; deep::reduce_rows cuts every tile of tds slots to
// its `ranks` best (ties to the lower slot) and merges the tiles' sorted
// lists to kw; the list is written out with the stored gains, (-inf, 0) past
// the offers. Rows of blocks at or past *n_real are skipped and left
// unwritten. ws_a / ws_b hold chunk_blocks * 256 x list_entries words, dst
// chunk_blocks * 256 x kw (ops/deep_topk.py::pair_plan). Arguments otherwise
// as grouped_pair_topk_launch. Returns 0, or deep::fail's code of the step
// that failed.
extern "C" int grouped_pair_topk_deep_launch(
    const void* q, const void* docs, const void* bias, const void* scale,
    const void* blk_cluster, const void* rows, const void* n_real, void* ws_g,
    void* ws_a, void* ws_b, void* dst, void* out_g, void* out_i, int G, int C,
    int R, int S, int tds, int ranks, int kw, int chunk_blocks, void* stream) {
  if (G < 1 || C < 1 || R < 16 || R % 16 != 0 || S < 8 || S % 8 != 0 ||
      tds < TS || tds % TS != 0 || tds > deep::RUN_MAX || ranks < 1 ||
      kw != ranks * ((S + tds - 1) / tds) || chunk_blocks < 1 || q == nullptr ||
      docs == nullptr || bias == nullptr || scale == nullptr ||
      blk_cluster == nullptr || ws_g == nullptr || dst == nullptr ||
      (S > tds && (ws_a == nullptr || ws_b == nullptr)))
    return deep::fail(deep::STEP_ARGS, cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      pair_gains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return deep::fail(deep::STEP_GAINS, err);
  const int* nr = static_cast<const int*>(n_real);
  float* wg = static_cast<float*>(ws_g);
  auto* d = static_cast<deep::u64*>(dst);
  for (int b0 = 0; b0 < G; b0 += chunk_blocks) {
    const int nb = min(chunk_blocks, G - b0);
    const long long rows0 = (long long)b0 * TE, n_rows = (long long)nb * TE;
    pair_gains_kernel<<<nb, THREADS, SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(docs),
        static_cast<const float*>(bias), static_cast<const float*>(scale),
        static_cast<const int*>(blk_cluster), static_cast<const int*>(rows), nr,
        wg, C, R, S, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return deep::fail(deep::STEP_GAINS, err);
    int len = 0;
    const int code = deep::reduce_rows(wg, S, n_rows, S, tds, ranks, kw, 0,
                                       static_cast<deep::u64*>(ws_a),
                                       static_cast<deep::u64*>(ws_b), d, kw,
                                       &len, nr, TE, rows0, st);
    if (code) return code;
    err = deep::emit<int>(d, kw, len, wg, S,
                          static_cast<float*>(out_g) + rows0 * kw,
                          static_cast<int*>(out_i) + rows0 * kw, kw, n_rows, nr,
                          TE, rows0, st);
    if (err != cudaSuccess) return deep::fail(deep::STEP_EMIT, err);
  }
  return 0;
}

