// Split-KV decode attention shared by the three decode kernels:
// paged_decode.cu (kernel #1, cache rows reached through a page table),
// flash_decode.cu (kernel #5, rows of a dense cache) and paged_decode_q8.cu
// (the int8 page walk: int8 rows with one f32 scale per page).  #1 and #5
// replace the TPU kernels src/repro/kernels/paged_decode.py:
// paged_flash_decode and src/repro/kernels/flash_decode.py:flash_decode; the
// int8 walk replaces the XLA walk src/repro/kernels/xla_paged.py:
// paged_flash_decode_xla with k_scale/v_scale.  All instantiate the two
// kernels below and differ only in the Rows policy: how a row's address is
// computed (a page-table lookup, clamped as XLA gathers clamp, against a
// dense stride) and, for the int8 walk, the page's scale (kScaled).  The
// cache rows have their own type R (bf16 or f32 as q for #1 and #5, int8
// for the walk), q and o the type T.
//
// Bound on the H100: KV bytes.  A decode step does 4·G·hd flops per cache
// row (2·hd·2 bytes of K and V in bf16), about 1 flop a byte, far below the
// ridge, so the least time is the K/V rows below each lane's length over
// 3.35 TB/s.  What limits a decode kernel at serving shapes is latency: a
// lane of 1024 rows walked by one block folds 64 pages in sequence while
// the short lanes' SMs idle, with one page's bytes in flight at a time.
//
// Design.
// 1. Split over the cache length.  A lane's fold blocks (pages for #1,
//    block_k rows for #5) are cut into splits of split_blocks blocks (the
//    wrappers pass SPLIT_BLOCKS, one constant).  The grid is (splits, kv
//    heads, lanes), sized on the host from the page table's width or
//    ceil(Smax / block_k), never from the lengths; a block whose split
//    starts at or past its lane's length exits at once.  One block serves
//    the G query heads of its (kv head, lane) group, so each K/V row is read
//    once per group.  A group wider than MAX_GHD elements (G * hd: glm4's
//    16 x 128, granite's 48 x 128) is cut into sub-groups of GS heads
//    (sub_group: G itself when it fits, else the largest of 8, 4, 2, 1 that
//    divides G and fits), each with its own blocks, so the middle grid axis
//    is KV * G / GS; a K/V row is then read once per sub-group.  GS depends
//    on G and hd alone.
// 2. Within a split, cache rows stream through a ring of STAGES stages of
//    TILE rows, loaded with 16-byte cp.async in their own type (bf16 stays
//    bf16 and int8 stays int8 in shared memory, widened in registers; an
//    int8 row is multiplied by its page's scale as it is widened, the
//    reference's dequantize on fetch); rows at or past the
//    split's end or the lane's length are zero-filled, not read.  With
//    TILE = 16 and STAGES = 4 a split of 4 pages of 16 rows is in flight
//    at once; longer splits refill a stage as soon as it is folded.  One
//    barrier per tile (two when a stage is refilled).
// 3. Each warp folds its own rows of every tile (rows w, w + 4, ...) into
//    its own f32 online-softmax state (m, l, acc) for all G heads: a lane
//    holds hd / 32 elements of each head's q and acc; the tile's G x 4
//    dots of the warp are summed across lanes together (warp_sums: G x 4
//    + 5 shuffles, not 5 per dot); scores are kept in base-2 units so that
//    p = 2^(s - m) is one special-function op; the softmax runs in every
//    lane with no barrier.  At the split's end the four warps' states are
//    merged in warp order into the split's partial (m, l, acc[hd]) per
//    head, written in f32.  The kernel is instantiated for GS = 1, 2, 4 and
//    8, so a lane holds only its sub-group's heads in registers (any other
//    GS takes the general one).  Head widths 32, 64, 96, 128 and 192: a
//    lane holds hd / 32 elements, loaded as the widest aligned vectors
//    (hd 96 in bf16: three 2-byte loads).
// 4. A second kernel (launched with programmatic dependence on the first)
//    merges each lane's splits in ascending order: m = max m_i, l = sum
//    2^(m_i - m) l_i, acc = sum 2^(m_i - m) acc_i, o = acc / max(l, 1e-30)
//    in the output's type.  It reads the lane's split count from the
//    lengths on the device; a length-0 lane has no split and writes exactly
//    0.  Every lane goes through it, one split or many.  No float atomics.
//
// Choices, from the split sweep of chip_smoke.py (numbers in PERF.md):
// SPLIT_BLOCKS = 4.  At the serving shapes (page 16) splits of 2, 4 and 8
// pages time alike and 16 is slower (the longest lane's serial walk); 4
// keeps the grid at a quarter of the pages and a whole split in the ring.
// A 4-stage ring of 16-row tiles holds such a split at once; deeper rings
// and 8- or 32-row tiles timed no better.  What remains is latency: two
// dependent memory round trips (length and page ids, then the rows), the
// fold, the partials and the combine, against a bound of a few µs.
//
// Because SPLIT_BLOCKS is fixed, a lane's splits, tiles, warp rows and
// merge order depend only on its own length: its output is bitwise the same
// in any batch.  Kernel #5 over a dense view gathered page by page with
// block_k == page_size folds the same logical rows in the same groups and
// order as kernel #1, so the two are bitwise equal.  Every product-sum a
// compiler could contract is an explicit __fmaf_rn / __fmul_rn / __fadd_rn,
// so the two libraries cannot round differently.
//
// Masking semantics of the reference: scores scaled by 1/sqrt(hd) after the
// dot (here by log2(e)/sqrt(hd), the same softmax in base 2); rows at or
// past the length get no weight (p = 0 exactly, so a fully masked group of
// rows never adds 2^0 = 1 to l); the denominator is clamped at 1e-30.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace decode {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int TILE = 16;               // cache rows a ring stage holds
constexpr int RW = TILE / NWARPS;      // rows of a tile each warp folds
constexpr int STAGES = 4;              // ring depth
constexpr int MAX_GHD = 1024;          // GS * hd a block holds
constexpr int MAX_SPLIT_BLOCKS = NT;   // one thread loads each page id
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Shape {
  static constexpr int E = HD / 32;                  // elements of a row per lane
  static constexpr int GMAX = MAX_GHD / HD;          // most heads a block holds
  static constexpr int N = 16 / sizeof(T);           // elements per 16-byte chunk
  static constexpr int VPR = HD / N;                 // chunks per row
  static constexpr int STAGE = 2 * TILE * HD;        // K rows then V rows, elements
};

// ring | per-warp acc [NWARPS][G][HD] f32 | m, l [NWARPS][G] f32 | page ids
// | (scaled rows) K then V page scales [split_blocks] f32
template <typename R, int HD>
inline size_t smem_bytes(int G, int split_blocks, bool scaled = false) {
  return sizeof(R) * static_cast<size_t>(STAGES) * Shape<R, HD>::STAGE +
         sizeof(float) * (static_cast<size_t>(NWARPS) * G * HD + 2 * NWARPS * G) +
         sizeof(int) * static_cast<size_t>(split_blocks) +
         (scaled ? 2 * sizeof(float) * static_cast<size_t>(split_blocks) : 0);
}

// the unsigned type of B bytes
template <int B> struct Chunk;
template <> struct Chunk<16> { using type = uint4; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<4> { using type = uint32_t; };
template <> struct Chunk<2> { using type = uint16_t; };
template <> struct Chunk<1> { using type = uint8_t; };

// E consecutive elements of T widened to f32.  p is E * sizeof(T) bytes
// past a 16-byte boundary times the lane, so it is aligned to the largest
// power of two (at most 16) dividing E * sizeof(T): loaded in chunks of that
// size.
template <typename T, int E>
__device__ __forceinline__ void load_e(const T* p, float (&out)[E]) {
  constexpr int BYTES = E * static_cast<int>(sizeof(T));
  constexpr int CH = BYTES % 16 == 0 ? 16
                     : BYTES % 8 == 0  ? 8
                     : BYTES % 4 == 0  ? 4
                     : BYTES % 2 == 0  ? 2
                                       : 1;
  constexpr int PER = CH / static_cast<int>(sizeof(T));
  using C = typename Chunk<CH>::type;
#pragma unroll
  for (int c = 0; c < BYTES / CH; ++c) {
    const C r = reinterpret_cast<const C*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < PER; ++i) out[c * PER + i] = to_f<T>(e[i]);
  }
}

// Rows of a dense (B, Smax, KV, hd) cache.
struct DenseRows {
  static constexpr bool kScaled = false;
  int smax;
  size_t row_stride;  // KV * hd elements
  __device__ __forceinline__ int fetch(int, int, int) const { return 0; }
  __device__ __forceinline__ void stash(int, int*, int) const {}
  __device__ __forceinline__ size_t offset(int b, int r, int, const int*) const {
    return (static_cast<size_t>(b) * smax + r) * row_stride;
  }
};

// Rows of a physical (n_pages, ps, KV, hd) pool through (B, P) page tables;
// row r of a lane lies in page tables[b, r / ps].  fetch/stash bring the
// split's page ids into shared memory (one thread each), clamped into the
// pool as XLA gathers clamp.
struct PagedRows {
  static constexpr bool kScaled = false;
  const int* tables;
  int n_pages;
  int ps;
  int P;
  size_t row_stride;
  __device__ __forceinline__ int fetch(int b, int first_blk, int split_blocks) const {
    const int i = first_blk + static_cast<int>(threadIdx.x);
    return (static_cast<int>(threadIdx.x) < split_blocks && i < P)
               ? tables[static_cast<size_t>(b) * P + i] : 0;
  }
  __device__ __forceinline__ void stash(int page, int* pages, int split_blocks) const {
    if (static_cast<int>(threadIdx.x) < split_blocks)
      pages[threadIdx.x] = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  }
  __device__ __forceinline__ size_t offset(int, int r, int first_blk, const int* pages) const {
    const int blk = r / ps;
    return (static_cast<size_t>(pages[blk - first_blk]) * ps + (r - blk * ps)) * row_stride;
  }
};

// PagedRows over an int8 pool with one f32 scale per page of this layer
// (k_scale, v_scale: (n_pages,)).  stash also brings each page's two
// scales into shared memory, after the page ids.
struct PagedRowsQ8 : PagedRows {
  static constexpr bool kScaled = true;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ void stash(int page, int* pages, int split_blocks) const {
    const int t = static_cast<int>(threadIdx.x);
    if (t < split_blocks) {
      const int p = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
      pages[t] = p;
      float* sc = reinterpret_cast<float*>(pages + split_blocks);
      sc[t] = k_scale[p];
      sc[split_blocks + t] = v_scale[p];
    }
  }
};

// Heads held in registers: GT when the sub-group size is a compile-time
// constant (the common GS = 1, 2, 4, 8), else the most a block may hold.
template <typename T, int HD, int GT>
struct HeadsHeld {
  static constexpr int value = GT > 0 ? GT : Shape<T, HD>::GMAX;
};

// Sums each of V values across the warp's 32 lanes and gives every lane
// every sum.  For V a power of two up to 32: log2(V) halving exchanges
// (each lane keeps one half of its values and adds its partner's copy of
// that half) leave lane L one partial, of index L >> (5 - log2 V); xor
// levels over the remaining lanes finish it; V broadcasts hand the sums
// round.  V + 5 shuffles in all, against 5 V for a butterfly per value.  The
// order of every sum is fixed, so every lane gets bitwise the same sums.
template <int V>
__device__ __forceinline__ void warp_sums(float (&v)[V]) {
  constexpr unsigned FULL = 0xffffffffu;
  if constexpr ((V & (V - 1)) == 0 && V <= 32) {
    constexpr int LOG2V = V == 32 ? 5 : V == 16 ? 4 : V == 8 ? 3 : V == 4 ? 2 : V == 2 ? 1 : 0;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int lvl = 0; lvl < LOG2V; ++lvl) {
      const int half = V >> (lvl + 1);
      const int off = 16 >> lvl;
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, off));
      }
    }
#pragma unroll
    for (int off = 16 >> LOG2V; off > 0; off >>= 1)
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], off));
    const float mine = v[0];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __shfl_sync(FULL, mine, i << (5 - LOG2V));
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __fadd_rn(v[i], __shfl_xor_sync(FULL, v[i], o));
    }
  }
}

// One warp folds rows warp, warp + NWARPS, ... of a staged tile into its
// (m, l, acc) for the group's G heads.  Scores are in base-2 units (scale2
// = log2(e) / sqrt(hd)), p = 2^(s - m) on the special-function unit.  Rows
// at or past row_end get no weight.  SCALED: row r's elements are multiplied
// by its page's scales, sc[blk] (K) and sc[split_blocks + blk] (V) with blk
// = r / bk - first_blk.
template <typename R, int HD, int GT, bool SCALED, int GA = HeadsHeld<R, HD, GT>::value>
__device__ __forceinline__ void fold_tile(
    const R* __restrict__ ks, const R* __restrict__ vs, int r_base, int row_end, int G,
    float scale2, const float (&qr)[GA][Shape<R, HD>::E], float (&m)[GA], float (&l)[GA],
    float (&acc)[GA][Shape<R, HD>::E], const float* __restrict__ sc, int bk, int first_blk,
    int split_blocks) {
  using S = Shape<R, HD>;
  constexpr int E = S::E;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float kk[RW][E], vv[RW][E];
  bool valid[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int j = warp + rr * NWARPS;
    valid[rr] = r_base + j < row_end;
    load_e<R, E>(ks + j * HD + lane * E, kk[rr]);
    load_e<R, E>(vs + j * HD + lane * E, vv[rr]);
    if constexpr (SCALED) {
      const int blk = min((r_base + j) / bk - first_blk, split_blocks - 1);
      const float ksc = sc[blk], vsc = sc[split_blocks + blk];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kk[rr][e] = __fmul_rn(kk[rr][e], ksc);
        vv[rr][e] = __fmul_rn(vv[rr][e], vsc);
      }
    }
  }
  float s[GA * RW];  // this lane's part of each (head, row) dot, then the dots
#pragma unroll
  for (int g = 0; g < GA; ++g) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      float d = 0.f;
      if (GT > 0 || g < G) {
        d = __fmul_rn(qr[g][0], kk[rr][0]);
#pragma unroll
        for (int e = 1; e < E; ++e) d = __fmaf_rn(qr[g][e], kk[rr][e], d);
      }
      s[g * RW + rr] = d;
    }
  }
  warp_sums<GA * RW>(s);
#pragma unroll
  for (int g = 0; g < GA; ++g) {
    if (GT > 0 || g < G) {
      float mx = m[g];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        s[g * RW + rr] = valid[rr] ? __fmul_rn(s[g * RW + rr], scale2) : NEG_INF;
        mx = fmaxf(mx, s[g * RW + rr]);
      }
      const float alpha = exp2_approx(__fsub_rn(m[g], mx));
      float p[RW];
      float psum = 0.f;
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        p[rr] = valid[rr] ? exp2_approx(__fsub_rn(s[g * RW + rr], mx)) : 0.f;
        psum = __fadd_rn(psum, p[rr]);
      }
      l[g] = __fmaf_rn(l[g], alpha, psum);
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = __fmul_rn(acc[g][e], alpha);
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) a = __fmaf_rn(p[rr], vv[rr][e], a);
        acc[g][e] = a;
      }
    }
  }
}

// Pass 1: grid (splits, H / GS, B), NT threads.  Block y holds
// query heads y * GS .. y * GS + GS - 1 (all of one kv head's group) of lane
// blockIdx.z and writes their split partials into part: acc [B][H][NS][HD],
// then (m, l) [B][H][NS][2], f32.  GS is GT when GT > 0.
template <typename T, typename R, int HD, int GT, typename Rows>
__global__ void __launch_bounds__(NT)
split_kernel(const T* __restrict__ q, const R* __restrict__ k, const R* __restrict__ v,
             const int* __restrict__ lens, Rows rows, float* __restrict__ part, int H, int KV,
             int gs, int bk, int rows_max, int split_blocks, float scale2) {
  using S = Shape<R, HD>;
  constexpr int E = S::E;
  constexpr int GA = HeadsHeld<R, HD, GT>::value;
  // the combine pass may be scheduled now; it waits for this grid before
  // it reads the partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, b = blockIdx.z;
  const int NS = gridDim.x;
  const int G = GT > 0 ? GT : gs;  // heads of this block
  const int head0 = blockIdx.y * G;
  const int kvh = head0 / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* ring = reinterpret_cast<R*>(smem_raw);
  float* w_acc = reinterpret_cast<float*>(ring + STAGES * S::STAGE);
  float* w_m = w_acc + NWARPS * G * HD;
  float* w_l = w_m + NWARPS * G;
  int* pages = reinterpret_cast<int*>(w_l + NWARPS * G);

  const int first_blk = split * split_blocks;
  const int page = rows.fetch(b, first_blk, split_blocks);  // in flight with the length
  int len = lens[b];
  len = len < 0 ? 0 : (len > rows_max ? rows_max : len);
  const int row0 = first_blk * bk;
  if (row0 >= len) return;
  const int span = split_blocks * bk;
  const int row_end = len - row0 < span ? len : row0 + span;
  const int n_tiles = (row_end - row0 + TILE - 1) / TILE;
  rows.stash(page, pages, split_blocks);
  __syncthreads();

  const size_t head_off = static_cast<size_t>(kvh) * HD;
  auto issue = [&](int t) {
    R* dst = ring + (t % STAGES) * S::STAGE;
    const int r_base = row0 + t * TILE;
    for (int i = tid; i < TILE * S::VPR; i += NT) {
      const int rr = i / S::VPR;
      const int c = (i - rr * S::VPR) * S::N;
      const int r = r_base + rr;
      const bool live = r < row_end;
      const size_t off = live ? rows.offset(b, r, first_blk, pages) + head_off + c : 0;
      cp_async16(dst + rr * HD + c, k + off, live ? 16 : 0);
      cp_async16(dst + (TILE + rr) * HD + c, v + off, live ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  float qr[GA][E], m[GA], l[GA], acc[GA][E];
  const T* qb = q + (static_cast<size_t>(b) * H + head0) * HD + lane * E;
#pragma unroll
  for (int g = 0; g < GA; ++g) {
    if (GT > 0 || g < G) load_e<T, E>(qb + g * HD, qr[g]);
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 1>();  // tile t has landed (this thread's copies)
    __syncthreads();              // every thread's copies of tile t
    const R* ks = ring + (t % STAGES) * S::STAGE;
    const int r_base = row0 + t * TILE;
    if (r_base + warp < row_end)
      fold_tile<R, HD, GT, Rows::kScaled>(ks, ks + TILE * HD, r_base, row_end, G, scale2, qr, m,
                                          l, acc, reinterpret_cast<const float*>(pages + split_blocks),
                                          bk, first_blk, split_blocks);
    if (t + STAGES < n_tiles) {
      __syncthreads();  // every warp is done with this stage
      issue(t + STAGES);
    }
    cp_async_commit();
  }

  // merge the warps' states in warp order into the split's partial
#pragma unroll
  for (int g = 0; g < GA; ++g) {
    if (GT > 0 || g < G) {
#pragma unroll
      for (int e = 0; e < E; ++e) w_acc[(warp * G + g) * HD + lane * E + e] = acc[g][e];
      if (lane == 0) {
        w_m[warp * G + g] = m[g];
        w_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  const int B = gridDim.z;
  float* part_ml = part + static_cast<size_t>(B) * H * NS * HD;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD;
    const int d = i - g * HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, w_m[w * G + g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = exp2_approx(__fsub_rn(w_m[w * G + g], mx));
      a = __fmaf_rn(c, w_acc[(w * G + g) * HD + d], a);
      ls = __fmaf_rn(c, w_l[w * G + g], ls);
    }
    const size_t row = (static_cast<size_t>(b) * H + head0 + g) * NS + split;
    part[row * HD + d] = a;
    if (d == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = ls;
    }
  }
}

// Pass 2: grid (H, B), HD threads.  Merges lane b's splits for head
// blockIdx.x in ascending order and writes o in T.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
combine_kernel(const float* __restrict__ part, const int* __restrict__ lens, T* __restrict__ o,
               int H, int NS, int bk, int rows_max, int split_blocks) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  int len = lens[b];  // written before pass 1 started, not by it
  len = len < 0 ? 0 : (len > rows_max ? rows_max : len);
  const int n_blk = (len + bk - 1) / bk;
  const int n_split = (n_blk + split_blocks - 1) / split_blocks;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // pass 1 done, partials visible
  const size_t row = (static_cast<size_t>(b) * H + h) * NS;
  const float* pa = part + row * HD;
  const float* ml = part + static_cast<size_t>(gridDim.y) * H * NS * HD + row * 2;
  // unrolled so that the loads of several splits are in flight together
  float mx = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float a = 0.f, ls = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float c = exp2_approx(__fsub_rn(ml[2 * s], mx));
    a = __fmaf_rn(c, pa[static_cast<size_t>(s) * HD + d], a);
    ls = __fmaf_rn(c, ml[2 * s + 1], ls);
  }
  o[(static_cast<size_t>(b) * H + h) * HD + d] = from_f<T>(__fdiv_rn(a, fmaxf(ls, 1e-30f)));
}

// Heads a block holds for a group of G query heads of width HD: G itself
// when G * HD <= MAX_GHD, else the largest of 8, 4, 2, 1 that divides G
// with GS * HD <= MAX_GHD.  A function of (G, HD) only.
inline int sub_group(int G, int HD) {
  if (G * HD <= MAX_GHD) return G;
  for (int gs = 8; gs > 1; gs >>= 1)
    if (G % gs == 0 && gs * HD <= MAX_GHD) return gs;
  return 1;
}

// the split kernel for GT heads a block; GT = 0, or a GT too wide for HD
// (never chosen by sub_group), is the general one
template <typename T, typename R, int HD, int GT, typename Rows>
inline auto split_fn() {
  if constexpr (GT * HD <= MAX_GHD) return split_kernel<T, R, HD, GT, Rows>;
  else return split_kernel<T, R, HD, 0, Rows>;
}

// Both passes on `stream`: pass 1 over NS = ceil(n_blocks / split_blocks)
// splits of every (head sub-group, lane), then the combine with
// programmatic dependence on it.  rows_max: the most rows a lane has (P *
// ps, or Smax); lengths are clamped to [0, rows_max].  Returns a
// cudaError_t.
template <typename T, int HD, typename Rows, typename R>
int launch(const T* q, const R* k, const R* v, const int* lens, const Rows& rows, float* part,
           T* o, int B, int H, int KV, int bk, int n_blocks, int rows_max, int split_blocks,
           float scale, cudaStream_t stream) {
  if (KV < 1 || H % KV || bk < 1 || split_blocks < 1 || split_blocks > MAX_SPLIT_BLOCKS ||
      n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int GS = sub_group(G, HD);
  const int NS = (n_blocks + split_blocks - 1) / split_blocks;
  if (NS > 0) {
    const size_t smem = smem_bytes<R, HD>(GS, split_blocks, Rows::kScaled);
    auto kern = GS == 1 ? split_fn<T, R, HD, 1, Rows>()
                : GS == 2 ? split_fn<T, R, HD, 2, Rows>()
                : GS == 4 ? split_fn<T, R, HD, 4, Rows>()
                : GS == 8 ? split_fn<T, R, HD, 8, Rows>()
                : split_fn<T, R, HD, 0, Rows>();
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<dim3(NS, H / GS, B), NT, smem, stream>>>(q, k, v, lens, rows, part, H, KV, GS, bk,
                                                   rows_max, split_blocks, scale * kLog2e);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(HD);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, combine_kernel<T, HD>,
                                             static_cast<const float*>(part), lens, o, H, NS, bk,
                                             rows_max, split_blocks));
}

}  // namespace decode
