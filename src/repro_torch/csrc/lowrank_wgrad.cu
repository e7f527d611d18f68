// Low-rank Wgrad projection (MeCeFO technique III): A = (x @ V1)^T @ dy.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_wgrad.py:
// lowrank_wgrad_project (Pallas grid (m/bm, T/bt), token axis innermost, an
// (r x bm) f32 accumulator carried in VMEM across the token blocks, and
// P = x_blk @ V1 recomputed for every m block).  x is (T, n), dy (T, m) and
// V1 (n, r), all f32 or all bf16; every product accumulates in f32, P is
// kept in f32 precision, and A (r x m) is f32.  The wrapper forms
// dW = V1 @ A outside the kernel, as kernels/ops.py does in the JAX
// package.
//
// Bound on the H100: bytes.  At the training path's shapes (T = 8192,
// n x m = 1024 x 2736 or 2736 x 1024, r = 64) the kernel must read x and dy
// once and write A: ~62 MB in bf16, 0.0186 ms at 3.35 TB/s, against ~3.9
// GFLOP, 0.004 ms at 989 TFLOP/s.
//
// bf16 (the main path): two tensor-core passes and a fixed-order sum.  The
// earlier kernel (kept below for f32) did its products as f32 FMAs on the
// CUDA cores (67 TFLOP/s at most: >= 0.059 ms for this work), ran one
// block per 64-token chunk (128 blocks: less than one wave on 132 SMs,
// each walking all 43 m tiles in turn), loaded operands one element at a
// time through synchronous stages, and wrote an f32 partial per chunk: an
// 89.6 MB round trip through device memory at these shapes, by itself 2.9x
// the bound.  Here:
//   1. P pass: P = x V1 (T x r), 64-token x 64-rank tiles (8 warps),
//      mma.sync bf16 products with f32 accumulation (exact products, so
//      nothing is lost to the tensor cores), x and V1 streamed in 16-byte
//      cp.async copies through a 4-stage shared-memory ring.  P is written
//      already split, P_hi = bf16(P) and P_lo = bf16(P - P_hi), as two
//      (T x r_pad) bf16 buffers in the layout the second pass reads.  This
//      is the one place the design leaves the TPU kernel's "P never leaves
//      fast memory": 4 MB of traffic at T = 8192, r = 64 (2 MB written, read
//      back from L2) for a second pass with full parallelism.
//   2. Wgrad pass: A = P_hi^T dy + P_lo^T dy, a tall-skinny product (M = r,
//      N = m, K = T) split over 64 x 128 tiles of (r, m) and over token
//      ranges, so that >= 256 blocks are in flight at both main-path shapes
//      (22 m tiles x 12 splits; 8 x 32).  Each block streams its dy tiles
//      and the matching P rows through a 3-stage cp.async ring: two stages'
//      copies are in flight behind the current stage's MMAs.  The pass is
//      launched with programmatic dependence on the P pass: its blocks
//      start as soon as every P-pass block runs, issue their first dy
//      copies (dy does not depend on P), and only then wait for the P pass
//      to finish.  The split P carries P to ~2^-17 relative (mma.cuh:
//      split_pair), far inside the 1e-4-of-max|A| limit that a P rounded to
//      bf16 misses.  Each block writes an f32 partial (splits x r x m: 8.4
//      MB at both shapes, not 89.6 MB).
//   3. A fixed-order sum of the partials over the splits, over all SMs.  No
//      float atomics anywhere, so A repeats bitwise from run to run.  (A
//      last-block-sums-its-tile ticket instead of this pass was slower on
//      the H100: 22 blocks summing 12 partials each make a long tail.)
// mma.sync m16n8k16 (with ldmatrix, .trans for the k-major operands)
// rather than wgmma: the kernel is bound by bytes, and its ~6.8 GFLOP
// (split included) take a few microseconds even at mma.sync's rate, so
// wgmma's extra rate would not show; mma.sync also masks ragged tiles
// simply.  Each pass runs close to the rate at which the H100 streams a
// cold 17-45 MB input (PERF.md); what separates the kernel from its bound
// is the second pass over the data (P round trip, partials, a third
// launch), not the arithmetic.  Ragged T, n, m and r (1..256) are masked in
// the kernel: rows and columns outside the tensors are zero-filled in
// shared memory, and rows whose length is not a multiple of 8 elements (or
// whose base is not 16-byte aligned) are loaded element by element instead
// of by cp.async.
//
// f32: the first version, CUDA-core FMAs (not on any main path): one block
// per 64-token chunk computes its P into shared memory, writes its partial
// P^T dy, and the same fixed-order sum adds the chunks.
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int LR_TILE = 64;      // r tile (both passes), n step (pass 1), token step (pass 2)
constexpr int LR_PITCH = LR_TILE + 8;  // bf16 per shared-memory row: 16-byte pad
// pass 1: 4 x 2 warps, each 16 tokens x 32 ranks
constexpr int P1_WM = 4;
constexpr int P1_NT = 64 * P1_WM;
constexpr int P1_BM = 16 * P1_WM;          // tokens per block
constexpr int P1_STAGES = 4;
constexpr int P1_XT = P1_BM * LR_PITCH;    // x tile
constexpr int P1_ST = P1_XT + LR_TILE * LR_PITCH;  // x tile + V1 tile
constexpr size_t P1_SMEM = sizeof(bf16) * P1_STAGES * P1_ST;
// pass 2: 2 x 4 warps, each 32 ranks x 32 columns of m
constexpr int P2_WC = 4;
constexpr int P2_NT = 64 * P2_WC;
constexpr int P2_BN = 32 * P2_WC;          // columns of m per block
constexpr int P2_DP = P2_BN + 8;           // dy tile pitch
constexpr int P2_STAGES = 3;
constexpr int P2_PT = LR_TILE * LR_PITCH;  // one of the P_hi, P_lo tiles
constexpr int P2_ST = 2 * P2_PT + LR_TILE * P2_DP;
constexpr size_t P2_SMEM = sizeof(bf16) * P2_STAGES * P2_ST;
constexpr int TARGET_BLOCKS = 264;  // pass-2 blocks to aim for: two on each of 132 SMs

struct Plan {
  int r_pad, k_tiles, m_tiles, r_tiles, splits, per_split;
};

Plan make_plan(int n_tok, int m, int r) {
  Plan p;
  p.r_tiles = (r + LR_TILE - 1) / LR_TILE;
  p.r_pad = p.r_tiles * LR_TILE;
  p.k_tiles = (n_tok + LR_TILE - 1) / LR_TILE;
  p.m_tiles = (m + P2_BN - 1) / P2_BN;
  const int tiles = p.m_tiles * p.r_tiles;
  int splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  splits = std::max(1, std::min(p.k_tiles, splits));
  p.per_split = (p.k_tiles + splits - 1) / splits;
  p.splits = (p.k_tiles + p.per_split - 1) / p.per_split;
  return p;
}

// rows x COLS bf16 at (row0, col0) of a row-major (n_rows x n_cols) matrix
// with leading dimension ld, into shared memory of pitch PITCH, by NT
// threads; what lies outside the matrix is zero.  `vec`: every row start is
// 16-byte aligned and n_cols % 8 == 0, so each 8-element chunk is whole and
// goes by cp.async.
template <int NT, int COLS, int PITCH>
__device__ __forceinline__ void lr_load_tile(bf16* dst, const bf16* src, int ld, int n_rows,
                                             int n_cols, int row0, int col0, int rows,
                                             bool vec) {
  constexpr int CPR = COLS / 8;
  for (int i = threadIdx.x; i < rows * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int gr = row0 + r, gc = col0 + c;
    bf16* d = dst + r * PITCH + c;
    if (gr < n_rows && gc < n_cols) {
      const bf16* s = src + static_cast<size_t>(gr) * ld + gc;
      if (vec) {
        cp_async16(d, s, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = gc + e < n_cols ? s[e] : __float2bfloat16_rn(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// pass 1: P (T x r_pad) = x @ V1, written as bf16 P_hi and P_lo
__global__ void __launch_bounds__(P1_NT)
lowrank_p_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ v1,
                      bf16* __restrict__ p_hi, bf16* __restrict__ p_lo, int n_tok, int n, int r,
                      int r_pad, bool x_vec, bool v_vec) {
  // the Wgrad pass may start now: it streams its first dy tiles, then waits
  // for this grid to finish before it reads P
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int t0 = blockIdx.x * P1_BM, r0 = blockIdx.y * LR_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % P1_WM, wn = warp / P1_WM;  // 16 tokens x 32 ranks per warp
  const int n_k = (n + LR_TILE - 1) / LR_TILE;

  auto load = [&](int kt) {
    bf16* s = ring + (kt % P1_STAGES) * P1_ST;
    lr_load_tile<P1_NT, LR_TILE, LR_PITCH>(s, x, n, n_tok, n, t0, kt * LR_TILE, P1_BM, x_vec);
    lr_load_tile<P1_NT, LR_TILE, LR_PITCH>(s + P1_XT, v1, r, n, r, kt * LR_TILE, r0, LR_TILE,
                                           v_vec);
  };
#pragma unroll
  for (int s = 0; s < P1_STAGES - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();
  }

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<P1_STAGES - 2>();  // stage kt landed for this thread
    __syncthreads();                 // ... for all; stage (kt - 1) % STAGES is free
    if (kt + P1_STAGES - 1 < n_k) load(kt + P1_STAGES - 1);
    cp_async_commit();
    const bf16* xs = ring + (kt % P1_STAGES) * P1_ST;
    const bf16* vs = xs + P1_XT;
#pragma unroll
    for (int ks = 0; ks < LR_TILE / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, xs + (wm * 16 + (lane & 15)) * LR_PITCH + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, vs + (ks * 16 + (lane & 15)) * LR_PITCH + wn * 32 + np * 16 +
                           (lane >> 4) * 8);
        mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = r0 + wn * 32 + j * 8 + c2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + wm * 16 + g + half * 8;
      if (t < n_tok) {
        uint32_t hi, lo;
        split_pair(acc[j][2 * half], acc[j][2 * half + 1], hi, lo);
        const size_t at = static_cast<size_t>(t) * r_pad + col;
        *reinterpret_cast<uint32_t*>(p_hi + at) = hi;
        *reinterpret_cast<uint32_t*>(p_lo + at) = lo;
      }
    }
  }
}

// pass 2: part[split] (r x m) = P_hi^T dy + P_lo^T dy over the split's tokens
__global__ void __launch_bounds__(P2_NT)
lowrank_a_bf16_kernel(const bf16* __restrict__ p_hi, const bf16* __restrict__ p_lo,
                      const bf16* __restrict__ dy, float* __restrict__ part, int n_tok, int m,
                      int r, int r_pad, int per_split, bool dy_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * P2_BN, r0 = blockIdx.y * LR_TILE, split = blockIdx.z;
  const int k_tiles = (n_tok + LR_TILE - 1) / LR_TILE;
  const int kt0 = split * per_split;
  const int n_k = min(k_tiles, kt0 + per_split) - kt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 1, wc = warp >> 1;  // 32 ranks x 32 columns per warp

  auto load_p = [&](int i) {
    bf16* s = ring + (i % P2_STAGES) * P2_ST;
    const int tok = (kt0 + i) * LR_TILE;
    lr_load_tile<P2_NT, LR_TILE, LR_PITCH>(s, p_hi, r_pad, n_tok, r_pad, tok, r0, LR_TILE, true);
    lr_load_tile<P2_NT, LR_TILE, LR_PITCH>(s + P2_PT, p_lo, r_pad, n_tok, r_pad, tok, r0,
                                           LR_TILE, true);
  };
  auto load_dy = [&](int i) {
    bf16* s = ring + (i % P2_STAGES) * P2_ST;
    const int tok = (kt0 + i) * LR_TILE;
    lr_load_tile<P2_NT, P2_BN, P2_DP>(s + 2 * P2_PT, dy, m, n_tok, m, tok, m0, LR_TILE, dy_vec);
  };
  // dy does not depend on the P pass: its first stages go out before the
  // wait for that grid (a no-op when launched without programmatic
  // dependence); group s holds P's stage s, group 0 also these dy stages
#pragma unroll
  for (int s = 0; s < P2_STAGES - 1; ++s)
    if (s < n_k) load_dy(s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < P2_STAGES - 1; ++s) {
    if (s < n_k) load_p(s);
    cp_async_commit();
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<P2_STAGES - 2>();
    __syncthreads();
    if (it + P2_STAGES - 1 < n_k) {
      load_p(it + P2_STAGES - 1);
      load_dy(it + P2_STAGES - 1);
    }
    cp_async_commit();
    const bf16* hs = ring + (it % P2_STAGES) * P2_ST;
    const bf16* ls = hs + P2_PT;
    const bf16* ds = hs + 2 * P2_PT;
#pragma unroll
    for (int ks = 0; ks < LR_TILE / 16; ++ks) {
      // A = P^T: P is stored token-major, so its fragments load transposed
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int off = (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * LR_PITCH + wr * 32 +
                        mi * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(ah[mi], hs + off);
        ldsm_x4_t(al[mi], ls + off);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, ds + (ks * 16 + (lane & 15)) * P2_DP + wc * 32 + np * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], ah[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np], al[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], ah[mi], bfr[2], bfr[3]);
          mma_bf16(acc[mi][2 * np + 1], al[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = part + static_cast<size_t>(split) * r * m;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + wr * 32 + mi * 16 + g + half * 8;
      if (row >= r) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = m0 + wc * 32 + j * 8 + c2;
        if (col < m) out[static_cast<size_t>(row) * m + col] = acc[mi][j][2 * half];
        if (col + 1 < m) out[static_cast<size_t>(row) * m + col + 1] = acc[mi][j][2 * half + 1];
      }
    }

}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 tile each
constexpr int BT = 64;         // tokens per chunk (one block)
constexpr int KT = 32;         // slice of n per shared-memory stage
constexpr int RT = 64;         // tile of r
constexpr int MT = 64;         // tile of m
constexpr int XPITCH = KT + 1; // pad: x_s rows fall on distinct banks

size_t smem_bytes(int r_pad) {
  // p_s[BT][r_pad] + x_s[BT][XPITCH] + v_s[KT][RT] + d_s[BT][MT], all f32
  return sizeof(float) * (static_cast<size_t>(BT) * r_pad + BT * XPITCH + KT * RT + BT * MT);
}

__global__ void __launch_bounds__(kThreads)
lowrank_partial_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                           const float* __restrict__ v1, float* __restrict__ part,
                           int n_tok, int n, int m, int r, int r_pad) {
  extern __shared__ __align__(16) float smem[];
  float* p_s = smem;                 // P = x_chunk @ V1, (BT, r_pad)
  float* x_s = p_s + BT * r_pad;     // (BT, XPITCH)
  float* v_s = x_s + BT * XPITCH;    // (KT, RT)
  float* d_s = v_s + KT * RT;        // (BT, MT)
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.x * BT;

  // P (BT x r) = x[t0 : t0 + BT] @ V1, one RT-wide tile of r at a time
  for (int r0 = 0; r0 < r_pad; r0 += RT) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < n; k0 += KT) {
      for (int i = tid; i < BT * KT; i += kThreads) {
        const int row = i / KT, col = i % KT;
        const int t = t0 + row, k = k0 + col;
        x_s[row * XPITCH + col] = (t < n_tok && k < n) ? x[static_cast<size_t>(t) * n + k] : 0.f;
      }
      for (int i = tid; i < KT * RT; i += kThreads) {
        const int row = i / RT, col = i % RT;
        const int k = k0 + row, c = r0 + col;
        v_s[i] = (k < n && c < r) ? v1[static_cast<size_t>(k) * r + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = x_s[(ty * 4 + i) * XPITCH + kk];
        const float4 b = *reinterpret_cast<const float4*>(v_s + kk * RT + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] += a[i] * b.x;
          acc[i][1] += a[i] * b.y;
          acc[i][2] += a[i] * b.z;
          acc[i][3] += a[i] * b.w;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(p_s + (ty * 4 + i) * r_pad + r0 + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();

  // part[chunk] (r x m) = P^T @ dy[t0 : t0 + BT], one MT-wide tile of m at a time
  float* out = part + static_cast<size_t>(blockIdx.x) * r * m;
  for (int m0 = 0; m0 < m; m0 += MT) {
    for (int i = tid; i < BT * MT; i += kThreads) {
      const int row = i / MT, col = i % MT;
      const int t = t0 + row, c = m0 + col;
      d_s[i] = (t < n_tok && c < m) ? dy[static_cast<size_t>(t) * m + c] : 0.f;
    }
    __syncthreads();
    for (int r0 = 0; r0 < r_pad; r0 += RT) {
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < BT; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(p_s + k * r_pad + r0 + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(d_s + k * MT + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] += av[i] * b.x;
          acc[i][1] += av[i] * b.y;
          acc[i][2] += av[i] * b.z;
          acc[i][3] += av[i] * b.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = r0 + ty * 4 + i;
        if (rr >= r) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = m0 + tx * 4 + j;
          if (cc < m) out[static_cast<size_t>(rr) * m + cc] = acc[i][j];
        }
      }
    }
    __syncthreads();
  }
}

// A[i] = sum over parts c = 0, 1, ... of part[c][i], in that order
__global__ void __launch_bounds__(kThreads)
lowrank_reduce_kernel(const float* __restrict__ part, float* __restrict__ a,
                      int parts, long long rm) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rm) return;
  float s = 0.f;
  for (int c = 0; c < parts; ++c) s += part[static_cast<size_t>(c) * rm + i];
  a[i] = s;
}

int reduce(const float* part, float* a, int parts, int r, int m, cudaStream_t stream) {
  const long long rm = static_cast<long long>(r) * m;
  const long long blocks = (rm + kThreads - 1) / kThreads;
  lowrank_reduce_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(part, a, parts, rm);
  return static_cast<int>(cudaGetLastError());
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_bf16(const bf16* x, const bf16* dy, const bf16* v1, float* scratch, float* a,
                int n_tok, int n, int m, int r, cudaStream_t stream) {
  const Plan p = make_plan(n_tok, m, r);
  bf16* p_hi = reinterpret_cast<bf16*>(scratch);
  bf16* p_lo = p_hi + static_cast<size_t>(n_tok) * p.r_pad;
  float* part = reinterpret_cast<float*>(p_lo + static_cast<size_t>(n_tok) * p.r_pad);
  int err = set_smem(reinterpret_cast<const void*>(lowrank_p_bf16_kernel), P1_SMEM);
  if (err) return err;
  err = set_smem(reinterpret_cast<const void*>(lowrank_a_bf16_kernel), P2_SMEM);
  if (err) return err;
  const dim3 g1((n_tok + P1_BM - 1) / P1_BM, p.r_tiles);
  lowrank_p_bf16_kernel<<<g1, P1_NT, P1_SMEM, stream>>>(
      x, v1, p_hi, p_lo, n_tok, n, r, p.r_pad, n % 8 == 0 && aligned16(x),
      r % 8 == 0 && aligned16(v1));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // the Wgrad pass launches with programmatic dependence on the P pass
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.m_tiles, p.r_tiles, p.splits);
  cfg.blockDim = dim3(P2_NT);
  cfg.dynamicSmemBytes = P2_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, lowrank_a_bf16_kernel, static_cast<const bf16*>(p_hi),
      static_cast<const bf16*>(p_lo), dy, part, n_tok, m, r, p.r_pad, p.per_split,
      m % 8 == 0 && aligned16(dy)));
  if (err) return err;
  return reduce(part, a, p.splits, r, m, stream);
}

int launch_f32(const float* x, const float* dy, const float* v1, float* part, float* a,
               int n_tok, int n, int m, int r, cudaStream_t stream) {
  const int chunks = (n_tok + BT - 1) / BT;
  const int r_pad = (r + RT - 1) / RT * RT;
  const size_t smem = smem_bytes(r_pad);
  int err = set_smem(reinterpret_cast<const void*>(lowrank_partial_f32_kernel), smem);
  if (err) return err;
  lowrank_partial_f32_kernel<<<chunks, kThreads, smem, stream>>>(x, dy, v1, part, n_tok, n, m,
                                                                  r, r_pad);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return reduce(part, a, chunks, r, m, stream);
}

}  // namespace

// f32 scratch elements the caller allocates for one launch: bf16 the split
// P (2 x n_tok x r_pad bf16) and the partials (splits x r x m); f32 the
// partials (ceil(n_tok / 64) x r x m).
extern "C" long long lowrank_wgrad_scratch(int n_tok, int n, int m, int r, int dtype) {
  (void)n;
  if (dtype == DT_BF16) {
    const Plan p = make_plan(n_tok, m, r);
    return static_cast<long long>(n_tok) * p.r_pad + static_cast<long long>(p.splits) * r * m;
  }
  return static_cast<long long>((n_tok + BT - 1) / BT) * r * m;
}

// x: (n_tok, n), dy: (n_tok, m), v1: (n, r), contiguous, one dtype;
// scratch: f32, lowrank_wgrad_scratch(...) elements; a: f32 (r, m) output.
// r <= 256.
extern "C" int lowrank_wgrad_launch(const void* x, const void* dy, const void* v1,
                                    void* scratch, void* a, int n_tok, int n, int m, int r,
                                    int dtype, void* stream) {
  if (n_tok <= 0 || n <= 0 || m <= 0 || r <= 0 || r > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  float* out = static_cast<float*>(a);
  if (dtype == DT_BF16) {
    return launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                       static_cast<const bf16*>(v1), sc, out, n_tok, n, m, r, s);
  }
  if (dtype == DT_F32) {
    return launch_f32(static_cast<const float*>(x), static_cast<const float*>(dy),
                      static_cast<const float*>(v1), sc, out, n_tok, n, m, r, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
