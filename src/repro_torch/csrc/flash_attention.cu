// Causal GQA flash attention, forward only.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (Pallas grid (B, H, Sq/bq, Sk/bk), an f32 (m, l, acc)
// carry in VMEM across the sequential KV-block axis).  On the GPU the
// blocks run in parallel and in no order, so the KV axis becomes a loop
// inside one block: one block per (64-row q tile, q head, batch row) walks
// the KV tiles itself and keeps (m, l, acc) in registers.  It keeps the
// reference's semantics: scores scaled by 1/sqrt(hd) after the dot, masked
// with NEG_INF (causal: key <= query; and keys past Sk), an f32 online
// softmax, the denominator clamped at 1e-30, f32 probabilities in the PV
// product, one cast of the output, and KV tiles wholly in the future
// skipped (the loop stops at the causal limit).  GQA maps query head h to
// KV head h / (H / KV).  Both Sq and Sk are masked at the ragged edge
// inside the kernel; the wrapper does not pad.
//
// Bound on the H100: at the serving prefill shape (B 4, S 512, H 16, KV 8,
// hd 128) the kernel must move 12.6 MB and do 4.3 GFLOP: 0.0075 ms at
// 3.35 TB/s against 0.0044 ms at 989 TFLOP/s, so bytes bound it; at the
// training shape (B 8, S 1024, H = KV = 16, hd 64) 67 MB and 17.2 GFLOP,
// 0.020 ms against 0.017 ms, near the card's ridge.
//
// bf16 (the main path): the tensor-core design.  The earlier kernel (the
// f32 one below) did QK^T and PV as scalar fmaf on the CUDA cores (67
// TFLOP/s at most: >= 0.064 ms for the serving shape's work alone), staged
// Q, K, V and P as f32 in shared memory (75.8 KB at hd 128) and loaded
// each 32-key tile synchronously between two __syncthreads.  Here:
//   - 4 warps, each owning 16 of the block's 64 query rows.  Q arrives once
//     by cp.async and stays in registers as mma A fragments.  Blocks are
//     ordered so that every head's last q tile (the longest causal rows)
//     starts first and the shortest last: a tail of short blocks, not of
//     long ones.
//   - K/V tiles of 64 keys stream as bf16 through a ring of shared-memory
//     stages (2 at hd 128, 3 below) by cp.async: the next tile's copy is
//     in flight while the current one is computed.  Rows are padded by 16
//     bytes so ldmatrix (.trans for V) reads 8 rows on 8 distinct bank
//     groups.
//   - S = QK^T by mma.sync m16n8k16 (bf16 products are exact, f32
//     accumulation), then scaled, masked and folded into the online softmax
//     in f32 registers (row max by quad shuffles; each thread keeps a
//     partial row sum, summed over the quad at the end); exp(x - m) runs as
//     2^(x log2 e - m log2 e) on the special-function unit (~2^-22
//     relative).
//   - The f32 P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//     register fragments, and PV runs as two MMAs into the f32
//     accumulator: P is carried to ~2^-17 relative, the precision of the
//     reference's f32 probabilities to well inside a bf16 output's half
//     ulp (FlashAttention and SDPA round P to bf16 instead, a different
//     function).  This costs 1.5x the tensor-core work of one PV.
//   - The output tile goes out through shared memory as 16-byte stores.
// mma.sync runs at about two thirds of wgmma's rate on Hopper and keeps
// each warp's QK^T, softmax and PV in sequence: a wgmma version (64-row
// warpgroup tiles, operands from TMA-fed swizzled shared memory, the
// softmax of one tile overlapped with the next tile's QK^T, as
// FlashAttention-3 does) is what the operations-bound training shape
// needs next.
//
// f32: the first version, CUDA-core FMAs from shared memory (not on any
// main path).
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_NT = 128;  // 4 warps, 16 query rows each
constexpr int TC_BQ = 64;   // query rows per block
constexpr int TC_BK = 64;   // keys per K/V tile
constexpr float LOG2E = 1.4426950408889634f;

// Head widths 32, 64, 96, 128 and 192 (hd / 16 k-steps of QK^T, hd / 8
// output column tiles).  At hd 192 the Q fragments (12 k-steps, 48
// registers) would join the 96-register accumulator, so Q stays in shared
// memory and each k-step's fragment is loaded with ldmatrix as it is used.
template <int HD>
struct TcCfg {
  static constexpr int PITCH = HD + 8;  // bf16 per shared-memory row: 16-byte pad
  static constexpr int STAGES = HD >= 128 ? 2 : 3;
  static constexpr int TILE = TC_BK * PITCH;  // one K or V tile
  static constexpr size_t SMEM = sizeof(bf16) * (TC_BQ * PITCH + STAGES * 2 * TILE);
  static constexpr bool Q_REGS = HD <= 128;  // Q fragments held in registers
};

// rows [row0, row0 + n_rows) of a (limit x HD) slab with row stride `stride`
// into shared memory; rows at or past `limit` are zero-filled
template <int HD>
__device__ __forceinline__ void tc_load_rows(bf16* dst, const bf16* src, size_t stride, int row0,
                                             int n_rows, int limit) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n_rows * CPR; i += TC_NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * TcCfg<HD>::PITCH + c,
               ok ? src + static_cast<size_t>(row0 + r) * stride + c : src, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk, int H,
                      int KV, float scale) {
  using C = TcCfg<HD>;
  constexpr int PITCH = C::PITCH, STAGES = C::STAGES;
  constexpr int KS = HD / 16;     // k16 steps of QK^T
  constexpr int NS = TC_BK / 8;   // n8 tiles of S
  constexpr int NO = HD / 8;      // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + TC_BQ * PITCH;  // stage s: K at ring + 2s TILE, V after it

  // blocks start in grid order (x fastest): every head's last q tile, whose
  // causal rows are the longest, goes first, the first q tiles last
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;

  // keys past the tile's last query row are all masked -> skip those tiles
  const int k_end = min(Sk, q0 + TC_BQ);
  const int n_tiles = (k_end + TC_BK - 1) / TC_BK;

  auto load_kv = [&](int tile) {
    bf16* ks = ring + (tile % STAGES) * 2 * C::TILE;
    tc_load_rows<HD>(ks, kb, kv_stride, tile * TC_BK, TC_BK, Sk);
    tc_load_rows<HD>(ks + C::TILE, vb, kv_stride, tile * TC_BK, TC_BK, Sk);
  };

  // prologue: Q and the first STAGES - 1 tiles, one commit group each
  tc_load_rows<HD>(Qs, qb, q_stride, q0, TC_BQ, Sq);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }

  uint32_t qf[C::Q_REGS ? KS : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of their sums
  const int row0 = q0 + warp * 16 + g;  // query position of row g (row g + 8: + 8)

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t (and Q) landed for this thread
    __syncthreads();              // ... for all threads; stage (t - 1) % STAGES is free
    if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1);
    cp_async_commit();

    const bf16* q_frag = Qs + (warp * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8;
    if (C::Q_REGS && t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[C::Q_REGS ? ks : 0], q_frag + ks * 16);
    }
    const bf16* Ks = ring + (t % STAGES) * 2 * C::TILE;
    const bf16* Vs = Ks + C::TILE;
    const int k0 = t * TC_BK;

    // S = Q K^T (16 rows x 64 keys per warp)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (!C::Q_REGS) ldsm_x4(qf[0], q_frag + ks * 16);
      const uint32_t(&a)[4] = qf[C::Q_REGS ? ks : 0];
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t kf[4];
        ldsm_x4(kf, Ks + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], a, kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], a, kf[2], kf[3]);
      }
    }

    // scale after the product, mask, and fold into the online softmax
    const bool edge = k0 + TC_BK > q0 + warp * 16 || k0 + TC_BK > Sk;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int kpos = k0 + j * 8 + c2 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (kpos >= Sk || kpos > qpos) x = NEG_INF;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the 4 lanes of a quad hold one row's 64 scores
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // exp(x - m) as 2^(x log2 e - m log2 e)
    const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;
    const float alpha0 = exp2_approx(fmaf(m0, LOG2E, -ml0));
    const float alpha1 = exp2_approx(fmaf(m1, LOG2E, -ml1));
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2_approx(fmaf(s[j][0], LOG2E, -ml0));
      s[j][1] = exp2_approx(fmaf(s[j][1], LOG2E, -ml0));
      s[j][2] = exp2_approx(fmaf(s[j][2], LOG2E, -ml1));
      s[j][3] = exp2_approx(fmaf(s[j][3], LOG2E, -ml1));
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // O += P_hi V + P_lo V
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_a_frag(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, Vs + (kk * 16 + (lane & 15)) * PITCH + j2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * j2], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * j2], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * j2 + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * j2 + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();  // nothing may still be landing in Qs (Sk == 0: no tile ran)
  __syncthreads();     // ... nor be read from it (Q fragments)

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);

  // the warp's 16 rows into Qs, then 16-byte stores
  bf16* os = Qs + warp * 16 * PITCH;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * PITCH + j * 8 + c2) =
        __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * PITCH + j * 8 + c2) =
        __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncthreads();
  bf16* ob = o + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < TC_BQ * CPR; i += TC_NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (q0 + r < Sq) {
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(q0 + r) * q_stride + c) =
          *reinterpret_cast<const uint4*>(Qs + r * PITCH + c);
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                int H, int KV, float scale, cudaStream_t stream) {
  using C = TcCfg<HD>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid(H, B, (Sq + TC_BQ - 1) / TC_BQ);
  flash_fwd_bf16_kernel<HD><<<grid, TC_NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 32;     // keys per KV tile
constexpr int NT = 128;    // threads: 16 row groups (4 rows) x 8 column lanes
constexpr int PPAD = BQ + 4;

template <int HD>
constexpr size_t smem_bytes() {
  // Qs[BQ][HD+4] + Ks[BK][HD+4] + Vs[BK][HD] + Ps[BK][BQ+4], all f32
  return sizeof(float) * (BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BK * PPAD);
}

template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src,
                                          size_t src_stride, int row0, int n_rows, int limit) {
  constexpr int N = Vec<float>::N;
  constexpr int VPR = HD / N;
  for (int i = threadIdx.x; i < n_rows * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * N;
    float v[N];
    if (row0 + r < limit) {
      load_vec<float>(src + static_cast<size_t>(row0 + r) * src_stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * pitch + c + e] = v[e];
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
                     int KV, float scale) {
  constexpr int QP = HD + 4;
  constexpr int NC = HD / 32;  // float4 output chunks per thread and row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * HD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int ty = threadIdx.x >> 3;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x & 7;   // key columns tx + 8j; output cols tx*4 + 32c

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const float* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  const float* kb = k + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;
  const float* vb = v + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;

  load_rows<HD>(Qs, QP, qb, q_stride, q0, BQ, Sq);

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // keys past the tile's last query row are all masked -> skip
  const int k_end = min(Sk, q0 + BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    load_rows<HD>(Ks, QP, kb, kv_stride, k0, BK, Sk);
    load_rows<HD>(Vs, HD, vb, kv_stride, k0, BK, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * QP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = kpos < Sk && kpos <= qpos;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes of a row group are adjacent lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_cur = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_cur);
        rs += p;
        Ps[(tx + 8 * j) * PPAD + ty * 4 + i] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_cur;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[i];
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[kk * PPAD + ty * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[kk * HD + tx * 4 + 32 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(pr[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pr[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pr[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pr[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(qpos) * q_stride +
                  static_cast<size_t>(h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[tx * 4 + 32 * c + e] = acc[i][c][e] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
               int H, int KV, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KV, float scale, int dtype, cudaStream_t s) {
  if (dtype == DT_BF16) return launch_bf16<HD>(q, k, v, o, B, Sq, Sk, H, KV, scale, s);
  if (dtype == DT_F32) return launch_f32<HD>(q, k, v, o, B, Sq, Sk, H, KV, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); all contiguous, 16-byte
// aligned; hd in {32, 64, 96, 128, 192}; H a multiple of KV.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Sq, int Sk, int H, int KV,
                                      int hd, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KV < 1 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define CASE(HD_) \
  case HD_: return launch<HD_>(q, k, v, o, B, Sq, Sk, H, KV, scale, dtype, s);
    CASE(32) CASE(64) CASE(96) CASE(128) CASE(192)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
