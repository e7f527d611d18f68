// The per-block fold shared by the two decode kernels, paged_decode.cu
// (kernel #1, blocks are pages reached through a page table) and
// flash_decode.cu (kernel #5, blocks are block_k rows of a dense cache).
//
// One thread block serves the G query heads of one (kv head, slot) pair.
// For each block of cache rows it (1) stages the rows' K and V for this kv
// head in shared memory with 16-byte loads, (2) computes the G x rows
// scores (warps over (g, row) pairs, lanes split hd, shuffles reduce),
// scaled by 1/sqrt(hd) after the dot and set to NEG_INF at or past the
// lane's length, (3) folds them into the f32 online-softmax state (m, l),
// one thread per query head, and (4) rescales and updates the G x hd f32
// accumulator, each thread owning MAX_PER_THREAD of its entries.  Both
// kernels call the same inlined code with the same row order, so over the
// same logical rows (a dense view gathered page by page, block_k ==
// page_size) they give bitwise the same output.  Every product-sum that a
// compiler could contract is written as an explicit fmaf, so the two
// instantiations cannot round differently.
#pragma once

#include "common.cuh"

namespace decode {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int MAX_PER_THREAD = 8;  // G * hd <= NT * MAX_PER_THREAD

// qs[G][HD] + ks[bk][HD] + vs[bk][HD] + ss[G][bk] + ms[G] + ls[G] + alphas[G], f32
template <int HD>
inline size_t smem_bytes(int G, int bk) {
  return sizeof(float) * (static_cast<size_t>(G) * HD + 2 * static_cast<size_t>(bk) * HD +
                          static_cast<size_t>(G) * bk + 3 * static_cast<size_t>(G));
}

struct State {
  float* qs;
  float* ks;
  float* vs;
  float* ss;
  float* ms;
  float* ls;
  float* alphas;
  int G;
  int bk;  // rows a block may hold (the ss row stride)
};

// Carve shared memory, load the G query rows of this group (heads
// kvh * G .. kvh * G + G - 1 are contiguous in q), set m = NEG_INF, l = 0
// and zero the accumulator.
template <typename T, int HD>
__device__ __forceinline__ State init(float* smem, const T* __restrict__ qb, int G, int bk,
                                      float (&acc)[MAX_PER_THREAD]) {
  constexpr int N = Vec<T>::N;
  State st;
  st.qs = smem;
  st.ks = st.qs + G * HD;
  st.vs = st.ks + bk * HD;
  st.ss = st.vs + bk * HD;
  st.ms = st.ss + G * bk;
  st.ls = st.ms + G;
  st.alphas = st.ls + G;
  st.G = G;
  st.bk = bk;
  const int tid = threadIdx.x;
  for (int i = tid; i < G * (HD / N); i += NT) {
    float v[N];
    load_vec<T>(qb + i * N, v);
#pragma unroll
    for (int e = 0; e < N; ++e) st.qs[i * N + e] = v[e];
  }
  if (tid < G) {
    st.ms[tid] = NEG_INF;
    st.ls[tid] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < MAX_PER_THREAD; ++t) acc[t] = 0.f;
  return st;
}

// Fold rows k_start .. k_start + n_rows - 1 (n_rows <= bk) into (m, l, acc).
// kb / vb point at the block's first row for this kv head; consecutive rows
// lie row_stride elements apart.  Rows at or past len get no weight.
template <typename T, int HD>
__device__ __forceinline__ void fold_block(const State& st, const T* __restrict__ kb,
                                           const T* __restrict__ vb, size_t row_stride,
                                           int n_rows, int k_start, int len, float scale,
                                           float (&acc)[MAX_PER_THREAD]) {
  constexpr int N = Vec<T>::N;
  constexpr int VPR = HD / N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = st.G;
  const int bk = st.bk;

  __syncthreads();  // the previous block fully consumed (and qs/ms/ls visible)
  for (int i = tid; i < n_rows * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * N;
    float kv[N], vv[N];
    load_vec<T>(kb + r * row_stride + c, kv);
    load_vec<T>(vb + r * row_stride + c, vv);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      st.ks[r * HD + c + e] = kv[e];
      st.vs[r * HD + c + e] = vv[e];
    }
  }
  __syncthreads();

  for (int pair = warp; pair < G * n_rows; pair += NWARPS) {
    const int g = pair / n_rows;
    const int j = pair - g * n_rows;
    float dot = 0.f;
#pragma unroll
    for (int d = lane; d < HD; d += 32) dot = fmaf(st.qs[g * HD + d], st.ks[j * HD + d], dot);
    dot = warp_sum(dot);
    if (lane == 0) st.ss[g * bk + j] = (k_start + j < len) ? dot * scale : NEG_INF;
  }
  __syncthreads();

  if (tid < G) {
    const int g = tid;
    float mx = NEG_INF;
    for (int j = 0; j < n_rows; ++j) mx = fmaxf(mx, st.ss[g * bk + j]);
    const float m_prev = st.ms[g];
    const float m_cur = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_cur);
    float sum = 0.f;
    for (int j = 0; j < n_rows; ++j) {
      const float p = expf(st.ss[g * bk + j] - m_cur);
      st.ss[g * bk + j] = p;
      sum += p;
    }
    st.ls[g] = fmaf(st.ls[g], alpha, sum);
    st.ms[g] = m_cur;
    st.alphas[g] = alpha;
  }
  __syncthreads();

#pragma unroll
  for (int t = 0; t < MAX_PER_THREAD; ++t) {
    const int idx = tid + t * NT;
    if (idx < G * HD) {
      const int g = idx / HD;
      const int d = idx - g * HD;
      float a = acc[t] * st.alphas[g];
      for (int j = 0; j < n_rows; ++j) a = fmaf(st.ss[g * bk + j], st.vs[j * HD + d], a);
      acc[t] = a;
    }
  }
}

// o = acc / max(l, 1e-30) for the G heads of the group; a lane whose every
// block was skipped (length 0) has acc = 0 and writes exactly 0.
template <typename T, int HD>
__device__ __forceinline__ void finish(const State& st, T* __restrict__ ob,
                                       const float (&acc)[MAX_PER_THREAD]) {
  __syncthreads();
  const int tid = threadIdx.x;
#pragma unroll
  for (int t = 0; t < MAX_PER_THREAD; ++t) {
    const int idx = tid + t * NT;
    if (idx < st.G * HD) {
      const int g = idx / HD;
      ob[idx] = from_f<T>(acc[t] / fmaxf(st.ls[g], 1e-30f));
    }
  }
}

}  // namespace decode
