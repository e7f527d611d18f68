// Paged flash decode: one query row per slot against the physical KV pool,
// walking each slot's page table.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py:
// paged_flash_decode (Pallas grid (B, H, P) with the page table and the
// lengths as scalar-prefetch operands, the body of
// kernels/flash_decode.py:_kernel).  On the GPU a block loads its own
// table row and length (there is no scalar prefetch) and the sequential
// page axis becomes a loop inside the block.  Semantics kept from the
// reference: block ki of slot b is page tables[b, ki]; scores scaled by
// 1/sqrt(hd) after the dot and masked with NEG_INF past the slot's length;
// an f32 online softmax (m, l, acc) per page; pages wholly past the length
// are skipped (the loop runs over ceil(len / page_size) pages), so a
// fully masked page never adds exp(0) = 1 to l; the denominator is clamped
// at 1e-30, so a length-0 lane outputs exactly 0.
//
// Bound on the H100: KV bytes.  A decode step does 4·G·hd flops per KV row
// it reads (2·hd·2 bytes in bf16), far below the ridge, so the least time
// is the pages covering each slot over 3.35 TB/s.  Design: one block per
// (kv head, slot) serves all G query heads of its group, so each K/V page
// row is read once per group and not once per query head.  A page's K and
// V rows for this kv head are staged in shared memory with 16-byte loads;
// warps compute the G·page_size scores (lanes split hd, shuffles reduce),
// G threads fold them into (m, l), and every thread updates its slice of
// the G·hd accumulator.  The result depends only on the logical K/V, not on
// which physical pages hold it, so a shuffled page layout gives bitwise
// the same output.
#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int MAX_PER_THREAD = 8;  // G * hd <= NT * MAX_PER_THREAD

template <int HD>
size_t smem_bytes(int G, int ps) {
  // qs[G][HD] + ks[ps][HD] + vs[ps][HD] + ss[G][ps] + ms[G] + ls[G] + alphas[G]
  return sizeof(float) * (static_cast<size_t>(G) * HD + 2 * static_cast<size_t>(ps) * HD +
                          static_cast<size_t>(G) * ps + 3 * static_cast<size_t>(G));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ o, int H, int KV,
                    int n_pages, int ps, int P, float scale) {
  constexpr int N = Vec<T>::N;
  constexpr int VPR = HD / N;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + G * HD;
  float* vs = ks + ps * HD;
  float* ss = vs + ps * HD;
  float* ms = ss + G * ps;
  float* ls = ms + G;
  float* alphas = ls + G;

  // the G query heads of this group are contiguous: h = kvh * G + g
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * HD;
  for (int i = tid; i < G * VPR; i += NT) {
    float v[N];
    load_vec<T>(qb + i * N, v);
#pragma unroll
    for (int e = 0; e < N; ++e) qs[i * N + e] = v[e];
  }
  if (tid < G) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }
  float acc[MAX_PER_THREAD];
#pragma unroll
  for (int t = 0; t < MAX_PER_THREAD; ++t) acc[t] = 0.f;

  const int len = lens[b];
  int n_pg = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_pg > P) n_pg = P;
  const int* trow = tables + static_cast<size_t>(b) * P;
  const size_t row_stride = static_cast<size_t>(KV) * HD;

  for (int pi = 0; pi < n_pg; ++pi) {
    int page = trow[pi];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);  // clamp, as XLA gathers do
    const size_t base = static_cast<size_t>(page) * ps * row_stride + static_cast<size_t>(kvh) * HD;
    __syncthreads();  // previous page fully consumed (and qs/ms/ls visible)
    for (int i = tid; i < ps * VPR; i += NT) {
      const int r = i / VPR;
      const int c = (i % VPR) * N;
      float kv[N], vv[N];
      load_vec<T>(k_pages + base + r * row_stride + c, kv);
      load_vec<T>(v_pages + base + r * row_stride + c, vv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        ks[r * HD + c + e] = kv[e];
        vs[r * HD + c + e] = vv[e];
      }
    }
    __syncthreads();

    const int k_start = pi * ps;
    for (int pair = warp; pair < G * ps; pair += NWARPS) {
      const int g = pair / ps;
      const int j = pair - g * ps;
      float dot = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) dot = fmaf(qs[g * HD + d], ks[j * HD + d], dot);
      dot = warp_sum(dot);
      if (lane == 0) ss[g * ps + j] = (k_start + j < len) ? dot * scale : NEG_INF;
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      float mx = NEG_INF;
      for (int j = 0; j < ps; ++j) mx = fmaxf(mx, ss[g * ps + j]);
      const float m_prev = ms[g];
      const float m_cur = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_cur);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float p = expf(ss[g * ps + j] - m_cur);
        ss[g * ps + j] = p;
        sum += p;
      }
      ls[g] = ls[g] * alpha + sum;
      ms[g] = m_cur;
      alphas[g] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < MAX_PER_THREAD; ++t) {
      const int idx = tid + t * NT;
      if (idx < G * HD) {
        const int g = idx / HD;
        const int d = idx - g * HD;
        float a = acc[t] * alphas[g];
        for (int j = 0; j < ps; ++j) a = fmaf(ss[g * ps + j], vs[j * HD + d], a);
        acc[t] = a;
      }
    }
  }
  __syncthreads();

  T* ob = o + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * HD;
#pragma unroll
  for (int t = 0; t < MAX_PER_THREAD; ++t) {
    const int idx = tid + t * NT;
    if (idx < G * HD) {
      const int g = idx / HD;
      ob[idx] = from_f<T>(acc[t] / fmaxf(ls[g], 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lens, void* o, int B, int H, int KV, int n_pages, int ps, int P,
           float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G * HD > NT * MAX_PER_THREAD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<HD>(G, ps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(KV, B);
  paged_decode_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      lens, static_cast<T*>(o), H, KV, n_pages, ps, P, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* tables, const int* lens,
             void* o, int B, int H, int KV, int hd, int n_pages, int ps, int P, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, tables, lens, o, B, H, KV, n_pages, ps, P, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, tables, lens, o, B, H, KV, n_pages, ps, P, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, tables, lens, o, B, H, KV, n_pages, ps, P, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, 1, H, hd); k_pages, v_pages: (n_pages, ps, KV, hd); tables:
// (B, P) int32; lens: (B,) int32 valid positions per slot.  All contiguous
// and 16-byte aligned; hd in {32, 64, 128}; H a multiple of KV.
extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* tables, const void* lens, void* o, int B,
                                   int H, int KV, int hd, int n_pages, int ps, int P,
                                   float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  if (dtype == DT_F32)
    return dispatch<float>(q, k_pages, v_pages, t, l, o, B, H, KV, hd, n_pages, ps, P, scale, s);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, t, l, o, B, H, KV, hd, n_pages, ps, P,
                                   scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
