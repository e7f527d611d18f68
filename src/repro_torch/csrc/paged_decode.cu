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
// row is read once per group and not once per query head.  Each page goes
// through decode_fold.cuh's fold (stage K/V rows in shared memory, score,
// fold into (m, l), update the accumulator), the same code kernel #5
// (flash_decode.cu) runs over a dense cache.  The result depends only on
// the logical K/V, not on which physical pages hold it, so a shuffled page
// layout gives bitwise the same output, and so does kernel #5 over the
// gathered dense view with block_k == page_size.
#include "decode_fold.cuh"

namespace {

using decode::MAX_PER_THREAD;
using decode::NT;

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ o, int H, int KV,
                    int n_pages, int ps, int P, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  extern __shared__ float4 smem4[];
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * HD;
  float acc[MAX_PER_THREAD];
  const decode::State st =
      decode::init<T, HD>(reinterpret_cast<float*>(smem4), q + qo, G, ps, acc);

  const int len = lens[b];
  int n_pg = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_pg > P) n_pg = P;
  const int* trow = tables + static_cast<size_t>(b) * P;
  const size_t row_stride = static_cast<size_t>(KV) * HD;

  for (int pi = 0; pi < n_pg; ++pi) {
    int page = trow[pi];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);  // clamp, as XLA gathers do
    const size_t base = static_cast<size_t>(page) * ps * row_stride + static_cast<size_t>(kvh) * HD;
    decode::fold_block<T, HD>(st, k_pages + base, v_pages + base, row_stride, ps, pi * ps, len,
                              scale, acc);
  }
  decode::finish<T, HD>(st, o + qo, acc);
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lens, void* o, int B, int H, int KV, int n_pages, int ps, int P,
           float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G * HD > NT * MAX_PER_THREAD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = decode::smem_bytes<HD>(G, ps);
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
