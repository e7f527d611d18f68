// Paged flash decode: one query row per slot against the physical KV pool,
// walking each slot's page table.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py:
// paged_flash_decode (Pallas grid (B, H, P) with the page table and the
// lengths as scalar-prefetch operands, the body of
// kernels/flash_decode.py:_kernel).  On the GPU a block loads its own page
// ids and length (there is no scalar prefetch).  Semantics kept from the
// reference: block ki of slot b is page tables[b, ki] (clamped into the
// pool); scores scaled by 1/sqrt(hd) after the dot; rows at or past the
// slot's length get no weight and pages wholly past it are not read; the
// denominator is clamped at 1e-30, so a length-0 lane outputs exactly 0.
//
// Bound on the H100: KV bytes, the pages covering each slot over 3.35 TB/s
// (4·G·hd flops per row against 2·hd·2 bytes: far below the ridge).
//
// Design: decode_fold.cuh's split-KV passes, the same code kernel #5
// (flash_decode.cu) runs over a dense cache; only the row address differs
// (PagedRows: the split's page ids are loaded once into shared memory).
// Each slot's pages are cut into splits of split_blocks pages (SPLIT_BLOCKS
// in kernels/flash_decode.py, chosen by a sweep on the card; see PERF.md),
// one block per (split, kv head, slot), the split's rows streamed through a
// 4-stage ring of 16-row cp.async tiles, then a combine pass merges each
// slot's splits in order.  The result depends only on the logical K/V and
// the slot's length, not on which physical pages hold it or on the other
// slots, and equals kernel #5 over the gathered dense view with block_k ==
// page_size bitwise.
#include "decode_fold.cuh"

namespace {

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lens,
           void* part, void* o, int B, int H, int KV, int n_pages, int ps, int P,
           int split_blocks, float scale, cudaStream_t stream) {
  const decode::PagedRows rows{tables, n_pages, ps, P, static_cast<size_t>(KV) * HD};
  return decode::launch<T, HD>(static_cast<const T*>(q), static_cast<const T*>(kp),
                               static_cast<const T*>(vp), lens, rows, static_cast<float*>(part),
                               static_cast<T*>(o), B, H, KV, ps, P, P * ps, split_blocks, scale,
                               stream);
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* tables, const int* lens,
             void* part, void* o, int B, int H, int KV, int hd, int n_pages, int ps, int P,
             int split_blocks, float scale, cudaStream_t s) {
  switch (hd) {
#define CASE(HD_)                                                                        \
  case HD_:                                                                              \
    return launch<T, HD_>(q, kp, vp, tables, lens, part, o, B, H, KV, n_pages, ps, P,    \
                          split_blocks, scale, s);
    CASE(32) CASE(64) CASE(96) CASE(128) CASE(192)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, 1, H, hd); k_pages, v_pages: (n_pages, ps, KV, hd); tables:
// (B, P) int32; lens: (B,) int32 valid positions per slot; part: f32
// scratch of B * H * ceil(P / split_blocks) * (hd + 2) elements.  All
// contiguous and 16-byte aligned; hd in {32, 64, 96, 128, 192}; H a
// multiple of KV.
extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* tables, const void* lens, void* part, void* o,
                                   int B, int H, int KV, int hd, int n_pages, int ps, int P,
                                   int split_blocks, float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  if (dtype == DT_F32)
    return dispatch<float>(q, k_pages, v_pages, t, l, part, o, B, H, KV, hd, n_pages, ps, P,
                           split_blocks, scale, s);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, t, l, part, o, B, H, KV, hd, n_pages, ps,
                                   P, split_blocks, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
