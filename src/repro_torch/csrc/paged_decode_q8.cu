// The int8 page walk: one query row per slot against an int8 KV pool with
// one f32 scale per page, walking each slot's page table.
//
// Replaces src/repro/kernels/xla_paged.py:paged_flash_decode_xla with
// k_scale/v_scale (XLA, not Pallas: the reference's only decode path for
// EngineConfig.kv_dtype="int8").  Semantics kept from it: block ki of slot b
// is page tables[b, ki]; a page's rows are dequantized on fetch, int8 -> f32
// times the page's scale (k_pages[p] * k_scale[p]); scores scaled by
// 1/sqrt(hd) after the dot; rows at or past the slot's length get no weight
// and pages wholly past it are not read (the reference's skip gate, so the
// null page that idle lanes write is never read); the denominator is
// clamped at 1e-30, so a length-0 lane outputs exactly 0.
//
// Bound on the H100: KV bytes, the int8 rows covering each slot plus a scale
// per page, over 3.35 TB/s: a quarter of bf16 #1's bytes.
//
// Design: kernel #1's split-KV passes (decode_fold.cuh) with the row policy
// PagedRowsQ8.  int8 rows go through the cp.async ring in their own type (a
// 16-byte copy moves 16 elements), each split's page ids and their two
// scales are loaded once into shared memory, and a lane widens its row
// elements to f32 and multiplies them by the page's scale in registers.
// Then the same per-warp online softmax, ordered split combine and head
// sub-groups as #1.  A lane's result depends only on its own rows and
// length: bitwise the same in any batch.
#include <stdint.h>

#include "decode_fold.cuh"

namespace {

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
           const int* tables, const int* lens, void* part, void* o, int B, int H, int KV,
           int n_pages, int ps, int P, int split_blocks, float scale, cudaStream_t stream) {
  decode::PagedRowsQ8 rows;
  rows.tables = tables;
  rows.n_pages = n_pages;
  rows.ps = ps;
  rows.P = P;
  rows.row_stride = static_cast<size_t>(KV) * HD;
  rows.k_scale = ks;
  rows.v_scale = vs;
  return decode::launch<T, HD>(static_cast<const T*>(q), static_cast<const int8_t*>(kp),
                               static_cast<const int8_t*>(vp), lens, rows,
                               static_cast<float*>(part), static_cast<T*>(o), B, H, KV, ps, P,
                               P * ps, split_blocks, scale, stream);
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
             const int* tables, const int* lens, void* part, void* o, int B, int H, int KV,
             int hd, int n_pages, int ps, int P, int split_blocks, float scale, cudaStream_t s) {
  switch (hd) {
#define CASE(HD_)                                                                          \
  case HD_:                                                                                \
    return launch<T, HD_>(q, kp, vp, ks, vs, tables, lens, part, o, B, H, KV, n_pages, ps, \
                          P, split_blocks, scale, s);
    CASE(32) CASE(64) CASE(96) CASE(128) CASE(192)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, 1, H, hd) f32 or bf16; k_pages, v_pages: (n_pages, ps, KV, hd)
// int8; k_scale, v_scale: (n_pages,) f32; tables: (B, P) int32; lens: (B,)
// int32 valid positions per slot; part: f32 scratch of B * H *
// ceil(P / split_blocks) * (hd + 2) elements.  All contiguous and 16-byte
// aligned; hd in {32, 64, 96, 128, 192}; H a multiple of KV.
extern "C" int paged_decode_q8_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scale, const void* v_scale,
                                      const void* tables, const void* lens, void* part, void* o,
                                      int B, int H, int KV, int hd, int n_pages, int ps, int P,
                                      int split_blocks, float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  if (dtype == DT_F32)
    return dispatch<float>(q, k_pages, v_pages, ks, vs, t, l, part, o, B, H, KV, hd, n_pages, ps,
                           P, split_blocks, scale, s);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, ks, vs, t, l, part, o, B, H, KV, hd,
                                   n_pages, ps, P, split_blocks, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
