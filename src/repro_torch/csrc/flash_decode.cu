// Flash decode: one query row per sequence against a dense (B, Smax, KV,
// hd) KV cache with ragged lengths.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:flash_decode
// (Pallas grid (B, H, Smax / block_k), the block axis sequential, (m, l,
// acc) carried in VMEM scratch across it).  Semantics kept from the
// reference: scores scaled by 1/sqrt(hd) after the dot; rows at or past the
// lane's length get no weight and blocks wholly past it are not read (the
// pl.when(k_start < cur_len) gate); the denominator is clamped at 1e-30, so
// a length-0 lane outputs exactly 0.  The JAX wrapper pads Smax up to a
// block multiple; here no row at or past Smax is read.
//
// Bound on the H100: KV bytes, the rows below each lane's length over 3.35
// TB/s (4·G·hd flops per row against 2·hd·2 bytes: far below the ridge).
//
// Design (not the TPU grid, which runs one query head per program, reads
// each K/V row G times and walks the blocks in sequence): decode_fold.cuh's
// split-KV passes, the same code kernel #1 (paged_decode.cu) runs per page;
// only the row address differs (DenseRows: a dense stride).  Each lane's
// block_k-row blocks are cut into splits of split_blocks blocks
// (SPLIT_BLOCKS in kernels/flash_decode.py, chosen by a sweep on the card;
// see PERF.md), one block per (split, kv head, lane), the split's rows
// streamed through a 4-stage ring of 16-row cp.async tiles, then a combine
// pass merges each lane's splits in order.  Over a dense view gathered from
// pages with block_k == page_size the two kernels give bitwise the same
// output, and a lane's output does not depend on the other lanes.
#include "decode_fold.cuh"

namespace {

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lens, void* part, void* o,
           int B, int H, int KV, int Smax, int bk, int split_blocks, float scale,
           cudaStream_t stream) {
  if (bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const decode::DenseRows rows{Smax, static_cast<size_t>(KV) * HD};
  return decode::launch<T, HD>(static_cast<const T*>(q), static_cast<const T*>(k),
                               static_cast<const T*>(v), lens, rows, static_cast<float*>(part),
                               static_cast<T*>(o), B, H, KV, bk, (Smax + bk - 1) / bk, Smax,
                               split_blocks, scale, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lens, void* part, void* o,
             int B, int H, int KV, int hd, int Smax, int bk, int split_blocks, float scale,
             cudaStream_t s) {
  switch (hd) {
#define CASE(HD_)                                                                             \
  case HD_:                                                                                   \
    return launch<T, HD_>(q, k, v, lens, part, o, B, H, KV, Smax, bk, split_blocks, scale, s);
    CASE(32) CASE(64) CASE(96) CASE(128) CASE(192)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, 1, H, hd); k_cache, v_cache: (B, Smax, KV, hd); lens: (B,)
// int32 valid positions per sequence; part: f32 scratch of B * H *
// ceil(ceil(Smax / bk) / split_blocks) * (hd + 2) elements.  All contiguous
// and 16-byte aligned; hd in {32, 64, 96, 128, 192}; H a multiple of KV;
// 1 <= bk <= Smax.
extern "C" int flash_decode_launch(const void* q, const void* k_cache, const void* v_cache,
                                   const void* lens, void* part, void* o, int B, int H, int KV,
                                   int hd, int Smax, int bk, int split_blocks, float scale,
                                   int dtype, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  if (dtype == DT_F32)
    return dispatch<float>(q, k_cache, v_cache, l, part, o, B, H, KV, hd, Smax, bk, split_blocks,
                           scale, s);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, l, part, o, B, H, KV, hd, Smax, bk,
                                   split_blocks, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
