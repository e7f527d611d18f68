// Flash decode: one query row per sequence against a dense (B, Smax, KV,
// hd) KV cache with ragged lengths.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:flash_decode
// (Pallas grid (B, H, Smax / block_k), the block axis sequential, (m, l,
// acc) carried in VMEM scratch across it).  Semantics kept from the
// reference: scores scaled by 1/sqrt(hd) after the dot and set to NEG_INF
// at or past the lane's length; an f32 online softmax over blocks of
// block_k rows; blocks wholly at or past the length are skipped (the
// pl.when(k_start < cur_len) gate), so a fully masked block never adds
// exp(0) = 1 to l; the denominator is clamped at 1e-30, so a length-0 lane
// outputs exactly 0.  The JAX wrapper pads Smax up to a block multiple;
// here the last block is ragged: it holds min(block_k, Smax - k_start)
// rows and no row at or past Smax is loaded.
//
// Bound on the H100: KV bytes.  A decode step does 4·G·hd flops per cache
// row it reads (2·hd·2 bytes in bf16 for K and V), far below the ridge, so
// the least time is the rows below each lane's length over 3.35 TB/s.
// Design (not the TPU grid, which runs one query head per program and
// would read each K/V row G times): one block per (kv head, slot) serves
// the G query heads of its group, and a loop inside the block walks the
// blocks up to the lane's length through decode_fold.cuh's fold, the same
// code kernel #1 (paged_decode.cu) runs per page.  Over a dense view
// gathered from pages with block_k == page_size the two kernels therefore
// give bitwise the same output.  Simple first: no split over the cache
// length, no cp.async/TMA pipelining of the next block's loads.
#include "decode_fold.cuh"

namespace {

using decode::MAX_PER_THREAD;
using decode::NT;

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int* __restrict__ lens,
                    T* __restrict__ o, int H, int KV, int Smax, int bk, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  extern __shared__ float4 smem4[];
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * HD;
  float acc[MAX_PER_THREAD];
  const decode::State st =
      decode::init<T, HD>(reinterpret_cast<float*>(smem4), q + qo, G, bk, acc);

  int len = lens[b];
  len = len < 0 ? 0 : (len > Smax ? Smax : len);  // rows past Smax do not exist
  const int n_blk = (len + bk - 1) / bk;
  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const size_t base = static_cast<size_t>(b) * Smax * row_stride + static_cast<size_t>(kvh) * HD;

  for (int bi = 0; bi < n_blk; ++bi) {
    const int k_start = bi * bk;
    const int n_rows = Smax - k_start < bk ? Smax - k_start : bk;
    const size_t off = base + static_cast<size_t>(k_start) * row_stride;
    decode::fold_block<T, HD>(st, k_cache + off, v_cache + off, row_stride, n_rows, k_start, len,
                              scale, acc);
  }
  decode::finish<T, HD>(st, o + qo, acc);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lens, void* o, int B, int H,
           int KV, int Smax, int bk, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G * HD > NT * MAX_PER_THREAD || bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = decode::smem_bytes<HD>(G, bk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(KV, B);
  flash_decode_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      static_cast<T*>(o), H, KV, Smax, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lens, void* o, int B, int H,
             int KV, int hd, int Smax, int bk, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, lens, o, B, H, KV, Smax, bk, scale, s);
    case 64: return launch<T, 64>(q, k, v, lens, o, B, H, KV, Smax, bk, scale, s);
    case 128: return launch<T, 128>(q, k, v, lens, o, B, H, KV, Smax, bk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, 1, H, hd); k_cache, v_cache: (B, Smax, KV, hd); lens: (B,)
// int32 valid positions per sequence.  All contiguous and 16-byte aligned;
// hd in {32, 64, 128}; H a multiple of KV; 1 <= bk <= Smax.
extern "C" int flash_decode_launch(const void* q, const void* k_cache, const void* v_cache,
                                   const void* lens, void* o, int B, int H, int KV, int hd,
                                   int Smax, int bk, float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  if (dtype == DT_F32)
    return dispatch<float>(q, k_cache, v_cache, l, o, B, H, KV, hd, Smax, bk, scale, s);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, l, o, B, H, KV, hd, Smax, bk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
