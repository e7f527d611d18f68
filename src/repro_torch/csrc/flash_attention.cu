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
// softmax, the denominator clamped at 1e-30, and KV tiles wholly in the
// future skipped (the loop stops at the causal limit).  GQA maps query
// head h to KV head h / (H / KV).  Both Sq and Sk are masked at the ragged
// edge inside the kernel; the wrapper does not pad.
//
// Bound on the H100: at the prefill shapes (S = 512, hd = 128, G = 2) the
// causal work is about 4·hd·S²/2 flops per (b, h) against reading q and k/v
// and writing o, some 170 flops per byte: below the ~295 flop/byte ridge,
// so bytes bound it (3.35 TB/s); prompts past ~900 tokens cross into the
// operations bound (989 TFLOP/s bf16 on the tensor cores).  This first
// version does its products with f32 FMAs on the CUDA cores
// from shared memory (Q and K row-major with a 4-float pad so the
// interleaved key columns fall on distinct banks, V row-major, P stored
// transposed for the PV product): far from the tensor-core bound, simple
// to check.  wgmma/TMA tiles are the later, faster version.
#include "common.cuh"

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 32;     // keys per KV tile
constexpr int NT = 128;    // threads: 16 row groups (4 rows) x 8 column lanes
constexpr int PPAD = BQ + 4;

template <int HD>
constexpr size_t smem_bytes() {
  // Qs[BQ][HD+4] + Ks[BK][HD+4] + Vs[BK][HD] + Ps[BK][BQ+4], all f32
  return sizeof(float) * (BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BK * PPAD);
}

template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src,
                                          size_t src_stride, int row0, int n_rows,
                                          int limit) {
  constexpr int N = Vec<T>::N;
  constexpr int VPR = HD / N;
  for (int i = threadIdx.x; i < n_rows * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * N;
    float v[N];
    if (row0 + r < limit) {
      load_vec<T>(src + static_cast<size_t>(row0 + r) * src_stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * pitch + c + e] = v[e];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, float scale) {
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
  const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;
  const T* vb = v + static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kvh) * HD;

  load_rows<T, HD>(Qs, QP, qb, q_stride, q0, BQ, Sq);

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
    load_rows<T, HD>(Ks, QP, kb, kv_stride, k0, BK, Sk);
    load_rows<T, HD>(Vs, HD, vb, kv_stride, k0, BK, Sk);
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
    T* orow = o + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(qpos) * q_stride +
              static_cast<size_t>(h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[tx * 4 + 32 * c + e] = from_f<T>(acc[i][c][e] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KV, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
             int Sk, int H, int KV, int hd, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); all contiguous, 16-byte
// aligned; hd in {32, 64, 128}; H a multiple of KV.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Sq, int Sk, int H, int KV,
                                      int hd, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return dispatch<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, scale, s);
  if (dtype == DT_BF16) return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
