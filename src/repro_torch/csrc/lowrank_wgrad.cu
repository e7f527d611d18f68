// Low-rank Wgrad projection (MeCeFO technique III): A = (x @ V1)^T @ dy.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_wgrad.py:
// lowrank_wgrad_project (Pallas grid (m/bm, T/bt), token axis innermost, an
// (r x bm) f32 accumulator carried in VMEM across the token blocks, and
// P = x_blk @ V1 recomputed for every m block).  x is (T, n), dy (T, m) and
// V1 (n, r), all f32 or all bf16; every product accumulates in f32 and A
// (r x m) is f32.  The wrapper forms dW = V1 @ A outside the kernel, as
// kernels/ops.py does in the JAX package.
//
// On the GPU the blocks run in parallel and in no order, so nothing can be
// carried from one token block to the next.  Pass 1: one block per chunk of
// BT tokens computes its P = x_chunk @ V1 (BT x r) once into shared memory
// (the TPU grid recomputes it per m block), then walks the m tiles and
// writes its partial A_chunk = P^T @ dy_chunk into an f32 scratch
// (chunks, r, m).  Pass 2 sums the partials over the chunks in a fixed
// order.  There are no float atomics, so A repeats bitwise from run to run.
// Ragged T, n, m and r are masked in the kernel (zero rows and columns add
// nothing), so the wrapper does not pad.
//
// Bound on the H100: bytes.  At the training path's shapes (T = 8192,
// n x m = 1024 x 2736 or 2736 x 1024, r = 64) the kernel must read x and dy
// once and write A: ~62 MB in bf16, 0.019 ms at 3.35 TB/s, against ~3.9
// GFLOP, 0.004 ms at 989 TFLOP/s.  This first version does its products
// with f32 FMAs on the CUDA cores from shared memory (each thread a 4 x 4
// register tile of a 64 x 64 output tile) and moves the partials through
// device memory (chunks x r x m x 4 bytes, written and read once): far
// from the bound, simple to check.  wgmma/TMA tiles and a split that keeps
// the partials on chip are the later, faster version.
#include "common.cuh"

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lowrank_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const T* __restrict__ v1, float* __restrict__ part,
                       int n_tok, int n, int m, int r, int r_pad) {
  extern __shared__ __align__(16) float smem[];
  float* p_s = smem;                 // P = x_chunk @ V1, (BT, r_pad)
  float* x_s = p_s + BT * r_pad;     // (BT, XPITCH)
  float* v_s = x_s + BT * XPITCH;    // (KT, RT)
  float* d_s = v_s + KT * RT;        // (BT, MT)
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.x * BT;

  // pass 1a: P (BT x r) = x[t0 : t0 + BT] @ V1, one RT-wide tile of r at a time
  for (int r0 = 0; r0 < r_pad; r0 += RT) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < n; k0 += KT) {
      for (int i = tid; i < BT * KT; i += kThreads) {
        const int row = i / KT, col = i % KT;
        const int t = t0 + row, k = k0 + col;
        x_s[row * XPITCH + col] =
            (t < n_tok && k < n) ? to_f<T>(x[static_cast<size_t>(t) * n + k]) : 0.f;
      }
      for (int i = tid; i < KT * RT; i += kThreads) {
        const int row = i / RT, col = i % RT;
        const int k = k0 + row, c = r0 + col;
        v_s[i] = (k < n && c < r) ? to_f<T>(v1[static_cast<size_t>(k) * r + c]) : 0.f;
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

  // pass 1b: part[chunk] (r x m) = P^T @ dy[t0 : t0 + BT], one MT-wide tile
  // of m at a time
  float* out = part + static_cast<size_t>(blockIdx.x) * r * m;
  for (int m0 = 0; m0 < m; m0 += MT) {
    for (int i = tid; i < BT * MT; i += kThreads) {
      const int row = i / MT, col = i % MT;
      const int t = t0 + row, c = m0 + col;
      d_s[i] = (t < n_tok && c < m) ? to_f<T>(dy[static_cast<size_t>(t) * m + c]) : 0.f;
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

// pass 2: A[i] = sum over chunks c = 0, 1, ... of part[c][i], in that order
__global__ void __launch_bounds__(kThreads)
lowrank_reduce_kernel(const float* __restrict__ part, float* __restrict__ a,
                      int chunks, long long rm) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rm) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[static_cast<size_t>(c) * rm + i];
  a[i] = s;
}

template <typename T>
int launch(const void* x, const void* dy, const void* v1, float* part, float* a,
           int n_tok, int n, int m, int r, cudaStream_t stream) {
  const int chunks = (n_tok + BT - 1) / BT;
  const int r_pad = (r + RT - 1) / RT * RT;
  const size_t smem = smem_bytes(r_pad);
  cudaError_t err = cudaFuncSetAttribute(lowrank_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lowrank_partial_kernel<T><<<chunks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(v1),
      part, n_tok, n, m, r, r_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rm = static_cast<long long>(r) * m;
  const long long blocks = (rm + kThreads - 1) / kThreads;
  lowrank_reduce_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(part, a, chunks, rm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch rows the caller allocates for `part`: chunks = ceil(n_tok / BT).
extern "C" int lowrank_wgrad_chunks(int n_tok) { return (n_tok + BT - 1) / BT; }

// x: (n_tok, n), dy: (n_tok, m), v1: (n, r), contiguous, one dtype; part:
// f32 (chunks, r, m) scratch; a: f32 (r, m) output.  r <= 256.
extern "C" int lowrank_wgrad_launch(const void* x, const void* dy, const void* v1,
                                    void* part, void* a, int n_tok, int n, int m, int r,
                                    int dtype, void* stream) {
  if (n_tok <= 0 || n <= 0 || m <= 0 || r <= 0 || r > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(a);
  if (dtype == DT_F32) return launch<float>(x, dy, v1, p, out, n_tok, n, m, r, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(x, dy, v1, p, out, n_tok, n, m, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
