// SwiGLU activation: out = silu(g) * u, computed in f32, cast back.
//
// Replaces the TPU kernel src/repro/kernels/swiglu.py:swiglu (Pallas,
// (block_rows, block_cols) VMEM tiles).  It computes what that kernel and
// kernels/ref.py:swiglu_ref compute: silu(g) is not rounded before the
// product.  The JAX trunk (models/layers.py, ffn_block) rounds silu(g) to
// the model dtype first; in bf16 the two differ by about one ulp, and at
// f32 they agree.
//
// Bound on the H100: bytes (read g and u, write out; a handful of flops per
// element).  Design: a flat grid-stride pass over all elements with
// 16-byte vector loads and stores, a scalar loop for the tail that does not
// fill a vector, and no shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ g, const T* __restrict__ u,
              T* __restrict__ out, long long n, int vec) {
  constexpr int N = Vec<T>::N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n_vec = n / N;
    for (long long i = tid; i < n_vec; i += stride) {
      float gv[N], uv[N];
      load_vec<T>(g + i * N, gv);
      load_vec<T>(u + i * N, uv);
#pragma unroll
      for (int e = 0; e < N; ++e) gv[e] = silu_mul(gv[e], uv[e]);
      store_vec<T>(out + i * N, gv);
    }
    done = n_vec * N;
  }
  for (long long i = done + tid; i < n; i += stride) {
    out[i] = from_f<T>(silu_mul(to_f<T>(g[i]), to_f<T>(u[i])));
  }
}

template <typename T>
int launch(const void* g, const void* u, void* out, long long n, int vec,
           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * (vec ? Vec<T>::N : 1);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, grid-stride beyond
  swiglu_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, u, out: n contiguous elements.  vec = 1 when all three pointers are
// 16-byte aligned.
extern "C" int swiglu_launch(const void* g, const void* u, void* out,
                             long long n, int dtype, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(g, u, out, n, vec, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(g, u, out, n, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
