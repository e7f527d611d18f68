// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, per row, in f32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm (Pallas,
// one (block_rows, d) VMEM tile per grid step).  It computes what that
// kernel (and kernels/ref.py:rmsnorm_ref) computes: the scale is applied in
// f32 before the cast back.  The JAX trunk's layers.rmsnorm casts to the
// model dtype first and multiplies by scale after; in bf16 the two orders
// differ by about one ulp, and at f32 they agree.
//
// Bound on the H100: bytes.  Two flops per element against 2-4 bytes read
// and written is far below the ~295 flop/byte ridge, so the least time is
// (read x + read scale + write y) / 3.35 TB/s.  Design: one warp per row,
// 16-byte vector loads over the row, an f32 sum of squares reduced with
// warp shuffles, then a second pass over the row (which L1 still holds for
// the widths the model uses) that writes y.  No shared memory, no
// cross-warp reduction; eight rows per 256-thread block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ y, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;
  constexpr int N = Vec<T>::N;

  float ss = 0.f;
  if (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float v[N];
      load_vec<T>(xr + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) ss = fmaf(v[i], v[i], ss);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float v = to_f<T>(xr[c]);
      ss = fmaf(v, v, ss);
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float v[N], s[N];
      load_vec<T>(xr + c, v);
      load_vec<T>(scale + c, s);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = (v[i] * r) * s[i];
      store_vec<T>(yr + c, v);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      yr[c] = from_f<T>((to_f<T>(xr[c]) * r) * to_f<T>(scale[c]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int vec, cudaStream_t stream) {
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  if (vec) {
    rmsnorm_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xp, sp, yp, rows, d, eps);
  } else {
    rmsnorm_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xp, sp, yp, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, d) contiguous; scale: (d,).  vec = 1 when every row start
// is 16-byte aligned (d a multiple of the vector width, aligned pointers).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              int rows, int d, float eps, int dtype, int vec,
                              void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(x, scale, y, rows, d, eps, vec, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
