// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, per row, in f32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm (Pallas,
// one (block_rows, d) VMEM tile per grid step).  It computes what that
// kernel (and kernels/ref.py:rmsnorm_ref) computes: an f32 sum of squares,
// rsqrt(ss / d + eps), the scale applied in f32, one cast back.  The JAX
// trunk's layers.rmsnorm casts to the model dtype first and multiplies by
// scale after; in bf16 the two orders differ by about one ulp, and at f32
// they agree.
//
// Bound on the H100: bytes.  Two flops per element against 2-4 bytes read
// and written is far below the ~295 flop/byte ridge, so the least time is
// (read x + read scale + write y) / 3.35 TB/s: 2.5 µs at the prefill's
// (2048, 1024) in bf16.  The decode round's rows ((8, 1024), (128, 128),
// (64, 128)) move a few kB: there the launch and one memory round trip are
// all the time there is.
//
// Design.
// 1. Whole rows in registers, for the widths the repo's configs use (bf16
//    d = 128, 1024, 2048, 4096; f32 d = 128, 1024).  A row is cut over LPR
//    lanes, each holding VPL 16-byte vectors of x and of scale at columns
//    (v * LPR + lane) * N (the LPR lanes read neighbouring vectors).  Every
//    load of x and of scale is issued before the first FMA, x is read once,
//    and y is written from registers: one memory round trip, not two
//    dependent ones.
// 2. Sub-warp rows.  At d = 128 in bf16 a row is 16 vectors, so 16 lanes
//    take a row and a warp two; the sum of squares is reduced by shuffle-
//    xor inside the LPR lanes.
// 3. Bytes in flight.  When a row is one vector a lane and the rows fill
//    the card several times over, a thread holds RPT = 4 rows and issues
//    all their loads together (at (32768, 128) bf16: 1024 blocks of 128
//    threads, one wave on 132 SMs with the whole input in flight); below
//    that, one row a thread, so that few rows spread over more SMs.  RPT
//    only says which rows a thread takes, never how a row is summed.  16
//    lanes a row at d = 1024, 256-thread blocks, one-warp blocks for few
//    rows and streaming loads timed no better on the card.
// 4. Programmatic dependent launch.  Every launch lets the kernel start
//    while the kernel before it in the stream finishes; it waits
//    (griddepcontrol.wait) before its first load, so it reads nothing, the
//    scale included, before its predecessor's writes are visible, and lets
//    the next kernel start at once (griddepcontrol.launch_dependents).
//    Back to back, the launch then overlaps the kernel before it: the warm
//    decode-shape times in PERF.md show it.
// 5. Other widths (the card tests run d = 96 and 100) take a warp a row,
//    16-byte vectors where the row allows them, two passes over the row (L1
//    holds it for the second); rows wider than WIDE = 16384 (nemotron-4's
//    18432) take a 256-thread block a row with a shared-memory reduce.
// 6. The split form, for a row cut over the model axis (the SSM mixer's
//    gate_norm over d_inner, each rank holding its heads' d_inner/M
//    channels): rmsnorm_sumsq_launch writes each row's f32 sum of squares
//    over the local channels; the caller all-reduces them over the model
//    group; rmsnorm_apply_launch takes the summed values and the whole
//    width and writes x * rsqrt(ss / d_whole + eps) * scale.  Both walk a
//    row with a warp, as the two passes of the warp-a-row kernel do.
//
// Batch invariance: the arrangement (lanes per row, each lane's columns,
// the order of its sums, the reduction tree) is chosen from d and the
// dtype alone, never from the row count, so a row's output is bitwise the
// same whatever rows surround it (the serving engine's determinism
// contract: src/repro/serve/engine.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // register-row blocks
constexpr int kWideThreads = 256;
constexpr int WIDE = 16384;     // wider rows take a block each

// Under programmatic dependent launch: wait until the kernel before this
// one in the stream has finished and its writes are visible, then let the
// next kernel launch.
__device__ __forceinline__ void dependent_launch_begin() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// x . x over N widened elements, added to ss in order
template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& raw, float ss) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) {
    const float f = to_f<T>(e[i]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// Rows of d = LPR * VPL * N held in registers; RPT rows a thread.
template <typename T, int LPR, int VPL, int RPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_regs_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y,
                    int rows, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int D = LPR * VPL * N;
  constexpr int GROUPS = kThreads / LPR;  // rows a block takes at once
  const int sub = threadIdx.x % LPR;
  const int grp = threadIdx.x / LPR;
  const int row0 = blockIdx.x * GROUPS * RPT + grp;
  dependent_launch_begin();

  uint4 xs[RPT][VPL], ss_raw[VPL];
  bool live[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r * GROUPS;
    live[r] = row < rows;
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + static_cast<size_t>(live[r] ? row : 0) * D);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (live[r]) xs[r][v] = xr[v * LPR + sub];
      else xs[r][v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
#pragma unroll
  for (int v = 0; v < VPL; ++v) ss_raw[v] = __ldg(sr + v * LPR + sub);

  float inv[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) ss = sum_sq<T>(xs[r][v], ss);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    inv[r] = rsqrtf(ss / static_cast<float>(D) + eps);
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (!live[r]) continue;
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(row0 + r * GROUPS) * D);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const T* xe = reinterpret_cast<const T*>(&xs[r][v]);
      const T* se = reinterpret_cast<const T*>(&ss_raw[v]);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < N; ++i) oe[i] = from_f<T>((to_f<T>(xe[i]) * inv[r]) * to_f<T>(se[i]));
      yr[v * LPR + sub] = out;
    }
  }
}

// A warp's walk of one row: the sum of squares, on every lane
template <typename T, bool VEC>
__device__ __forceinline__ float warp_row_sum_sq(const T* __restrict__ xr, int d, int lane) {
  constexpr int N = Vec<T>::N;
  float ss = 0.f;
  if (VEC) {
    for (int c = lane * N; c < d; c += 32 * N)
      ss = sum_sq<T>(*reinterpret_cast<const uint4*>(xr + c), ss);
  } else {
    for (int c = lane; c < d; c += 32) {
      const float v = to_f<T>(xr[c]);
      ss = fmaf(v, v, ss);
    }
  }
  return warp_sum(ss);
}

// ... and y = (x * r) * scale over it
template <typename T, bool VEC>
__device__ __forceinline__ void warp_row_apply(const T* __restrict__ xr,
                                               const T* __restrict__ scale, T* __restrict__ yr,
                                               int d, float r, int lane) {
  constexpr int N = Vec<T>::N;
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
    for (int c = lane; c < d; c += 32) yr[c] = from_f<T>((to_f<T>(xr[c]) * r) * to_f<T>(scale[c]));
  }
}

// Any width up to WIDE: a warp a row, two passes (the second from L1).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y,
                    int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  dependent_launch_begin();
  if (row >= rows) return;  // whole warps: a row is one warp's
  const T* xr = x + static_cast<size_t>(row) * d;
  const float ss = warp_row_sum_sq<T, VEC>(xr, d, lane);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  warp_row_apply<T, VEC>(xr, scale, y + static_cast<size_t>(row) * d, d, r, lane);
}

// The split form's first pass: each row's f32 sum of squares
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_sumsq_kernel(const T* __restrict__ x, float* __restrict__ ss, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  dependent_launch_begin();
  if (row >= rows) return;
  const float s = warp_row_sum_sq<T, VEC>(x + static_cast<size_t>(row) * d, d, lane);
  if (lane == 0) ss[row] = s;
}

// ... and its second: the rows normed by the summed squares of the whole width
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_apply_kernel(const T* __restrict__ x, const float* __restrict__ ss,
                     const T* __restrict__ scale, T* __restrict__ y, int rows, int d,
                     float d_whole, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  dependent_launch_begin();
  if (row >= rows) return;
  const float r = rsqrtf(ss[row] / d_whole + eps);
  const size_t off = static_cast<size_t>(row) * d;
  warp_row_apply<T, VEC>(x + off, scale, y + off, d, r, lane);
}

// Rows wider than WIDE: a block a row; per-thread sums, then warp sums in
// warp order through shared memory.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y,
                     int d, float eps) {
  __shared__ float part[kWideThreads / 32];
  dependent_launch_begin();
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kWideThreads) {
    const float v = to_f<T>(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWideThreads / 32; ++w) tot += part[w];
  const float r = rsqrtf(tot / static_cast<float>(d) + eps);
  for (int c = threadIdx.x; c < d; c += kWideThreads)
    yr[c] = from_f<T>((to_f<T>(xr[c]) * r) * to_f<T>(scale[c]));
}

// Launches kernel on `blocks` blocks of `threads` with programmatic stream
// serialization allowed (the kernels wait for their predecessor first).
template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), int blocks, int threads, cudaStream_t stream,
               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...));
}

constexpr int kSMs = 132;  // H100 SXM

// RPT = 4 rows a thread once the one-row grid would pass 4 blocks an SM
template <typename T, int LPR, int VPL>
int launch_regs(const T* x, const T* s, T* y, int rows, float eps, cudaStream_t stream) {
  constexpr int groups = kThreads / LPR;
  if (VPL == 1 && rows > 4 * kSMs * groups) {
    constexpr int per_block = groups * 4;
    return launch_pdl(rmsnorm_regs_kernel<T, LPR, VPL, 4>, (rows + per_block - 1) / per_block,
                      kThreads, stream, x, s, y, rows, eps);
  }
  return launch_pdl(rmsnorm_regs_kernel<T, LPR, VPL, 1>, (rows + groups - 1) / groups, kThreads,
                    stream, x, s, y, rows, eps);
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int rows, int d, float eps, int vec,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  if (vec) {
    if constexpr (sizeof(T) == 2) {
      switch (d) {
        case 128: return launch_regs<T, 16, 1>(xp, sp, yp, rows, eps, stream);
        case 1024: return launch_regs<T, 32, 4>(xp, sp, yp, rows, eps, stream);
        case 2048: return launch_regs<T, 32, 8>(xp, sp, yp, rows, eps, stream);
        case 4096: return launch_regs<T, 32, 16>(xp, sp, yp, rows, eps, stream);
        default: break;
      }
    } else {
      switch (d) {
        case 128: return launch_regs<T, 32, 1>(xp, sp, yp, rows, eps, stream);
        case 1024: return launch_regs<T, 32, 8>(xp, sp, yp, rows, eps, stream);
        default: break;
      }
    }
  }
  if (d > WIDE)
    return launch_pdl(rmsnorm_block_kernel<T>, rows, kWideThreads, stream, xp, sp, yp, d, eps);
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  auto kernel = vec ? rmsnorm_warp_kernel<T, true> : rmsnorm_warp_kernel<T, false>;
  return launch_pdl(kernel, blocks, kThreads, stream, xp, sp, yp, rows, d, eps);
}

template <typename T>
int launch_sumsq(const void* x, void* ss, int rows, int d, int vec, cudaStream_t stream) {
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  auto kernel = vec ? rmsnorm_sumsq_kernel<T, true> : rmsnorm_sumsq_kernel<T, false>;
  return launch_pdl(kernel, blocks, kThreads, stream, static_cast<const T*>(x),
                    static_cast<float*>(ss), rows, d);
}

template <typename T>
int launch_apply(const void* x, const void* ss, const void* scale, void* y, int rows, int d,
                 float d_whole, float eps, int vec, cudaStream_t stream) {
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  auto kernel = vec ? rmsnorm_apply_kernel<T, true> : rmsnorm_apply_kernel<T, false>;
  return launch_pdl(kernel, blocks, kThreads, stream, static_cast<const T*>(x),
                    static_cast<const float*>(ss), static_cast<const T*>(scale),
                    static_cast<T*>(y), rows, d, d_whole, eps);
}

}  // namespace

// The split form (design note 6).  x, y: (rows, d) contiguous; ss: (rows,)
// f32; scale: (d,); d_whole: the width the row was cut from.
extern "C" int rmsnorm_sumsq_launch(const void* x, void* ss, int rows, int d, int dtype,
                                    int vec, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_sumsq<float>(x, ss, rows, d, vec, s);
  if (dtype == DT_BF16) return launch_sumsq<__nv_bfloat16>(x, ss, rows, d, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rmsnorm_apply_launch(const void* x, const void* ss, const void* scale, void* y,
                                    int rows, int d, int d_whole, float eps, int dtype, int vec,
                                    void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float dw = static_cast<float>(d_whole);
  if (dtype == DT_F32) return launch_apply<float>(x, ss, scale, y, rows, d, dw, eps, vec, s);
  if (dtype == DT_BF16)
    return launch_apply<__nv_bfloat16>(x, ss, scale, y, rows, d, dw, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
