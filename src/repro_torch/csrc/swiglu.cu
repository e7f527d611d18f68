// SwiGLU activation, forward and backward: f32 arithmetic on tensors read
// and written in their own type (f32 or bf16).
//
// Replaces the TPU kernel src/repro/kernels/swiglu.py:swiglu (Pallas,
// (block_rows, block_cols) VMEM tiles) and, in swiglu_bwd_kernel, its
// gradient, which the reference leaves to autodiff.  Two arithmetics,
// chosen by the template parameter ROUND:
//   - ROUND false, the Pallas kernel's (and kernels/ref.py:swiglu_ref's):
//     out = silu(g) * u in f32, rounded once.
//   - ROUND true, the JAX trunk's (models/layers.py ffn_block,
//     models/moe.py experts): s = silu(g) rounded to the type first, then
//     out = round(s * u).  The port's model path takes this one.
// In bf16 the two differ in about a quarter of the outputs; at f32 they
// are the same function.
//
// The backward reproduces autograd of each plain version
// (kernels/swiglu.py): Pallas mode du = round(dy * silu(g)),
// dg = round(dy * u * sig * (1 + g * (1 - sig))); trunk mode
// du = round(dy * s), t = round(dy * u), dg = round(t * sig * (1 + g *
// (1 - sig))), the roundings jax.vjp of the trunk's expression takes.
// silu' has the form of PyTorch's silu_backward.
//
// Bound on the H100: bytes.  The forward reads g and u and writes out, the
// backward reads g, u, dy and writes dg and du; a few tens of f32
// operations an element are far below the ridge.  At the MoE decode
// round's (1024, 768) in bf16 the forward moves 4.7 MB, 1.4 us at 3.35
// TB/s: less than a plain launch's floor, so there the launch is much of
// the time.
//
// Design: a flat walk under programmatic dependent launch.
// 1. One 16-byte vector of each input a thread, all of a thread's loads
//    issued before its arithmetic; one block per kThreads vectors, so the
//    grid covers the tensor with no cap.  A sweep on the card (2, 4 and 8
//    vectors a thread, grids capped at one or two waves of resident
//    blocks) found nothing faster at any main-path shape, forward or
//    backward (PERF.md §6).
// 2. Programmatic dependent launch.  The kernel may start while its
//    predecessor in the stream (the gate and up products) finishes: every
//    thread waits (griddepcontrol.wait) before its first load, the tail's
//    included, so it reads nothing before the predecessor's writes are
//    visible, then lets its successor launch.  Back to back this hides
//    most of the launch, which at the MoE decode round's buffer is most of
//    the time.
// 3. One arithmetic for vector and tail elements (FwdOp, BwdOp).  A
//    tensor whose pointers are not all 16-byte aligned takes the scalar
//    loop for every element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void dependent_launch_begin() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f<T>(from_f<T>(x));
}

// out = silu(g) * u, before the store's rounding
template <typename T, bool ROUND>
struct FwdOp {
  static constexpr int NI = 2, NO = 1;
  __device__ __forceinline__ void operator()(const float* x, float* y) const {
    const float g = x[0], u = x[1];
    const float s = g / (1.f + expf(-g));
    y[0] = (ROUND ? rounded<T>(s) : s) * u;
  }
};

// (dg, du) of out at dy, before the stores' rounding
template <typename T, bool ROUND>
struct BwdOp {
  static constexpr int NI = 3, NO = 2;
  __device__ __forceinline__ void operator()(const float* x, float* y) const {
    const float g = x[0], u = x[1], dy = x[2];
    const float d = 1.f + expf(-g);
    const float sig = 1.f / d;
    const float s = g / d;
    const float t = ROUND ? rounded<T>(dy * u) : dy * u;
    y[0] = t * sig * (1.f + g * (1.f - sig));
    y[1] = dy * (ROUND ? rounded<T>(s) : s);
  }
};

template <typename T, int NI, int NO>
struct Args {
  const T* in[NI];
  T* out[NO];
};

// Op over n elements of each of its inputs and outputs (the design above).
template <typename T, typename Op>
__device__ __forceinline__ void walk(const Args<T, Op::NI, Op::NO>& a, long long n, int vec) {
  constexpr int N = Vec<T>::N, NI = Op::NI, NO = Op::NO;
  const Op op{};
  dependent_launch_begin();
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (vec) {
    const long long n_vec = n / N;
    for (long long i = tid; i < n_vec; i += stride) {
      float x[NI][N], y[NO][N];
#pragma unroll
      for (int j = 0; j < NI; ++j) load_vec<T>(a.in[j] + i * N, x[j]);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float xe[NI], ye[NO];
#pragma unroll
        for (int j = 0; j < NI; ++j) xe[j] = x[j][e];
        op(xe, ye);
#pragma unroll
        for (int o = 0; o < NO; ++o) y[o][e] = ye[o];
      }
#pragma unroll
      for (int o = 0; o < NO; ++o) store_vec<T>(a.out[o] + i * N, y[o]);
    }
    done = n_vec * N;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float xe[NI], ye[NO];
#pragma unroll
    for (int j = 0; j < NI; ++j) xe[j] = to_f<T>(a.in[j][i]);
    op(xe, ye);
#pragma unroll
    for (int o = 0; o < NO; ++o) a.out[o][i] = from_f<T>(ye[o]);
  }
}

template <typename T, bool ROUND>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(Args<T, 2, 1> a, long long n, int vec) {
  walk<T, FwdOp<T, ROUND>>(a, n, vec);
}

template <typename T, bool ROUND>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(Args<T, 3, 2> a, long long n, int vec) {
  walk<T, BwdOp<T, ROUND>>(a, n, vec);
}

// One launch of kernel over n elements: one block per kThreads vectors
// (kThreads elements on the scalar path), programmatic stream
// serialization allowed.
template <typename T, typename A>
int launch(void (*kernel)(A, long long, int), const A& a, long long n, int vec,
           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * (vec ? Vec<T>::N : 1);
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a, n, vec));
}

template <typename T, bool ROUND, bool BWD>
int dispatch_kernel(const void* const* in, void* const* out, long long n, int vec,
                    cudaStream_t s) {
  if constexpr (BWD) {
    Args<T, 3, 2> a{{static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
                     static_cast<const T*>(in[2])},
                    {static_cast<T*>(out[0]), static_cast<T*>(out[1])}};
    return launch<T>(swiglu_bwd_kernel<T, ROUND>, a, n, vec, s);
  } else {
    Args<T, 2, 1> a{{static_cast<const T*>(in[0]), static_cast<const T*>(in[1])},
                    {static_cast<T*>(out[0])}};
    return launch<T>(swiglu_kernel<T, ROUND>, a, n, vec, s);
  }
}

template <bool BWD>
int dispatch(const void* const* in, void* const* out, long long n, int dtype, int vec,
             int round_silu, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    return round_silu ? dispatch_kernel<float, true, BWD>(in, out, n, vec, s)
                      : dispatch_kernel<float, false, BWD>(in, out, n, vec, s);
  }
  if (dtype == DT_BF16) {
    return round_silu ? dispatch_kernel<__nv_bfloat16, true, BWD>(in, out, n, vec, s)
                      : dispatch_kernel<__nv_bfloat16, false, BWD>(in, out, n, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// g, u, out: n contiguous elements.  vec = 1 when all pointers are 16-byte
// aligned; round_silu picks the trunk's arithmetic.
extern "C" int swiglu_launch(const void* g, const void* u, void* out, long long n, int dtype,
                             int vec, int round_silu, void* stream) {
  const void* in[2] = {g, u};
  void* outs[1] = {out};
  return dispatch<false>(in, outs, n, dtype, vec, round_silu, stream);
}

// g, u, dy, dg, du: n contiguous elements each; the rest as swiglu_launch.
extern "C" int swiglu_bwd_launch(const void* g, const void* u, const void* dy, void* dg,
                                 void* du, long long n, int dtype, int vec, int round_silu,
                                 void* stream) {
  const void* in[3] = {g, u, dy};
  void* outs[2] = {dg, du};
  return dispatch<true>(in, outs, n, dtype, vec, round_silu, stream);
}
