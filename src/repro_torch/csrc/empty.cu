// Empty kernels, the yardsticks of the launch floor: the least time any
// launch can read on this card under a given timer (chip_smoke.py times
// them cold and warm beside the µs-scale kernels of the decode round).
// empty_launch is a plain launch; empty_pdl_launch is launched as kernel #3
// is, with programmatic stream serialization, and waits for its
// predecessor as #3 does.  They replace no TPU kernel and no path of the
// port launches them.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

__global__ void empty_pdl_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int empty_pdl_launch(void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_pdl_kernel));
}
