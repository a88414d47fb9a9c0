// What a kernel library exports besides its launchers, once per library
// (its float32 translation unit): the CUDA error string of a launch's code
// and each registered kernel's attributes (small_linalg.cuh::CDDP_REGISTER).
// The main library takes them from riccati_backward.cu, a lane library
// (ops/kernels/build.py::lane_library) from its own first unit.
#pragma once

#include <cstring>

#include "small_linalg.cuh"

extern "C" {

#ifndef CDDP_F64
const char* cddp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What cudaFuncGetAttributes and the occupancy calculator report for the
// kernel of the launcher `name` (with its type suffix) at the block size and
// dynamic shared memory it launches with: out = {registers per thread, local
// (spill) bytes per thread, static shared bytes, dynamic shared bytes,
// resident blocks per SM, threads per block}. Returns a CUDA error code,
// cudaErrorInvalidDeviceFunction for an unknown name.
int cddp_kernel_attributes(const char* name, int* out) {
  for (const cddp::KernelInfo* k = cddp::kernel_list(); k != nullptr; k = k->next) {
    if (std::strcmp(k->name, name) != 0) continue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, k->fn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k->fn, k->threads, k->smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vals[6] = {a.numRegs, int(a.localSizeBytes), int(a.sharedSizeBytes), k->smem,
                         blocks, k->threads};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidDeviceFunction);
}
#endif

}  // extern "C"
