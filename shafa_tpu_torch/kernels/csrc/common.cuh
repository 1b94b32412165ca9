// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every C entry point of the library returns cudaGetLastError() after its
// launches (0 = success); the Python wrappers raise on anything else.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SHAFA_RETURN_IF_LAUNCH_FAILED()              \
  do {                                               \
    cudaError_t err_ = cudaGetLastError();           \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)

// MSB-first bit-stream word -> the u32 whose little-endian bytes are the
// stream's bytes in file order.
__device__ __forceinline__ uint32_t shafa_bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}
