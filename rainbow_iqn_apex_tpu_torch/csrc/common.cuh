// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is reached through a plain C entry point (extern "C") that the
// Python wrappers load with ctypes: pointers and the CUDA stream arrive as
// void*, sizes as int.  An entry launches on the caller's stream, allocates
// nothing, never synchronises, and returns cudaGetLastError() so a refused
// launch is reported to the wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define PORT_API extern "C" __attribute__((visibility("default")))

namespace port {

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

}  // namespace port
