// K6f: the device sample frontier's fenced write-back into the priority mirror.
//
//   pri[k]     = (|td[k]| + eps)^omega                     (k over the B rows of one learn step)
//   p[idx[k]]  = p[idx[k]] > 0 ? pri[k] : 0               (never resurrect a zero slot)
//
// Replaces DeviceSampleFrontier's _writeback (rainbow_iqn_apex_tpu/replay/frontier.py:145-153),
// one XLA-fused graph on the TPU.  It is K6 (csrc/replay_writeback.cu) for one
// group, with the absolute value taken and no running max priority (the
// frontier keeps the fresh-item default on the host trees).  The fence reads
// the mirror before any write of the batch.  A repeated id is written once,
// with its last occurrence's value: JAX's scatter leaves their order open
// (frontier.py:275-277), the host replay's sequential update keeps the last,
// and so does this kernel (a thread writes only if no later thread holds its
// id), whatever order the threads run in.  omega == 0.5 takes sqrtf, as XLA
// rewrites a constant power of 0.5 and torch a scalar one.  An id outside
// [0, N) is dropped, as XLA drops an out-of-bounds scatter update.
//
// Bound on the H100: a few hundred bytes at B = 32: launch-bound.  Design: one
// block, one thread per row, a barrier between the fence reads and the writes.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS) frontier_writeback_kernel(
    float* __restrict__ p, const int* __restrict__ idx, const float* __restrict__ td, int N,
    int B, float eps, float omega) {
    const int k = threadIdx.x;
    int slot = 0;
    float write = 0.f;
    bool last = false;
    if (k < B) {
        slot = idx[k];
        const float x = fabsf(td[k]) + eps;
        const float pri = omega == 0.5f ? sqrtf(x) : powf(x, omega);
        const bool inside = slot >= 0 && slot < N;
        const float current = inside ? p[slot] : 0.f;
        write = current > 0.f ? pri : 0.f;
        last = inside;
        for (int j = k + 1; j < B; ++j) last = last && idx[j] != slot;
    }
    __syncthreads();  // every fence read before any write
    if (last) p[slot] = write;
}

}  // namespace

// p [N] f32 in place; idx [B] int32, td [B] f32.
PORT_API int port_frontier_writeback(void* p, const void* idx, const void* td, int N, int B,
                                     float eps, float omega, void* stream) {
    if (B < 1 || B > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const int threads = ((B + 31) / 32) * 32;
    frontier_writeback_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<const int*>(idx), static_cast<const float*>(td), N, B,
        eps, omega);
    return (int)cudaGetLastError();
}
