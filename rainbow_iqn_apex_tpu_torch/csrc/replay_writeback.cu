// K6: the fenced priority write-back of the device replay, G groups in order.
//
//   pri[i]        = (td[i] + eps)^omega                          (i over the G*B draws)
//   max_priority  = max(max_priority, max_i pri[i])              (before the fence)
//   for g in 0..G-1:                                             (in order)
//     p[idx[g, k]] = p[idx[g, k]] > 0 ? pri[g, k] : 0            (the never-resurrect fence)
//
// Replaces DeviceReplay.update_priorities (rainbow_iqn_apex_tpu/replay/device.py:335-346)
// and update_priorities_grouped (:321-333), XLA-fused on the TPU.  Inside a
// group the fence reads the value from before the group and, where an id
// repeats, its last occurrence is written; group g's fence reads what the
// groups before it left.  That is the JAX package's G ordered scatters and the
// host replay's sequential update (replay/buffer.py:update_priorities).  Each
// thread writes only if no later thread of its group holds the same id, so the
// result does not depend on the order threads run in.  omega == 0.5 takes
// sqrtf, as XLA rewrites a constant power of 0.5 and torch a scalar one;
// the maxima propagate NaN, as jnp.maximum and torch.maximum do.  An id
// outside [0, N) is dropped, as XLA drops an out-of-bounds scatter update:
// the kernel never reads or writes outside the priorities.
//
// Bound on the H100: a few KB at G*B = 128, far under a microsecond: the
// kernel is launch-bound.  Design: one block, one thread per draw of a group,
// a barrier between the fence reads and the writes of each group; the
// maximum is a block reduction, not an atomic.
//
// K6s, the write-back of R2D2's sequence replay (DeviceSequenceReplay
// .update_priorities and update_priorities_grouped,
// rainbow_iqn_apex_tpu/replay/device_sequence.py:285-305), is this kernel
// without the fence (port_seq_writeback): p[idx[g, k]] = pri[g, k], a direct
// set, with the same order (the last group, and in a group the last
// occurrence of an id, wins) and the same running maximum.  The sequence ring
// never invalidates a slot, so it has nothing to fence.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float priority_of(float td, float eps, float omega) {
    return omega == 0.5f ? sqrtf(td + eps) : powf(td + eps, omega);
}

__global__ void __launch_bounds__(MAX_THREADS) writeback_kernel(
    float* __restrict__ p, float* __restrict__ max_priority, const int* __restrict__ idx,
    const float* __restrict__ td, int N, int G, int B, float eps, float omega, int fence) {
    __shared__ float warp_max[MAX_THREADS / 32];
    const int k = threadIdx.x;
    float m = -INFINITY;
    for (int g = 0; g < G; ++g) {
        const int i = g * B + k;
        int slot = 0;
        float write = 0.f;
        bool last = false;
        if (k < B) {
            slot = idx[i];
            const float pri = priority_of(td[i], eps, omega);
            m = nan_max(m, pri);
            const bool inside = slot >= 0 && slot < N;
            // the fence reads what the earlier groups left
            write = !fence || (inside && p[slot] > 0.f) ? pri : 0.f;
            last = inside;
            for (int j = k + 1; j < B; ++j) last = last && idx[g * B + j] != slot;
        }
        __syncthreads();  // every fence read of this group before its writes
        if (last) p[slot] = write;
        __syncthreads();  // the writes before the next group's reads
    }
    for (int d = 16; d > 0; d >>= 1) m = nan_max(m, __shfl_down_sync(0xffffffffu, m, d));
    if ((k & 31) == 0) warp_max[k >> 5] = m;
    __syncthreads();
    if (k == 0) {
        float all = *max_priority;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) all = nan_max(all, warp_max[w]);
        *max_priority = all;
    }
}

int launch(void* p, void* max_priority, const void* idx, const void* td, int N, int G, int B,
           float eps, float omega, int fence, void* stream) {
    if (B < 1 || B > MAX_THREADS || G < 1) return (int)cudaErrorInvalidValue;
    const int threads = ((B + 31) / 32) * 32;
    writeback_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<float*>(max_priority), static_cast<const int*>(idx),
        static_cast<const float*>(td), N, G, B, eps, omega, fence);
    return (int)cudaGetLastError();
}

}  // namespace

// p [N] f32 and max_priority [] f32 in place; idx [G, B] int32, td [G * B] f32.
PORT_API int port_replay_writeback(void* p, void* max_priority, const void* idx, const void* td,
                                   int N, int G, int B, float eps, float omega, void* stream) {
    return launch(p, max_priority, idx, td, N, G, B, eps, omega, 1, stream);
}

// K6s: the same without the fence.
PORT_API int port_seq_writeback(void* p, void* max_priority, const void* idx, const void* td,
                                int N, int G, int B, float eps, float omega, void* stream) {
    return launch(p, max_priority, idx, td, N, G, B, eps, omega, 0, stream);
}
