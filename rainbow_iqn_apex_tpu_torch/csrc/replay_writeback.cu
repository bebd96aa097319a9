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
// maximum is a block reduction, not an atomic.  The fenced scatter lives in
// writeback.cuh (scatter_group), which K1's weighted launch also runs: the
// fused Anakin step folds this write-back into K1 (csrc/quantile_huber.cu),
// so its own launch serves update_priorities and update_priorities_grouped.
//
// K6s, the write-back of R2D2's sequence replay (DeviceSequenceReplay
// .update_priorities and update_priorities_grouped,
// rainbow_iqn_apex_tpu/replay/device_sequence.py:285-305), is this kernel
// without the fence (port_seq_writeback): p[idx[g, k]] = pri[g, k], a direct
// set, with the same order (the last group, and in a group the last
// occurrence of an id, wins) and the same running maximum.  The sequence ring
// never invalidates a slot, so it has nothing to fence.
#include "common.cuh"
#include "writeback.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS) writeback_kernel(
    float* __restrict__ p, float* __restrict__ max_priority, const int* __restrict__ idx,
    const float* __restrict__ td, int N, int G, int B, float eps, float omega, int fence) {
    __shared__ float scratch[33];
    const int k = threadIdx.x;
    float m = -INFINITY;
    for (int g = 0; g < G; ++g) {
        const int i = g * B + k;
        int slot[1] = {k < B ? idx[i] : -1};
        bool inside[1] = {k < B && slot[0] >= 0 && slot[0] < N};
        float pri[1] = {0.f}, cur[1] = {0.f};
        if (k < B) {
            pri[0] = port::priority_of(td[i] + eps, omega);
            m = port::nan_max(m, pri[0]);
        }
        // the fence reads what the earlier groups left
        if (fence && inside[0]) cur[0] = p[slot[0]];
        port::scatter_group<1>(idx + g * B, B, slot, inside, pri, cur, fence != 0,
                               [&](int s, float v) { p[s] = v; });
    }
    m = port::block_nan_max(m, scratch);
    if (k == 0) *max_priority = port::nan_max(*max_priority, m);
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
